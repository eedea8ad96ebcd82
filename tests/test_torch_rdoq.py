"""K5 (rdoq) plain version against rate_jax.make_rdoq_fn.

Real residuals (synthetic-clip blocks against a flat DC prediction) are
transformed and quantized by K2's forward half; the levels and unquantized
coefficients then go through the JAX RDOQ and the port's, for luma and
chroma tables at every square tx size the commit codes (64x64 on its coded
32x32). The levels must be identical on every lane: a lane may differ only
on a float32 near-tie between two competing scores, and the seeded inputs
have none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.codec import rate_jax
from svtav1_tpu.constants.cdf import FrameContext as RefFrameContext
from svtav1_tpu_torch.codec import rate_torch
from svtav1_tpu_torch.constants.av1 import TxSize
from svtav1_tpu_torch.constants.cdf import FrameContext
from svtav1_tpu_torch.ops import quantize as quant_ops
from svtav1_tpu_torch.ops import transforms_torch as TT
from svtav1_tpu_torch.pipeline.intra_md import rd_lambda
from svtav1_tpu_torch.utils.testclip import make_frames

TX = {4: TxSize.TX_4X4, 8: TxSize.TX_8X8, 16: TxSize.TX_16X16, 32: TxSize.TX_32X32,
      64: TxSize.TX_64X64}


def _levels_and_coeff(n: int, qindex: int, seed: int):
    """(levels, coeff) (L, adj, adj) of n x n blocks of a synthetic frame
    against their rounded means, with mixed DCT/ADST lanes up to 16."""
    (y, _u, _v), = make_frames(256, 192, 1, seed=seed)
    y = y.astype(np.int32)
    R, C = 192 // n, 256 // n
    blocks = y[: R * n, : C * n].reshape(R, n, C, n).transpose(0, 2, 1, 3).reshape(-1, n, n)
    pred = np.broadcast_to(blocks.mean(axis=(1, 2), keepdims=True).round().astype(np.int32),
                           blocks.shape).copy()
    L = blocks.shape[0]
    rng = np.random.default_rng(seed)
    va = torch.from_numpy(rng.integers(0, 2, L).astype(bool) & (n <= 16))
    ha = torch.from_numpy(rng.integers(0, 2, L).astype(bool) & (n <= 16))
    dq = (quant_ops.dc_q(qindex, 8), quant_ops.ac_q(qindex, 8))
    lv, co = TT.txfm_quant(torch.from_numpy(blocks), torch.from_numpy(pred), va, ha, *dq, 8)
    return lv, co, dq


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("plane", [0, 1])
def test_plain_matches_jax(n, plane):
    qindex = 120
    lv, co, dq = _levels_and_coeff(n, qindex, seed=n + plane)
    lam = np.float32(rd_lambda(qindex, 8))
    skip_ctx = 7 if plane else 0
    fn = jax.jit(rate_jax.make_rdoq_fn(RefFrameContext(qindex), int(TX[n]), plane,
                                       txb_skip_ctx=skip_ctx))
    want = np.asarray(fn(jnp.asarray(lv.numpy()), jnp.asarray(co.numpy()), dq[0], dq[1], lam))
    rt = rate_torch.make_rdoq_fn(FrameContext(qindex), int(TX[n]), plane, txb_skip_ctx=skip_ctx,
                                 device="cpu")
    got = rt(lv, co, dq[0], dq[1], float(lam)).numpy()
    differing = int((got != want).reshape(len(got), -1).any(axis=1).sum())
    assert differing == 0, f"{differing} of {len(got)} lanes differ"
    # RDOQ did something on these inputs, and only ever lowers magnitudes
    base = lv.numpy()
    assert (np.abs(got) <= np.abs(base)).all() and (got != base).any()
    assert ((got == 0) | (np.sign(got) == np.sign(base))).all()


def test_all_zero_blocks_stay_zero():
    rt = rate_torch.make_rdoq_fn(FrameContext(120), int(TxSize.TX_8X8), 0, device="cpu")
    z = torch.zeros((3, 8, 8), dtype=torch.int32)
    assert torch.equal(rt(z, z, 100, 120, 50.0), z)
