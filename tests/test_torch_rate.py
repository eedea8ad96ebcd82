"""K3 (txb_rate) plain version against rate_jax.make_txb_bits_fn.

Configurations are the decide's (device_decide._rate_fns): luma per block
size and tx type, chroma with txb_skip_ctx=7. Tolerance rtol=1e-5,
atol=1e-3 bits: only the float32 summation order differs (rate_jax.py:11-12).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.codec import rate_jax
from svtav1_tpu.codec.tile_codec import max_uv_txsize
from svtav1_tpu.constants.av1 import MAX_TXSIZE_RECT, TxType
from svtav1_tpu.pipeline.device_decide import BSIZE_BY_N, TX_SEARCH, fc_for_qctx
from svtav1_tpu_torch.codec import rate_torch
from svtav1_tpu_torch.pipeline import device_decide as port_decide

CONFIGS = []
for _n in (8, 16, 32, 64):
    _tx_y = int(MAX_TXSIZE_RECT[BSIZE_BY_N[_n]])
    for _t in (TX_SEARCH if _n <= 16 else TX_SEARCH[:1]):
        CONFIGS.append((_n, _tx_y, _t, 0, 0))
    CONFIGS.append((_n, int(max_uv_txsize(BSIZE_BY_N[_n])), int(TxType.DCT_DCT), 1, 7))


def _closure(fn) -> dict:
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def _levels(rng, B, h, w, dense: bool):
    if dense:
        lv = rng.integers(-40, 41, (B, h, w))
        lv[: B // 4] *= 30  # large levels: br rounds and Golomb
    else:
        lv = np.zeros((B, h, w), np.int64)
        k = max(2, h * w // 16)
        for b in range(B):
            pos = rng.integers(0, min(h * w, 64), k)  # low frequencies
            lv[b].flat[pos] = rng.integers(-5, 6, k)
        lv[0] = 0  # an all-zero block (skip)
        lv[1] = 0
        lv[1, 0, 0] = -1
    lv[2, 0, 0] = 14 + 4  # Golomb remainders at powers of two
    lv[3, 0, 0] = -(14 + 2)
    return lv.astype(np.int32)


@pytest.mark.parametrize("qctx", [1, 2])
@pytest.mark.parametrize("cfg", CONFIGS, ids=[f"n{c[0]}-tx{c[1]}-t{c[2]}-p{c[3]}" for c in CONFIGS])
def test_plain_matches_jax(cfg, qctx):
    n, tx_size, tx_type, plane, skip_ctx = cfg
    fc = fc_for_qctx(qctx)
    fn = rate_jax.make_txb_bits_fn(fc, tx_size, tx_type, plane, skip_ctx, 0)
    arrays = rate_torch.txb_rate_arrays(fc, tx_size, tx_type, plane, skip_ctx, 0)
    ref = _closure(fn)
    for k in ("base_lut", "base_eob_lut", "br_lut", "skip_lut", "dc_sign_lut", "eob_cost",
              "ectx_lut", "iscan", "nz_off", "br_grp"):
        np.testing.assert_array_equal(np.asarray(arrays[k]), np.asarray(ref[k]), err_msg=k)
    assert arrays["tx_class"] == ref["tx_class"]
    tabs = rate_torch.TxbRateTables.from_numpy(arrays, "cpu")
    rng = np.random.default_rng(n * 31 + tx_type + 7 * plane + qctx)
    for dense in (False, True):
        lv = _levels(rng, 16, arrays["h"], arrays["w"], dense)
        want = np.asarray(fn(jnp.asarray(lv)))
        got = tabs(torch.from_numpy(lv)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_decide_rate_fns_cover_luma_and_chroma():
    """One luma table set per TX_SEARCH type (the tx-type search), one chroma."""
    fns = port_decide._rate_fns(1, 16, "cpu")
    assert len(fns["y"]) == len(port_decide.TX_SEARCH) and fns["uv"].h == 8
    assert all(t.h == 16 and t.tx_class == 0 for t in fns["y"])
