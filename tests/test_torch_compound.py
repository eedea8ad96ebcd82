"""Compound prediction of the port against svtav1_tpu on the same numpy
inputs: the plain versions of the conv-buf MC pass, the normative average
and K11 (mc_compound) in svtav1_tpu_torch.ops.me_torch against
svtav1_tpu.ops.me_jax, integer for integer; and one hierarchical-B frame's
decide, with the NEW_NEWMV candidate on (LAST, ALTREF), against
svtav1_tpu.pipeline.inter_device: integer outputs exact, costs to float32
summation order (rtol 1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.ops import me_jax
from svtav1_tpu.pipeline import device_decide as ref_decide
from svtav1_tpu.pipeline import inter_device as ref_inter
from svtav1_tpu_torch.codec.tile_codec import FrameParams
from svtav1_tpu_torch.ops import me_torch
from svtav1_tpu_torch.pipeline import device_decide, inter_device
from svtav1_tpu_torch.pipeline import encoder as port_enc
from svtav1_tpu_torch.utils.testclip import make_frames

CASES = [(n, bd) for n in (4, 8, 16) for bd in (8, 10)]


def _lanes(n: int, bd: int, seed: int, nref: int = 3, H: int = 40, W: int = 56):
    """A (nref, H, W) reference stack and B lanes of n x n blocks with random
    1/16-pel MVs (some reaching past every edge) and ref indices."""
    g = np.random.default_rng(seed)
    refs = g.integers(0, 1 << bd, (nref, H, W)).astype(np.int32)
    B = 48
    ys = g.integers(0, H - n + 1, B).astype(np.int32)
    xs = g.integers(0, W - n + 1, B).astype(np.int32)
    mv = g.integers(-20 * 16, 20 * 16, (4, B)).astype(np.int32)
    mv[:, :4] = [[-(H + 12) * 16, 0, (H + 9) * 16, 5], [7, -(W + 12) * 16, -3, (W + 9) * 16],
                 [(H + 10) * 16 + 3, -5, 0, -(H + 11) * 16], [-1, (W + 11) * 16, -(W + 9) * 16, 2]]
    ri = g.integers(0, nref, (2, B)).astype(np.int32)
    return refs, ys, xs, mv, ri


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("n, bd", CASES)
def test_conv_buf_mc_matches_jax(n, bd):
    refs, ys, xs, mv, ri = _lanes(n, bd, seed=n + bd)
    want = me_jax.mc_lanes(jnp.asarray(refs), jnp.asarray(ys), jnp.asarray(xs), jnp.asarray(mv[0]),
                           jnp.asarray(mv[1]), n, n, 0, bd, ref_idx=jnp.asarray(ri[0]),
                           conv_buf=True)
    got = me_torch.mc_lanes_plain(*_t(refs, ys, xs, mv[0], mv[1]), n, n, 0, bd,
                                  torch.from_numpy(ri[0]), conv_buf=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n, bd", CASES)
def test_compound_average_matches_jax(n, bd):
    refs, ys, xs, mv, ri = _lanes(n, bd, seed=2 * n + bd)
    c = [me_jax.mc_lanes(jnp.asarray(refs), jnp.asarray(ys), jnp.asarray(xs),
                         jnp.asarray(mv[2 * k]), jnp.asarray(mv[2 * k + 1]), n, n, 0, bd,
                         ref_idx=jnp.asarray(ri[k]), conv_buf=True) for k in (0, 1)]
    want = me_jax.compound_average_j(c[0], c[1], bd)
    got = me_torch.compound_average_plain(*_t(np.asarray(c[0]), np.asarray(c[1])), bd)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n, bd", CASES)
def test_mc_lanes_compound_matches_jax(n, bd):
    """The wrapper on CPU tensors (K11's plain version), 8-tap and, at n=4,
    the 4-tap filters; uint8 reference stacks at bd 8, as on the card."""
    refs, ys, xs, mv, ri = _lanes(n, bd, seed=3 * n + bd)
    want = me_jax.mc_lanes_compound(jnp.asarray(refs), jnp.asarray(ys), jnp.asarray(xs),
                                    *[jnp.asarray(m) for m in mv], n, n, 0, bd,
                                    jnp.asarray(ri[0]), jnp.asarray(ri[1]))
    stack = refs.astype(np.uint8) if bd == 8 else refs
    got = me_torch.mc_lanes_compound(*_t(stack, ys, xs, *mv), n, n, 0, bd, *_t(ri[0], ri[1]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_b_frame_decide_matches_jax():
    """Frame 2 of the clip against frames 1 (LAST), 0 (GOLDEN) and 3
    (ALTREF) with reference_select and a non-zero global MV: the decide
    with the compound lane, and some blocks pick it."""
    W, H = 96, 64
    frames = make_frames(W, H, 4, seed=5)
    src = frames[2]
    refs = [frames[1], frames[0], frames[3]]
    p = FrameParams(width=W, height=H, qindex=128, frame_is_intra=False, enable_gm=1,
                    enable_rdoq=True, reference_select=1, **port_enc.PRESETS["medium"])
    gm = [(0, 0)] * 8
    gm[1] = (4, -6)
    p.gm_mvs = tuple(gm)
    stack = [np.stack([np.asarray(r[pl], np.uint8) for r in refs]) for pl in range(3)]
    want = ref_inter.decide_inter_frame(
        ref_decide.put_frames([list(src)], 8), tuple(jax.device_put(s) for s in stack), p,
        p.interp_filter, ref_ids=(1, 4, 7))
    got = inter_device.decide_inter_frame(
        device_decide.put_frames([list(src)], 8, "cpu"),
        tuple(torch.from_numpy(s) for s in stack), p, p.interp_filter, ref_ids=(1, 4, 7))
    assert sorted(got) == sorted(want)
    compound = 0
    for n in want:
        for key in want[n]:
            if key == "cost":
                np.testing.assert_allclose(got[n][key], want[n][key], rtol=1e-5, err_msg=f"n={n}")
            else:
                np.testing.assert_array_equal(got[n][key], want[n][key], err_msg=f"n={n} {key}")
        compound += int((want[n]["ref2"] >= 0).sum())
    assert compound > 0


@pytest.mark.parametrize("n, bd", CASES)
def test_mc_lanes_compound_planes_equals_the_plain_version_per_plane(n, bd):
    """The planes form (on the card one launch, the commit's U and V) on
    CPU tensors: two and three stacks of one shape that share the lanes give
    mc_compound_plain of each stack."""
    refs, ys, xs, mv, ri = _lanes(n, bd, seed=3 * n + bd)
    dt = np.uint8 if bd == 8 else np.int16
    stacks = [refs, refs[::-1], (refs * 7 + 31) % (1 << bd)]
    stacks = [torch.from_numpy(np.ascontiguousarray(s.astype(dt))) for s in stacks]
    lanes = (*_t(ys, xs, *mv), n, n, 0, bd, *_t(ri[0], ri[1]))
    for P in (2, 3):
        got = me_torch.mc_lanes_compound_planes(stacks[:P], *lanes)
        assert got.shape == (P, len(ys), n, n) and got.dtype == torch.int32
        for k in range(P):
            assert torch.equal(got[k], me_torch.mc_compound_plain(stacks[k], *lanes)), (P, k)
    assert not torch.equal(got[0], got[1])
