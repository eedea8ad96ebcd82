"""K4 (dlf_edges) plain version against dlf_jax.filter_vertical_edges_j on
random planes with flen_maps_from_sizes maps from random size maps: all
four filter lengths, several levels, sharpness 0. Exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.filters import dlf_jax as ref
from svtav1_tpu_torch.filters import dlf_torch as port


def _smooth_plane(rng, F, H, W, bd):
    """Blocky planes with small steps, so flat and filter masks both fire."""
    hi = (1 << bd) - 1
    base = rng.integers(60 << (bd - 8), 190 << (bd - 8), (F, H // 8 + 1, W // 8 + 1))
    pl = np.repeat(np.repeat(base, 8, 1), 8, 2)[:, :H, :W]
    pl = pl + rng.integers(-2, 3, (F, H, W)) * (rng.random((F, H, W)) < 0.3)
    return np.clip(pl, 0, hi).astype(np.int32)


@pytest.mark.parametrize("plane", [0, 1])
@pytest.mark.parametrize("level", [6, 20, 40])
@pytest.mark.parametrize("bd", [8, 10])
def test_plain_matches_jax(plane, level, bd):
    rng = np.random.default_rng(plane * 100 + level + bd)
    F, R8, C8 = 2, 6, 8
    sm = rng.choice([8, 16, 32, 64], (F, R8, C8)).astype(np.int32)
    ss = 1 if plane else 0
    H, W = R8 * (8 >> ss), C8 * (8 >> ss)
    planes = _smooth_plane(rng, F, H, W, bd)
    lim, blim, thr = port._limits(level, 0)
    for transpose in (False, True):
        flen_ref = ref.flen_maps_from_sizes(sm, plane, transpose)
        flen = port.flen_maps_from_sizes(sm, plane, transpose, (C8 * 8, R8 * 8))
        np.testing.assert_array_equal(flen, flen_ref)
        # luma edges take 8 and 14 taps, chroma edges 4 and 6
        assert set(np.unique(flen)) >= ({0, 8, 14} if plane == 0 else {0, 4, 6})
        src = planes.transpose(0, 2, 1).copy() if transpose else planes
        want = np.asarray(ref.filter_vertical_edges_j(jnp.asarray(src), jnp.asarray(flen_ref),
                                                      lim, blim, thr, bd))
        got = port.filter_vertical_edges_plain(torch.from_numpy(src), torch.from_numpy(flen),
                                               lim, blim, thr, bd)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want != src).any()  # the filters did something


def test_no_edges_pass_through():
    planes = torch.arange(2 * 8 * 4, dtype=torch.int32).reshape(2, 8, 4)
    flen = torch.zeros((2, 2, 0), dtype=torch.int32)
    out = port.filter_vertical_edges_plain(planes, flen, 1, 6, 0)
    assert torch.equal(out, planes)


def _jax_deblock(planes, flen_v, flen_h, lim_v, lim_h, bd):
    """The reference's two passes (dlf_jax.filter_vertical_edges_j on the
    vertical edges, then through the transpose on the horizontal ones); a
    limits of None leaves its pass out."""
    out = jnp.asarray(planes)
    if lim_v is not None:
        out = ref.filter_vertical_edges_j(out, jnp.asarray(flen_v), *lim_v, bd)
    if lim_h is not None:
        out = ref.filter_vertical_edges_j(out.transpose(0, 2, 1), jnp.asarray(flen_h), *lim_h,
                                          bd).transpose(0, 2, 1)
    return np.asarray(out)


@pytest.mark.parametrize("plane", [0, 1])
@pytest.mark.parametrize("bd", [8, 10])
def test_deblock_plain_matches_jax(plane, bd):
    """K4's whole-plane entry (deblock: both passes, up to three jobs in one
    call) against the reference's passes: three levels in one call (the
    luma search's shape), then a call whose jobs leave out one pass each
    (level 0), on planes whose sides are not multiples of 64."""
    rng = np.random.default_rng(plane * 10 + bd)
    F, R8, C8 = 1, 7, 9
    sm = rng.choice([8, 16, 32, 64], (F, R8, C8)).astype(np.int32)
    ss = 1 if plane else 0
    H, W = R8 * (8 >> ss), C8 * (8 >> ss)
    planes = _smooth_plane(rng, F, H, W, bd)
    disp = (C8 * 8, R8 * 8)
    flen_v, flen_h = (port.flen_maps_from_sizes(sm, plane, tr, disp).astype(np.int32)
                      for tr in (False, True))
    t = torch.from_numpy
    for levels in (((6, 6), (20, 20), (40, 40)), ((0, 30), (30, 0))):
        lims = [tuple(port._limits(lv, 0) if lv else None for lv in pair) for pair in levels]
        got = port.deblock([(t(planes), t(flen_v), t(flen_h), *lv) for lv in lims], bd)
        assert got.shape == (len(lims), F, H, W)
        for j, lv in enumerate(lims):
            want = _jax_deblock(planes, flen_v, flen_h, *lv, bd)
            np.testing.assert_array_equal(got[j].numpy(), want, err_msg=f"levels {levels[j]}")
            assert (want != planes).any()
