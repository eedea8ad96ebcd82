"""The port's filter stage (_filter_device: DLF with the frame-level luma
level search, then CDEF, display-edge replication and the pack) against the
JAX package's _filter_device on the same recon, skip map and block sizes:
the searched level, the CDEF strengths and the planes must be exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.filters import dlf_jax
from svtav1_tpu.pipeline import device_commit as ref
from svtav1_tpu_torch.filters import dlf
from svtav1_tpu_torch.filters import dlf_torch
from svtav1_tpu_torch.pipeline import device_commit as port
from svtav1_tpu_torch.utils.testclip import make_frames


def _inputs(w, h, seed):
    """Source frames and a blocky recon of them (per-block offsets, so
    deblocking pays off), a random block-size map and skip map."""
    frames = make_frames(w, h, 2, seed=seed)
    rng = np.random.default_rng(seed)
    R8, C8 = h // 8, w // 8
    sm = rng.choice([8, 16, 32], (2, R8, C8)).astype(np.int32)
    rec = []
    for i, ss in ((0, 0), (1, 1), (2, 1)):
        src = np.stack([f[i] for f in frames]).astype(np.int32)
        off = np.repeat(np.repeat(rng.integers(-5, 6, (2, R8, C8)), 8 >> ss, 1), 8 >> ss, 2)
        rec.append(np.clip(src + off + rng.integers(-1, 2, src.shape), 0, 255).astype(np.int32))
    skip8 = rng.random((2, R8, C8)) < 0.3
    return np.stack([f[0] for f in frames]).astype(np.uint8), rec, sm, skip8


@pytest.mark.parametrize("size", [(64, 64), (128, 96)])
@pytest.mark.parametrize("enable_cdef, cdef_cands", [(False, 0), (True, 0), (True, 4)])
def test_filter_device_matches_jax(size, enable_cdef, cdef_cands):
    w, h = size
    src_y, rec, sm, skip8 = _inputs(w, h, seed=w + cdef_cands)
    levels = tuple(dlf.pick_filter_levels(120, 8, True, h))
    lf_search = port._lf_candidates(levels[0])
    assert lf_search == ref._lf_candidates(levels[0]) and len(lf_search) > 1
    flens = [dlf_jax.flen_maps_from_sizes(sm, plane, tr) for plane in range(3)
             for tr in (False, True)]
    damping = 5
    want_packed, want_stats, want_planes = ref._filter_device(
        *(jnp.asarray(p) for p in rec), jnp.asarray(src_y), jnp.asarray(skip8),
        jnp.asarray(np.concatenate([f.ravel() for f in flens])), levels, 0, 8, damping,
        enable_cdef, tuple(f.shape for f in flens), disp_dims=(w - 6, h - 2),
        cdef_cands=cdef_cands, lf_search=lf_search)
    pflens = [torch.as_tensor(dlf_torch.flen_maps_from_sizes(sm, plane, tr, (w, h)),
                              dtype=torch.int32) for plane in range(3) for tr in (False, True)]
    packed, stats, planes = port._filter_device(
        *(torch.from_numpy(p) for p in rec), torch.from_numpy(src_y), torch.from_numpy(skip8),
        pflens, levels, 0, 8, damping, enable_cdef, disp_dims=(w - 6, h - 2),
        cdef_cands=cdef_cands, lf_search=lf_search)
    np.testing.assert_array_equal(stats.numpy(), np.asarray(want_stats))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want_packed))
    for got, want in zip(planes, want_planes):  # the planes a device DPB keeps
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (stats.numpy()[:, 4] > 0).all()  # the search left level 0 behind


def test_luma_level_zero_leaves_chroma_unfiltered():
    """A frame whose searched luma level is 0 codes no chroma level, and a
    decoder then filters none of its planes (spec 5.9.11, 7.14.1): the
    port's filter stage leaves that frame's chroma as it was, and filters
    the chroma of a frame whose luma level is not 0 at the chroma levels.
    (The reference filters both; ROADMAP queue 3.)"""
    w, h = 64, 64
    src_y, rec, sm, skip8 = _inputs(w, h, seed=5)
    rec[0][0] = src_y[0]  # frame 0: the unfiltered luma is the source, level 0 wins
    levels = tuple(dlf.pick_filter_levels(120, 8, True, h))
    lf_search = port._lf_candidates(levels[0])
    flens = [torch.as_tensor(dlf_torch.flen_maps_from_sizes(sm, plane, tr, (w, h)),
                             dtype=torch.int32) for plane in range(3) for tr in (False, True)]
    args = [torch.from_numpy(p) for p in rec] + [torch.from_numpy(src_y), torch.from_numpy(skip8),
                                                 flens]
    _, stats, planes = port._filter_device(*args, levels, 0, 8, 5, False, lf_search=lf_search)
    _, _, fixed = port._filter_device(*args, levels, 0, 8, 5, False)
    assert lf_search[int(stats[0, 4])] == 0 and lf_search[int(stats[1, 4])] > 0
    for pl in (1, 2):
        np.testing.assert_array_equal(planes[pl][0].numpy(), rec[pl][0])
        np.testing.assert_array_equal(planes[pl][1].numpy(), fixed[pl][1].numpy())
        assert (planes[pl][1].numpy() != rec[pl][1]).any()
