"""K6 (cdef_dir) and K7 (cdef_filter) plain versions against
filters/cdef_jax.py: find_dir_j, and cdef_frames_j's strength search and
apply on luma and chroma, on noisy copies of synthetic-clip frames with a
random skip map. Directions, variances, strengths and planes are exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.filters import cdef_jax
from svtav1_tpu_torch.filters import cdef_torch
from svtav1_tpu_torch.utils.testclip import make_frames


def _inputs(w, h, noise, seed):
    frames = make_frames(w, h, 2, seed=seed)
    rng = np.random.default_rng(seed)
    src = np.stack([f[0] for f in frames]).astype(np.int32)
    rec = [np.clip(np.stack([f[i] for f in frames]).astype(np.int32)
                   + rng.integers(-noise, noise + 1, (2,) + frames[0][i].shape), 0, 255)
           .astype(np.int32) for i in range(3)]
    nonskip = rng.random((2, h // 8, w // 8)) < 0.8
    return src, rec, nonskip


@pytest.mark.parametrize("size", [(64, 64), (128, 96)])
def test_find_dir_plain_matches_jax(size):
    w, h = size
    _, rec, _ = _inputs(w, h, 6, seed=w)
    cells = rec[0].reshape(2, h // 8, 8, w // 8, 8).transpose(0, 1, 3, 2, 4)
    d_ref, v_ref = cdef_jax.find_dir_j(jnp.asarray(cells))
    d, v = cdef_torch.find_dir(torch.from_numpy(rec[0]))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    assert len(np.unique(d.numpy())) == 8


@pytest.mark.parametrize("size", [(64, 64), (128, 96)])
@pytest.mark.parametrize("n_cand", [0, 4])
@pytest.mark.parametrize("noise", [2, 6])
def test_cdef_frames_plain_matches_jax(size, n_cand, noise):
    w, h = size
    src, rec, nonskip = _inputs(w, h, noise, seed=w + noise)
    want, want_st, _ = cdef_jax.cdef_frames_j([jnp.asarray(p) for p in rec], jnp.asarray(src),
                                              jnp.asarray(nonskip), damping=5, n_cand=n_cand)
    got, st = cdef_torch.cdef_frames([torch.from_numpy(p) for p in rec], torch.from_numpy(src),
                                     torch.from_numpy(nonskip), 5, n_cand=n_cand)
    np.testing.assert_array_equal(st.numpy(), np.asarray(want_st))
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"plane {i}")
    assert (got[0].numpy() != rec[0]).any()  # the filter did something


def test_filter_candidates_share_one_call():
    """K candidates in one call equal K single calls; the SSE counts only
    the masked cells."""
    src, rec, nonskip = _inputs(64, 64, 4, seed=9)
    plane, s = torch.from_numpy(rec[0]), torch.from_numpy(src)
    mask = torch.from_numpy(nonskip)
    dirs, var = cdef_torch.find_dir(plane)
    pri = torch.tensor([[0, 0], [2, 2], [6, 6]], dtype=torch.int32)
    sec = torch.tensor([[0, 0], [1, 1], [2, 2]], dtype=torch.int32)
    out, sse = cdef_torch.cdef_filter(plane, dirs, var, pri, sec, mask, 5, src=s)
    for k in range(3):
        one, one_sse = cdef_torch.cdef_filter(plane, dirs, var, pri[k:k + 1], sec[k:k + 1], mask, 5,
                                              src=s)
        assert torch.equal(one[0], out[k]) and torch.equal(one_sse[0], sse[k])
    assert torch.equal(out[0], plane)  # strength 0 is the identity
    m = np.repeat(np.repeat(nonskip, 8, 1), 8, 2)
    d = (rec[0] - src).astype(np.int64) * m
    np.testing.assert_array_equal(sse[0].numpy(), (d * d).sum(axis=(1, 2)))
