"""K6 (cdef_dir) and K7 (cdef_search, cdef_apply) plain versions against
filters/cdef_jax.py: find_dir_j (also on cells of extreme samples), and
cdef_frames_j's strength search and apply on luma and chroma, on noisy
copies of synthetic-clip frames with a random skip map. Directions,
variances, strengths and planes are exact. K6's design without JAX: the
90-degree rotation that its second lane runs, its int32 cost bound, and
its two-lane int32 arithmetic against the int64 references.
K7's two entry points against the plain filter (cdef_filter_plain) and the
sequence of filter calls that cdef_frames made before them; K7's bound."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.filters import cdef_jax
from svtav1_tpu_torch.filters import cdef_torch
from svtav1_tpu_torch.filters.cdef import _CWEIGHTS, _PMATS, find_dir_batch
from svtav1_tpu_torch.utils.testclip import cdef_extreme_cells, cdef_extreme_plane, make_frames


def _inputs(w, h, noise, seed):
    frames = make_frames(w, h, 2, seed=seed)
    rng = np.random.default_rng(seed)
    src = np.stack([f[0] for f in frames]).astype(np.int32)
    rec = [np.clip(np.stack([f[i] for f in frames]).astype(np.int32)
                   + rng.integers(-noise, noise + 1, (2,) + frames[0][i].shape), 0, 255)
           .astype(np.int32) for i in range(3)]
    nonskip = rng.random((2, h // 8, w // 8)) < 0.8
    return src, rec, nonskip


@pytest.mark.parametrize("size", [(64, 64), (128, 96), "extremes"])
def test_find_dir_plain_matches_jax(size):
    """The clip's noisy luma; "extremes": cells of 0 and the largest sample
    (flat, checkerboards, stripes, 45-degree steps) at the (64, 64) shape, at
    8 bits and at 10 (the reference fed the cells >> 2)."""
    if size == "extremes":
        cases = [(cdef_extreme_plane(2, 64, 64, bd, seed=bd), bd - 8) for bd in (8, 10)]
    else:
        w, h = size
        cases = [(_inputs(w, h, 6, seed=w)[1][0], 0)]
    for plane, cs in cases:
        F, h, w = plane.shape
        cells = plane.reshape(F, h // 8, 8, w // 8, 8).transpose(0, 1, 3, 2, 4) >> cs
        d_ref, v_ref = cdef_jax.find_dir_j(jnp.asarray(cells))
        d, v = cdef_torch.find_dir(torch.from_numpy(plane), cs)
        np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
        assert len(np.unique(d.numpy())) == 8


def _costs(cells, cs=0):
    """(N, 8) int64 costs of the eight directions of (N, 8, 8) cells
    (filters/cdef.py's bins and weights)."""
    x = (cells.reshape(-1, 64).astype(np.int64) >> cs) - 128
    return np.stack([((x @ _PMATS[d]) ** 2 * _CWEIGHTS[d]).sum(axis=1) for d in range(8)], 1)


def _two_lanes(cells, cs=0):
    """K6's arithmetic in int32: lane 0 takes directions 0-3 of each cell,
    lane 1 directions 0-3 of the cell rotated by 90 degrees as directions
    4-7; the first direction of the largest of the eight costs, and var."""
    def four(c):
        x = ((c.reshape(-1, 64).astype(np.int32) >> cs) - 128).astype(np.int32)
        return np.stack([((x @ _PMATS[d].astype(np.int32)) ** 2
                          * _CWEIGHTS[d].astype(np.int32)).sum(axis=1, dtype=np.int32)
                         for d in range(4)], 1)

    costs = np.concatenate([four(cells), four(np.rot90(cells, axes=(1, 2)))], axis=1)
    assert costs.dtype == np.int32
    best = costs.argmax(axis=1)
    rows = np.arange(len(best))
    return best, (costs[rows, best] - costs[rows, (best + 4) & 7]) >> 10


def _design_cells(bd):
    rng = np.random.default_rng(bd)
    smooth = make_frames(64, 64, 1, seed=bd, bd=bd)[0][0].astype(np.int32)
    return np.concatenate([rng.integers(0, 1 << bd, (2000, 8, 8)).astype(np.int32),
                           smooth.reshape(8, 8, 8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8),
                           cdef_extreme_cells(bd)])


@pytest.mark.parametrize("bd", [8, 10])
def test_rotation_gives_directions_4_to_7(bd):
    """The costs of directions 0-3 of a cell rotated by 90 degrees, either
    way, are the costs of directions 4-7 of the cell: K6's second lane runs
    the first lane's instructions on the rotated cell."""
    cells, cs = _design_cells(bd), bd - 8
    costs = _costs(cells, cs)
    for k in (1, -1):
        rot = _costs(np.rot90(cells, k, axes=(1, 2)), cs)
        np.testing.assert_array_equal(rot[:, :4], costs[:, 4:])
        np.testing.assert_array_equal(rot[:, 4:], costs[:, :4])


def test_costs_fit_in_int32():
    """The largest cost over flat cells of 0, 255 and 1023 (10 bits,
    coeff_shift 2) is 2^14 * 840 * 64 = 880,803,840 < 2^31, reached by
    flat 0; no cell of the design sets exceeds it."""
    flat = [(np.full((1, 8, 8), v, np.int32), cs) for v, cs in ((0, 0), (255, 0), (1023, 2))]
    top = max(int(_costs(c, cs).max()) for c, cs in flat)
    assert top == 2 ** 14 * 840 * 64 == 880_803_840 < 2 ** 31
    assert int(_costs(flat[0][0]).max()) == top
    for bd in (8, 10):
        assert int(_costs(_design_cells(bd), bd - 8).max()) <= top


@pytest.mark.parametrize("bd", [8, 10])
def test_two_lane_int32_model_matches_find_dir(bd):
    """K6's two-lane int32 arithmetic gives the directions and variances of
    filters/cdef.find_dir_batch and cdef_torch.find_dir_plain (int64)."""
    cells, cs = _design_cells(bd), bd - 8
    d, v = _two_lanes(cells, cs)
    wd, wv = find_dir_batch(cells, cs)
    np.testing.assert_array_equal(d, wd)
    np.testing.assert_array_equal(v, wv)
    n = len(cells) // 8 * 8  # whole rows of 8 cells as a (1, 8, 8 n) plane
    plane = cells[:n].reshape(1, n // 8, 8, 8, 8).transpose(0, 1, 3, 2, 4).reshape(1, n, 64)
    pd, pv = cdef_torch.find_dir_plain(torch.from_numpy(np.ascontiguousarray(plane)), cs)
    np.testing.assert_array_equal(pd.numpy().reshape(-1), d[:n])
    np.testing.assert_array_equal(pv.numpy().reshape(-1), v[:n])
    assert len(np.unique(d)) == 8


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
    out, sse = cdef_torch.cdef_filter_plain(plane, dirs, var, pri, sec, mask, 5, src=s)
    for k in range(3):
        one, one_sse = cdef_torch.cdef_filter_plain(plane, dirs, var, pri[k:k + 1], sec[k:k + 1],
                                                    mask, 5, src=s)
        assert torch.equal(one[0], out[k]) and torch.equal(one_sse[0], sse[k])
    assert torch.equal(out[0], plane)  # strength 0 is the identity
    m = np.repeat(np.repeat(nonskip, 8, 1), 8, 2)
    d = (rec[0] - src).astype(np.int64) * m
    np.testing.assert_array_equal(sse[0].numpy(), (d * d).sum(axis=(1, 2)))


def _old_cdef_frames(planes, src_y, nonskip8, damping, coeff_shift, ladder):
    """cdef_frames as four filter calls with PyTorch glue between them (the
    search, argmin, and the luma and two chroma applies)."""
    F = planes[0].shape[0]
    dirs, var = cdef_torch.find_dir(planes[0], coeff_shift)
    cand = torch.tensor(ladder, dtype=torch.int32)
    pri = (cand[:, 0:1] << coeff_shift).expand(-1, F).contiguous()
    sec = (cand[:, 1:2] << coeff_shift).expand(-1, F).contiguous()
    _, sse = cdef_torch.cdef_filter_plain(planes[0], dirs, var, pri, sec, nonskip8,
                                          damping + coeff_shift, coeff_shift, src=src_y,
                                          want_out=False)
    best = torch.argmin(sse, dim=0)
    y_pri, y_sec = cand[best, 0], cand[best, 1]
    uv_pri, uv_sec = y_pri >> 1, y_sec >> 1
    new_y = cdef_torch.cdef_filter_plain(planes[0], dirs, var, (y_pri << coeff_shift)[None],
                                         (y_sec << coeff_shift)[None], nonskip8,
                                         damping + coeff_shift, coeff_shift)[0][0]
    uv = [cdef_torch.cdef_filter_plain(pl, dirs, None, (uv_pri << coeff_shift)[None],
                                       (uv_sec << coeff_shift)[None], nonskip8,
                                       damping + coeff_shift - 1, coeff_shift)[0][0]
          for pl in planes[1:]]
    return sse, [new_y, *uv], torch.stack([y_pri, y_sec, uv_pri, uv_sec], dim=-1)


@pytest.mark.parametrize("bd, n_cand", [(8, 0), (8, 4), (10, 0)])
def test_search_and_apply_equal_the_filter_sequence(bd, n_cand):
    """K7's two entry points (plain versions) give the SSE of the filter's
    candidates, and the planes and strengths of the four-call sequence."""
    from svtav1_tpu_torch.filters.cdef import SEARCH_CANDIDATES

    src, rec, nonskip = _inputs(64, 48, 4, seed=bd + n_cand)
    cs = bd - 8
    planes = [torch.from_numpy(p << cs) for p in rec]
    src_y, mask = torch.from_numpy(src << cs), torch.from_numpy(nonskip)
    ladder = SEARCH_CANDIDATES[:n_cand] if n_cand else SEARCH_CANDIDATES
    want_sse, want, want_st = _old_cdef_frames(planes, src_y, mask, 5, cs, ladder)
    dirs, var = cdef_torch.find_dir(planes[0], cs)
    sse = cdef_torch.cdef_search(planes[0], dirs, var, mask, src_y, ladder, 5, cs)
    assert sse.dtype == torch.int64 and torch.equal(sse, want_sse)
    got, st = cdef_torch.cdef_apply(planes, dirs, var, mask, sse, ladder, 5, cs)
    assert torch.equal(st, want_st)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    got2, st2 = cdef_torch.cdef_frames(planes, src_y, mask, 5, bd=bd, n_cand=n_cand)
    assert torch.equal(st2, want_st) and all(torch.equal(a, b) for a, b in zip(got2, want))


def test_apply_takes_the_first_candidate_on_ties():
    """Equal SSEs pick the first candidate (torch.argmin's rule, which the
    kernel's own argmin follows); chroma strengths are luma's >> 1."""
    _, rec, nonskip = _inputs(32, 32, 4, seed=3)
    planes = [torch.from_numpy(p) for p in rec]
    mask = torch.from_numpy(nonskip)
    dirs, var = cdef_torch.find_dir(planes[0])
    ladder = [(2, 1), (4, 2), (4, 2), (8, 2)]
    sse = torch.tensor([[9, 5], [3, 5], [3, 1], [3, 5]], dtype=torch.int64)
    _, st = cdef_torch.cdef_apply(planes, dirs, var, mask, sse, ladder, 5)
    assert st.tolist() == [[4, 2, 2, 1], [4, 2, 2, 1]]
    sse = torch.tensor([[1, 7], [1, 2], [0, 2], [5, 2]], dtype=torch.int64)
    _, st = cdef_torch.cdef_apply(planes, dirs, var, mask, sse, ladder, 5)
    assert st.tolist() == [[4, 2, 2, 1], [4, 2, 2, 1]]
    sse = torch.tensor([[1, 1], [1, 1], [1, 1], [1, 1]], dtype=torch.int64)
    _, st = cdef_torch.cdef_apply(planes, dirs, var, mask, sse, ladder, 5)
    assert st.tolist() == [[2, 1, 1, 0], [2, 1, 1, 0]]


def test_cdef_bounds_count_unmasked_cells_and_shared_taps():
    """K7's bound counts what these inputs need: the search reads the plane
    and the source on the unmasked cells only and does the tap work once
    per sample and the candidate work once per candidate; the apply reads
    and writes the three planes."""
    from svtav1_tpu_torch.utils import profile_keyframes as pk

    F, H, W, K = 2, 64, 128, 7
    cells = F * (H // 8) * (W // 8)
    nb, ops = pk.cdef_search_work(F, H, W, K, cells // 4)
    assert nb == cells * 9 + 2 * 64 * (cells // 4) * 4 + K * F * 8
    assert ops == 64 * (cells // 4) * (pk.CDEF_TAP_OPS + K * pk.CDEF_CAND_OPS)
    assert pk.cdef_search_work(F, H, W, K, 0)[1] == 0
    assert pk.CDEF_TAP_OPS + pk.CDEF_CAND_OPS == 144  # the per-candidate count it replaces
    args = (None,) * 8 + (K, F, H, W, 5, 0, None)
    assert pk.launch_bound("cdef_search", args, cells // 4) == (nb, ops)
    nb_a, ops_a = pk.cdef_apply_work(F, H, W, K, cells)
    assert nb_a == 2 * F * H * W * 3 // 2 * 4 + cells * 9 + K * F * 8 + F * 16
    assert ops_a == 96 * cells * 144
    args = (None,) * 13 + (K, F, H, W, 5, 0, None)
    assert pk.launch_bound("cdef_apply", args, cells) == (nb_a, ops_a)
