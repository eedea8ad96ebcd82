"""CDEF — constrained directional enhancement filter (AV1 spec 7.15).

Applied after deblocking by both encoder and decoder. The direction search
is normative (decoder re-derives it). Vectorized re-expression of the
reference kernels (cdef.c svt_aom_cdef_find_dir_c :151, constrain :88,
svt_cdef_filter_block_c :253, svt_cdef_filter_fb :339, strength application
enc_cdef.c svt_av1_cdef_frame): all 8x8 units are processed as one batched
gather/arithmetic pass instead of per-block kernel dispatch.

Round-1 profile: cdef_bits = 0 (single frame-wide strength pair), so the
per-64x64 cdef_idx literal costs zero tile bits.
"""
from __future__ import annotations

import numpy as np

from ..codec.mvp import MiState

CDEF_VERY_LARGE = 0x7F7F
DIV_TABLE = np.array([0, 840, 420, 280, 210, 168, 140, 120, 105], np.int64)

# Cdef_Directions (spec 7.15.3) as (dy, dx) per direction, taps k=0,1
CDEF_DIRS = np.array(
    [[(-1, 1), (-2, 2)],
     [(0, 1), (-1, 2)],
     [(0, 1), (0, 2)],
     [(0, 1), (1, 2)],
     [(1, 1), (2, 2)],
     [(1, 0), (2, 1)],
     [(1, 0), (2, 0)],
     [(1, 0), (2, -1)]],
    np.int32,
)
PRI_TAPS = np.array([[4, 2], [3, 3]], np.int32)  # indexed by pri_strength & 1
SEC_TAPS = np.array([[2, 1], [2, 1]], np.int32)


def _msb(v: np.ndarray) -> np.ndarray:
    return np.where(v > 0, np.floor(np.log2(np.maximum(v, 1))).astype(np.int64), 0)


def _partial_matrices():
    """(8, 64, 15) one-hot maps: flat 8x8 sample -> partial-sum bin per dir."""
    mats = np.zeros((8, 64, 15), np.int64)
    for i in range(8):
        for j in range(8):
            f = i * 8 + j
            mats[0, f, i + j] = 1
            mats[1, f, i + j // 2] = 1
            mats[2, f, i] = 1
            mats[3, f, 3 + i - j // 2] = 1
            mats[4, f, 7 + i - j] = 1
            mats[5, f, 3 - i // 2 + j] = 1
            mats[6, f, j] = 1
            mats[7, f, i // 2 + j] = 1
    return mats


_PMATS = _partial_matrices()


def _cost_weights():
    """Per-direction per-bin squared-partial weights (find_dir cost model)."""
    w = np.zeros((8, 15), np.int64)
    for d in (2, 6):
        w[d, :8] = DIV_TABLE[8]
    for d in (0, 4):
        for i in range(7):
            w[d, i] = DIV_TABLE[i + 1]
            w[d, 14 - i] = DIV_TABLE[i + 1]
        w[d, 7] = DIV_TABLE[8]
    for d in (1, 3, 5, 7):
        for j in range(5):
            w[d, 3 + j] = DIV_TABLE[8]
        for j in range(3):
            w[d, j] = DIV_TABLE[2 * j + 2]
            w[d, 10 - j] = DIV_TABLE[2 * j + 2]
    return w


_CWEIGHTS = _cost_weights()


def find_dir_batch(blocks: np.ndarray, coeff_shift: int = 0):
    """blocks: (N, 8, 8) luma. Returns (dirs (N,), vars (N,)) — normative."""
    x = (blocks.reshape(-1, 64).astype(np.int64) >> coeff_shift) - 128
    costs = np.zeros((x.shape[0], 8), np.int64)
    for d in range(8):
        partial = x @ _PMATS[d]  # (N, 15)
        costs[:, d] = (partial * partial * _CWEIGHTS[d][None, :]).sum(axis=1)
    dirs = np.argmax(costs, axis=1)
    best = costs[np.arange(len(dirs)), dirs]
    opp = costs[np.arange(len(dirs)), (dirs + 4) & 7]
    return dirs.astype(np.int64), (best - opp) >> 10


def adjust_strength(strength: int, var: np.ndarray) -> np.ndarray:
    i = np.where((var >> 6) > 0, np.minimum(_msb(var >> 6), 12), 0)
    return np.where(var != 0, (strength * (4 + i) + 8) >> 4, 0)


def _constrain(diff, strength, damping):
    """strength/damping may be per-unit arrays broadcast over samples."""
    s = np.asarray(strength, np.int16)
    shift = np.maximum(0, damping - _msb(s)).astype(np.int16)
    ad = np.abs(diff)
    mag = np.minimum(ad, np.maximum(0, s - (ad >> shift)).astype(diff.dtype))
    return np.where(diff < 0, -mag, mag) * (s > 0)


def _gather_taps(plane: np.ndarray, ys: np.ndarray, xs: np.ndarray, bh: int, bw: int,
                 dirs: np.ndarray):
    """Gather center + 4 primary + 8 secondary tap planes as int32 arrays.

    Returns (x0, ptaps[(k,sgn)] list of 4, staps list of 8) each (N, bh, bw);
    out-of-frame samples carry CDEF_VERY_LARGE."""
    H, W = plane.shape
    B = 2
    # int16 is safe for 8/10-bit samples and CDEF_VERY_LARGE (0x7F7F)
    P = np.full((H + 2 * B, W + 2 * B), CDEF_VERY_LARGE, np.int16)
    P[B : B + H, B : B + W] = plane
    ii = np.arange(bh)[None, :, None]
    jj = np.arange(bw)[None, None, :]
    Y = ys[:, None, None] + ii + B
    X = xs[:, None, None] + jj + B
    x0 = P[Y, X]
    d0 = CDEF_DIRS[dirs]
    d_p2 = CDEF_DIRS[(dirs + 2) & 7]
    d_m2 = CDEF_DIRS[(dirs - 2) & 7]
    ptaps, staps = [], []
    for k in range(2):
        for sgn in (1, -1):
            ptaps.append(P[Y + sgn * d0[:, k, 0][:, None, None], X + sgn * d0[:, k, 1][:, None, None]])
        for dt in (d_p2, d_m2):
            for sgn in (1, -1):
                staps.append(P[Y + sgn * dt[:, k, 0][:, None, None], X + sgn * dt[:, k, 1][:, None, None]])
    return x0, ptaps, staps


def _apply_taps(x0, ptaps, staps, pri: np.ndarray, sec: int, pri_damping: int,
                sec_damping: int, coeff_shift: int = 0) -> np.ndarray:
    """Constrained weighted sum + min/max clip (svt_cdef_filter_block_c)."""
    pri_arr = np.asarray(pri, np.int16).reshape(-1, 1, 1)
    taps_sel = (np.asarray(pri, np.int64).reshape(-1) >> coeff_shift) & 1
    sum_ = np.zeros(x0.shape, np.int16)
    mx = x0.copy()
    mn = x0.copy()
    for k in range(2):
        ptap = PRI_TAPS[taps_sel, k].astype(np.int16)[:, None, None]
        stap = np.int16(SEC_TAPS[0, k])
        for p in ptaps[2 * k : 2 * k + 2]:
            sum_ += ptap * _constrain(p - x0, pri_arr, pri_damping)
            np.maximum(mx, np.where(p == CDEF_VERY_LARGE, mx, p), out=mx)
            np.minimum(mn, p, out=mn)
        for s in staps[4 * k : 4 * k + 4]:
            sum_ += stap * _constrain(s - x0, np.int16(sec), sec_damping)
            np.maximum(mx, np.where(s == CDEF_VERY_LARGE, mx, s), out=mx)
            np.minimum(mn, s, out=mn)
    y = x0 + ((8 + sum_ - (sum_ < 0)) >> 4)
    return np.clip(y, mn, mx)


def _filter_units(plane: np.ndarray, ys: np.ndarray, xs: np.ndarray, bh: int, bw: int,
                  pri: np.ndarray, sec: int, dirs: np.ndarray, pri_damping: int,
                  sec_damping: int, coeff_shift: int = 0) -> np.ndarray:
    x0, ptaps, staps = _gather_taps(plane, ys, xs, bh, bw, dirs)
    return _apply_taps(x0, ptaps, staps, pri, sec, pri_damping, sec_damping, coeff_shift)


def nonskip_units(mi: MiState):
    """8x8-luma-unit coordinates (by, bx) where not all covering mi are skip."""
    sk = mi.skip[: (mi.mi_rows >> 1) * 2, : (mi.mi_cols >> 1) * 2]
    sk4 = sk.reshape(mi.mi_rows >> 1, 2, mi.mi_cols >> 1, 2).all(axis=(1, 3))
    by, bx = np.nonzero(~sk4)
    return by.astype(np.int64), bx.astype(np.int64)


def cdef_frame(planes: list, mi: MiState, y_pri: int, y_sec: int, uv_pri: int, uv_sec: int,
               damping: int, bd: int = 8, units=None, dirs=None, variances=None,
               out_planes=None) -> None:
    """Apply CDEF in place (reads are pre-CDEF; writes go to `out_planes` or
    back into `planes` after full computation)."""
    coeff_shift = max(bd - 8, 0)
    if units is None:
        by, bx = nonskip_units(mi)
    else:
        by, bx = units
    if len(by) == 0 or (y_pri | y_sec | uv_pri | uv_sec) == 0:
        return
    if dirs is None:
        blocks = _gather_blocks(planes[0], by * 8, bx * 8, 8, 8)
        dirs, variances = find_dir_batch(blocks, coeff_shift)
    outs = out_planes if out_planes is not None else [p.copy() for p in planes]
    # luma (dir forced 0 when the frame-level primary strength is 0)
    if y_pri or y_sec:
        t = adjust_strength(y_pri << coeff_shift, variances)
        res = _filter_units(planes[0], by * 8, bx * 8, 8, 8, t, y_sec << coeff_shift,
                            dirs if y_pri else np.zeros_like(dirs),
                            damping + coeff_shift, damping + coeff_shift, coeff_shift)
        _scatter_blocks(outs[0], by * 8, bx * 8, res)
    # chroma (4:2:0): 4x4 units co-located with luma 8x8, luma's direction
    if uv_pri or uv_sec:
        for pl in (1, 2):
            pri = np.full(len(by), uv_pri << coeff_shift, np.int64)
            res = _filter_units(planes[pl], by * 4, bx * 4, 4, 4, pri, uv_sec << coeff_shift,
                                dirs if uv_pri else np.zeros_like(dirs),
                                damping + coeff_shift - 1, damping + coeff_shift - 1, coeff_shift)
            _scatter_blocks(outs[pl], by * 4, bx * 4, res)
    if out_planes is None:
        for p, o in zip(planes, outs):
            p[:] = o


def _gather_blocks(plane, ys, xs, bh, bw):
    ii = np.arange(bh)[None, :, None]
    jj = np.arange(bw)[None, None, :]
    return plane[ys[:, None, None] + ii, xs[:, None, None] + jj]


def _scatter_blocks(plane, ys, xs, vals):
    bh, bw = vals.shape[1:]
    ii = np.arange(bh)[None, :, None]
    jj = np.arange(bw)[None, None, :]
    plane[ys[:, None, None] + ii, xs[:, None, None] + jj] = vals


# ----------------------------------------------------------------- encoder

# candidate (y_pri, y_sec) pairs; sec must be in {0,1,2,4} (signalable set)
SEARCH_CANDIDATES = ((0, 0), (1, 0), (1, 1), (2, 1), (3, 1), (4, 2), (6, 2))


def pick_damping(qindex: int) -> int:
    return min(6, 3 + (qindex >> 6))


def search_strengths(recon: list, src: list, mi: MiState, qindex: int, bd: int = 8,
                     sample_stride: int = 4) -> tuple:
    """Pick a frame-wide strength set by luma SSE on subsampled units
    (simplified analog of enc_cdef.c cdef_seg_search + finish_cdef_search:
    fixed candidate ladder instead of the 64-combo DP)."""
    damping = pick_damping(qindex)
    by, bx = nonskip_units(mi)
    if len(by) == 0:
        return (0, 0, 0, 0, damping)
    sby, sbx = by[::sample_stride], bx[::sample_stride]
    coeff_shift = max(bd - 8, 0)
    blocks = _gather_blocks(recon[0], sby * 8, sbx * 8, 8, 8)
    dirs, variances = find_dir_batch(blocks, coeff_shift)
    src_blocks = _gather_blocks(src[0], sby * 8, sbx * 8, 8, 8).astype(np.int64)
    # taps depend only on dirs -> gather once, re-weight per candidate
    x0, ptaps, staps = _gather_taps(recon[0], sby * 8, sbx * 8, 8, 8, dirs)

    best = None
    for y_pri, y_sec in SEARCH_CANDIDATES:
        if y_pri == 0 and y_sec == 0:
            res = blocks.astype(np.int64)
        else:
            t = adjust_strength(y_pri << coeff_shift, variances)
            res = _apply_taps(x0, ptaps, staps, t, y_sec << coeff_shift,
                              damping + coeff_shift, damping + coeff_shift, coeff_shift)
        sse = int(((res - src_blocks) ** 2).sum())
        if best is None or sse < best[0]:
            best = (sse, y_pri, y_sec)
    _, y_pri, y_sec = best
    uv_pri, uv_sec = y_pri >> 1, y_sec >> 1
    if uv_sec == 3:
        uv_sec = 4
    return (y_pri, y_sec, uv_pri, uv_sec, damping)

