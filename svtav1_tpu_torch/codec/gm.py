"""Global motion: TRANSLATION-type estimation + frame-header param codec.

TPU-first re-architecture of the reference's global motion stage
(global_me.c:126 svt_aom_global_motion_estimation; the reference fits
full warp models via feature matching + RANSAC on every ME-complete
frame).  Here the hot path stays on device untouched: a cheap host-side
3-level pyramid translation fit (mean-pool /8 full search, then /2 and
/1 refinements on decimated grids) feeds ONE extra GLOBALMV candidate
lane into the batched device decide — the RD pick stays device-side.

Parameter coding follows spec 5.9.24/5.9.25 (global_motion_params /
global_param): TRANSLATION params are wmmat[0] (row) / wmmat[1] (col) in
WARPEDMODEL_PREC_BITS(16)-fraction units, coded as signed subexp
(k = 3) diffs against the primary reference frame's saved params —
svt_aom_gm_get_motion_vector_enc (adaptive_mv_pred.c:954) documents the
row/col layout and the >> 13 translation-to-1/8-pel relation.
"""
from __future__ import annotations

import numpy as np

WARPEDMODEL_PREC_BITS = 16
GM_TRANS_ONLY_PREC_DIFF = WARPEDMODEL_PREC_BITS - 3  # params -> 1/8-pel
SUBEXP_K = 3


# --------------------------------------------------------------- param codec
# spec 4.10.7 ns(), 5.9.26/5.9.27 subexp with reference

def _floor_log2(x: int) -> int:
    return int(x).bit_length() - 1


def read_ns(r, n: int) -> int:
    w = _floor_log2(n) + 1
    m = (1 << w) - n
    v = r.f(w - 1)
    if v < m:
        return v
    extra = r.f(1)
    return (v << 1) - m + extra


def write_ns(w, n: int, v: int) -> None:
    wd = _floor_log2(n) + 1
    m = (1 << wd) - n
    if v < m:
        w.f(v, wd - 1)
    else:
        x = v + m
        w.f(x >> 1, wd - 1)
        w.f(x & 1, 1)


def read_subexp(r, num_syms: int) -> int:
    i, mk = 0, 0
    while True:
        b2 = SUBEXP_K + i - 1 if i else SUBEXP_K
        a = 1 << b2
        if num_syms <= mk + 3 * a:
            return read_ns(r, num_syms - mk) + mk
        if r.f(1):
            i += 1
            mk += a
        else:
            return r.f(b2) + mk


def write_subexp(w, num_syms: int, v: int) -> None:
    i, mk = 0, 0
    while True:
        b2 = SUBEXP_K + i - 1 if i else SUBEXP_K
        a = 1 << b2
        if num_syms <= mk + 3 * a:
            write_ns(w, num_syms - mk, v - mk)
            return
        if v >= mk + a:
            w.f(1, 1)
            i += 1
            mk += a
        else:
            w.f(0, 1)
            w.f(v - mk, b2)
            return


def _inverse_recenter(ref: int, v: int) -> int:
    if v > 2 * ref:
        return v
    if v & 1:
        return ref - ((v + 1) >> 1)
    return ref + (v >> 1)


def _recenter(ref: int, x: int) -> int:
    if x > 2 * ref:
        return x
    if x >= ref:
        return (x - ref) * 2
    return (ref - x) * 2 - 1


def read_unsigned_subexp_with_ref(r, mx: int, ref: int) -> int:
    v = read_subexp(r, mx)
    if (ref << 1) <= mx:
        return _inverse_recenter(ref, v)
    return mx - 1 - _inverse_recenter(mx - 1 - ref, v)


def write_unsigned_subexp_with_ref(w, mx: int, ref: int, x: int) -> None:
    if (ref << 1) <= mx:
        v = _recenter(ref, x)
    else:
        v = _recenter(mx - 1 - ref, mx - 1 - x)
    write_subexp(w, mx, v)


def read_signed_subexp_with_ref(r, low: int, high: int, ref: int) -> int:
    return read_unsigned_subexp_with_ref(r, high - low, ref - low) + low


def write_signed_subexp_with_ref(w, low: int, high: int, ref: int, x: int) -> None:
    write_unsigned_subexp_with_ref(w, high - low, ref - low, x - low)


# translation global params <-> 1/8-pel MV.  With allow_high_precision_mv
# = 0 the coded precision is 1/4 pel: mv8 must be even.

def trans_bits(allow_hp: bool) -> tuple:
    """(absBits, precDiff) for a TRANSLATION param component."""
    abs_bits = 9 - (0 if allow_hp else 1)
    prec_diff = GM_TRANS_ONLY_PREC_DIFF + (0 if allow_hp else 1)
    return abs_bits, prec_diff


def write_global_param(w, allow_hp: bool, prev8: int, cur8: int) -> None:
    """One translation component: cur8/prev8 are 1/8-pel values."""
    abs_bits, prec_diff = trans_bits(allow_hp)
    mx = 1 << abs_bits
    shift = prec_diff - GM_TRANS_ONLY_PREC_DIFF  # 1/8-pel -> coded units
    assert cur8 % (1 << shift) == 0, "gm mv finer than coded precision"
    write_signed_subexp_with_ref(w, -mx, mx + 1, prev8 >> shift, cur8 >> shift)


def read_global_param(r, allow_hp: bool, prev8: int) -> int:
    abs_bits, prec_diff = trans_bits(allow_hp)
    mx = 1 << abs_bits
    shift = prec_diff - GM_TRANS_ONLY_PREC_DIFF
    return read_signed_subexp_with_ref(r, -mx, mx + 1, prev8 >> shift) << shift


def write_global_motion_params(w, gm_mvs, prev_gm_mvs, allow_hp: bool) -> None:
    """spec 5.9.24 for the TRANSLATION/IDENTITY subset.  gm_mvs /
    prev_gm_mvs: per-ref-id (index 1..7) (row8, col8) tuples."""
    for ref in range(1, 8):
        mv = tuple(gm_mvs[ref]) if gm_mvs is not None else (0, 0)
        if mv == (0, 0):
            w.f(0, 1)  # is_global
            continue
        w.f(1, 1)  # is_global
        w.f(0, 1)  # is_rot_zoom
        w.f(1, 1)  # is_translation
        prev = tuple(prev_gm_mvs[ref]) if prev_gm_mvs is not None else (0, 0)
        write_global_param(w, allow_hp, prev[0], mv[0])  # wmmat[0] = row
        write_global_param(w, allow_hp, prev[1], mv[1])  # wmmat[1] = col


def read_global_motion_params(r, prev_gm_mvs, allow_hp: bool) -> list:
    """Decoder mirror of write_global_motion_params -> list of 8 (row8, col8)
    (index 0 unused)."""
    out = [(0, 0)] * 8
    for ref in range(1, 8):
        if not r.f(1):  # is_global
            continue
        # read first, then check: under python -O an assert (and a read
        # inside it) would vanish and the reader lose its place
        is_rot_zoom = r.f(1)
        is_translation = r.f(1)
        if is_rot_zoom or not is_translation:
            raise ValueError("global motion other than translation is not supported")
        prev = tuple(prev_gm_mvs[ref]) if prev_gm_mvs is not None else (0, 0)
        row8 = read_global_param(r, allow_hp, prev[0])
        col8 = read_global_param(r, allow_hp, prev[1])
        out[ref] = (row8, col8)
    return out


# ------------------------------------------------------------- estimation

def _pool2(a: np.ndarray) -> np.ndarray:
    h, w = a.shape[0] & ~1, a.shape[1] & ~1
    a = a[:h, :w]
    return (a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2]) * 0.25


def _best_offset(cur: np.ndarray, ref: np.ndarray, center: tuple, rad: int,
                 step_grid: int = 1) -> tuple:
    """argmin over (dy, dx) in center +- rad of mean |cur - ref_shifted|,
    computed on an every-`step_grid` sample grid.  Returns (dy, dx, sad,
    zero_sad)."""
    H, W = cur.shape
    m = rad + max(abs(center[0]), abs(center[1]))
    ys = slice(m, H - m, step_grid)
    xs = slice(m, W - m, step_grid)
    if H - 2 * m < 8 or W - 2 * m < 8:
        return 0, 0, 0.0, 0.0
    c = cur[ys, xs].astype(np.float32)
    best = (0, 0)
    best_sad = None
    zero_sad = None
    for dy in range(center[0] - rad, center[0] + rad + 1):
        for dx in range(center[1] - rad, center[1] + rad + 1):
            rshift = ref[m + dy:H - m + dy:step_grid, m + dx:W - m + dx:step_grid]
            sad = float(np.mean(np.abs(c - rshift)))
            if dy == 0 and dx == 0:
                zero_sad = sad
            if best_sad is None or sad < best_sad:
                best_sad, best = sad, (dy, dx)
    if zero_sad is None:
        zero_sad = float(np.mean(np.abs(
            c - ref[m:H - m:step_grid, m:W - m:step_grid])))
    return best[0], best[1], best_sad, zero_sad


def estimate_translation(cur_y: np.ndarray, ref_y: np.ndarray,
                         max_fp: int = 63, gain_thresh: float = 0.98) -> tuple:
    """Full-pel translation (row8, col8) of `cur_y` relative to `ref_y`
    (both full-res luma, any int dtype).  3-level decimated pyramid:
    /8 mean-pool full search +-8 -> /2 refine -> /1 refine.  Returns
    (0, 0) unless the best offset beats the zero offset by `gain_thresh`.
    """
    cur = np.asarray(cur_y, np.float32)
    ref = np.asarray(ref_y, np.float32)
    if cur.shape[0] < 128 or cur.shape[1] < 128:
        return (0, 0)
    c2, r2 = _pool2(cur), _pool2(ref)
    c8 = _pool2(_pool2(c2))
    r8 = _pool2(_pool2(r2))
    dy8, dx8, _, _ = _best_offset(c8, r8, (0, 0), 8)
    dy2, dx2, _, _ = _best_offset(c2, r2, (dy8 * 4, dx8 * 4), 3, step_grid=2)
    dy1, dx1, sad, zsad = _best_offset(cur, ref, (dy2 * 2, dx2 * 2), 2,
                                       step_grid=3)
    if (dy1, dx1) == (0, 0) or zsad <= 0 or sad > gain_thresh * zsad:
        return (0, 0)
    dy1 = int(np.clip(dy1, -max_fp, max_fp))
    dx1 = int(np.clip(dx1, -max_fp, max_fp))
    return (dy1 * 8, dx1 * 8)
