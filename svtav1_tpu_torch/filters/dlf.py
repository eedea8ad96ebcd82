"""Deblocking loop filter (AV1 spec 7.14), applied identically by encoder
and decoder to the reconstructed frame before it enters the DPB.

Vectorized re-expression of the normative per-edge process: instead of the
reference's per-4-sample kernel dispatch (deblocking_filter.c
svt_av1_filter_block_plane_vert/horz :287/:420, set_lpf_parameters :162,
filter kernels deblocking_common.c filter4/6/8/14 :214-786), we build
whole-plane edge parameter maps from the mi grids and apply each filter
class as masked array arithmetic — one pass per (plane, direction), the
horizontal pass running the vertical code on transposed views. Level
selection mirrors svt_av1_pick_filter_level_by_q (deblocking_filter.c:1036).

Restrictions honored by this profile: no segmentation, no delta-lf, no
mode/ref deltas -> the filter level (and thus limit/blimit/thresh) is a
frame constant per plane/direction.
"""
from __future__ import annotations

import numpy as np

from ..codec.mvp import MiState
from ..constants.av1 import BLOCK_W, MAX_TXSIZE_RECT, TX_W, RefFrame
from ..ops import quantize as quant_ops

MAX_LOOP_FILTER = 63


def _round2(x: int, n: int) -> int:
    return (x + (1 << (n - 1))) >> n


def pick_filter_levels(qindex: int, bd: int, frame_is_intra: bool, height: int) -> tuple:
    """(level_y_v, level_y_h, level_u, level_v) by-q (deblocking_filter.c:1073)."""
    q = quant_ops.ac_q(qindex, bd)
    if bd == 8:
        if frame_is_intra:
            filt = _round2(q * 17563 - 421574, 18)
        else:
            mult = 6017 if height <= 480 else 12034
            filt = _round2(q * mult + 650707, 18)
    elif bd == 10:
        filt = _round2(q * 20723 + 4060632, 20)
        if frame_is_intra:
            filt -= 4
    else:
        filt = _round2(q * 20723 + 16242526, 22)
        if frame_is_intra:
            filt -= 4
    filt = max(0, min(MAX_LOOP_FILTER, filt))
    chroma = max(0, min(MAX_LOOP_FILTER, filt // 2))
    return (filt, filt, chroma, chroma)


def _limits(level: int, sharpness: int = 0) -> tuple:
    """(limit, blimit, thresh) per svt_aom_update_sharpness + hev_thr=lvl>>4."""
    lim = level >> ((sharpness > 0) + (sharpness > 4))
    if sharpness > 0:
        lim = min(lim, 9 - sharpness)
    lim = max(lim, 1)
    return lim, 2 * (level + 2) + lim, level >> 4


def _uv_tx_w(bsize_arr: np.ndarray) -> np.ndarray:
    """Chroma tx width in samples for (square-profile) luma block sizes."""
    w = BLOCK_W[bsize_arr]
    return np.clip(w >> 1, 4, 32)


def _filter_vertical_edges(plane: np.ndarray, flen: np.ndarray, lim: int, blim: int, thr: int,
                           bd: int = 8) -> None:
    """Filter vertical edges in place. flen: (plane_mi_rows, n_edge_cols)
    filter lengths {0,4,6,8,14} for edge columns x = 4*(k+1).

    bd > 8: thresholds and the narrow-filter clamps scale by << (bd-8)
    (deblocking_common.c highbd_filter4 / highbd_*_mask)."""
    H, W = plane.shape
    K = flen.shape[1]
    if K == 0 or not np.any(flen):
        return
    sh = bd - 8
    lim, blim, thr = lim << sh, blim << sh, thr << sh
    half = 128 << sh
    fthr = 1 << sh  # flat threshold

    def _clip8(v):
        return np.clip(v, -half, half - 1)

    # per-sample-row filter length map
    flen_s = np.repeat(flen, 4, axis=0)[:H]  # (H, K)
    cols = (np.arange(K) + 1) * 4  # edge columns
    # gather p6..p0,q0..q6 as (H, K) planes; clip indices (masks gate
    # validity). int16: max weighted sum is 16*1023 (10-bit) < 32767.
    def col(off):
        return plane[:, np.clip(cols + off, 0, W - 1)].astype(np.int16)

    p = [col(-1 - i) for i in range(7)]  # p0..p6
    q = [col(i) for i in range(7)]  # q0..q6

    out = {}
    outm = {}  # per-offset class-membership masks: only lanes belonging to a
    # filter class may write their column (unmasked writes of original
    # samples could clobber a neighboring edge's filtered output)

    # --- shared narrow filter (filter4) on (p1,p0,q0,q1); returns deltas
    def narrow(mask):
        ps1, ps0 = p[1] - half, p[0] - half
        qs0, qs1 = q[0] - half, q[1] - half
        hev = (np.abs(p[1] - p[0]) > thr) | (np.abs(q[1] - q[0]) > thr)
        f = _clip8(ps1 - qs1) * hev
        f = _clip8(f + 3 * (qs0 - ps0)) * mask
        f1 = _clip8(f + 4) >> 3
        f2 = _clip8(f + 3) >> 3
        oq0 = _clip8(qs0 - f1) + half
        op0 = _clip8(ps0 + f2) + half
        t = ((f1 + 1) >> 1) * (~hev)
        oq1 = _clip8(qs1 - t) + half
        op1 = _clip8(ps1 + t) + half
        return op1, op0, oq0, oq1

    def fmask2():
        return ((np.abs(p[1] - p[0]) <= lim) & (np.abs(q[1] - q[0]) <= lim) &
                (np.abs(p[0] - q[0]) * 2 + np.abs(p[1] - q[1]) // 2 <= blim))

    def fmask3():
        return (fmask2() & (np.abs(p[2] - p[1]) <= lim) & (np.abs(q[2] - q[1]) <= lim))

    def fmask_full():
        return (fmask3() & (np.abs(p[3] - p[2]) <= lim) & (np.abs(q[3] - q[2]) <= lim))

    def flat_n(n):  # flat over p[n-1]..p0/q0..q[n-1] vs thresh 1 << (bd-8)
        m = (np.abs(p[1] - p[0]) <= fthr) & (np.abs(q[1] - q[0]) <= fthr)
        for i in range(2, n):
            m &= (np.abs(p[i] - p[0]) <= fthr) & (np.abs(q[i] - q[0]) <= fthr)
        return m

    r2 = lambda x, n: (x + (1 << (n - 1))) >> n

    sel4 = flen_s == 4
    sel6 = flen_s == 6
    sel8 = flen_s == 8
    sel14 = flen_s == 14

    # class 4: narrow only
    if np.any(sel4):
        m = fmask2() & sel4
        op1, op0, oq0, oq1 = narrow(m)
        out.setdefault(-2, p[1].copy())[sel4] = op1[sel4]
        out.setdefault(-1, p[0].copy())[sel4] = op0[sel4]
        out.setdefault(0, q[0].copy())[sel4] = oq0[sel4]
        out.setdefault(1, q[1].copy())[sel4] = oq1[sel4]
        for off in (-2, -1, 0, 1):
            outm[off] = outm.get(off, False) | sel4

    # class 6 (chroma): flat3 -> 5-tap else narrow
    if np.any(sel6):
        mask = fmask3() & sel6
        flat = flat_n(3) & mask
        op1, op0, oq0, oq1 = narrow(mask & ~flat)
        l_op1 = r2(p[2] * 3 + p[1] * 2 + p[0] * 2 + q[0], 3)
        l_op0 = r2(p[2] + p[1] * 2 + p[0] * 2 + q[0] * 2 + q[1], 3)
        l_oq0 = r2(p[1] + p[0] * 2 + q[0] * 2 + q[1] * 2 + q[2], 3)
        l_oq1 = r2(p[0] + q[0] * 2 + q[1] * 2 + q[2] * 3, 3)
        for off, nar, lng in ((-2, op1, l_op1), (-1, op0, l_op0), (0, oq0, l_oq0), (1, oq1, l_oq1)):
            base = out.setdefault(off, (p[-off - 1] if off < 0 else q[off]).copy())
            base[sel6] = np.where(flat, lng, nar)[sel6]
            outm[off] = outm.get(off, False) | sel6

    # class 8: flat4 -> 7-tap else narrow
    if np.any(sel8):
        mask = fmask_full() & sel8
        flat = flat_n(4) & mask
        op1, op0, oq0, oq1 = narrow(mask & ~flat)
        l = {}
        l[-3] = r2(p[3] * 3 + p[2] * 2 + p[1] + p[0] + q[0], 3)
        l[-2] = r2(p[3] * 2 + p[2] + p[1] * 2 + p[0] + q[0] + q[1], 3)
        l[-1] = r2(p[3] + p[2] + p[1] + p[0] * 2 + q[0] + q[1] + q[2], 3)
        l[0] = r2(p[2] + p[1] + p[0] + q[0] * 2 + q[1] + q[2] + q[3], 3)
        l[1] = r2(p[1] + p[0] + q[0] + q[1] * 2 + q[2] + q[3] * 2, 3)
        l[2] = r2(p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 3, 3)
        nar = {-2: op1, -1: op0, 0: oq0, 1: oq1}
        for off in range(-3, 3):
            base = out.setdefault(off, (p[-off - 1] if off < 0 else q[off]).copy())
            v = np.where(flat, l[off], nar.get(off, p[-off - 1] if off < 0 else q[off]))
            base[sel8] = v[sel8]
            outm[off] = outm.get(off, False) | sel8

    # class 14 (luma): flat4 & flat2(outer) -> 13-tap; flat4 -> 7-tap; else narrow
    if np.any(sel14):
        mask = fmask_full() & sel14
        flat = flat_n(4) & mask
        flat2 = ((np.abs(p[6] - p[0]) <= fthr) & (np.abs(p[5] - p[0]) <= fthr) & (np.abs(p[4] - p[0]) <= fthr) &
                 (np.abs(q[4] - q[0]) <= fthr) & (np.abs(q[5] - q[0]) <= fthr) & (np.abs(q[6] - q[0]) <= fthr) &
                 (np.abs(p[1] - p[0]) <= fthr) & (np.abs(q[1] - q[0]) <= fthr)) & flat
        op1, op0, oq0, oq1 = narrow(mask & ~flat)
        l8 = {}
        l8[-3] = r2(p[3] * 3 + p[2] * 2 + p[1] + p[0] + q[0], 3)
        l8[-2] = r2(p[3] * 2 + p[2] + p[1] * 2 + p[0] + q[0] + q[1], 3)
        l8[-1] = r2(p[3] + p[2] + p[1] + p[0] * 2 + q[0] + q[1] + q[2], 3)
        l8[0] = r2(p[2] + p[1] + p[0] + q[0] * 2 + q[1] + q[2] + q[3], 3)
        l8[1] = r2(p[1] + p[0] + q[0] + q[1] * 2 + q[2] + q[3] * 2, 3)
        l8[2] = r2(p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 3, 3)
        l14 = {}
        l14[-6] = r2(p[6] * 7 + p[5] * 2 + p[4] * 2 + p[3] + p[2] + p[1] + p[0] + q[0], 4)
        l14[-5] = r2(p[6] * 5 + p[5] * 2 + p[4] * 2 + p[3] * 2 + p[2] + p[1] + p[0] + q[0] + q[1], 4)
        l14[-4] = r2(p[6] * 4 + p[5] + p[4] * 2 + p[3] * 2 + p[2] * 2 + p[1] + p[0] + q[0] + q[1] + q[2], 4)
        l14[-3] = r2(p[6] * 3 + p[5] + p[4] + p[3] * 2 + p[2] * 2 + p[1] * 2 + p[0] + q[0] + q[1] + q[2] + q[3], 4)
        l14[-2] = r2(p[6] * 2 + p[5] + p[4] + p[3] + p[2] * 2 + p[1] * 2 + p[0] * 2 + q[0] + q[1] + q[2] + q[3] + q[4], 4)
        l14[-1] = r2(p[6] + p[5] + p[4] + p[3] + p[2] + p[1] * 2 + p[0] * 2 + q[0] * 2 + q[1] + q[2] + q[3] + q[4] + q[5], 4)
        l14[0] = r2(p[5] + p[4] + p[3] + p[2] + p[1] + p[0] * 2 + q[0] * 2 + q[1] * 2 + q[2] + q[3] + q[4] + q[5] + q[6], 4)
        l14[1] = r2(p[4] + p[3] + p[2] + p[1] + p[0] + q[0] * 2 + q[1] * 2 + q[2] * 2 + q[3] + q[4] + q[5] + q[6] * 2, 4)
        l14[2] = r2(p[3] + p[2] + p[1] + p[0] + q[0] + q[1] * 2 + q[2] * 2 + q[3] * 2 + q[4] + q[5] + q[6] * 3, 4)
        l14[3] = r2(p[2] + p[1] + p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 2 + q[4] * 2 + q[5] + q[6] * 4, 4)
        l14[4] = r2(p[1] + p[0] + q[0] + q[1] + q[2] + q[3] * 2 + q[4] * 2 + q[5] * 2 + q[6] * 5, 4)
        l14[5] = r2(p[0] + q[0] + q[1] + q[2] + q[3] + q[4] * 2 + q[5] * 2 + q[6] * 7, 4)
        nar = {-2: op1, -1: op0, 0: oq0, 1: oq1}
        for off in range(-6, 6):
            orig = p[-off - 1] if off < 0 else q[off]
            base = out.setdefault(off, orig.copy())
            v = np.where(flat2, l14[off], np.where(flat, l8.get(off, orig), nar.get(off, orig)))
            base[sel14] = v[sel14]
            outm[off] = outm.get(off, False) | sel14

    # scatter modified sample columns back; guard against overlapping edges
    # (closest-possible 14-tap edges are 16 apart -> max reach 6 < 16; 8-tap
    # edges 8 apart -> reach 3 < 8; 4/6-tap edges 4 apart -> reach 2 <= 2...
    # p2/q2 of filter6 reaches 3 into a 4-wide chroma tx: AV1 guarantees
    # chroma tx >= 4 and filter6 only modifies +-2 samples, so no overlap).
    for off, vals in sorted(out.items()):
        target_cols = cols + off
        valid = (target_cols >= 0) & (target_cols < W)
        m = outm[off]
        if not np.all(valid):
            cur = plane[:, target_cols[valid]]
            plane[:, target_cols[valid]] = np.where(m[:, valid], vals[:, valid], cur)
        else:
            cur = plane[:, target_cols]
            plane[:, target_cols] = np.where(m, vals, cur)


def offscreen(n_rows: int, n_edges: int, cw: int, ch: int) -> np.ndarray:
    """(n_rows, n_edges) bool: the 4-sample edge segments of a vertical-edge
    map (edge k at plane column 4(k+1), segment j at plane rows 4j..4j+3)
    that lie outside the displayed cw x ch plane samples. The spec filters
    none of them (7.14.2 onScreen: x >= FrameWidth or y >= FrameHeight in
    luma samples; libaom's set_lpf_parameters compares with the crop
    width and height), though CDEF later reads their samples inside the
    mi-aligned frame. The horizontal pass passes its transposed dims."""
    x = 4 * np.arange(1, n_edges + 1)
    y = 4 * np.arange(n_rows)
    return (x[None, :] >= cw) | (y[:, None] >= ch)


def _edge_maps_vertical(mi: MiState, plane: int, pw: int, ph: int, lvl: int) -> np.ndarray:
    """Filter-length map for vertical edges of one plane.

    Returns (plane_mi_rows, n_edge_cols) int array; edge k is at plane
    column x = 4*(k+1). Mirrors set_lpf_parameters with frame-constant
    levels and TX_MODE_LARGEST (tx == block for luma, uv tx fills block)."""
    ss = 0 if plane == 0 else 1
    n_rows = ph // 4
    n_edges = pw // 4 - 1
    flen = np.zeros((n_rows, n_edges), np.int32)
    if lvl == 0 or n_edges <= 0:
        return flen
    # mi coordinates for each (plane row j, edge k)
    j = np.arange(n_rows)
    k = np.arange(1, n_edges + 1)
    if ss == 0:
        mi_r = j
        mi_c = k
        prev_c = k - 1
    else:
        mi_r = 1 | (j * 2)
        mi_c = 1 | (k * 2)
        prev_c = mi_c - 2
    R = mi_r[:, None]
    C = np.broadcast_to(mi_c[None, :], (n_rows, n_edges))
    P = np.broadcast_to(prev_c[None, :], (n_rows, n_edges))

    bsize_c = mi.bsize[R, C]
    bsize_p = mi.bsize[R, P]
    if ss == 0:
        tw_c = TX_W[MAX_TXSIZE_RECT[bsize_c]]
        tw_p = TX_W[MAX_TXSIZE_RECT[bsize_p]]
    else:
        tw_c = _uv_tx_w(bsize_c)
        tw_p = _uv_tx_w(bsize_p)

    # plane-sample offset of x within the current block
    origin_c = C - mi.off_x[R, C]  # block origin mi col
    x_plane = (k * 4)[None, :]
    origin_plane = (origin_c * 4) >> ss
    off_in_block = x_plane - origin_plane
    is_tx_edge = (off_in_block % tw_c) == 0
    bw_plane = np.maximum(BLOCK_W[bsize_c] >> ss, 4)
    pu_edge = (off_in_block % bw_plane) == 0

    skip_c = (mi.skip[R, C] == 1) & (mi.ref0[R, C] >= int(RefFrame.LAST_FRAME))
    skip_p = (mi.skip[R, P] == 1) & (mi.ref0[R, P] >= int(RefFrame.LAST_FRAME))
    apply = is_tx_edge & (~skip_p | ~skip_c | pu_edge)

    min_tw = np.minimum(tw_c, tw_p)
    if plane == 0:
        f = np.where(min_tw == 4, 4, np.where(min_tw == 8, 8, 14))
    else:
        f = np.where(min_tw == 4, 4, 6)
    flen[:] = np.where(apply, f, 0)
    return flen


def _transposed_mi(mi: MiState) -> MiState:
    """MiState view with rows/cols swapped (for the horizontal pass)."""
    t = MiState.__new__(MiState)
    t.mi_rows, t.mi_cols = mi.mi_cols, mi.mi_rows
    t.bsize = mi.bsize.T
    t.mode = mi.mode.T
    t.ref0 = mi.ref0.T
    t.ref1 = mi.ref1.T
    t.mv0 = np.swapaxes(mi.mv0, 0, 1)
    t.mv1 = np.swapaxes(mi.mv1, 0, 1)
    t.skip = mi.skip.T
    t.off_x = mi.off_y.T
    t.off_y = mi.off_x.T
    # width/height tables swap via bsize transpose trick: square-only profile
    return t


def loop_filter_frame(planes: list, mi: MiState, qindex: int, bd: int,
                      frame_is_intra: bool, levels: tuple | None = None,
                      sharpness: int = 0, *, disp_dims: tuple) -> tuple:
    """Apply the deblocking filter in place to [y, u, v]. Returns levels.
    disp_dims = (width, height) of the displayed frame: edges outside it
    stay unfiltered (`offscreen`)."""
    if levels is None:
        levels = pick_filter_levels(qindex, bd, frame_is_intra, planes[0].shape[0])
    if levels[0] == 0 and levels[1] == 0:
        return levels
    miT = _transposed_mi(mi)
    for plane in range(3):
        lvl_v = levels[0] if plane == 0 else levels[plane + 1]
        lvl_h = levels[1] if plane == 0 else levels[plane + 1]
        pl = planes[plane]
        ph, pw = pl.shape
        ss = 1 if plane else 0
        cw, ch = (disp_dims[0] + ss) >> ss, (disp_dims[1] + ss) >> ss
        if lvl_v:
            lim, blim, thr = _limits(lvl_v, sharpness)
            flen = _edge_maps_vertical(mi, plane, pw, ph, lvl_v)
            flen[offscreen(*flen.shape, cw, ch)] = 0
            _filter_vertical_edges(pl, flen, lim, blim, thr, bd)
        if lvl_h:
            lim, blim, thr = _limits(lvl_h, sharpness)
            plT = np.ascontiguousarray(pl.T)
            flen = _edge_maps_vertical(miT, plane, ph, pw, lvl_h)
            flen[offscreen(*flen.shape, ch, cw)] = 0
            _filter_vertical_edges(plT, flen, lim, blim, thr, bd)
            pl[:] = plT.T
    return levels
