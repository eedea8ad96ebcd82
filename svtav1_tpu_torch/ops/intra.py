"""Batched intra prediction (AV1 spec 7.11.2).

TPU-first: each predictor maps a batch of edge vectors
(above: (B, W), left: (B, H), topleft: (B,)) to predictions (B, H, W) with
pure elementwise/broadcast math — no per-block branching. Works with numpy
or jax.numpy via the `xp` module argument (behavioral reference:
Source/Lib/Codec/intra_prediction.c:1029-1140, enc_intra_prediction.c:120-185).

Edge construction rules (reference enc_intra_prediction.c:124-183):
  - missing left  -> fill with above[0] if available else 129 (base+1)
  - missing above -> fill with left[0] if available else 127 (base-1)
  - topleft: both -> real pixel; above only -> above[0]; left only -> left[0];
    neither -> 128 (base); values are for bd=8 and scale as base = 128<<(bd-8).
"""
from __future__ import annotations

import numpy as np

from ..constants.av1 import PredMode

# Normative smooth-predictor weights (AV1 spec "Smooth prediction process",
# reference intra_prediction.c:26-45), indexed by block dimension.
SM_WEIGHTS = {
    4: np.array([255, 149, 85, 64], np.int32),
    8: np.array([255, 197, 146, 105, 73, 50, 37, 32], np.int32),
    16: np.array([255, 225, 196, 170, 145, 123, 102, 84, 68, 54, 43, 33, 26, 20, 17, 16], np.int32),
    32: np.array([255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111, 101, 92, 83, 74,
                  66, 59, 52, 45, 39, 34, 29, 25, 21, 17, 14, 12, 10, 9, 8, 8], np.int32),
    64: np.array([255, 248, 240, 233, 225, 218, 210, 203, 196, 189, 182, 176, 169, 163, 156,
                  150, 144, 138, 133, 127, 121, 116, 111, 106, 101, 96, 91, 86, 82, 77, 73, 69,
                  65, 61, 57, 54, 50, 47, 44, 41, 38, 35, 32, 29, 27, 25, 22, 20, 18, 16, 15,
                  13, 12, 10, 9, 8, 7, 6, 6, 5, 5, 4, 4, 4], np.int32),
}


def dc_pred(above, left, have_above: bool, have_left: bool, bd: int = 8, xp=np):
    """(B, W), (B, H) -> (B, H, W). Availability is uniform across the batch."""
    B, W = above.shape
    H = left.shape[1]
    if have_above and have_left:
        s = xp.sum(above, axis=1) + xp.sum(left, axis=1)
        dc = (s + ((W + H) >> 1)) // (W + H)
    elif have_above:
        dc = (xp.sum(above, axis=1) + (W >> 1)) >> int(np.log2(W))
    elif have_left:
        dc = (xp.sum(left, axis=1) + (H >> 1)) >> int(np.log2(H))
    else:
        dc = xp.full((B,), 1 << (bd - 1), xp.int32)
    return xp.broadcast_to(dc[:, None, None], (B, H, W)).astype(xp.int32)


def v_pred(above, left, topleft, xp=np):
    B, W = above.shape
    H = left.shape[1]
    return xp.broadcast_to(above[:, None, :], (B, H, W)).astype(xp.int32)


def h_pred(above, left, topleft, xp=np):
    B, W = above.shape
    H = left.shape[1]
    return xp.broadcast_to(left[:, :, None], (B, H, W)).astype(xp.int32)


def paeth_pred(above, left, topleft, xp=np):
    B, W = above.shape
    H = left.shape[1]
    t = above[:, None, :].astype(xp.int32)  # (B,1,W)
    l = left[:, :, None].astype(xp.int32)  # (B,H,1)
    tl = topleft[:, None, None].astype(xp.int32)
    base = t + l - tl
    pt = xp.abs(base - t)
    pl = xp.abs(base - l)
    ptl = xp.abs(base - tl)
    use_l = (pl <= pt) & (pl <= ptl)
    use_t = (pt <= ptl)
    return xp.where(use_l, l + 0 * pt, xp.where(use_t, t + 0 * pl, tl + 0 * pl)).astype(xp.int32)


def smooth_pred(above, left, topleft, xp=np):
    B, W = above.shape
    H = left.shape[1]
    wh = xp.asarray(SM_WEIGHTS[H])[None, :, None]  # (1,H,1)
    ww = xp.asarray(SM_WEIGHTS[W])[None, None, :]  # (1,1,W)
    below = left[:, -1, None, None].astype(xp.int32)
    right = above[:, -1, None, None].astype(xp.int32)
    t = above[:, None, :].astype(xp.int32)
    l = left[:, :, None].astype(xp.int32)
    s = wh * t + (256 - wh) * below + ww * l + (256 - ww) * right
    return ((s + 256) >> 9).astype(xp.int32)


def smooth_v_pred(above, left, topleft, xp=np):
    B, W = above.shape
    H = left.shape[1]
    wh = xp.asarray(SM_WEIGHTS[H])[None, :, None]
    below = left[:, -1, None, None].astype(xp.int32)
    t = above[:, None, :].astype(xp.int32)
    s = wh * t + (256 - wh) * below
    return xp.broadcast_to((s + 128) >> 8, (B, H, W)).astype(xp.int32)


def smooth_h_pred(above, left, topleft, xp=np):
    B, W = above.shape
    H = left.shape[1]
    ww = xp.asarray(SM_WEIGHTS[W])[None, None, :]
    right = above[:, -1, None, None].astype(xp.int32)
    l = left[:, :, None].astype(xp.int32)
    s = ww * l + (256 - ww) * right
    return xp.broadcast_to((s + 128) >> 8, (B, H, W)).astype(xp.int32)


def predict(mode: int, above, left, topleft, have_above: bool, have_left: bool, bd: int = 8, xp=np):
    """Dispatch one mode for a batch of blocks with shared availability."""
    m = PredMode(mode)
    if m == PredMode.DC_PRED:
        return dc_pred(above, left, have_above, have_left, bd, xp)
    fn = {
        PredMode.V_PRED: v_pred,
        PredMode.H_PRED: h_pred,
        PredMode.PAETH_PRED: paeth_pred,
        PredMode.SMOOTH_PRED: smooth_pred,
        PredMode.SMOOTH_V_PRED: smooth_v_pred,
        PredMode.SMOOTH_H_PRED: smooth_h_pred,
    }[m]
    return fn(above, left, topleft, xp=xp)


def build_edges(recon: np.ndarray, x: int, y: int, w: int, h: int, bd: int = 8,
                have_above: bool | None = None, have_left: bool | None = None):
    """Build (above, left, topleft) for one block from the recon plane
    (single-block helper used by the scalar encoder/decoder paths).

    recon: (H, W) plane holding decoded samples for all blocks before this one
    in coding order. Availability defaults to frame-boundary rules; pass
    explicit flags for tile boundaries. Returns above (w,), left (h,), topleft.
    """
    base = 1 << (bd - 1)
    if have_above is None:
        have_above = y > 0
    if have_left is None:
        have_left = x > 0
    if have_above:
        above = recon[y - 1, x : x + w].astype(np.int32)
        if above.shape[0] < w:  # replicate last (frame edge)
            above = np.concatenate([above, np.full(w - above.shape[0], above[-1], np.int32)])
    else:
        above = np.full(w, np.int32(recon[y, x - 1]) if have_left else base - 1, np.int32)
    if have_left:
        left = recon[y : y + h, x - 1].astype(np.int32)
        if left.shape[0] < h:
            left = np.concatenate([left, np.full(h - left.shape[0], left[-1], np.int32)])
    else:
        left = np.full(h, np.int32(recon[y - 1, x]) if have_above else base + 1, np.int32)
    if have_above and have_left:
        topleft = np.int32(recon[y - 1, x - 1])
    elif have_above:
        topleft = np.int32(above[0])
    elif have_left:
        topleft = np.int32(left[0])
    else:
        topleft = np.int32(base)
    return above, left, topleft


# ---------------------------------------------------------------------------
# Directional prediction (AV1 spec 7.11.2.4; behavior intra_prediction.c:314-413)
# ---------------------------------------------------------------------------

import functools
import os as _os

_DATA = _os.path.join(_os.path.dirname(__file__), "..", "constants", "data")

# base angles for the 8 directional modes, enum order V..D67
MODE_ANGLE = {int(PredMode.V_PRED): 90, int(PredMode.H_PRED): 180, int(PredMode.D45_PRED): 45,
              int(PredMode.D135_PRED): 135, int(PredMode.D113_PRED): 113, int(PredMode.D157_PRED): 157,
              int(PredMode.D203_PRED): 203, int(PredMode.D67_PRED): 67}


@functools.lru_cache(maxsize=None)
def _avail_tables() -> dict:
    with np.load(_os.path.join(_DATA, "intra_avail.npz")) as z:
        return {k: z[k].copy() for k in z.files}


def _dr_derivative(angle: int) -> tuple[int, int]:
    """(dx, dy) per reference get_dx/get_dy (intra_prediction.c:286-300)."""
    d = _avail_tables()["eb_dr_intra_derivative"]
    if 0 < angle < 90:
        dx = int(d[angle])
    elif 90 < angle < 180:
        dx = int(d[180 - angle])
    else:
        dx = 1
    if 90 < angle < 180:
        dy = int(d[angle - 90])
    elif 180 < angle < 270:
        dy = int(d[270 - angle])
    else:
        dy = 1
    return dx, dy


@functools.lru_cache(maxsize=None)
def dr_tables(angle: int, w: int, h: int):
    """Constant gather tables for directional prediction (upsample==0).

    Returns (src_sel, base, shift) as (h, w) int32 arrays:
      src_sel 0 -> gather from above_ext at [base] (index -1 == topleft,
      so stored offset +1); 1 -> from left_ext likewise. `shift` in 0..31.
      base is clamped to the max extension; positions past max replicate
      the last extension pixel (base points at it with shift 0).
    """
    dx, dy = _dr_derivative(angle)
    rr, cc = np.mgrid[0:h, 0:w]
    if angle < 90:  # zone 1: above only
        x = (rr + 1) * dx
        base = (x >> 6) + cc
        shift = (x & 0x3F) >> 1
        maxb = w + h - 1
        over = base >= maxb
        base = np.where(over, maxb, base)
        shift = np.where(over, 0, shift)
        return np.zeros_like(base), base.astype(np.int32), shift.astype(np.int32)
    if angle > 180:  # zone 3: left only
        y = (cc + 1) * dy
        base = (y >> 6) + rr
        shift = (y & 0x3F) >> 1
        maxb = w + h - 1
        over = base >= maxb
        base = np.where(over, maxb, base)
        shift = np.where(over, 0, shift)
        return np.ones_like(base), base.astype(np.int32), shift.astype(np.int32)
    # zone 2: above for base_x >= -1 else left
    xrow = -(rr + 1) * dx
    base1 = (xrow >> 6) + cc
    shift1 = (xrow & 0x3F) >> 1
    yy = (rr << 6) - (cc + 1) * dy
    base2 = yy >> 6
    shift2 = (yy & 0x3F) >> 1
    use_above = base1 >= -1
    base = np.where(use_above, base1, base2)
    shift = np.where(use_above, shift1, shift2)
    return np.where(use_above, 0, 1).astype(np.int32), base.astype(np.int32), shift.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _dr_matrix(angle: int, w: int, h: int) -> np.ndarray:
    """Directional prediction as one constant matrix: pred = E @ M where
    E = [topleft, above_ext (w+h), left_ext (h+w)] per batch row and
    M (1+2(w+h), w*h) float32 carries the two-tap 5-bit interpolation
    weights. TPU-first form: gathers from tiny per-lane edge vectors lower
    to slow paths, while an MXU matmul with a static (sparse) matrix is
    fast — and exact, since every product/sum stays below 2^24."""
    src_sel, base, shift = dr_tables(angle, w, h)
    e = w + h
    M = np.zeros((1 + 2 * e, w * h), np.float32)
    pos = np.arange(w * h)
    for sel_val, off in ((0, 0), (1, e)):
        m = (src_sel.reshape(-1) == sel_val)
        bi = base.reshape(-1) + 1  # slot 0 = topleft
        bs = shift.reshape(-1)
        i0 = np.where(bi == 0, 0, bi + off)
        i1 = np.minimum(bi + 1, e) + off
        i1 = np.where(bi + 1 == 0, 0, i1)
        np.add.at(M, (i0[m], pos[m]), (32 - bs[m]).astype(np.float32))
        np.add.at(M, (i1[m], pos[m]), bs[m].astype(np.float32))
    return M


def dr_pred(above_ext, left_ext, topleft, angle: int, w: int, h: int, xp=np):
    """Directional prediction for a batch.

    above_ext: (B, w + h) above row incl. top-right extension (replicated
    per availability); left_ext: (B, h + w); topleft (B,).
    """
    B = above_ext.shape[0]
    if xp is not np:  # device path: one MXU matmul against a static matrix
        E = xp.concatenate([topleft[:, None], above_ext, left_ext], axis=1)
        M = xp.asarray(_dr_matrix(angle, w, h))
        val = (E.astype(xp.float32) @ M).astype(xp.int32)
        return ((val + 16) >> 5).reshape(B, h, w)
    src_sel, base, shift = dr_tables(angle, w, h)
    # prepend topleft so index -1 maps to slot 0
    a = xp.concatenate([topleft[:, None], above_ext], axis=1)  # (B, 1+w+h)
    l = xp.concatenate([topleft[:, None], left_ext], axis=1)
    bi = xp.asarray(base) + 1
    bs = xp.asarray(shift)
    sel = xp.asarray(src_sel)
    va = a[:, bi] * (32 - bs) + a[:, xp.minimum(bi + 1, a.shape[1] - 1)] * bs
    vl = l[:, bi] * (32 - bs) + l[:, xp.minimum(bi + 1, l.shape[1] - 1)] * bs
    val = xp.where(sel[None] == 0, va, vl)
    return ((val + 16) >> 5).astype(xp.int32)


_BSIZE_NAME = ("4x4", "4x8", "8x4", "8x8", "8x16", "16x8", "16x16", "16x32",
               "32x16", "32x32", "32x64", "64x32", "64x64", "64x128", "128x64",
               "128x128", "4x16", "16x4", "8x32", "32x8", "16x64", "64x16")
_VERT_SQ = {3: "8x8", 6: "16x16", 9: "32x32", 12: "64x64"}  # square bsizes w/ vert tables


def _avail_bit(name: str, idx: int) -> bool:
    tbl = _avail_tables()[name]
    return bool((int(tbl[idx // 8]) >> (idx % 8)) & 1)


def intra_has_top_right(bsize: int, mi_row: int, mi_col: int, have_top: bool,
                        right_available: bool, partition: int = 0,
                        txw4: int | None = None, row_off: int = 0,
                        col_off: int = 0, ss_x: int = 0) -> bool:
    """svt_aom_intra_has_top_right (intra_prediction.c:697), 64px SBs,
    per-txb offsets in plane 4px units. Defaults = whole-block tx."""
    if not have_top or not right_available:
        return False
    from ..constants.av1 import BLOCK_H as _BH
    from ..constants.av1 import BLOCK_W as _BW

    bw_unit = int(_BW[bsize]) // 4
    plane_bw_unit = max(bw_unit >> ss_x, 1)
    if txw4 is None:
        txw4 = plane_bw_unit
    if row_off > 0:  # enough pixels to the right within the block row
        return col_off + txw4 < plane_bw_unit
    # all top-right pixels are in the block above, already available
    if col_off + txw4 < plane_bw_unit:
        return True
    bw_mi_log2 = int(np.log2(max(int(_BW[bsize]) // 4, 1)))
    bh_mi_log2 = int(np.log2(max(int(_BH[bsize]) // 4, 1)))
    sb_mi_size = 16
    blk_row_in_sb = (mi_row & (sb_mi_size - 1)) >> bh_mi_log2
    blk_col_in_sb = (mi_col & (sb_mi_size - 1)) >> bw_mi_log2
    if blk_row_in_sb == 0:
        return True
    if ((blk_col_in_sb + 1) << bw_mi_log2) >= sb_mi_size:
        return False
    # MAX_MIB_SIZE_LOG2 = 5 (tables laid out on the 128px grid)
    idx = (blk_row_in_sb << (5 - bw_mi_log2)) + blk_col_in_sb
    if partition in (6, 7) and int(bsize) in _VERT_SQ:  # VERT_A / VERT_B
        return _avail_bit("has_tr_vert_" + _VERT_SQ[int(bsize)], idx)
    return _avail_bit("has_tr_" + _BSIZE_NAME[int(bsize)], idx)


def intra_has_bottom_left(bsize: int, mi_row: int, mi_col: int,
                          bottom_available: bool, have_left: bool,
                          partition: int = 0, txh4: int | None = None,
                          row_off: int = 0, col_off: int = 0,
                          ss_y: int = 0) -> bool:
    """svt_aom_intra_has_bottom_left (intra_prediction.c:965)."""
    if not bottom_available or not have_left:
        return False
    from ..constants.av1 import BLOCK_H as _BH
    from ..constants.av1 import BLOCK_W as _BW

    bh_unit = int(_BH[bsize]) // 4
    plane_bh_unit = max(bh_unit >> ss_y, 1)
    if txh4 is None:
        txh4 = plane_bh_unit
    if col_off > 0:  # bottom-left is inside this block, not yet decoded
        return False
    # all bottom-left pixels are in the left block, already available
    if row_off + txh4 < plane_bh_unit:
        return True
    bw_mi_log2 = int(np.log2(max(int(_BW[bsize]) // 4, 1)))
    bh_mi_log2 = int(np.log2(max(int(_BH[bsize]) // 4, 1)))
    sb_mi_size = 16
    blk_row_in_sb = (mi_row & (sb_mi_size - 1)) >> bh_mi_log2
    blk_col_in_sb = (mi_col & (sb_mi_size - 1)) >> bw_mi_log2
    # leftmost column of superblock: bl pixels must stay inside the left SB
    if blk_col_in_sb == 0:
        blk_start_row_off = (blk_row_in_sb << bh_mi_log2) >> ss_y
        sb_height_unit = sb_mi_size >> ss_y
        return blk_start_row_off + row_off + txh4 < sb_height_unit
    # bottom row of superblock (not leftmost column): unavailable
    if ((blk_row_in_sb + 1) << bh_mi_log2) >= sb_mi_size:
        return False
    idx = (blk_row_in_sb << (5 - bw_mi_log2)) + blk_col_in_sb
    if partition in (6, 7) and int(bsize) in _VERT_SQ:
        return _avail_bit("has_bl_vert_" + _VERT_SQ[int(bsize)], idx)
    return _avail_bit("has_bl_" + _BSIZE_NAME[int(bsize)], idx)


def build_edges_ext(recon, x: int, y: int, w: int, h: int, bd: int,
                    have_above: bool, have_left: bool,
                    n_topright: int, n_bottomleft: int):
    """Extended edges for directional modes.

    Returns (above_ext (w+h,), left_ext (h+w,), topleft) with the
    normative replication rules (reference enc_intra_prediction.c:124-183):
    real above pixels [x, x+w+n_topright), then replicate; same for left.
    """
    base = 1 << (bd - 1)
    na, nl = w + h, h + w
    if have_above:
        avail = w + max(n_topright, 0)
        row = recon[y - 1, x : x + avail].astype(np.int32)
        above = np.empty(na, np.int32)
        above[: row.shape[0]] = row
        above[row.shape[0] :] = row[-1]
    else:
        above = np.full(na, np.int32(recon[y, x - 1]) if have_left else base - 1, np.int32)
    if have_left:
        avail = h + max(n_bottomleft, 0)
        col = recon[y : y + avail, x - 1].astype(np.int32)
        left = np.empty(nl, np.int32)
        left[: col.shape[0]] = col
        left[col.shape[0] :] = col[-1]
    else:
        left = np.full(nl, np.int32(recon[y - 1, x]) if have_above else base + 1, np.int32)
    if have_above and have_left:
        topleft = np.int32(recon[y - 1, x - 1])
    elif have_above:
        topleft = np.int32(above[0])
    elif have_left:
        topleft = np.int32(left[0])
    else:
        topleft = np.int32(base)
    return above, left, topleft


# ---------------------------------------------------------------- filter intra

FILTER_INTRA_MODES = 5
_FI_DATA = _os.path.join(_os.path.dirname(__file__), "..", "constants", "data", "filter_intra.npz")


@functools.lru_cache(maxsize=None)
def filter_intra_taps() -> np.ndarray:
    """(5, 8, 8) int32 taps (AV1 spec Intra_Filter_Taps; reference
    C_DEFAULT/filterintra_c.c eb_av1_filter_intra_taps)."""
    with np.load(_FI_DATA) as z:
        return z["taps"].astype(np.int32)


def filter_intra_pred(above: np.ndarray, left: np.ndarray, topleft: int, mode: int,
                      w: int, h: int, bd: int = 8) -> np.ndarray:
    """Recursive filter-intra predictor (spec 7.11.2.3; reference
    svt_aom_highbd_filter_intra_predictor intra_prediction.c:2474):
    4x2 sub-blocks predicted from 7 neighbors with per-mode taps."""
    assert w <= 32 and h <= 32
    taps = filter_intra_taps()[mode]
    buf = np.zeros((h + 1, w + 1), np.int64)
    buf[0, 0] = topleft
    buf[0, 1 : w + 1] = above[:w]
    buf[1 : h + 1, 0] = left[:h]
    hi = (1 << bd) - 1
    for r in range(1, h + 1, 2):
        for c in range(1, w + 1, 4):
            p = np.array([buf[r - 1, c - 1], buf[r - 1, c], buf[r - 1, c + 1], buf[r - 1, c + 2],
                          buf[r - 1, c + 3], buf[r, c - 1], buf[r + 1, c - 1], 0], np.int64)
            s = taps @ p  # (8,)
            # ROUND_POWER_OF_TWO_SIGNED(x, 4)
            v = np.sign(s) * ((np.abs(s) + 8) >> 4)
            v = np.clip(v, 0, hi)
            for k in range(8):
                buf[r + (k >> 2), c + (k & 3)] = v[k]
    return buf[1 : h + 1, 1 : w + 1].astype(np.int32)


# ---------------------------------------------------------------------------
# Normative per-txb intra predictor with full edge preparation (decode side).
# Behavioral reference: enc_intra_prediction.c build_intra_predictors
# (replication rules, 127/128/129 defaults, corner/edge filter, upsample)
# + intra_prediction.c dr z1/z2/z3 with upsample; spec 7.11.2.
# ---------------------------------------------------------------------------

# extend_modes (intra_prediction.c:469): (left, above, aboveleft, aboveright,
# bottomleft) per base intra mode 0..12
_EXTEND_NEED = (
    (1, 1, 0, 0, 0),  # DC
    (0, 1, 0, 0, 0),  # V
    (1, 0, 0, 0, 0),  # H
    (0, 1, 0, 1, 0),  # D45
    (1, 1, 1, 0, 0),  # D135
    (1, 1, 1, 0, 0),  # D113
    (1, 1, 1, 0, 0),  # D157
    (1, 0, 0, 0, 1),  # D203
    (0, 1, 0, 1, 0),  # D67
    (1, 1, 0, 0, 0),  # SMOOTH
    (1, 1, 0, 0, 0),  # SMOOTH_V
    (1, 1, 0, 0, 0),  # SMOOTH_H
    (1, 1, 1, 0, 0),  # PAETH
)


def edge_filter_strength(bs0: int, bs1: int, delta: int, ftype: int) -> int:
    """svt_aom_intra_edge_filter_strength (spec Intra_Edge_Filter_Strength)."""
    d = abs(delta)
    blk_wh = bs0 + bs1
    s = 0
    if ftype == 0:
        if blk_wh <= 8:
            s = 1 if d >= 56 else 0
        elif blk_wh <= 16:  # covers the <=12 case (same threshold)
            s = 1 if d >= 40 else 0
        elif blk_wh <= 24:
            s = 3 if d >= 32 else (2 if d >= 16 else (1 if d >= 8 else 0))
        elif blk_wh <= 32:
            s = 3 if d >= 32 else (2 if d >= 4 else (1 if d >= 1 else 0))
        else:
            s = 3 if d >= 1 else 0
    else:
        if blk_wh <= 8:
            s = 2 if d >= 64 else (1 if d >= 40 else 0)
        elif blk_wh <= 16:
            s = 2 if d >= 48 else (1 if d >= 20 else 0)
        elif blk_wh <= 24:
            s = 3 if d >= 4 else 0
        else:
            s = 3 if d >= 1 else 0
    return s


def use_edge_upsample(bs0: int, bs1: int, delta: int, ftype: int) -> bool:
    d = abs(delta)
    if d <= 0 or d >= 40:
        return False
    return (bs0 + bs1) <= (8 if ftype else 16)


_EDGE_KERNELS = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))


def _filter_edge(buf: np.ndarray, start: int, sz: int, strength: int) -> None:
    """In-place 5-tap smoothing of buf[start : start+sz] (index 0 kept)."""
    if strength == 0 or sz <= 0:
        return
    k = _EDGE_KERNELS[strength - 1]
    edge = buf[start : start + sz].copy()
    for i in range(1, sz):
        s = 0
        for j in range(5):
            idx = min(max(i - 2 + j, 0), sz - 1)
            s += int(edge[idx]) * k[j]
        buf[start + i] = (s + 8) >> 4


def _upsample_edge(buf: np.ndarray, start: int, sz: int, bd: int) -> None:
    """In-place 2x edge upsample: logical p = buf[start:], writes
    p[-2 .. 2*sz-2] (svt_av1_upsample_intra_edge)."""
    inb = np.empty(sz + 3, np.int32)
    inb[0] = inb[1] = buf[start - 1]
    inb[2 : 2 + sz] = buf[start : start + sz]
    inb[sz + 2] = buf[start + sz - 1]
    buf[start - 2] = inb[0]
    mx = (1 << bd) - 1
    for i in range(sz):
        s = -int(inb[i]) + 9 * int(inb[i + 1]) + 9 * int(inb[i + 2]) - int(inb[i + 3])
        buf[start + 2 * i - 1] = min(max((s + 8) >> 4, 0), mx)
        buf[start + 2 * i] = inb[i + 2]


def _dr_scalar(above: np.ndarray, aoff: int, left: np.ndarray, loff: int,
               w: int, h: int, angle: int, up_a: int, up_l: int, bd: int) -> np.ndarray:
    """dr z1/z2/z3 with upsampling (intra_prediction.c:344-470)."""
    dx, dy = _dr_derivative(angle)
    out = np.zeros((h, w), np.int32)
    mx = (1 << bd) - 1

    def rp2(v):
        return (v + 16) >> 5

    if 0 < angle < 90:  # z1: above only
        max_base_x = (w + h - 1) << up_a
        frac_bits = 6 - up_a
        base_inc = 1 << up_a
        x = dx
        for r in range(h):
            base = x >> frac_bits
            shift = ((x << up_a) & 0x3F) >> 1
            for c in range(w):
                if base >= max_base_x:
                    out[r, c:] = above[aoff + max_base_x]
                    break
                v = int(above[aoff + base]) * (32 - shift) + int(above[aoff + base + 1]) * shift
                out[r, c] = min(max(rp2(v), 0), mx)
                base += base_inc
            x += dx
        return out
    if 90 < angle < 180:  # z2
        min_base_x = -(1 << up_a)
        fbx, fby = 6 - up_a, 6 - up_l
        binc = 1 << up_a
        x = -dx
        for r in range(h):
            base1 = x >> fbx
            y = (r << 6) - dy
            b1 = base1
            for c in range(w):
                if b1 >= min_base_x:
                    s1 = ((x * (1 << up_a)) & 0x3F) >> 1
                    v = int(above[aoff + b1]) * (32 - s1) + int(above[aoff + b1 + 1]) * s1
                else:
                    b2 = y >> fby
                    s2 = ((y * (1 << up_l)) & 0x3F) >> 1
                    v = int(left[loff + b2]) * (32 - s2) + int(left[loff + b2 + 1]) * s2
                out[r, c] = min(max(rp2(v), 0), mx)
                b1 += binc
                y -= dy
            x -= dx
        return out
    # z3: left only (180 < angle < 270)
    max_base_y = (w + h - 1) << up_l
    frac_bits = 6 - up_l
    binc = 1 << up_l
    y = dy
    for c in range(w):
        base = y >> frac_bits
        shift = ((y << up_l) & 0x3F) >> 1
        for r in range(h):
            if base >= max_base_y:
                out[r:, c] = left[loff + max_base_y]
                break
            v = int(left[loff + base]) * (32 - shift) + int(left[loff + base + 1]) * shift
            out[r, c] = min(max(rp2(v), 0), mx)
            base += binc
        y += dy
    return out


def predict_unit_normative(recon: np.ndarray, px: int, py: int, w: int, h: int,
                           bd: int, mode: int, angle_delta: int,
                           n_top: int, n_topright: int, n_left: int,
                           n_bottomleft: int, filt_type: int,
                           enable_edge_filter: bool,
                           fi_mode: int | None = None) -> np.ndarray:
    """Full normative intra prediction for one transform unit.

    n_* = available reference pixel counts (0 when the side is unavailable);
    mirrors build_intra_predictors exactly, including the edge filter and
    upsampling (spec 7.11.2). Used by the conformance decoder when the
    sequence enables the intra edge filter or TX_MODE_SELECT."""
    base = 1 << (bd - 1)
    need_left, need_above, need_al, need_ar, need_bl = _EXTEND_NEED[int(mode)]
    p_angle = 0
    is_dr = is_directional_mode(int(mode))
    if is_dr:
        p_angle = MODE_ANGLE[int(mode)] + angle_delta * 3
        if p_angle <= 90:
            need_left, need_above, need_al = 0, 1, 1
        elif p_angle < 180:
            need_left, need_above, need_al = 1, 1, 1
        else:
            need_left, need_above, need_al = 1, 0, 1
    if fi_mode is not None:
        need_left = need_above = need_al = 1

    if (not need_above and n_left == 0) or (not need_left and n_top == 0):
        if need_left:
            val = int(recon[py - 1, px]) if n_top > 0 else base + 1
        else:
            val = int(recon[py, px - 1]) if n_left > 0 else base - 1
        return np.full((h, w), val, np.int32)

    BUF = 2 * 64 + 48
    above = np.full(BUF, base, np.int32)
    left = np.full(BUF, base, np.int32)
    AOFF = 32  # logical index 0 at offset 32 (room for upsample p[-2])

    if need_left:
        nb = need_bl
        if fi_mode is not None:
            nb = 0
        if is_dr:
            nb = p_angle > 180
        num_need = h + (w if nb else 0)
        if n_left > 0:
            left[AOFF : AOFF + n_left] = recon[py : py + n_left, px - 1]
            i = n_left
            if nb and n_bottomleft > 0:
                left[AOFF + h : AOFF + h + n_bottomleft] = \
                    recon[py + h : py + h + n_bottomleft, px - 1]
                i = h + n_bottomleft
            if i < num_need:
                left[AOFF + i : AOFF + num_need] = left[AOFF + i - 1]
        else:
            left[AOFF : AOFF + num_need] = (int(recon[py - 1, px]) if n_top > 0
                                            else base + 1)
    if need_above:
        nr = need_ar
        if fi_mode is not None:
            nr = 0
        if is_dr:
            nr = p_angle < 90
        num_need = w + (h if nr else 0)
        if n_top > 0:
            above[AOFF : AOFF + n_top] = recon[py - 1, px : px + n_top]
            i = n_top
            if nr and n_topright > 0:
                above[AOFF + w : AOFF + w + n_topright] = \
                    recon[py - 1, px + w : px + w + n_topright]
                i = w + n_topright
            if i < num_need:
                above[AOFF + i : AOFF + num_need] = above[AOFF + i - 1]
        else:
            above[AOFF : AOFF + num_need] = (int(recon[py, px - 1]) if n_left > 0
                                             else base - 1)
    if need_al:
        if n_top > 0 and n_left > 0:
            al = int(recon[py - 1, px - 1])
        elif n_top > 0:
            al = int(recon[py - 1, px])
        elif n_left > 0:
            al = int(recon[py, px - 1])
        else:
            al = base
        above[AOFF - 1] = al
        left[AOFF - 1] = al

    if fi_mode is not None:
        return filter_intra_pred(above[AOFF : AOFF + w], left[AOFF : AOFF + h],
                                 int(above[AOFF - 1]), int(fi_mode), w, h, bd)

    if is_dr:
        up_a = up_l = 0
        if enable_edge_filter:
            nr = p_angle < 90
            nb = p_angle > 180
            if p_angle != 90 and p_angle != 180:
                ab_le = 1 if need_al else 0
                if need_above and need_left and (w + h >= 24):
                    v = (int(left[AOFF]) * 5 + int(above[AOFF - 1]) * 6
                         + int(above[AOFF]) * 5 + 8) >> 4
                    above[AOFF - 1] = v
                    left[AOFF - 1] = v
                if need_above and n_top > 0:
                    s = edge_filter_strength(w, h, p_angle - 90, filt_type)
                    _filter_edge(above, AOFF - ab_le,
                                 n_top + ab_le + (h if nr else 0), s)
                if need_left and n_left > 0:
                    s = edge_filter_strength(h, w, p_angle - 180, filt_type)
                    _filter_edge(left, AOFF - ab_le,
                                 n_left + ab_le + (w if nb else 0), s)
            if need_above and use_edge_upsample(w, h, p_angle - 90, filt_type):
                up_a = 1
                _upsample_edge(above, AOFF, w + (h if nr else 0), bd)
            if need_left and use_edge_upsample(h, w, p_angle - 180, filt_type):
                up_l = 1
                _upsample_edge(left, AOFF, h + (w if nb else 0), bd)
        if p_angle == 90:
            return np.broadcast_to(above[AOFF : AOFF + w], (h, w)).astype(np.int32).copy()
        if p_angle == 180:
            return np.broadcast_to(left[AOFF : AOFF + h, None], (h, w)).astype(np.int32).copy()
        return _dr_scalar(above, AOFF, left, AOFF, w, h, p_angle, up_a, up_l, bd)

    # non-directional: reuse the batched kernels on the prepared edges
    ha, hl = n_top > 0, n_left > 0
    return predict(int(mode), above[None, AOFF : AOFF + w],
                   left[None, AOFF : AOFF + h],
                   np.array([above[AOFF - 1]]), ha, hl, bd)[0]


def is_directional_mode(mode: int) -> bool:
    return int(mode) in MODE_ANGLE


def cfl_apply(dc_pred: np.ndarray, luma: np.ndarray, px: int, py: int,
              w: int, h: int, alpha_q3: int, bd: int) -> np.ndarray:
    """Chroma-from-luma: dc_pred + round(alpha_q3 * luma_ac_q3 / 64)
    (spec 7.11.5; intra_prediction.c svt_cfl_luma_subsampling_420 +
    svt_subtract_average + cfl predict). 4:2:0 only."""
    ly, lx = py * 2, px * 2
    sub = luma[ly : ly + 2 * h, lx : lx + 2 * w].astype(np.int64)
    q3 = (sub[0::2, 0::2] + sub[0::2, 1::2] + sub[1::2, 0::2] + sub[1::2, 1::2]) << 1
    npel = w * h
    log2n = int(np.log2(npel))
    avg = (int(q3.sum()) + (npel >> 1)) >> log2n
    ac = q3 - avg
    scaled = alpha_q3 * ac  # q6
    val = np.where(scaled >= 0, (scaled + 32) >> 6, -((-scaled + 32) >> 6))
    return np.clip(dc_pred.astype(np.int64) + val, 0, (1 << bd) - 1).astype(np.int32)
