"""Native tile encode: flatten the plan to an op stream and run the C walker.

The Python TileCodec.encode remains the behavioral reference; this path is
byte-exact with it (tests/test_native_entropy.py::test_tile_walk_parity) and
~20x faster. Python does the cheap partition-tree flattening; C
(entropy.c ec_encode_tile_ops) writes every symbol and owns all context
state — mirroring the reference's native entropy-coding process
(ec_process.c / entropy_coding.c).
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..constants.av1 import BLOCK_W, MAX_TXSIZE_RECT, Partition, PredMode, TxSize
from ..entropy import native
from . import txb as txb_mod
from .tile_codec import (EXT_TX_SET_INDEX_INTRA, AV1_EXT_TX_IND, AV1_NUM_EXT_TX_SET, FrameParams, Plan,
                         ext_tx_set_type_intra, is_directional, max_uv_txsize)

OP_COLS = 24


class _TileParams(ctypes.Structure):
    _fields_ = [
        ("partition", ctypes.c_void_p), ("skip", ctypes.c_void_p), ("kf_y", ctypes.c_void_p),
        ("uv_mode", ctypes.c_void_p), ("angle", ctypes.c_void_p), ("intra_ext_tx", ctypes.c_void_p),
        ("txb_skip", ctypes.c_void_p), ("eob_flag", ctypes.c_void_p * 7), ("eob_extra", ctypes.c_void_p),
        ("base_eob", ctypes.c_void_p), ("base", ctypes.c_void_p), ("br", ctypes.c_void_p),
        ("dc_sign", ctypes.c_void_p),
        # inter syntax tables
        ("y_mode", ctypes.c_void_p), ("intra_inter", ctypes.c_void_p),
        ("single_ref", ctypes.c_void_p), ("newmv", ctypes.c_void_p),
        ("zeromv", ctypes.c_void_p), ("refmv", ctypes.c_void_p), ("drl", ctypes.c_void_p),
        ("inter_ext_tx", ctypes.c_void_p),
        ("comp_inter", ctypes.c_void_p), ("comp_ref_type", ctypes.c_void_p),
        ("comp_ref", ctypes.c_void_p), ("comp_bwdref", ctypes.c_void_p),
        ("comp_mode", ctypes.c_void_p),
        ("wiener_restore", ctypes.c_void_p), ("sgrproj_restore", ctypes.c_void_p),
        ("switchable_restore", ctypes.c_void_p),
        ("nmv_joints", ctypes.c_void_p), ("nmv_sign", ctypes.c_void_p),
        ("nmv_classes", ctypes.c_void_p), ("nmv_class0", ctypes.c_void_p),
        ("nmv_bits", ctypes.c_void_p), ("nmv_class0_fp", ctypes.c_void_p),
        ("nmv_fp", ctypes.c_void_p), ("nmv_class0_hp", ctypes.c_void_p),
        ("nmv_hp", ctypes.c_void_p),
        ("scans", ctypes.c_void_p), ("scan_off", ctypes.c_void_p),
        ("off2d", ctypes.c_void_p), ("off2d_off", ctypes.c_void_p),
        ("mi_rows", ctypes.c_int32), ("mi_cols", ctypes.c_int32),
        ("mi_row0", ctypes.c_int32), ("mi_row1", ctypes.c_int32),
        ("mi_col0", ctypes.c_int32), ("mi_col1", ctypes.c_int32),
        ("qindex_positive", ctypes.c_int32), ("update", ctypes.c_int32),
        ("frame_is_intra", ctypes.c_int32),
        ("reference_select", ctypes.c_int32),
        ("sign_bias", ctypes.c_int32 * 8),
        ("gm_mv", (ctypes.c_int32 * 2) * 8),
    ]


class _TileState(ctypes.Structure):
    _fields_ = [
        ("above_part", ctypes.c_void_p), ("left_part", ctypes.c_void_p),
        ("mode_grid", ctypes.c_void_p), ("skip_grid", ctypes.c_void_p),
        ("above_ctx", ctypes.c_void_p * 3), ("left_ctx", ctypes.c_void_p * 3),
        ("ref_grid", ctypes.c_void_p), ("bsize_grid", ctypes.c_void_p),
        ("mv_grid", ctypes.c_void_p),
        ("ref1_grid", ctypes.c_void_p), ("mv1_grid", ctypes.c_void_p),
    ]


def _p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


_geom_cache: dict = {}


def _geometry():
    """Concatenated scan + 2d ctx-offset tables for all (tx_size, tx_type)."""
    if _geom_cache:
        return _geom_cache
    scans, scan_off = [], np.zeros(19 * 16, np.int32)
    pos = 0
    for ts in range(19):
        for tt in range(16):
            try:
                s = txb_mod.get_scan(ts, tt)
            except Exception:
                s = np.zeros(1, np.int32)
            scan_off[ts * 16 + tt] = pos
            scans.append(s.astype(np.int32))
            pos += len(s)
    off2d, off2d_off = [], np.zeros(19, np.int32)
    pos = 0
    for ts in range(19):
        o = txb_mod.nz_map_ctx_offset_2d(ts).astype(np.int32)
        off2d_off[ts] = pos
        off2d.append(o)
        pos += len(o)
    _geom_cache.update(scans=np.ascontiguousarray(np.concatenate(scans), np.int32), scan_off=scan_off,
                       off2d=np.ascontiguousarray(np.concatenate(off2d), np.int32), off2d_off=off2d_off)
    return _geom_cache


def flatten_plan(plan: Plan, p: FrameParams, sb_range) -> tuple[np.ndarray, np.ndarray]:
    """Walk the partition tree in coding order -> (ops (N,16) int32, levels)."""
    from ..constants.av1 import TX_SIZE_SQR
    from ..pipeline.intra_md import MODES as _MODES

    ops = []
    levels = []
    lvl_pos = 0
    # grid cell index for array-backed plans
    g_map = {}
    for gi, g in enumerate(plan.grids):
        R, C = g["modes"].shape
        n = g["n"]
        for r in range(R):
            mi_r = (g["y0"] + r * n) // 4
            for c in range(C):
                g_map[(mi_r, (g["x0"] + c * n) // 4, g["bsize"])] = (gi, r, c)
    # per-bsize tx signaling constants (intra + inter sets)
    from .tile_codec import EXT_TX_SET_INDEX_INTER, ext_tx_set_type_inter
    from ..constants.av1 import SIZE_GROUP

    txsig = {}
    txsig_inter = {}
    for bsize in set(k[2] for k in g_map) | set(k[2] for k in plan.blocks):
        tx_y = int(MAX_TXSIZE_RECT[bsize])
        for out, set_type, eidx in (
                (txsig, ext_tx_set_type_intra(tx_y), EXT_TX_SET_INDEX_INTRA),
                (txsig_inter, ext_tx_set_type_inter(tx_y), EXT_TX_SET_INDEX_INTER)):
            nsym = AV1_NUM_EXT_TX_SET[set_type]
            if nsym > 1 and p.qindex > 0:
                out[bsize] = (nsym, int(AV1_EXT_TX_IND[set_type][0]),
                              eidx[set_type], int(TX_SIZE_SQR[tx_y]))
            else:
                out[bsize] = (0, 0, 0, 0)

    def add_levels(lv):
        nonlocal lvl_pos
        if lv is None:
            return -1
        levels.append(np.ascontiguousarray(lv, np.int32).reshape(-1))
        off = lvl_pos
        lvl_pos += levels[-1].size
        return off

    def emit_block(mi_row, mi_col, bsize, bw4):
        op = np.full(OP_COLS, -1, np.int32)
        op[0:4] = (1, mi_row, mi_col, bw4)
        key = (mi_row, mi_col, bsize)
        gref = g_map.get(key)
        if gref is not None and key not in plan.blocks:
            gi, r, c = gref
            g = plan.grids[gi]
            y_mode = _MODES[int(g["modes"][r, c])]
            skip = int(g["skip"][r, c])
            op[4] = y_mode
            op[5] = 0  # uv DC
            op[6] = skip
            op[7] = 3 if is_directional(y_mode) else -1
            op[8] = -1
            op[9:13] = txsig[bsize]
            op[16:20] = (0, 0, 0, 0)
            op[20] = int(SIZE_GROUP[bsize])
            if not skip:
                op[13] = add_levels(g["ly"][r, c])
                op[14] = add_levels(g["lu"][r, c])
                op[15] = add_levels(g["lv"][r, c])
        else:
            d = plan.blocks[key]
            op[4] = d.y_mode
            op[5] = d.uv_mode
            op[6] = d.skip
            if d.is_inter:
                op[7] = op[8] = -1
                ns, _, eset, sqr = txsig_inter[bsize]
                op[9] = ns
                op[10] = int(AV1_EXT_TX_IND[ext_tx_set_type_inter(
                    int(MAX_TXSIZE_RECT[bsize]))][d.tx_type]) if ns else 0
                op[16] = int(d.ref_frame)
                op[17], op[18] = int(d.mv[0]), int(d.mv[1])
                op[19] = int(d.ref_mv_idx)
                op[21] = int(d.ref_frame1)
                op[22], op[23] = int(d.mv1[0]), int(d.mv1[1])
            else:
                op[7] = d.angle_delta_y + 3 if is_directional(d.y_mode) else -1
                op[8] = d.angle_delta_uv + 3 if is_directional(d.uv_mode) else -1
                ns, _, eset, sqr = txsig[bsize]
                op[9] = ns
                op[10] = int(AV1_EXT_TX_IND[ext_tx_set_type_intra(
                    int(MAX_TXSIZE_RECT[bsize]))][d.tx_type]) if ns else 0
                op[16] = 0
                op[17] = op[18] = 0
                op[19] = 0
            op[11] = eset
            op[12] = sqr
            op[20] = int(SIZE_GROUP[bsize])
            if not d.skip:
                op[13] = add_levels(d.levels_y)
                op[14] = add_levels(d.levels_u)
                op[15] = add_levels(d.levels_v)
        ops.append(op)

    def walk(mi_row, mi_col, bsize):
        if mi_row >= p.mi_rows or mi_col >= p.mi_cols:
            return
        bw4 = int(BLOCK_W[bsize]) // 4
        part = int(plan.partitions.get((mi_row, mi_col, bsize), Partition.PARTITION_NONE))
        op = np.full(OP_COLS, -1, np.int32)
        op[0:5] = (0, mi_row, mi_col, bw4, part)
        ops.append(op)
        if part == int(Partition.PARTITION_SPLIT):
            half = bw4 // 2
            from .tile_codec import PARTITION_SUBSIZE_INT

            sub = PARTITION_SUBSIZE_INT[part][bsize]
            for dy in (0, half):
                for dx in (0, half):
                    walk(mi_row + dy, mi_col + dx, sub)
            return
        emit_block(mi_row, mi_col, bsize, bw4)

    def emit_lr(mi_row, mi_col):
        """LR units whose first SB is this SB (tile_codec._code_lr twin):
        op kind 2 = [2, plane, frame_ftype, unit_rtype, wiener taps x6,
        sgr_ep, sgr_xqd0, sgr_xqd1]."""
        from ..filters import restoration as lr

        for plane in range(3):
            ftype = p.lr_types[plane]
            if ftype == lr.RESTORE_NONE:
                continue
            sub = 1 if plane else 0
            usize = p.lr_unit_size(plane)
            ph = (p.height + sub) >> sub
            pw = (p.width + sub) >> sub
            unit_rows = lr.count_units(usize, ph)
            unit_cols = lr.count_units(usize, pw)
            num = 4 >> sub
            ur0 = (mi_row * num + usize - 1) // usize
            ur1 = min(unit_rows, ((mi_row + 16) * num + usize - 1) // usize)
            uc0 = (mi_col * num + usize - 1) // usize
            uc1 = min(unit_cols, ((mi_col + 16) * num + usize - 1) // usize)
            for ur in range(ur0, ur1):
                for uc in range(uc0, uc1):
                    info = plan.lr_units[plane][ur][uc]
                    op = np.full(OP_COLS, -1, np.int32)
                    op[0] = 2
                    op[1] = plane
                    op[2] = int(ftype)
                    op[3] = int(info.rtype)
                    if info.rtype == lr.RESTORE_WIENER:
                        for ps in range(2):
                            for j in range(3):
                                op[4 + ps * 3 + j] = int(info.wiener[ps][j])
                    elif info.rtype == lr.RESTORE_SGRPROJ:
                        op[10] = int(info.sgr_ep)
                        op[11] = int(info.sgr_xqd[0])
                        op[12] = int(info.sgr_xqd[1])
                    ops.append(op)

    from ..constants.av1 import BlockSize

    r0, r1, c0, c1 = sb_range
    for sb_row in range(r0, r1):
        for sb_col in range(c0, c1):
            if p.lr_active:
                emit_lr(sb_row * 16, sb_col * 16)
            walk(sb_row * 16, sb_col * 16, int(BlockSize.BLOCK_64X64))
    ops_arr = np.stack(ops) if ops else np.zeros((0, OP_COLS), np.int32)
    lv_arr = np.concatenate(levels) if levels else np.zeros(1, np.int32)
    return np.ascontiguousarray(ops_arr), np.ascontiguousarray(lv_arr)


def encode_tile_native(p: FrameParams, fc, plan: Plan, sb_range) -> bytes:
    ops, lv = flatten_plan(plan, p, sb_range)
    return run_tile_ops(p, fc, ops, lv, sb_range)


def run_tile_ops(p: FrameParams, fc, ops: np.ndarray, lv: np.ndarray, sb_range) -> bytes:
    """Marshal CDF tables + context state and run the C walker over a
    prebuilt (N, OP_COLS) int32 op stream + int32 levels buffer."""
    lib = native.get_lib()
    assert lib is not None
    lib.ec_encode_tile_ops.argtypes = [ctypes.c_void_p, ctypes.POINTER(_TileParams),
                                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                       ctypes.POINTER(_TileState)]
    lib.ec_encode_tile_ops.restype = ctypes.c_int64

    g = _geometry()
    t = fc.tables
    keep = []  # keep arrays alive

    def cp(a):
        a = np.ascontiguousarray(a, np.int32)
        keep.append(a)
        return _p(a)

    tp = _TileParams()
    tp.partition = cp(t["partition"])
    tp.skip = cp(t["skip"])
    tp.kf_y = cp(t["kf_y_mode"])
    tp.uv_mode = cp(t["uv_mode"])
    tp.angle = cp(t["angle_delta"])
    tp.intra_ext_tx = cp(t["intra_ext_tx"])
    tp.txb_skip = cp(t["txb_skip"])
    for i, nm in enumerate(["eob_flag_16", "eob_flag_32", "eob_flag_64", "eob_flag_128",
                            "eob_flag_256", "eob_flag_512", "eob_flag_1024"]):
        tp.eob_flag[i] = cp(t[nm])
    tp.eob_extra = cp(t["eob_extra"])
    tp.base_eob = cp(t["coeff_base_eob"])
    tp.base = cp(t["coeff_base"])
    tp.br = cp(t["coeff_br"])
    tp.dc_sign = cp(t["dc_sign"])
    for nm in ("y_mode", "intra_inter", "single_ref", "newmv", "zeromv", "refmv",
               "drl", "inter_ext_tx", "nmv_joints", "nmv_sign", "nmv_classes",
               "nmv_class0", "nmv_bits", "nmv_class0_fp", "nmv_fp",
               "nmv_class0_hp", "nmv_hp"):
        setattr(tp, nm, cp(t[nm]))
    for nm, key in (("comp_inter", "comp_inter"), ("comp_ref_type", "comp_ref_type"),
                    ("comp_ref", "comp_ref"), ("comp_bwdref", "comp_bwdref"),
                    ("comp_mode", "inter_compound_mode"),
                    ("wiener_restore", "wiener_restore"),
                    ("sgrproj_restore", "sgrproj_restore"),
                    ("switchable_restore", "switchable_restore")):
        setattr(tp, nm, cp(t[key]))
    tp.scans = _p(g["scans"])
    tp.scan_off = _p(g["scan_off"])
    tp.off2d = _p(g["off2d"])
    tp.off2d_off = _p(g["off2d_off"])
    tp.mi_rows, tp.mi_cols = p.mi_rows, p.mi_cols
    tp.mi_row0, tp.mi_row1 = sb_range[0] * 16, min(sb_range[1] * 16, p.mi_rows)
    tp.mi_col0, tp.mi_col1 = sb_range[2] * 16, min(sb_range[3] * 16, p.mi_cols)
    tp.qindex_positive = int(p.qindex > 0)
    tp.update = int(not p.disable_cdf_update)
    tp.frame_is_intra = int(p.frame_is_intra)
    tp.reference_select = int(p.reference_select)
    for i, b in enumerate(p.sign_bias()):
        tp.sign_bias[i] = int(b)
    for i in range(8):
        tp.gm_mv[i][0] = int(p.gm_mvs[i][0])
        tp.gm_mv[i][1] = int(p.gm_mvs[i][1])

    mc, mr = p.mi_cols, p.mi_rows
    st_bufs = dict(
        above_part=np.zeros(mc, np.uint8), left_part=np.zeros(mr, np.uint8),
        mode_grid=np.full(mr * mc, -1, np.int8), skip_grid=np.zeros(mr * mc, np.uint8),
        ref_grid=np.zeros(mr * mc, np.int8), bsize_grid=np.zeros(mr * mc, np.int8),
        mv_grid=np.zeros(mr * mc * 2, np.int32),
        ref1_grid=np.zeros(mr * mc, np.int8), mv1_grid=np.zeros(mr * mc * 2, np.int32),
        a0=np.zeros(mc, np.int32), a1=np.zeros((mc + 1) >> 1, np.int32), a2=np.zeros((mc + 1) >> 1, np.int32),
        l0=np.zeros(mr, np.int32), l1=np.zeros((mr + 1) >> 1, np.int32), l2=np.zeros((mr + 1) >> 1, np.int32),
    )
    st = _TileState()
    st.above_part = _p(st_bufs["above_part"])
    st.left_part = _p(st_bufs["left_part"])
    st.mode_grid = _p(st_bufs["mode_grid"])
    st.skip_grid = _p(st_bufs["skip_grid"])
    st.ref_grid = _p(st_bufs["ref_grid"])
    st.bsize_grid = _p(st_bufs["bsize_grid"])
    st.mv_grid = _p(st_bufs["mv_grid"])
    st.ref1_grid = _p(st_bufs["ref1_grid"])
    st.mv1_grid = _p(st_bufs["mv1_grid"])
    for i, k in enumerate(["a0", "a1", "a2"]):
        st.above_ctx[i] = _p(st_bufs[k])
    for i, k in enumerate(["l0", "l1", "l2"]):
        st.left_ctx[i] = _p(st_bufs[k])

    ops = np.ascontiguousarray(ops, np.int32)
    lv = np.ascontiguousarray(lv, np.int32)
    ec = lib.ec_create()
    try:
        lib.ec_encode_tile_ops(ec, ctypes.byref(tp), _p(ops), len(ops), _p(lv), ctypes.byref(st))
        cap = 1 << 24
        buf = (ctypes.c_uint8 * cap)()
        n = lib.ec_done(ec, buf, cap)
        assert n >= 0
        return bytes(buf[:n])
    finally:
        lib.ec_free(ec)
