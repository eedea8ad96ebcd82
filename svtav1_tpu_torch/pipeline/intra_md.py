"""Intra mode decision + reconstruction (encoder side).

Sequential reference implementation (numpy): recursive partition RD over
square blocks 8..64, mode search over the non-directional intra modes,
closed-loop recon identical to the decoder's. This is the behavioral model
for the batched JAX wavefront MD (pipeline/intra_device.py); reference
behavior: product_coding_loop.c md_encode_block / svt_aom_mode_decision_sb.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..codec import txb as txb_mod
from ..codec.tile_codec import (BlockDecision, FrameParams, Plan, chroma_tx_type, max_uv_txsize)
from ..constants.av1 import BLOCK_W, MAX_TXSIZE_RECT, TX_H, TX_W, BlockSize, Partition, PredMode, TxType
from ..codec.tile_codec import is_directional
from ..ops import intra as intra_ops
from ..ops import quantize as quant_ops
from ..ops import transforms as txfm_ops


def predict_block(recon, px, py, pw, ph, mode, p, ss, bsize):
    """Prediction incl. directional modes, frame-wide (single tile)."""
    ha, hl = py > 0, px > 0
    angle = intra_ops.MODE_ANGLE[mode] if is_directional(mode) else 0
    if angle and angle != 90 and angle != 180:
        x, y = px << ss, py << ss
        mi_row, mi_col = y // 4, x // 4
        from ..constants.av1 import BLOCK_H, BLOCK_W

        bw4, bh4 = int(BLOCK_W[bsize]) // 4, int(BLOCK_H[bsize]) // 4
        right_av = (mi_col + bw4) < p.mi_cols
        xr = (p.mi_cols * 4 - (x + int(BLOCK_W[bsize]))) >> ss
        yd = (p.mi_rows * 4 - (y + int(BLOCK_H[bsize]))) >> ss
        bottom_av = yd > 0 and (mi_row + bh4) < p.mi_rows
        has_tr = intra_ops.intra_has_top_right(bsize, mi_row, mi_col, ha, right_av)
        has_bl = intra_ops.intra_has_bottom_left(bsize, mi_row, mi_col, bottom_av, hl)
        n_tr = min(pw, xr) if has_tr else 0
        n_bl = min(ph, yd) if has_bl else 0
        ae, le, tl = intra_ops.build_edges_ext(recon, px, py, pw, ph, p.bd, ha, hl, n_tr, n_bl)
        return intra_ops.dr_pred(ae[None], le[None], np.array([tl]), angle, pw, ph)[0]
    above, left, tl = intra_ops.build_edges(recon, px, py, pw, ph, p.bd, ha, hl)
    return intra_ops.predict(mode, above[None], left[None], np.array([tl]), ha, hl, p.bd)[0]

MODES = [PredMode.DC_PRED, PredMode.V_PRED, PredMode.H_PRED, PredMode.SMOOTH_PRED,
         PredMode.SMOOTH_V_PRED, PredMode.SMOOTH_H_PRED, PredMode.PAETH_PRED,
         PredMode.D45_PRED, PredMode.D135_PRED, PredMode.D113_PRED,
         PredMode.D157_PRED, PredMode.D203_PRED, PredMode.D67_PRED]

BSIZE_OF = {8: BlockSize.BLOCK_8X8, 16: BlockSize.BLOCK_16X16, 32: BlockSize.BLOCK_32X32, 64: BlockSize.BLOCK_64X64}


def rd_lambda(qindex: int, bd: int = 8) -> float:
    """RD lambda in (SSE, bits) units — classic q^2 scaling (rd_cost.c analog)."""
    q = quant_ops.ac_q(qindex, bd) / 8.0
    return 0.12 * q * q


@dataclass
class _Ctx:
    params: FrameParams
    src: list  # [y, u, v] source planes (aligned dims, int32)
    recon: list  # planes being built
    plan: Plan
    lam: float
    fc: object = None  # FrameContext (default CDFs) for rate estimation


def _code_unit(ctx: _Ctx, x: int, y: int, size: int, mode: int, uv_mode: int, write: bool,
               tx_type_y: int = int(TxType.DCT_DCT), fi_mode=None):
    """Predict/transform/quantize one block; if write, commit recon + plan.

    Returns (sse, bits_estimate, levels_per_plane, all_zero)."""
    p = ctx.params
    bsize = BSIZE_OF[size]
    tx_y = int(MAX_TXSIZE_RECT[int(bsize)])
    tx_uv = int(max_uv_txsize(int(bsize)))
    total_sse = 0.0
    total_bits = 0.0  # mode-signaling bits added by the caller (exact CDFs)
    levels_out = []
    all_zero = True
    planes_recon = []
    for plane in range(3):
        ss = 0 if plane == 0 else 1
        px, py, psz = x >> ss, y >> ss, size >> ss
        tx_size = tx_y if plane == 0 else tx_uv
        m = mode if plane == 0 else uv_mode
        tx_type = int(tx_type_y) if plane == 0 else chroma_tx_type(uv_mode, tx_size)
        rec = ctx.recon[plane]
        srcp = ctx.src[plane]
        if plane == 0 and fi_mode is not None:
            above, left, tl = intra_ops.build_edges(rec, px, py, psz, psz, p.bd, py > 0, px > 0)
            pred = intra_ops.filter_intra_pred(above, left, int(tl), fi_mode, psz, psz, p.bd)
        else:
            pred = predict_block(rec, px, py, psz, psz, int(m), p, ss, int(bsize))
        target = srcp[py : py + psz, px : px + psz]
        resid = (target - pred).astype(np.int32)
        coeff = txfm_ops.fwd_txfm2d_np(resid[None], tx_type, p.bd)[0]
        lv_full = quant_ops.quantize_np(coeff, p.qindex, psz, psz, p.bd)
        adj = txb_mod.adjusted_tx_size(tx_size)
        ah, aw = int(TX_H[adj]), int(TX_W[adj])
        lv = lv_full[:ah, :aw]
        # fwd already zeroes outside the adjusted (<=32x32) region for 64-pt dims
        dq = quant_ops.dequantize_np(lv_full, p.qindex, psz, psz, p.bd)
        recon_blk = txfm_ops.inv_txfm2d_add_np(dq[None], pred[None], tx_type, p.bd)[0]
        sse = float(((recon_blk - target).astype(np.float64) ** 2).sum())
        if ctx.fc is not None:
            from ..codec import rate as rate_mod

            bits = rate_mod.txb_bits(ctx.fc, lv, tx_size, tx_type, int(plane > 0),
                                     0 if plane == 0 else 7, 0)
        else:
            nz = int(np.count_nonzero(lv))
            bits = 2.0 + nz * 3.0 + 2.0 * np.log2(1.0 + float(np.abs(lv).sum()))
        total_sse += sse
        total_bits += bits
        levels_out.append(lv.copy())
        if np.any(lv != 0):
            all_zero = False
        planes_recon.append(recon_blk)
        if write:
            rec[py : py + psz, px : px + psz] = recon_blk
    return total_sse, total_bits, levels_out, all_zero, planes_recon


def _best_mode_for_block(ctx: _Ctx, x: int, y: int, size: int):
    """Two-stage mode search: luma-SAD ranking, full RD on the finalists
    (md_stage_0 fast cost -> md_stage_3 full loop)."""
    p = ctx.params
    target = ctx.src[0][y : y + size, x : x + size]
    scored = []
    for mode in MODES:
        pred = predict_block(ctx.recon[0], x, y, size, size, int(mode), p, 0, int(BSIZE_OF[size]))
        sad = float(np.abs(pred.astype(np.int64) - target).sum())
        scored.append((sad, int(mode)))
    # filter-intra candidates join the stage-0 ranking (DC blocks <= 32)
    dcm = int(PredMode.DC_PRED)
    if ctx.params.enable_filter_intra and size <= 32:
        for k in range(intra_ops.FILTER_INTRA_MODES):
            above, left, tl = intra_ops.build_edges(ctx.recon[0], x, y, size, size,
                                                    p.bd, y > 0, x > 0)
            pred = intra_ops.filter_intra_pred(above, left, int(tl), k, size, size, p.bd)
            sad = float(np.abs(pred.astype(np.int64) - target).sum())
            scored.append((sad, dcm, k))
    scored = [(s[0], s[1], s[2] if len(s) > 2 else None) for s in scored]
    scored.sort(key=lambda t: t[0])
    from ..codec import rate as rate_mod

    tx_y = int(MAX_TXSIZE_RECT[int(BSIZE_OF[size])])

    def txt_bits(tx, mode, zero):
        # tx type is only signaled when the luma txb is non-zero
        if zero or ctx.fc is None:
            return 0.0
        return rate_mod.txtype_signal_bits(ctx.fc, tx_y, int(tx), False, int(mode))

    best = None
    for _, mode, fi in scored[:3]:
        mbits = _intra_mode_bits(ctx, size, mode, fi)
        sse, bits, levels, zero, rb = _code_unit(ctx, x, y, size, mode, mode, write=False, fi_mode=fi)
        cost = sse + ctx.lam * (bits + mbits + txt_bits(TxType.DCT_DCT, mode, zero))
        if best is None or cost < best[0]:
            best = (cost, mode, levels, zero, int(TxType.DCT_DCT), rb, fi)
    # luma tx-type search on the winning mode
    from .inter_md import tx_type_candidates

    mode = best[1]
    if best[6] is None:  # tx-type search skipped for filter-intra winners
        mbits = _intra_mode_bits(ctx, size, mode, None)
        for tx in tx_type_candidates(size, is_inter=False):
            sse, bits, levels, zero, rb = _code_unit(ctx, x, y, size, mode, mode, write=False, tx_type_y=tx)
            cost = sse + ctx.lam * (bits + mbits + txt_bits(tx, mode, zero))
            if cost < best[0]:
                best = (cost, mode, levels, zero, tx, rb, None)
    return best


def _intra_mode_bits(ctx: "_Ctx", size: int, mode: int, fi) -> float:
    """Key-frame mode-signaling bits (ctx-0 approximation, exact CDFs):
    kf y mode + zero angle deltas for directional modes + uv mode (uv == y)
    + filter-intra syntax (entropy_coding.c write_intra_* twins)."""
    fc = ctx.fc
    if fc is None:
        return 16.0
    from ..codec import rate as rate_mod

    bsize = int(BSIZE_OF[size])
    b = rate_mod.symbol_bits(fc["kf_y_mode"][0][0], int(mode), 13)
    if is_directional(mode):
        ad = fc["angle_delta"][int(mode) - int(PredMode.V_PRED)]
        b += 2.0 * rate_mod.symbol_bits(ad, 3, 7)  # zero delta, y then uv
    cfl_allowed = int(size <= 32)
    b += rate_mod.symbol_bits(fc["uv_mode"][cfl_allowed][int(mode)], int(mode),
                              14 if cfl_allowed else 13)
    if (ctx.params.enable_filter_intra and int(mode) == int(PredMode.DC_PRED)
            and size <= 32):
        b += rate_mod.symbol_bits(fc["filter_intra"][bsize], int(fi is not None), 2)
        if fi is not None:
            b += rate_mod.symbol_bits(fc["filter_intra_mode"], int(fi), 5)
    return b


def _code_square(ctx: _Ctx, x: int, y: int, size: int) -> float:
    """Recursive partition RD. Commits recon+plan for the winning choice."""
    p = ctx.params
    mi_row, mi_col = y // 4, x // 4
    bsize = BSIZE_OF[size]

    # blocks that stick out of the mi grid must SPLIT (no NONE choice)
    fits = (x + size <= p.aligned_width) and (y + size <= p.aligned_height)
    if not fits:
        assert size > 8
        half = size // 2
        cost_split = 0.0
        for dy in (0, half):
            for dx in (0, half):
                sx, sy = x + dx, y + dy
                if sx // 4 >= p.mi_cols or sy // 4 >= p.mi_rows:
                    continue
                cost_split += _code_square(ctx, sx, sy, half)
        ctx.plan.partitions[(mi_row, mi_col, int(bsize))] = int(Partition.PARTITION_SPLIT)
        return cost_split

    # candidate NONE on a snapshot
    snap = [r.copy() for r in ctx.recon]
    best = _best_mode_for_block(ctx, x, y, size)
    cost_none, mode, levels, zero, tx_y, recon_blks, fi = best
    # commit NONE from the cached open-loop evaluation
    for plane in range(3):
        ss = 0 if plane == 0 else 1
        px, py, psz = x >> ss, y >> ss, size >> ss
        ctx.recon[plane][py : py + psz, px : px + psz] = recon_blks[plane]

    if size > 8:
        recon_none = [r.copy() for r in ctx.recon]
        # try SPLIT from snapshot
        for i, r in enumerate(ctx.recon):
            r[:] = snap[i]
        half = size // 2
        from ..codec import rate as rate_mod

        if ctx.fc is not None:
            cost_split = ctx.lam * rate_mod.partition_bits(ctx.fc, size, split=True)
            cost_none = cost_none + ctx.lam * rate_mod.partition_bits(ctx.fc, size, split=False)
        else:
            cost_split = ctx.lam * 4.0
        sub_keys = []
        for dy in (0, half):
            for dx in (0, half):
                sx, sy = x + dx, y + dy
                if sx // 4 >= p.mi_cols or sy // 4 >= p.mi_rows:
                    continue
                cost_split += _code_square(ctx, sx, sy, half)
        if cost_split < cost_none:
            ctx.plan.partitions[(mi_row, mi_col, int(bsize))] = int(Partition.PARTITION_SPLIT)
            return cost_split
        # undo split decisions: restore recon and drop sub-plan entries
        for i, r in enumerate(ctx.recon):
            r[:] = recon_none[i]
        _drop_subtree(ctx.plan, mi_row, mi_col, size)

    ctx.plan.partitions[(mi_row, mi_col, int(bsize))] = int(Partition.PARTITION_NONE)
    ctx.plan.blocks[(mi_row, mi_col, int(bsize))] = BlockDecision(
        y_mode=mode, uv_mode=mode, skip=int(zero), tx_type=int(tx_y),
        use_filter_intra=int(fi is not None), filter_intra_mode=fi if fi is not None else 0,
        levels_y=levels[0] if not zero else None,
        levels_u=levels[1] if not zero else None,
        levels_v=levels[2] if not zero else None,
    )
    return cost_none


def _drop_subtree(plan: Plan, mi_row: int, mi_col: int, size: int) -> None:
    span = size // 4
    for key in [k for k in plan.partitions if mi_row <= k[0] < mi_row + span and mi_col <= k[1] < mi_col + span
                and BLOCK_W[k[2]] < size]:
        del plan.partitions[key]
    for key in [k for k in plan.blocks if mi_row <= k[0] < mi_row + span and mi_col <= k[1] < mi_col + span
                and BLOCK_W[k[2]] < size]:
        del plan.blocks[key]


def encode_intra_frame(src_planes: list, params: FrameParams) -> tuple[Plan, list]:
    """Mode decision for a whole intra frame.

    src_planes: [y, u, v] int32 planes at aligned dims.
    Returns (plan, recon_planes)."""
    p = params
    recon = [np.zeros_like(pl) for pl in src_planes]
    from ..constants.cdf import FrameContext

    ctx = _Ctx(params=p, src=src_planes, recon=recon, plan=Plan(), lam=rd_lambda(p.qindex, p.bd),
               fc=FrameContext(p.qindex))
    for sb_y in range(0, p.aligned_height, 64):
        for sb_x in range(0, p.aligned_width, 64):
            _code_square(ctx, sb_x, sb_y, 64)
    return ctx.plan, recon
