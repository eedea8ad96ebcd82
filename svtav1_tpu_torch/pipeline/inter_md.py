"""Inter (+intra) mode decision for non-key frames — encoder side.

Sequential reference implementation (numpy): recursive partition RD over
square blocks 8..64. Per block it evaluates the single-ref inter candidates
(GLOBALMV / NEARESTMV / NEARMV from the normative MV stack, NEWMV from a
full-pel + subpel motion search) against the intra modes, with closed-loop
recon identical to the decoder's. Behavioral reference:
product_coding_loop.c md_encode_block candidate classes and
motion_estimation.c full-pel search (re-architected: fixed small candidate
set, exhaustive windows instead of pruned searches).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..codec import rate as rate_mod
from ..codec import txb as txb_mod
from ..codec.mvp import MiState, TileBounds, find_mv_stack
from ..codec.tile_codec import (AV1_EXT_TX_USED, BlockDecision, FrameParams, Plan, chroma_tx_type,
                                chroma_tx_type_inter, ext_tx_set_type_inter, ext_tx_set_type_intra,
                                is_directional, max_uv_txsize)
from ..constants.av1 import (BLOCK_W, MAX_TXSIZE_RECT, TX_H, TX_W, BlockSize, InterMode, Partition, PredMode,
                             RefFrame, TxType)
from ..ops import convolve as conv_ops
from ..ops import quantize as quant_ops
from ..ops import transforms as txfm_ops
from .intra_md import BSIZE_OF, MODES, predict_block, rd_lambda

SEARCH_RANGE = 12  # full-pel search radius around the MV predictor


@dataclass
class _Ctx:
    params: FrameParams
    src: list
    recon: list
    refs: dict  # ref_frame id -> [y, u, v] planes
    plan: Plan
    lam: float
    mi: MiState
    tile: TileBounds
    sbias: object = None  # RefFrameSignBias (must match the tile walk's)
    fc: object = None  # FrameContext (default CDFs) for rate estimation


def _mc_pred(ctx: _Ctx, ref_frame: int, plane: int, px: int, py: int, psz: int, mv) -> np.ndarray:
    refp = ctx.refs[ref_frame][plane]
    mvy, mvx = int(mv[0]), int(mv[1])
    if plane == 0:
        mvy, mvx = mvy * 2, mvx * 2
    return conv_ops.convolve_2d_scalar(refp, px, py, psz, psz, mvx, mvy,
                                       which=ctx.params.interp_filter, bd=ctx.params.bd)


def _sad(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(np.int64) - b).sum())


def _fullpel_search(ctx: _Ctx, x: int, y: int, size: int, center_mv, ref_frame: int) -> tuple:
    """Exhaustive full-pel SAD search in a window around center_mv (1/8 pel).
    Returns best full-pel mv (1/8 units)."""
    ref = ctx.refs[ref_frame][0]
    srcb = ctx.src[0][y : y + size, x : x + size]
    H, W = ref.shape
    cy = y + (int(center_mv[0]) >> 3)
    cx = x + (int(center_mv[1]) >> 3)
    r = SEARCH_RANGE
    y0, y1 = max(0, cy - r), min(H - size, cy + r)
    x0, x1 = max(0, cx - r), min(W - size, cx + r)
    if y1 < y0 or x1 < x0:
        return (0, 0)
    # sliding-window SAD via stride tricks over the clipped window; large
    # blocks use 2x-decimated SADs (reference sub-sampled SAD speed feature)
    win = ref[y0 : y1 + size, x0 : x1 + size]
    from numpy.lib.stride_tricks import sliding_window_view

    views = sliding_window_view(win, (size, size))
    if size >= 32:
        views = views[:, :, ::2, ::2]
        srcb = srcb[::2, ::2]
    sads = np.abs(views.astype(np.int32) - srcb.astype(np.int32)).sum(axis=(2, 3))
    # bias toward the predictor: tiny mv-cost on the full-pel grid
    dy = (np.arange(y0, y1 + 1) - cy)[:, None]
    dx = (np.arange(x0, x1 + 1) - cx)[None, :]
    cost = sads + (np.abs(dy) + np.abs(dx)) * 4
    by, bx = np.unravel_index(np.argmin(cost), cost.shape)
    return ((y0 + int(by) - y) * 8, (x0 + int(bx) - x) * 8)


def _subpel_refine(ctx: _Ctx, x: int, y: int, size: int, mv, ref_frame: int) -> tuple:
    """Two-stage (1/2 then 1/4 pel) 8-neighbor refinement by luma SAD."""
    srcb = ctx.src[0][y : y + size, x : x + size]
    best = (int(mv[0]), int(mv[1]))
    best_sad = _sad(_mc_pred(ctx, ref_frame, 0, x, y, size, best), srcb)
    for step in (4, 2):  # 1/8-pel units: half-pel, quarter-pel
        improved = True
        while improved:
            improved = False
            for dy in (-step, 0, step):
                for dx in (-step, 0, step):
                    if dy == 0 and dx == 0:
                        continue
                    cand = (best[0] + dy, best[1] + dx)
                    s = _sad(_mc_pred(ctx, ref_frame, 0, x, y, size, cand), srcb)
                    if s < best_sad:
                        best_sad, best = s, cand
                        improved = True
    return best


def _code_unit(ctx: _Ctx, x: int, y: int, size: int, d: BlockDecision, write: bool):
    """Predict/transform/quantize one block for decision d; optionally commit.

    Returns (sse, bits_estimate, levels, all_zero). Bits are real CDF-based
    counts from the txb writer plus the candidate's mode bits."""
    p = ctx.params
    bsize = BSIZE_OF[size]
    tx_y = int(MAX_TXSIZE_RECT[int(bsize)])
    tx_uv = int(max_uv_txsize(int(bsize)))
    total_sse = 0.0
    txb_bits_sum = 0.0
    levels_out = []
    all_zero = True
    planes_recon = []
    eff_luma_tx = int(TxType.DCT_DCT)
    for plane in range(3):
        ss = 0 if plane == 0 else 1
        px, py, psz = x >> ss, y >> ss, size >> ss
        tx_size = tx_y if plane == 0 else tx_uv
        if d.is_inter:
            pred = _mc_pred(ctx, d.ref_frame, plane, px, py, psz, d.mv)
            tx_type = int(d.tx_type) if plane == 0 else chroma_tx_type_inter(eff_luma_tx, tx_size)
        else:
            m = d.y_mode if plane == 0 else d.uv_mode
            pred = predict_block(ctx.recon[plane], px, py, psz, psz, int(m), p, ss, int(bsize))
            tx_type = int(d.tx_type) if plane == 0 else chroma_tx_type(d.uv_mode, tx_size)
        target = ctx.src[plane][py : py + psz, px : px + psz]
        resid = (target - pred).astype(np.int32)
        coeff = txfm_ops.fwd_txfm2d_np(resid[None], tx_type, p.bd)[0]
        lv_full = quant_ops.quantize_np(coeff, p.qindex, psz, psz, p.bd)
        adj = txb_mod.adjusted_tx_size(tx_size)
        lv = lv_full[: int(TX_H[adj]), : int(TX_W[adj])]
        if plane == 0:
            eff_luma_tx = int(d.tx_type) if np.any(lv != 0) else int(TxType.DCT_DCT)
        dq = quant_ops.dequantize_np(lv_full, p.qindex, psz, psz, p.bd)
        recon_blk = txfm_ops.inv_txfm2d_add_np(dq[None], pred[None], tx_type, p.bd)[0]
        sse = float(((recon_blk - target).astype(np.float64) ** 2).sum())
        txb_bits_sum += rate_mod.txb_bits(ctx.fc, lv, tx_size, tx_type, int(plane > 0),
                                          0 if plane == 0 else 7, 0)
        total_sse += sse
        levels_out.append(lv.copy())
        planes_recon.append(recon_blk)
        if np.any(lv != 0):
            all_zero = False
    mode_bits = getattr(d, "_mode_bits", 8.0)
    # skip=1 replaces all txb syntax with a single skip flag
    total_bits = mode_bits + 1.0 + (0.0 if all_zero else txb_bits_sum)
    if write:
        for plane in range(3):
            ss = 0 if plane == 0 else 1
            px, py, psz = x >> ss, y >> ss, size >> ss
            ctx.recon[plane][py : py + psz, px : px + psz] = planes_recon[plane]
    return total_sse, total_bits, levels_out, all_zero, planes_recon


def _inter_candidates(ctx: _Ctx, x: int, y: int, size: int, ref_frame: int):
    """Candidate (mode, mv, ref_mv_idx, mode_bits) list from the MV stack."""
    mi_row, mi_col = y // 4, x // 4
    bsize = int(BSIZE_OF[size])
    stack = find_mv_stack(ctx.mi, ctx.tile, mi_row, mi_col, bsize, ref_frame, ctx.sbias)
    fc = ctx.fc
    M = InterMode
    sb = rate_mod.symbol_bits
    ref_bits = rate_mod.single_ref_bits(fc, ref_frame)
    b_new = sb(fc["newmv"][stack.new_mv_ctx], 0, 2)
    b_not_new = sb(fc["newmv"][stack.new_mv_ctx], 1, 2)
    b_glob = b_not_new + sb(fc["zeromv"][stack.zero_mv_ctx], 0, 2)
    b_not_glob = b_not_new + sb(fc["zeromv"][stack.zero_mv_ctx], 1, 2)
    b_nearest = b_not_glob + sb(fc["refmv"][stack.ref_mv_ctx], 0, 2)
    b_near = b_not_glob + sb(fc["refmv"][stack.ref_mv_ctx], 1, 2) + (1.0 if stack.count > 2 else 0.0)

    cands = [(int(M.GLOBALMV), (0, 0), 0, ref_bits + b_glob)]
    nearest = (int(stack.mvs[0][0]), int(stack.mvs[0][1]))
    cands.append((int(M.NEARESTMV), nearest, 0, ref_bits + b_nearest))
    near = (int(stack.mvs[1][0]), int(stack.mvs[1][1]))
    if near != nearest:
        cands.append((int(M.NEARMV), near, 1, ref_bits + b_near))
    # NEWMV: full-pel search centered on the class predictor + subpel refine
    pred = stack.pred_mv(0)
    fp = _fullpel_search(ctx, x, y, size, pred, ref_frame)
    mv = _subpel_refine(ctx, x, y, size, fp, ref_frame)
    drl_bits = 1.0 if stack.count > 1 else 0.0
    cands.append((int(M.NEWMV), mv, 0,
                  ref_bits + b_new + drl_bits + rate_mod.mv_bits(fc, mv, pred)))
    return cands


def _fast_cost(ctx: _Ctx, x: int, y: int, size: int, d: BlockDecision) -> float:
    """Stage-0 cost: luma-only prediction SAD + mode-bits proxy (analog of
    product_coding_loop.c md_stage_0 fast cost)."""
    p = ctx.params
    if d.is_inter:
        pred = _mc_pred(ctx, d.ref_frame, 0, x, y, size, d.mv)
    else:
        pred = predict_block(ctx.recon[0], x, y, size, size, int(d.y_mode), p, 0,
                             int(BSIZE_OF[size]))
    sad = _sad(pred, ctx.src[0][y : y + size, x : x + size])
    return sad + np.sqrt(max(ctx.lam, 1.0)) * getattr(d, "_mode_bits", 8.0)


FULL_RD_CANDIDATES = 3  # stage-1 finalist count


def _best_for_block(ctx: _Ctx, x: int, y: int, size: int):
    """Two-stage candidate funnel (md_stage_0 fast cost -> full RD on the
    finalists; reference product_coding_loop.c md_encode_block)."""
    fc = ctx.fc
    cands = []
    b_inter = rate_mod.symbol_bits(fc["intra_inter"][0], 1, 2)
    for ref_frame in ctx.refs:
        for mode, mv, rmi, mode_bits in _inter_candidates(ctx, x, y, size, ref_frame):
            d = BlockDecision(y_mode=mode, ref_frame=ref_frame, mv=mv, ref_mv_idx=rmi)
            d._mode_bits = b_inter + mode_bits
            cands.append(d)
    bsize = int(BSIZE_OF[size])
    from ..constants.av1 import SIZE_GROUP

    b_intra = rate_mod.symbol_bits(fc["intra_inter"][0], 0, 2)
    cfl_allowed = int(size <= 32)
    for mode in MODES:
        d = BlockDecision(y_mode=int(mode), uv_mode=int(mode))
        d._mode_bits = (b_intra
                        + rate_mod.symbol_bits(fc["y_mode"][int(SIZE_GROUP[bsize])], int(mode), 13)
                        + rate_mod.symbol_bits(fc["uv_mode"][cfl_allowed][int(mode)], int(mode),
                                               14 if cfl_allowed else 13))
        cands.append(d)
    scored = sorted(cands, key=lambda d: _fast_cost(ctx, x, y, size, d))
    tx_y = int(MAX_TXSIZE_RECT[bsize])

    def txt_bits(d, zero):
        # tx type is only signaled when the luma txb is non-zero
        if zero:
            return 0.0
        return rate_mod.txtype_signal_bits(fc, tx_y, int(d.tx_type), d.is_inter,
                                           int(d.y_mode))

    best = None
    for d in scored[:FULL_RD_CANDIDATES]:
        sse, bits, levels, zero, recon_blks = _code_unit(ctx, x, y, size, d, write=False)
        cost = sse + ctx.lam * (bits + txt_bits(d, zero))
        if best is None or cost < best[0]:
            best = (cost, d, (sse, bits, levels, zero, recon_blks))
    # luma tx-type search on the winner (Appendix-TX-Search analog)
    import dataclasses

    d = best[1]
    for tx_type in tx_type_candidates(size, d.is_inter):
        d2 = dataclasses.replace(d, tx_type=tx_type)
        d2._mode_bits = getattr(d, "_mode_bits", 8.0)
        sse, bits, levels, zero, recon_blks = _code_unit(ctx, x, y, size, d2, write=False)
        cost = sse + ctx.lam * (bits + txt_bits(d2, zero))
        if cost < best[0]:
            best = (cost, d2, (sse, bits, levels, zero, recon_blks))
    return best


def tx_type_candidates(size: int, is_inter: bool):
    """Non-DCT luma tx types allowed for this (square) block size."""
    from ..constants.av1 import MAX_TXSIZE_RECT

    tx_size = int(MAX_TXSIZE_RECT[int(BSIZE_OF[size])])
    set_type = ext_tx_set_type_inter(tx_size) if is_inter else ext_tx_set_type_intra(tx_size)
    out = []
    for t in (int(TxType.ADST_ADST), int(TxType.ADST_DCT), int(TxType.DCT_ADST)):
        if AV1_EXT_TX_USED[set_type][t]:
            out.append(t)
    return out


def _commit_block(ctx: _Ctx, x: int, y: int, size: int, d: BlockDecision, cached=None) -> float:
    if cached is not None:
        # re-use the open-loop evaluation (recon state is unchanged)
        sse, bits, levels, zero, recon_blks = cached
        for plane in range(3):
            ss = 0 if plane == 0 else 1
            px, py, psz = x >> ss, y >> ss, size >> ss
            ctx.recon[plane][py : py + psz, px : px + psz] = recon_blks[plane]
    else:
        sse, bits, levels, zero, _ = _code_unit(ctx, x, y, size, d, write=True)
    d.skip = int(zero)
    d.levels_y = levels[0] if not zero else None
    d.levels_u = levels[1] if not zero else None
    d.levels_v = levels[2] if not zero else None
    mi_row, mi_col = y // 4, x // 4
    bsize = int(BSIZE_OF[size])
    ctx.plan.partitions[(mi_row, mi_col, bsize)] = int(Partition.PARTITION_NONE)
    ctx.plan.blocks[(mi_row, mi_col, bsize)] = d
    ctx.mi.set_block(mi_row, mi_col, bsize, d.y_mode, d.ref_frame, int(RefFrame.NONE),
                     (int(d.mv[0]), int(d.mv[1])), skip=d.skip)
    return sse + ctx.lam * bits


def _code_square(ctx: _Ctx, x: int, y: int, size: int) -> float:
    p = ctx.params
    mi_row, mi_col = y // 4, x // 4
    bsize = BSIZE_OF[size]

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

    snap_recon = [r.copy() for r in ctx.recon]
    snap_mi = ctx.mi.snapshot()
    cost_none, d, cached = _best_for_block(ctx, x, y, size)
    cost_none = _commit_block(ctx, x, y, size, d, cached)

    # all-zero inter block at this size: deeper partitions cannot beat it
    # (classic skip-based depth pruning, enc_mode_config.c depth refinement)
    if d.is_inter and d.skip:
        ctx.plan.partitions[(mi_row, mi_col, int(bsize))] = int(Partition.PARTITION_NONE)
        return cost_none

    if size > 8:
        recon_none = [r.copy() for r in ctx.recon]
        mi_none = ctx.mi.snapshot()
        for i, r in enumerate(ctx.recon):
            r[:] = snap_recon[i]
        ctx.mi.restore(snap_mi)
        half = size // 2
        cost_split = ctx.lam * rate_mod.partition_bits(ctx.fc, size, split=True)
        cost_none = cost_none + ctx.lam * rate_mod.partition_bits(ctx.fc, size, split=False)
        for dy in (0, half):
            for dx in (0, half):
                cost_split += _code_square(ctx, x + dx, y + dy, half)
        if cost_split < cost_none:
            ctx.plan.partitions[(mi_row, mi_col, int(bsize))] = int(Partition.PARTITION_SPLIT)
            return cost_split
        for i, r in enumerate(ctx.recon):
            r[:] = recon_none[i]
        ctx.mi.restore(mi_none)
        from .intra_md import _drop_subtree

        _drop_subtree(ctx.plan, mi_row, mi_col, size)
        ctx.plan.partitions[(mi_row, mi_col, int(bsize))] = int(Partition.PARTITION_NONE)
    return cost_none


def encode_inter_frame(src_planes: list, params: FrameParams, refs: dict) -> tuple[Plan, list]:
    """Mode decision for one inter (low-delay P) frame.

    refs: ref_frame id -> [y, u, v] recon planes of the reference."""
    p = params
    recon = [np.zeros_like(pl) for pl in src_planes]
    mi = MiState(p.mi_rows, p.mi_cols)
    tile = TileBounds(0, p.mi_rows, 0, p.mi_cols)
    from ..constants.cdf import FrameContext

    ctx = _Ctx(params=p, src=src_planes, recon=recon, refs=refs, plan=Plan(),
               lam=rd_lambda(p.qindex, p.bd), mi=mi, tile=tile, sbias=p.sign_bias(),
               fc=FrameContext(p.qindex))
    for sb_y in range(0, p.aligned_height, 64):
        for sb_x in range(0, p.aligned_width, 64):
            _code_square(ctx, sb_x, sb_y, 64)
    return ctx.plan, recon
