"""Device inter frame pipeline (PyTorch): batched ME + MC + mode decision,
ported from svtav1_tpu's pipeline/inter_device.py for low-delay P frames and
hierarchical-B frames.

One decide program per frame computes, for every square block of every size
8..64,

  - hierarchical full-pel ME with per-size SAD-tree aggregation (K8) and
    the subpel search with the winner's normative prediction (K9) against
    each reference (ops/me_torch),
  - full open-loop RD (K2 transform/quant/recon, K3 exact CDF txb rates)
    for the NEWMV candidate per reference, the GLOBALMV candidate on the
    first reference (K10 MC when the frame's global MV is not zero) and,
    in hierarchical-B middles, the compound NEW_NEWMV candidate on (LAST,
    ALTREF) at the two NEWMV vectors, the luma tx-type search on the
    winner, chroma at the winning (first) MV (K10),
  - the intra candidates (device_decide._decide_intra_size, sf_nmodes_inter
    modes), and the per-block winner (intra vs inter).

Mode-rate contexts use the neighbour-free approximation (ctx 0, empty
neighbour ref counts); coded inter modes are NEWMV (or GLOBALMV at the
global MV) and NEW_NEWMV; the normative MVP stack is built by the tile walk
at write time.

Partition RD and the commit are shared with the intra pipeline
(device_decide.partition_dp, device_commit.commit_regions, whose phase A
codes the inter blocks from K10 predictions, and the compound blocks from
K11's). A frame runs in three phases so that its host work can overlap the
next frame's device work: inter_start_decide, inter_start_commit (the DPB
planes stay on the device) and inter_finish. The restoration route instead
follows inter_start_decide with inter_commit_restoration: the commit and
its filters, the recon on the host for the restoration search.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..codec import rate as rate_np
from ..codec import rate_torch
from ..codec.tile_codec import FrameParams
from ..constants.av1 import RefFrame, TxType
from ..ops import me_torch
from ..utils import profiler
from . import device_decide
from .device_decide import MODES, SIZES, TX_SEARCH, _blocks_of, _eval_txfm

MAX_MV_ABS = 4094  # 1/8-pel component clamp (within spec MV range, even)


def single_ref_tree_bits(fc, ref_id: int) -> float:
    """single-ref tree signaling bits for one RefFrame id, with the
    empty-neighbor-count context approximation (every _ref_ctx() = 1 —
    tile_codec._ref_ctx with zero counts)."""
    sb = rate_np.symbol_bits
    bits = 0.0
    bit0 = ref_id >= int(RefFrame.BWDREF_FRAME)
    bits += sb(fc["single_ref"][1][0], int(bit0), 2)
    if bit0:
        b = ref_id == int(RefFrame.ALTREF_FRAME)
        bits += sb(fc["single_ref"][1][1], int(b), 2)
        if not b:
            bits += sb(fc["single_ref"][1][5], int(ref_id == int(RefFrame.ALTREF2_FRAME)), 2)
    else:
        b = ref_id in (int(RefFrame.LAST3_FRAME), int(RefFrame.GOLDEN_FRAME))
        bits += sb(fc["single_ref"][1][2], int(b), 2)
        if b:
            bits += sb(fc["single_ref"][1][4], int(ref_id == int(RefFrame.GOLDEN_FRAME)), 2)
        else:
            bits += sb(fc["single_ref"][1][3], int(ref_id == int(RefFrame.LAST2_FRAME)), 2)
    return bits


def inter_cand_cost_const(fc, ref_ids, ref_select: bool = False, comp_pair=None) -> dict:
    """Mode-signaling bit constants for the decide pass (ctx-0 / empty
    neighbor-ref-count approximations; exact contexts are applied by the
    tile walk): is_inter flag + single-ref tree per ref + {new,glob} mode
    flags. ref_ids: the RefFrame id per stacked ref index. With
    reference_select, single candidates pay the comp_inter=0 bit, and with a
    comp_pair `comp` carries the compound NEW_NEWMV signaling constant
    (comp_inter=1 + BIDIR ref pair + inter_compound_mode symbol)."""
    sb = rate_np.symbol_bits
    is_inter_b = sb(fc["intra_inter"][0], 1, 2)
    single_b = sb(fc["comp_inter"][1], 0, 2) if ref_select else 0.0
    b_new = sb(fc["newmv"][0], 0, 2)
    b_glob = sb(fc["newmv"][0], 1, 2) + sb(fc["zeromv"][0], 0, 2)
    ref_bits = [single_ref_tree_bits(fc, int(r)) for r in ref_ids]
    comp = None
    if comp_pair is not None:
        cb = sb(fc["comp_inter"][1], 1, 2)
        cb += sb(fc["comp_ref_type"][2], 1, 2)  # BIDIR
        cb += sb(fc["comp_ref"][1][0], 0, 2)  # fwd group {LAST, LAST2}
        cb += sb(fc["comp_ref"][1][1], 0, 2)  # LAST
        cb += sb(fc["comp_bwdref"][1][0], 1, 2)  # ALTREF
        cb += sb(fc["inter_compound_mode"][0], 7, 8)  # NEW_NEWMV
        comp = is_inter_b + cb
    return dict(new=[is_inter_b + single_b + rb + b_new for rb in ref_bits],
                glob=is_inter_b + single_b + ref_bits[0] + b_glob, comp=comp)


def inter_txtype_cost_const(fc, n: int) -> np.ndarray:
    """(len(TX_SEARCH),) inter tx-type signaling bits (inter_ext_tx cdf)."""
    from ..codec.tile_codec import (AV1_EXT_TX_IND, AV1_EXT_TX_USED, AV1_NUM_EXT_TX_SET,
                                    EXT_TX_SET_DCTONLY, EXT_TX_SET_INDEX_INTER,
                                    ext_tx_set_type_inter)
    from ..constants.av1 import MAX_TXSIZE_RECT, TX_SIZE_SQR
    from .intra_device import BSIZE_BY_N

    tx_size = int(MAX_TXSIZE_RECT[BSIZE_BY_N[n]])
    set_type = ext_tx_set_type_inter(tx_size)
    out = np.zeros(len(TX_SEARCH), np.float32)
    for j, t in enumerate(TX_SEARCH):
        if set_type == EXT_TX_SET_DCTONLY:
            out[j] = 0.0 if t == int(TxType.DCT_DCT) else 1e9
        elif not AV1_EXT_TX_USED[set_type][t]:
            out[j] = 1e9
        else:
            eset = EXT_TX_SET_INDEX_INTER[set_type]
            nsyms = AV1_NUM_EXT_TX_SET[set_type]
            sqr = int(TX_SIZE_SQR[tx_size])
            out[j] = rate_np.symbol_bits(fc["inter_ext_tx"][eset][sqr],
                                         int(AV1_EXT_TX_IND[set_type][t]), nsyms)
    return out


def _mv_rate(mv, pred, joint, comp):
    """(B, 2) 1/8-pel MVs + predictors -> (B,) signaling bits via the exact
    NMV LUTs (codec/rate_torch.mv_component_cost_lut)."""
    d = (mv - pred).clamp(-MAX_MV_ABS, MAX_MV_ABS)
    ady, adx = d[:, 0].abs().long(), d[:, 1].abs().long()
    return joint[(ady != 0).long(), (adx != 0).long()] + comp[0, ady] + comp[1, adx]


def globalmv_lanes8(refs_y, gm8, R8: int, C8: int, which: int, bd: int):
    """The GLOBALMV prediction of the frame's (R8, C8) grid of 8x8 lanes
    from refs_y[0] at the global MV gm8 (1/8 pel), as (R8, C8, 8, 8) int32
    (one K10 launch). Every size's GLOBALMV lanes are blocks of it: a lane's
    samples depend on its position, the MV and the 8-tap filter only."""
    dev = refs_y.device
    B = R8 * C8
    ys = torch.arange(R8, device=dev, dtype=torch.int32).repeat_interleave(C8) * 8
    xs = torch.arange(C8, device=dev, dtype=torch.int32).repeat(R8) * 8
    mv = (gm8.to(torch.int32) * 2).expand(B, 2)
    return me_torch.mc_lanes(refs_y, ys, xs, mv[:, 0], mv[:, 1], 8, 8, which, bd,
                             ref_idx=torch.zeros(B, dtype=torch.int32, device=dev)) \
        .view(R8, C8, 8, 8)


def _lanes8_blocks(lanes8, n: int, R: int, C: int):
    """The (R, C) grid of n x n blocks of globalmv_lanes8's output, as an
    (R, C, n/8, 8, n/8, 8) view (no copy)."""
    k = n // 8
    return lanes8[: R * k, : C * k].view(R, k, C, k, 8, 8).permute(0, 2, 1, 4, 3, 5)


def _decide_inter_size(src_y, src_u, src_v, refs_y, refs_u, refs_v, mv_by_ref, pred_by_ref,
                       intra_out, consts, n: int, rate_fns, dq, bd: int, R: int, C: int, lam,
                       which: int, mc_by_ref, comp_pair=None, tx_ntypes: int = 4, gm8=None,
                       glob8=None, ref_off_x: int = 0):
    """Inter candidate evaluation for the (R, C) grid at size n, merged with
    the intra decision `intra_out` = (cost, mode, tx) from device_decide.

    src planes (1, H, W) int32; refs_* (NREF, H, W') uint8 (int16 at 10 bits) stacks whose
    luma column ref_off_x (chroma ref_off_x // 2) is the source's column 0
    (a tile's halo-cropped references; 0 and W' = W for a whole frame);
    mv_by_ref: per reference (B, 2) subpel MVs, pred_by_ref (B, 2) MV-rate
    predictors (the SB MV), mc_by_ref (B, n, n) the subpel search's
    predictions at those MVs. The candidates are the NEWMV lane of every
    reference, the GLOBALMV lane on reference 0 and, with comp_pair = (ri0,
    ri1) stack indices, the NEW_NEWMV lane at those references' NEWMV
    vectors, whose prediction here is the (a + b + 1) >> 1 average of their
    two predictions (the commit redoes it with the normative compound
    average); evaluated lane-major (block, candidate) so that the argmin
    over candidates keeps the reference's first-candidate tie order.
    Returns (cost, is_inter, mode, tx, ref, mvy, mvx, ref2, mv2y, mv2x),
    each (R*C,)."""
    dev = src_y.device
    B = R * C
    nc = n // 2
    nref = len(mv_by_ref)
    r_idx = torch.arange(R, device=dev, dtype=torch.int32).repeat_interleave(C)
    c_idx = torch.arange(C, device=dev, dtype=torch.int32).repeat(R)
    srcb = _blocks_of(src_y, n, R, C)
    joint, comp, cand_bits, txt_cost = consts

    # GLOBALMV lane: the frame's global MV for ref 0, its prediction the
    # blocks of glob8, the frame's 8x8 lanes at that MV (a block copy of
    # ref 0 when global motion is off)
    glob_mv = (torch.zeros((B, 2), dtype=torch.int32, device=dev) if gm8 is None
               else gm8[None, :].expand(B, 2).to(torch.int32))
    mvs = [*mv_by_ref, glob_mv]
    refs_1 = list(range(nref)) + [0]
    refs_2 = [-1] * (nref + 1)
    mvs_2 = [torch.zeros((B, 2), dtype=torch.int32, device=dev)] * (nref + 1)
    bits = [cand_bits["new"][ri] + _mv_rate(mv, pred_by_ref[ri], joint, comp)
            for ri, mv in enumerate(mv_by_ref)]
    bits.append(cand_bits["glob"].expand(B))
    if gm8 is None:
        glob_pred = _blocks_of(refs_y[0:1, :, ref_off_x:].to(torch.int32), n, R, C)
    else:
        glob_pred = _lanes8_blocks(glob8, n, R, C)
    preds = [*mc_by_ref, glob_pred]
    if comp_pair is not None:
        ri0, ri1 = comp_pair
        mvs.append(mv_by_ref[ri0])
        refs_1.append(ri0)
        refs_2.append(ri1)
        mvs_2.append(mv_by_ref[ri1])
        bits.append(cand_bits["comp"] + _mv_rate(mv_by_ref[ri0], pred_by_ref[ri0], joint, comp)
                    + _mv_rate(mv_by_ref[ri1], pred_by_ref[ri1], joint, comp))
        preds.append((mc_by_ref[ri0] + mc_by_ref[ri1] + 1) >> 1)
    NC = len(mvs)
    cand_mv = torch.stack(mvs, dim=1)  # (B, NC, 2)
    cand_mv2 = torch.stack(mvs_2, dim=1)
    cand_ref = torch.tensor(refs_1, dtype=torch.int32, device=dev)
    cand_ref2 = torch.tensor(refs_2, dtype=torch.int32, device=dev)
    cand_mbits = torch.stack(bits, dim=1)  # (B, NC)
    pred = torch.empty((B, NC, n, n), dtype=torch.int32, device=dev)
    for i, p in enumerate(preds):  # copied once each, the GLOBALMV blocks from their view
        pred[:, i].view(p.shape).copy_(p)
    rate, dist = _eval_txfm(srcb, pred.reshape(B * NC, n, n), dq, bd, rate_fns["y"][0], rep=NC)
    cost_nc = dist.reshape(B, NC) + lam * (rate.reshape(B, NC) + cand_mbits)
    pick = torch.argmin(cost_nc, dim=1)
    bi = torch.arange(B, device=dev)
    cost_i = cost_nc[bi, pick]
    mv_i = cand_mv[bi, pick]
    ref_i = cand_ref[pick]
    ref2_i = cand_ref2[pick]
    mv2_i = cand_mv2[bi, pick]
    mbits_i = cand_mbits[bi, pick]
    pred_i = pred[bi, pick].contiguous()

    # luma tx-type search on the inter winner (sizes with a non-DCT set)
    tx_i = torch.zeros(B, dtype=torch.int32, device=dev)
    if n <= 16 and tx_ntypes > 1:
        for j in range(1, tx_ntypes):
            ratej, dj = _eval_txfm(srcb, pred_i, dq, bd, rate_fns["y"][j], tx_type=TX_SEARCH[j])
            cj = dj + lam * (ratej + mbits_i + txt_cost[j])
            take = cj < cost_i
            cost_i = torch.where(take, cj, cost_i)
            tx_i = torch.where(take, j, tx_i)

    # chroma at the winner's MV (DCT approximation, as the intra decide does)
    puv = me_torch.mc_lanes_planes([refs_u, refs_v], r_idx * nc, c_idx * nc + ref_off_x // 2,
                                   mv_i[:, 0], mv_i[:, 1], nc, nc, which, bd, ref_idx=ref_i)
    for srcc, pc in ((src_u, puv[0]), (src_v, puv[1])):
        ratec, distc = _eval_txfm(_blocks_of(srcc, nc, R, C), pc, dq, bd, rate_fns["uv"])
        cost_i = cost_i + distc + lam * ratec
    cost_i = cost_i + lam * 1.0  # skip flag

    # merge with intra
    cost_a, mode_a, tx_a = intra_out
    ca = cost_a.reshape(B)
    take_inter = cost_i < ca
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    minus1 = torch.full((B,), -1, dtype=torch.int32, device=dev)
    return (torch.where(take_inter, cost_i, ca), take_inter.to(torch.int32),
            torch.where(take_inter, zero, mode_a.reshape(B)),
            torch.where(take_inter, tx_i, tx_a.reshape(B)),
            torch.where(take_inter, ref_i, minus1),
            torch.where(take_inter, mv_i[:, 0], zero), torch.where(take_inter, mv_i[:, 1], zero),
            torch.where(take_inter, ref2_i, minus1), torch.where(take_inter, mv2_i[:, 0], zero),
            torch.where(take_inter, mv2_i[:, 1], zero))


@functools.lru_cache(maxsize=32)
def _decide_inter_program(width: int, height: int, qctx: int, bd: int, nref: int, which: int,
                          ref_ids: tuple, ref_select: bool, sf: tuple, use_gm: bool,
                          device: str):
    """Whole-frame inter decide: ME + subpel + per-size inter/intra RD, with
    the per-frame constants (CDF rate tables, penalty grids, MV LUTs) built
    once per qctx bucket on the device; qindex enters as runtime operands
    (dqv, lam). Returns (run, layout)."""
    from .device_decide import (QCTX_REP, _decide_intra_size, _penalty_grid_np, _rate_fns,
                                fc_for_qctx, intra_mode_cost_const, intra_txtype_cost_const)

    p = FrameParams(width=width, height=height, qindex=QCTX_REP[qctx], bd=bd,
                    frame_is_intra=False)
    fc = fc_for_qctx(qctx)
    dev = torch.device(device)
    aw, ah = p.aligned_width, p.aligned_height
    mi_end = (p.mi_rows, p.mi_cols)
    sizes = [n for n in SIZES if ah // n and aw // n]
    layout = [(n, ah // n, aw // n) for n in sizes]

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    # the reduced intra class of inter frames: sf[0] modes (7 at medium, the
    # non-directional ones; the reference likewise restricts intra injection)
    intra_consts = {n: (t(_penalty_grid_np(p, 0, 0, ah // n, aw // n, n, (0, 0), mi_end)),
                        t(intra_mode_cost_const(fc, n, False)),
                        t(intra_txtype_cost_const(fc, n)), _rate_fns(qctx, n, dev))
                    for n in sizes}
    # the compound pair: (LAST, ALTREF) stack indices when both are present
    ids = list(ref_ids[:nref])
    comp_pair = None
    if ref_select and int(RefFrame.LAST_FRAME) in ids and int(RefFrame.ALTREF_FRAME) in ids:
        comp_pair = (ids.index(int(RefFrame.LAST_FRAME)), ids.index(int(RefFrame.ALTREF_FRAME)))
    cb = inter_cand_cost_const(fc, ids, ref_select=ref_select, comp_pair=comp_pair)
    cand_bits = dict(new=[t(np.float32(b)) for b in cb["new"]], glob=t(np.float32(cb["glob"])),
                     comp=None if cb["comp"] is None else t(np.float32(cb["comp"])))
    inter_txt = {n: t(inter_txtype_cost_const(fc, n)) for n in sizes}
    joint = t(rate_torch.mv_joint_cost(fc))
    comp = t(rate_torch.mv_component_cost_lut(fc, MAX_MV_ABS))
    # the SB grid of the ME
    sbr, sbc = -(-ah // 64), -(-aw // 64)

    def run(sy8, su8, sv8, refs_y8, refs_u8, refs_v8, dqv, lam, gm8):
        dq = (int(dqv[0]), int(dqv[1]))
        lam_t = torch.tensor(lam, dtype=torch.float32, device=dev)
        sy, su, sv = (x.to(torch.int32) for x in (sy8, su8, sv8))
        # the source's ME pyramid, once for every reference (K8 reads the
        # planes, uint8 or int16 by bd, edge-padded to the SB grid)
        src_pyr = me_torch.me_pyramid(sy8[0], sbr, sbc, bd)
        srcb = {n: _blocks_of(sy, n, R, C) for n, R, C in layout}
        grid = {n: (torch.arange(R, device=dev, dtype=torch.int32).repeat_interleave(C) * n,
                    torch.arange(C, device=dev, dtype=torch.int32).repeat(R) * n)
                for n, R, C in layout}

        # per-ref ME: full-pel per size, then the subpel search, which also
        # yields each winner's normative prediction for the RD below
        mv_by_ref = {n: [] for n in sizes}
        mc_by_ref = {n: [] for n in sizes}
        sb_pred = []
        for ri in range(nref):
            mvs_fp, mv_sb = me_torch.me_fullpel_frame(sy8[0], refs_y8[ri], sbr, sbc,
                                                      src_pyr=src_pyr, bd=bd)
            sb_pred.append(mv_sb.reshape(sbr, sbc, 2) * 8)
            for n, R, C in layout:
                fp = mvs_fp[n][:R, :C].reshape(R * C, 2)
                mv8, mc8 = me_torch.subpel_pred_lanes(srcb[n], refs_y8[ri], *grid[n], fp, which,
                                                      bd, fast=bool(sf[2]))
                mv_by_ref[n].append(mv8.clamp(-MAX_MV_ABS, MAX_MV_ABS))
                mc_by_ref[n].append(mc8)

        # the GLOBALMV lanes of every size: blocks of one K10 launch at 8x8
        glob8 = globalmv_lanes8(refs_y8, gm8, ah // 8, aw // 8, which, bd) if use_gm else None
        packed = []
        for n, R, C in layout:
            pen, mode_cost, txt_cost, rate_fns = intra_consts[n]
            intra_out = _decide_intra_size(sy, su, sv, pen, mode_cost, txt_cost, n, rate_fns, dq,
                                           bd, R, C, lam_t, nmodes=sf[0], tx_ntypes=sf[1])
            # MV-rate predictor proxy: the SB-level MV over each block
            k = 64 // n
            preds = [sb_pred[ri].repeat_interleave(k, 0).repeat_interleave(k, 1)[:R, :C]
                     .reshape(R * C, 2) for ri in range(nref)]
            outs = _decide_inter_size(
                sy, su, sv, refs_y8, refs_u8, refs_v8, mv_by_ref[n], preds, intra_out,
                (joint, comp, cand_bits, inter_txt[n]), n, rate_fns, dq, bd, R, C, lam_t, which,
                mc_by_ref[n], comp_pair=comp_pair, tx_ntypes=sf[1], gm8=gm8 if use_gm else None,
                glob8=glob8)
            packed += [outs[0]] + [o.to(torch.float32) for o in outs[1:]]
        return torch.cat(packed)

    return run, layout


_DECIDE_KEYS = ("cost", "is_inter", "mode", "tx", "ref", "mvy", "mvx", "ref2", "mv2y", "mv2x")


def _unpack_decide(flat: np.ndarray, layout) -> dict:
    out = {}
    off = 0
    for n, R, C in layout:
        sz = R * C
        g = {}
        for kname in _DECIDE_KEYS:
            arr = flat[off : off + sz].reshape(R, C)
            g[kname] = arr.astype(np.float64) if kname == "cost" else arr.astype(np.int32)
            off += sz
        out[n] = g
    return out


def _decide_program(p: FrameParams, refs_dev, which: int, ref_ids):
    from ..constants.cdf import get_q_ctx

    return _decide_inter_program(p.width, p.height, get_q_ctx(p.qindex), p.bd,
                                 int(refs_dev[0].shape[0]), which,
                                 tuple(int(r) for r in ref_ids), bool(p.reference_select),
                                 (int(p.sf_nmodes_inter), int(p.sf_tx_ntypes),
                                  int(p.sf_fast_subpel)),
                                 bool(p.enable_gm), str(refs_dev[0].device))


def _run_decide(src_dev, refs_dev, p: FrameParams, which: int, ref_ids):
    """Dispatch the decide program; returns (flat device tensor, layout)."""
    run, layout = _decide_program(p, refs_dev, which, ref_ids)
    gm8 = torch.as_tensor(np.asarray(p.gm_mvs[int(ref_ids[0])], np.int32),
                          device=refs_dev[0].device)
    dqv, lam_op = device_decide.qparams_np(p.qindex, p.bd)
    return run(src_dev[0], src_dev[1], src_dev[2], *refs_dev, dqv, lam_op, gm8), layout


def decide_inter_frame(src_dev, refs_dev, params: FrameParams, which: int, ref_ids=(1, 4)) -> dict:
    """Run the decide; returns {n: dict(cost, is_inter, mode, tx, ref, mvy,
    mvx, ref2, mv2y, mv2x)} numpy grids over the full aligned frame.
    src_dev: put_frames() planes of one frame; refs_dev: (NREF, H, W) uint8 (int16 at 10 bits)
    device stacks (Y, U, V); ref_ids: the RefFrame id per stack index."""
    flat, layout = _run_decide(src_dev, refs_dev, params, which, ref_ids)
    return _unpack_decide(flat.cpu().numpy(), layout)


# --------------------------------------------------------------- pipelined
# Three-phase inter frame for the overlapped host/device pipeline:
#
#   start_decide  — h2d source + dispatch the decide program, no host sync.
#   start_commit  — fetch the decide (the frame's one mandatory sync), host
#                   partition DP, dispatch commit + in-loop filters. The
#                   filtered, display-edge-replicated recon planes stay on
#                   the device (.dpb_planes) so the next frame's ME/MC
#                   chains on them without a host round trip.
#   finish        — pull levels, build the op stream, run the native C
#                   walk, fetch the recon for the packet.


class PendingInter:
    """Mutable carrier of one in-flight frame's device tensors + host aux."""


def inter_start_decide(src_planes, params: FrameParams, refs_dev, which: int,
                       ref_ids) -> PendingInter:
    p = params
    pend = PendingInter()
    with profiler.stage("h2d"):
        pend.src_dev = device_decide.put_frames([src_planes], p.bd, refs_dev[0].device)
    with profiler.stage("decide"):
        pend.flat, pend.layout = _run_decide(pend.src_dev, refs_dev, p, which, ref_ids)
    pend.p = p
    pend.refs_dev = refs_dev
    pend.which = which
    pend.ref_ids = [int(r) for r in ref_ids]
    return pend


def _commit(pend: PendingInter, array_out: bool):
    """The commit half of a started frame: fetch the decide (the frame's one
    mandatory sync), the host partition DP, then the commit on the device
    (commit_regions; the levels' fetch is left to finish_levels with
    array_out). Sets pend.plan, pend.tree and pend.region; returns (leaves,
    commit_regions' output)."""
    from ..codec.tile_codec import Plan
    from ..constants.cdf import FrameContext
    from . import device_commit
    from .intra_md import rd_lambda

    p = pend.p
    fc = FrameContext(p.qindex)
    lam = float(rd_lambda(p.qindex, p.bd))
    region = (0, 0, p.aligned_width, p.aligned_height)
    with profiler.stage("decide"):
        flat = pend.flat.cpu().numpy()
    del pend.flat
    dec = _unpack_decide(flat, pend.layout)
    with profiler.stage("partition_dp"):
        partitions, leaves, tree = device_decide.partition_dp(dec, p, fc, lam, region)
    plan = Plan()
    plan.partitions.update(partitions)
    out = device_commit.commit_regions(
        pend.src_dev, p, [leaves], [dec], [plan], region, refs_dev=pend.refs_dev,
        ref_ids=pend.ref_ids, which=pend.which, array_out=array_out, fetch_levels=False)
    pend.plan, pend.tree, pend.region = plan, tree, region
    return leaves, out


def inter_start_commit(pend: PendingInter, enable_dlf: bool = True, enable_cdef: bool = True,
                       sharpness: int = 0) -> PendingInter:
    from ..filters import cdef as cdef_mod
    from . import device_commit

    p = pend.p
    leaves, (ry, ru, rv, skip8, aux) = _commit(pend, array_out=True)
    with profiler.stage("filter"):
        levels = p.lf_levels if (enable_dlf and any(p.lf_levels)) else (0, 0, 0, 0)
        flens = device_commit.flen_maps([leaves], p, ry.device)
        damping = cdef_mod.pick_damping(p.qindex)
        lf_search = device_commit._lf_candidates(levels[0]) if p.sf_dlf_search else ()
        packed, stats, planes = device_commit._filter_device(
            ry, ru, rv, pend.src_dev[0], skip8, flens, tuple(levels), sharpness, p.bd, damping,
            enable_cdef, disp_dims=(p.width, p.height), cdef_cands=4 if p.sf_cdef_fast else 0,
            lf_search=lf_search)
    pend.aux = aux
    pend.lf_levels = tuple(levels)
    pend.lf_search = lf_search
    pend.damping = damping
    pend.packed, pend.strengths = packed, stats
    pend.dpb_planes = [pl[0] for pl in planes]  # device uint8 or int16 planes, F == 1
    pend.src_dev = None
    pend.refs_dev = None
    return pend


def inter_commit_restoration(pend: PendingInter, enable_cdef: bool = True) -> tuple:
    """The restoration route's inter frame, synchronously, after
    inter_start_decide (the reference's encode_inter_frame_device(...,
    use_arrays=False, apply_filters=False) and its host DLF and CDEF): the
    commit, then device_commit.restoration_filters on the device. The plan
    walk is left to the caller, after the restoration search. Returns
    (plan, the CDEF output as host int32 planes, filt with the deblocked
    planes)."""
    from . import device_commit

    leaves, (ry, ru, rv, skip8) = _commit(pend, array_out=False)
    [(recon, filt)] = device_commit.restoration_filters(ry, ru, rv, pend.src_dev[0], skip8,
                                                        [leaves], pend.p, enable_cdef)
    pend.src_dev = None
    pend.refs_dev = None
    return pend.plan, recon, filt


def inter_finish(pend: PendingInter, walk_fc) -> tuple:
    """Complete one pipelined frame: levels d2h + op-stream build + native C
    walk + recon fetch. Returns (plan, recon_int32_planes, filt, payloads)."""
    from ..codec import array_plan
    from ..codec.tile_walk_native import run_tile_ops
    from . import device_commit

    p = pend.p
    device_commit.finish_levels(pend.aux)
    with profiler.stage("entropy_walk"):
        tiles = p.tiles()[0]
        ops, _keys = array_plan.build_tile_ops(
            p, pend.tree, pend.aux["sched"], pend.aux["level_base"], 0, pend.region, tiles,
            pend.aux["ref_ids"], TX_SEARCH, MODES)
        payloads = [run_tile_ops(p, walk_fc, ops, pend.aux["levels_i32"], tiles)]
    with profiler.stage("recon_d2h"):
        packed = pend.packed.cpu().numpy()
        stats = pend.strengths.cpu().numpy()
    aw, ah = p.aligned_width, p.aligned_height
    ysz, csz = ah * aw, (ah // 2) * (aw // 2)
    recon = [packed[:ysz].reshape(ah, aw).astype(np.int32),
             packed[ysz : ysz + csz].reshape(ah // 2, aw // 2).astype(np.int32),
             packed[ysz + csz :].reshape(ah // 2, aw // 2).astype(np.int32)]
    lf = pend.lf_levels
    if pend.lf_search:
        ylvl = pend.lf_search[int(stats[0, 4])]
        lf = (ylvl, ylvl, lf[2], lf[3])
    filt = dict(lf_levels=lf, cdef=(int(stats[0, 0]), int(stats[0, 1]), int(stats[0, 2]),
                                    int(stats[0, 3]), pend.damping))
    return pend.plan, recon, filt, payloads
