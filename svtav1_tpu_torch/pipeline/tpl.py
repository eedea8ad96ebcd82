"""TPL (the temporal dependency model) and CRF q assignment, ported from
svtav1_tpu's pipeline/tpl.py (itself the analog of the reference's
src_ops_process.c dispenser tpl_mc_flow_dispenser_sb_generic :519,
synthesizer tpl_model_update_b :1483, r0 svt_aom_generate_r0beta :1587, and
rc_process.c crf_qindex_calc :782, the qstep-ratio path).

- The dispenser `_tpl_frame` codes one window frame on the device on a 16x16
  grid: an open-loop intra probe from source neighbours (K1, five modes, and
  K15's SATD proxy), then per reference a full-pel ME (K8), the two-step
  subpel refinement (K14), MC from the reference's TPL recon and from its
  source (K10) and the SATD proxy of the recon prediction (K15); the
  cheaper reference per block, intra where it is cheaper still; then the
  quantization error and recon of the chosen recon prediction and the
  error of the chosen source prediction (K15). Frames run in coding order,
  so every reference's TPL recon exists when it is used.
- The synthesizer and the q rules are host numpy on the small per-frame
  grids, copied from the reference.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import resolve_device
from ..ops import me_torch
from ..ops import quantize as quant_ops
from ..ops import transforms_torch as TT
from . import gop, intra_device
from .device_decide import _grid_neighbors

TPL_B = 16  # dispenser block size
# the intra probe's modes, as indices of intra_device.MODES: DC, V, H, SMOOTH
# and D113 (the reference's comment names PAETH, but its index 9 is D113)
PROBE = (0, 1, 2, 3, 9)
_ABSENT = 1 << 30  # the cost of an absent reference


@functools.lru_cache(maxsize=8)
def _tpl_frame(H: int, W: int, bd: int, device: str):
    """One dispenser step with up to two references:
    run(src, ref0_src, ref0_rec, ref1_src, ref1_rec, dq) -> (intra_cost,
    inter_cost, srcrf, recrf, mv, ref_pick, recon), the (H/16, W/16) grids of
    the frame and its (H, W) TPL recon plane. Planes are (H, W)
    me_torch.plane_dtype(bd) on the device (uint8 at 8 bits, int16 at 10);
    an absent reference is None. ref_pick: 0/1 for the chosen
    reference, -1 where intra wins. The inter cost grid holds
    min(inter, intra); the costs are float32 as in the reference."""
    R, C = H // TPL_B, W // TPL_B
    B = R * C
    sbr, sbc = H // 64, W // 64
    dev = torch.device(device)
    r_idx = torch.arange(R, device=dev).repeat_interleave(C)
    c_idx = torch.arange(C, device=dev).repeat(R)
    ys, xs = (r_idx * TPL_B).to(torch.int32), (c_idx * TPL_B).to(torch.int32)
    ha, hl = r_idx > 0, c_idx > 0
    npr = len(PROBE)
    probe_modes = torch.tensor(PROBE, dtype=torch.int32, device=dev).repeat(B)
    ha5, hl5 = ha.repeat_interleave(npr), hl.repeat_interleave(npr)
    bi = torch.arange(B, device=dev)
    base = 1 << (bd - 1)
    absent = torch.full((B,), _ABSENT, dtype=torch.int32, device=dev)

    def blocks(plane):
        return plane.reshape(R, TPL_B, C, TPL_B).permute(0, 2, 1, 3).reshape(B, TPL_B, TPL_B) \
            .contiguous()

    def ref_cost(src_pl, src_pyr, srcb, ref_src, ref_rec):
        fp = me_torch.me_fullpel_frame(src_pl, ref_src, sbr, sbc, src_pyr=src_pyr,
                                       bd=bd)[0][16][:R, :C].reshape(B, 2)
        mv8 = me_torch.subpel_refine_lanes(srcb, ref_src, ys, xs, fp, 0, bd)
        mvy, mvx = mv8[:, 0] * 2, mv8[:, 1] * 2
        pred_rec, pred_src = me_torch.mc_lanes_planes([ref_rec, ref_src], ys, xs, mvy, mvx,
                                                      TPL_B, TPL_B, 0, bd)
        return TT.tpl_cost(srcb, pred_rec, 0, 0, 0, bd), mv8, pred_rec, pred_src

    def run(src_pl, r0src, r0rec, r1src, r1rec, dq):
        src = src_pl.to(torch.int32)
        srcb = blocks(src)

        # intra probe, open-loop from source neighbours, with the
        # reference's fills where a neighbour is missing
        above, left, tl = _grid_neighbors(src[None], TPL_B, R, C)
        left_fill = torch.where(ha, above[:, 0], base + 1)
        above_fill = torch.where(hl, left[:, 0], base - 1)
        above = torch.where(ha[:, None], above, above_fill[:, None])
        left = torch.where(hl[:, None], left, left_fill[:, None])
        tl = torch.where(ha & hl, tl, torch.where(ha, above[:, 0], torch.where(hl, left[:, 0],
                                                                               base)))
        edges = (x.to(torch.int32).repeat_interleave(npr, dim=0).contiguous()
                 for x in (above, left, tl))
        probe = intra_device.predict(*edges, ha5, hl5, TPL_B, mode=probe_modes,
                                     bd=bd)  # (B*5, 16, 16)
        satd = TT.tpl_cost(srcb, probe, 0, 0, 0, bd, rep=npr).reshape(B, npr)
        intra_cost, intra_pick = satd.min(dim=1)  # the first minimum
        intra_pred = probe.reshape(B, npr, TPL_B, TPL_B)[bi, intra_pick]

        # inter per reference: ME on the sources, MC from the TPL recon
        zeros = torch.zeros((B, TPL_B, TPL_B), dtype=torch.int32, device=dev)
        zmv = torch.zeros((B, 2), dtype=torch.int32, device=dev)
        refs = ((r0src, r0rec), (r1src, r1rec))
        # the source's ME pyramid, once for both references
        src_pyr = (me_torch.me_pyramid(src_pl, sbr, sbc, bd)
                   if r0src is not None and r1src is not None else None)
        per_ref = [ref_cost(src_pl, src_pyr, srcb, rs, rr) if rs is not None
                   else (absent, zmv, zeros, zeros) for rs, rr in refs]
        (c0, mv0, prec0, psrc0), (c1, mv1, prec1, psrc1) = per_ref
        pick1 = c1 < c0
        inter_cost = torch.minimum(c0, c1)
        mv8 = torch.where(pick1[:, None], mv1, mv0)
        pred_rec = torch.where(pick1[:, None, None], prec1, prec0)
        pred_src = torch.where(pick1[:, None, None], psrc1, psrc0)
        use_inter = inter_cost < intra_cost
        ref_pick = torch.where(use_inter, pick1.to(torch.int32), -1)

        best_pred = torch.where(use_inter[:, None, None], pred_rec, intra_pred).contiguous()
        err_rec, rec_blocks = TT.tpl_cost(srcb, best_pred, 1, dq[0], dq[1], bd, want_recon=True)
        best_src = torch.where(use_inter[:, None, None], pred_src, intra_pred).contiguous()
        err_src, _ = TT.tpl_cost(srcb, best_src, 1, dq[0], dq[1], bd)
        srcrf = err_src.to(torch.float32).clamp(min=1.0)
        recrf = torch.maximum(srcrf, err_rec.to(torch.float32).clamp(min=1.0))
        srcrf = torch.where(use_inter, srcrf, recrf)  # intra: no propagation gain

        recon = rec_blocks.reshape(R, C, TPL_B, TPL_B).permute(0, 2, 1, 3).reshape(H, W)
        return (intra_cost.to(torch.float32).reshape(R, C),
                torch.minimum(inter_cost, intra_cost).to(torch.float32).reshape(R, C),
                srcrf.reshape(R, C), recrf.reshape(R, C), mv8.reshape(R, C, 2),
                ref_pick.reshape(R, C), recon.to(me_torch.plane_dtype(bd)))

    return run


def window_schedule(n_frames: int, minigop: int) -> list:
    """Coding-order TPL schedule for a window whose frame 0 is the intra
    seed (anchor): [(cur, ref_past, ref_future|None), ...] in window-local
    indices — the display chain when minigop == 1, the dyadic mini-GoP
    structure otherwise (pd_process.c set_mini_gop_structure analog)."""
    sched = [(0, None, None)]
    anchor = 0
    while anchor < n_frames - 1:
        avail = n_frames - 1 - anchor
        size = 1
        while size * 2 <= avail and size * 2 <= minigop:
            size *= 2
        for f in gop.schedule_minigop(anchor, size):
            sched.append((f.disp_idx, f.past_idx, f.future_idx))
        anchor += size
    return sched


def tpl_window(frames_y: list, qindex: int, bd: int = 8, minigop: int = 1, device=None):
    """Run the dispenser over a window (frame 0 = intra seed) following the
    coding prediction structure (minigop > 1: dyadic hierarchy; each coded
    frame MEs against its true past/future anchors and their TPL recons).

    frames_y: list of (H, W) int source luma planes of depth bd (8 or 10),
    H and W multiples of 64. `device=None` means CUDA. Returns per-frame
    stats dicts (window order) with numpy grids."""
    dev = resolve_device(device)
    H, W = frames_y[0].shape
    run = _tpl_frame(H, W, bd, str(dev))
    dq = (quant_ops.dc_q(qindex, bd), quant_ops.ac_q(qindex, bd))
    srcs, recs, out = {}, {}, {}
    sched = window_schedule(len(frames_y), minigop)
    dt = me_torch.plane_np_dtype(bd)
    for (cur, rp, rf) in sched:
        srcs[cur] = torch.from_numpy(np.asarray(frames_y[cur], dt)).to(dev)
        *grids, recs[cur] = run(srcs[cur], srcs.get(rp), recs.get(rp), srcs.get(rf), recs.get(rf),
                                dq)
        out[cur] = grids
    stats = [None] * len(frames_y)
    for (cur, rp, rf) in sched:
        ic, xc, sd, rd, mv, rp_map = (g.cpu().numpy() for g in out[cur])
        stats[cur] = dict(intra_cost=ic.astype(np.float64), inter_cost=xc.astype(np.float64),
                          srcrf=sd.astype(np.float64), recrf=rd.astype(np.float64), mv=mv,
                          ref_pick=rp_map, ref0=rp if rp is not None else -1,
                          ref1=rf if rf is not None else -1, _sched=sched)
    return stats


def synthesize(stats: list) -> np.ndarray:
    """Backward propagation (tpl_model_update_b math, rates off).

    Each block's dependency mass flows to its CHOSEN reference (the coded
    prediction structure): prop = (recrf - srcrf + mc_dep *
    (recrf - srcrf)/recrf) * overlap/pix. Returns r0 per frame."""
    n = len(stats)
    sched = stats[0].get("_sched") or [(t, t - 1 if t else None, None)
                                       for t in range(n)]
    mc_dep = [np.zeros_like(s["recrf"]) for s in stats]
    for (t, _rp, _rf) in reversed(sched):
        s = stats[t]
        refs = (s.get("ref0", -1), s.get("ref1", -1))
        if refs[0] < 0 and refs[1] < 0:
            continue
        R, C = s["recrf"].shape
        cur_all = (s["recrf"] - s["srcrf"]) \
            + mc_dep[t] * (s["recrf"] - s["srcrf"]) / s["recrf"]
        fy = (np.arange(R)[:, None] * TPL_B + (s["mv"][..., 0] >> 3)).astype(np.int64)
        fx = (np.arange(C)[None, :] * TPL_B + (s["mv"][..., 1] >> 3)).astype(np.int64)
        g0y = np.floor_divide(fy, TPL_B)
        g0x = np.floor_divide(fx, TPL_B)
        oy = fy - g0y * TPL_B  # in [0, 16)
        ox = fx - g0x * TPL_B
        for which in (0, 1):
            ref = refs[which]
            if ref < 0:
                continue
            sel = s["ref_pick"] == which
            if not sel.any():
                continue
            cur = np.where(sel, cur_all, 0.0)
            dep = mc_dep[ref]
            Rr, Cr = dep.shape
            for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
                gy = g0y + dy
                gx = g0x + dx
                wy = np.where(dy == 0, TPL_B - oy, oy)
                wx = np.where(dx == 0, TPL_B - ox, ox)
                w = (wy * wx).astype(np.float64) / (TPL_B * TPL_B)
                ok = (gy >= 0) & (gy < Rr) & (gx >= 0) & (gx < Cr) & (w > 0) & sel
                np.add.at(dep, (gy[ok], gx[ok]), (cur * w)[ok])
    r0 = np.ones(n)
    for t, s in enumerate(stats):
        rec_sum = float(s["recrf"].sum())
        dep_sum = float(mc_dep[t].sum())
        if rec_sum + dep_sum > 0:
            r0[t] = rec_sum / (rec_sum + dep_sum)
    return r0


def qindex_from_qstep_ratio(leaf_qindex: int, qstep_ratio: float, bd: int = 8) -> int:
    """rc_process.c svt_av1_get_q_index_from_qstep_ratio."""
    target = quant_ops.dc_q(leaf_qindex, bd) * qstep_ratio
    if qstep_ratio < 1.0:
        q = leaf_qindex
        while q > 0 and quant_ops.dc_q(q, bd) > target:
            q -= 1
        return q
    q = leaf_qindex
    while q < 255 and quant_ops.dc_q(q, bd) < target:
        q += 1
    return q


# GOP-structure r0 scaling (rc_process.c tpl_hl_islice_div_factor /
# tpl_hl_base_frame_div_factor analogs, indexed by hierarchical levels)
_ISLICE_DIV = {0: 1.0, 1: 1.2, 2: 1.6, 3: 2.0, 4: 2.5}
_BASE_DIV = {0: 1.0, 1: 1.0, 2: 1.2, 3: 1.4, 4: 1.6}
R0_WEIGHT = (0.75, 0.9, 1.0)  # I, BASE, NON-BASE (rc_process.c:779)


def crf_qindex(cq_level: int, r0: float, is_key: bool, layer: int,
               hierarchical_levels: int, bd: int = 8) -> int:
    """Per-frame CRF qindex from r0 (crf_qindex_calc qstep-ratio path)."""
    hl = min(hierarchical_levels, 4)
    if is_key:
        r0 = r0 / _ISLICE_DIV[hl]
        w = R0_WEIGHT[0]
    elif layer == 0:
        r0 = r0 / _BASE_DIV[hl]
        w = R0_WEIGHT[1]
    else:
        # non-base: interpolate toward cq by layer (the reference's
        # arf_q/w1-w2 ladder); approximate with the qstep rule + blend
        w = R0_WEIGHT[2]
    q = qindex_from_qstep_ratio(cq_level, np.sqrt(max(r0, 1e-6)) * w, bd)
    q = int(np.clip(q, 1, cq_level))
    if not is_key and layer > 0:
        # blend toward the leaf q for higher layers (non_base_qindex_weight)
        t = min(layer, 3) / 3.0
        q = int(round((1 - t) * q + t * cq_level))
    return max(1, min(255, q))
