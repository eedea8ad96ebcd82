"""Device commit pass (PyTorch): conformant reconstruction of the decided
plan, ported from svtav1_tpu's pipeline/device_commit.py for key frames and
inter frames (low-delay P and hierarchical-B).

The decide pass chose modes and partitions open-loop; this pass produces
the final quantized coefficients and the recon the decoder reproduces bit
for bit. Intra prediction needs final neighbour recon, the one sequential
dependence of AV1, so blocks run in mi8 anti-diagonal waves (w = r8 + c8 +
n8 - 1, 8-px units): every provider of a block's above row, left column and
top-left corner completes at a strictly smaller wave (proof in the
reference module's NOTES). All blocks of a wave form one batch per size.

Neighbour pixels live in frontier maps, not the recon plane:
`bottom_rows[r8, x]` = recon row (r8+1)*8-1, `right_cols[c8, y]` = recon
col (c8+1)*8-1, `corners[r8, c8]` = recon[(r8+1)*8-1, (c8+1)*8-1]. Each
(band, pixel) cell has one writer, so the index writes of one wave never
collide.

Inter blocks need no neighbour recon: phase A codes every inter block of a
size in one batch before the wavefront (K10 predicts Y, U and V from the
reference stack, K11 the compound blocks' from their two references, then
K2, with K5 between its halves when RDOQ is on) and writes its frontier
cells; phase B, the wavefront, then runs only the waves that hold intra
blocks.

Phase B runs in pipeline/wavefront.py: on the card one launch of K16
commit_wave walks a wave-major task table with a grid barrier between
waves; each task predicts its chosen mode (K1's device code), transforms,
quantizes and reconstructs (K2's), with RDOQ (K5's) when on, and writes its
frontier cells. Its plain version, the CPU path, is the wave loop of K1, K2
and K5 batched by wave and size. Phase A's gathers and frontier writes are
plain PyTorch. Lanes are sized by exact counts (the host knows each
wave's lanes), so there are no pad lanes. The commit also leaves an 8x8
skip map on the device for CDEF. The filters then run on the device: K4
deblocking (with the frame-level luma level search), CDEF (K6 and K7, with
its strength search), display-edge replication; the recon is packed to
uint8 and fetched in one transfer.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..codec.tile_codec import (BlockDecision, FrameParams, Plan, chroma_tx_type,
                                chroma_tx_type_inter, max_uv_txsize)
from ..ops.me_torch import plane_np_dtype
from ..utils import profiler
from . import wavefront
from .device_decide import MODES, SIZES, TX_SEARCH
from .intra_device import BSIZE_BY_N


def _build_schedule(leaves_per_frame, dec_per_frame, region):
    """Split each size's leaves into an INTER segment (no neighbor
    dependence — committed in one batched step before the wavefront) and an
    INTRA segment sorted by anti-diagonal wave. Returns per-size host arrays
    laid out [inter (NI) | intra by wave (NW)] plus segment counts.

    `region` = (x0, y0, w, h) pixels; coords are (f, REGION-LOCAL r8, c8).
    Independent intra frames share one wavefront schedule — lanes from every
    frame batch together at each wave. Returns {n: dict(coords (N,3),
    mode (N,), tx (N,), uv_tx (N,), ref (N,), mv (N,2), offsets (W+1,)
    INTRA-relative, NI, NW, kmax)} and W.

    Wave safety with the split: an intra block's above/left/topleft
    providers are written either in the inter phase (before any wave) or at
    a strictly smaller wave (see module NOTES) — so removing inter lanes
    from the wavefront preserves the dependence order while collapsing the
    serial wave count of P/B frames to the (few) waves that contain intra
    blocks. Fully vectorized (numpy lexsort + fancy gathers)."""
    x0, y0, rw, rh = region
    R8, C8 = rh // 8, rw // 8
    W = R8 + C8 + 7  # max wave = (R8-1) + (C8-1) + 8 - 1 => W-1
    out = {}
    leaf_arr = [np.asarray(lv, np.int32).reshape(-1, 3) for lv in leaves_per_frame]
    for n in SIZES:
        n8 = n // 8
        fs_l, r8_l, c8_l = [], [], []
        for f, la in enumerate(leaf_arr):
            if not len(la):
                continue
            sel = la[:, 2] == n
            if not sel.any():
                continue
            fs_l.append(np.full(int(sel.sum()), f, np.int32))
            r8_l.append(la[sel, 0] // 2 - y0 // 8)
            c8_l.append(la[sel, 1] // 2 - x0 // 8)
        if not fs_l:
            # emit an empty entry so the set of sizes (and the commit
            # program's static cfg) never depends on content
            if rh >= n and rw >= n:
                out[n] = dict(coords=np.zeros((0, 3), np.int32),
                              mode=np.zeros(0, np.int32), tx=np.zeros(0, np.int32),
                              uv_tx=np.zeros(0, np.int32), ref=np.zeros(0, np.int32),
                              mv=np.zeros((0, 2), np.int32),
                              ref2=np.zeros(0, np.int32), mv2=np.zeros((0, 2), np.int32),
                              offsets=np.zeros(W + 1, np.int32), NI=0, NW=0, kmax=0)
            continue
        fs = np.concatenate(fs_l)
        r8 = np.concatenate(r8_l)
        c8 = np.concatenate(c8_l)
        N = len(fs)
        rs, cs = r8 * 8 // n, c8 * 8 // n
        has_inter = "ref" in dec_per_frame[0][n]

        def gather(key):
            outv = np.empty(N, np.int32)
            for f in range(len(dec_per_frame)):
                m = fs == f
                if m.any():
                    outv[m] = dec_per_frame[f][n][key][rs[m], cs[m]]
            return outv

        mode = gather("mode")
        tx = gather("tx")
        if has_inter:
            ref = gather("ref")
            mv = np.stack([gather("mvy"), gather("mvx")], axis=1)
            if "ref2" in dec_per_frame[0][n]:
                ref2 = gather("ref2")
                mv2 = np.stack([gather("mv2y"), gather("mv2x")], axis=1)
            else:
                ref2 = np.full(N, -1, np.int32)
                mv2 = np.zeros((N, 2), np.int32)
        else:
            ref = np.full(N, -1, np.int32)
            mv = np.zeros((N, 2), np.int32)
            ref2 = np.full(N, -1, np.int32)
            mv2 = np.zeros((N, 2), np.int32)
        tx_uv_size = int(max_uv_txsize(BSIZE_BY_N[n]))
        intra_map = np.array([TX_SEARCH.index(chroma_tx_type(m, tx_uv_size))
                              for m in MODES], np.int32)
        inter_map = np.array([TX_SEARCH.index(chroma_tx_type_inter(t, tx_uv_size))
                              for t in TX_SEARCH], np.int32)
        # inter uv tx assumes nonzero luma; the device swaps to DCT when the
        # quantized luma comes out all-zero (tile_codec._chroma_tx_type rule)
        uv_tx = np.where(ref >= 0, inter_map[tx], intra_map[np.where(ref >= 0, 0, mode)])
        mode = np.where(ref >= 0, 0, mode)

        is_int = ref >= 0
        wave = r8 + c8 + (n8 - 1)
        # order: inter first (raster), then intra by (wave, f, r8, c8)
        seg = is_int.astype(np.int32) * -1 + 1  # inter -> 0, intra -> 1
        order = np.lexsort((c8, r8, fs, np.where(is_int, 0, wave), seg))
        fs, r8, c8 = fs[order], r8[order], c8[order]
        mode, tx, uv_tx = mode[order], tx[order], uv_tx[order]
        ref, mv, wave = ref[order], mv[order], wave[order]
        ref2, mv2 = ref2[order], mv2[order]
        NI = int(is_int.sum())
        NW = N - NI
        counts = np.bincount(wave[NI:], minlength=W).astype(np.int64)
        offsets = np.zeros(W + 1, np.int32)
        np.cumsum(counts, out=offsets[1:])
        coords = np.stack([fs, r8, c8], axis=1).astype(np.int32)
        out[n] = dict(coords=coords, mode=mode, tx=tx, uv_tx=uv_tx, ref=ref,
                      mv=mv, ref2=ref2, mv2=mv2, offsets=offsets, NI=NI, NW=NW,
                      kmax=int(counts.max()) if NW else 0)
    return out, W


def finish_levels(aux: dict) -> None:
    """Complete the commit's level fetch: expand the packed int16 buffer
    (aux["levels_raw"], on the host) to the int32 view + per-size slab
    offsets + per-block skip flags the op-stream builder needs. The levels
    are aux["levels_raw"] (on the host) or aux["levels_dev"] (a device
    tensor, fetched here). Call once per commit."""
    if "levels_raw" in aux:
        levels_packed = aux.pop("levels_raw")
    else:
        with profiler.stage("levels_d2h"):
            levels_packed = aux.pop("levels_dev").cpu().numpy()
    _t_unpack = time.perf_counter()
    levels_i32 = levels_packed.astype(np.int32)
    level_base = {}
    off = 0
    for n, s in aux["sched"].items():
        N = len(s["coords"])
        adj, nc = min(n, 32), n // 2
        bY, bU, bV = off, off + N * adj * adj, off + N * (adj * adj + nc * nc)
        level_base[n] = (bY, bU, bV)
        off += N * (adj * adj + 2 * nc * nc)
        ya = np.abs(levels_i32[bY:bU].reshape(N, adj * adj)).sum(1)
        ua = np.abs(levels_i32[bU:bV].reshape(N, nc * nc)).sum(1)
        va = np.abs(levels_i32[bV : bV + N * nc * nc].reshape(N, nc * nc)).sum(1)
        s["skip"] = (ya + ua + va) == 0
    aux["levels_i32"] = levels_i32
    aux["level_base"] = level_base
    profiler.add("commit/unpack_plan", time.perf_counter() - _t_unpack)


def _commit_device(src_y8, src_u8, src_v8, sched: dict, R8: int, C8: int,
                   bd: int, dq, tx_ntypes: int, lam: float, rdoq_qctx: int | None = None,
                   refs=None, which: int = 0, ref_origin=(0, 0)):
    """The reference's _commit_device: phase A codes the inter lanes of every
    size in one batch each (MC from `refs`, the (NREF, H, W) uint8 Y, U, V
    stacks, by the lanes' ref index; F == 1; lanes with a second reference
    take the compound average of K11, launched on those lanes only, where
    the reference computes both predictions and selects), phase B runs the intra
    wavefront over the waves that hold intra lanes (wavefront.commit_wave:
    K16 on the card), then recon and level
    assembly. src planes (F, H, W) on the device (the region's crop);
    ref_origin: the (y, x) luma coordinates of the region's origin in
    `refs`; rdoq_qctx: the coefficient-CDF bucket of
    the RDOQ tables, None for no RDOQ. Returns (levels int16 packed in sched
    order, recon y, u, v (F, AH, AW) int32, skip8 (F, R8, C8) bool: every
    plane's levels zero in the block covering the 8x8 cell)."""
    from ..ops import me_torch

    dev = src_y8.device
    F = src_y8.shape[0]
    AW, AH = C8 * 8, R8 * 8
    dq_dc, dq_ac = int(dq[0]), int(dq[1])
    src = [p.to(torch.int32).contiguous() for p in (src_y8, src_u8, src_v8)]

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    # frontier maps: bottom rows, right columns, per-cell corners per plane
    maps = ([zeros(F, R8, AW), zeros(F, R8, AW // 2), zeros(F, R8, AW // 2)],
            [zeros(F, C8, AH), zeros(F, C8, AH // 2), zeros(F, C8, AH // 2)],
            [zeros(F, R8, C8), zeros(F, R8, C8), zeros(F, R8, C8)])
    ar_cache = {m: torch.arange(m, device=dev) for m in (1, 2, 4, 8, 16, 32, 64)}

    lanes = {}
    for n, s in sched.items():
        N = len(s["coords"])
        adj, nc = min(n, 32), n // 2
        lanes[n] = dict(
            coords=torch.as_tensor(s["coords"], dtype=torch.long, device=dev),
            mode=torch.as_tensor(s["mode"], dtype=torch.int32, device=dev),
            tx=torch.as_tensor(s["tx"], dtype=torch.int32, device=dev),
            uv_tx=torch.as_tensor(s["uv_tx"], dtype=torch.int32, device=dev),
            ref=torch.as_tensor(s["ref"], dtype=torch.int32, device=dev),
            mv=torch.as_tensor(s["mv"], dtype=torch.int32, device=dev),
            NI=int(s["NI"]),
            # the compound lanes (second reference >= 0) among the inter lanes
            cmp=np.nonzero(s["ref2"][: int(s["NI"])] >= 0)[0],
            ly=torch.empty((N, adj, adj), dtype=torch.int32, device=dev),
            lu=torch.empty((N, nc, nc), dtype=torch.int32, device=dev),
            lv=torch.empty((N, nc, nc), dtype=torch.int32, device=dev),
            ry=torch.empty((N, n, n), dtype=torch.int32, device=dev),
            ru=torch.empty((N, nc, nc), dtype=torch.int32, device=dev),
            rv=torch.empty((N, nc, nc), dtype=torch.int32, device=dev))

    def inter_step(n: int, NI: int):
        """Phase A: code this size's NI inter lanes in one batch."""
        L = lanes[n]
        n8, nc = n // 8, n // 2
        rc = L["coords"][:NI]
        fidx, r8, c8 = rc[:, 0], rc[:, 1], rc[:, 2]
        x, y = c8 * 8, r8 * 8
        ri, mv = L["ref"][:NI], L["mv"][:NI]
        # K10: luma at the 1/8-pel MV (1/16 of luma), chroma at the same MV
        # (1/16 of chroma), at the lanes' coordinates in the references
        ry_, rx_ = y + ref_origin[0], x + ref_origin[1]
        ryc, rxc = ry_ // 2, rx_ // 2
        pred = me_torch.mc_lanes(refs[0], ry_, rx_, mv[:, 0] * 2, mv[:, 1] * 2, n, n, which, bd,
                                 ref_idx=ri)
        xc, yc = x // 2, y // 2
        puv = me_torch.mc_lanes_planes([refs[1], refs[2]], ryc, rxc, mv[:, 0], mv[:, 1], nc, nc,
                                       which, bd, ref_idx=ri).reshape(2 * NI, nc, nc)
        if len(L["cmp"]):
            # K11 on the compound lanes: luma at the two 1/8-pel MVs, chroma
            # at the same values in 1/16 of the chroma plane
            ci = torch.as_tensor(L["cmp"], dtype=torch.long, device=dev)
            r2 = torch.as_tensor(sched[n]["ref2"][L["cmp"]], dtype=torch.int32, device=dev)
            m2 = torch.as_tensor(sched[n]["mv2"][L["cmp"]], dtype=torch.int32, device=dev)
            m1, r1 = mv[ci], ri[ci]
            pred[ci] = me_torch.mc_lanes_compound(refs[0], ry_[ci], rx_[ci], m1[:, 0] * 2,
                                                  m1[:, 1] * 2, m2[:, 0] * 2, m2[:, 1] * 2, n, n,
                                                  which, bd, r1, r2)
            cuv = me_torch.mc_lanes_compound_planes(
                [refs[1], refs[2]], ryc[ci], rxc[ci], m1[:, 0], m1[:, 1], m2[:, 0], m2[:, 1], nc,
                nc, which, bd, r1, r2)
            puv[ci], puv[NI + ci] = cuv[0], cuv[1]
        rq_y, rq_uv = (wavefront.rdoq_fns(rdoq_qctx, n, dev) if rdoq_qctx is not None
                       else (None, None))
        va, hv = wavefront.tx_lanes(L["tx"][:NI], tx_ntypes if n <= 16 else 1)
        lv_y, rec_y = wavefront.code_blocks(wavefront.src_blocks(src[0], fidx, x, y, n), pred, va,
                                            hv, dq_dc, dq_ac, bd, rq_y, lam)
        # inter chroma tx follows the effective luma type: DCT when the
        # quantized luma is all zero (tile_codec._chroma_tx_type)
        luma_zero = lv_y.abs().sum(dim=(1, 2)) == 0
        uv_tx = torch.where(luma_zero, 0, L["uv_tx"][:NI])
        va, hv = wavefront.tx_lanes(torch.cat([uv_tx, uv_tx]), 4 if nc <= 16 else 1)
        suv = torch.cat([wavefront.src_blocks(src[1], fidx, xc, yc, nc),
                         wavefront.src_blocks(src[2], fidx, xc, yc, nc)])
        lv_uv, rec_uv = wavefront.code_blocks(suv, puv, va, hv, dq_dc, dq_ac, bd, rq_uv, lam)
        rec_u, rec_v = rec_uv[:NI], rec_uv[NI:]
        L["ly"][:NI] = lv_y
        L["lu"][:NI] = lv_uv[:NI]
        L["lv"][:NI] = lv_uv[NI:]
        L["ry"][:NI] = rec_y
        L["ru"][:NI] = rec_u
        L["rv"][:NI] = rec_v
        wavefront.frontier_write(maps, 0, fidx, r8, c8, x, y, n8, rec_y, 8)
        wavefront.frontier_write(maps, 1, fidx, r8, c8, xc, yc, n8, rec_u, 4)
        wavefront.frontier_write(maps, 2, fidx, r8, c8, xc, yc, n8, rec_v, 4)

    t0 = time.perf_counter()
    for n, L in lanes.items():
        if L["NI"]:
            if refs is None:
                raise ValueError("inter lanes need the reference stacks")
            inter_step(n, L["NI"])
    if refs is not None:
        profiler.add("commit/phase_a", time.perf_counter() - t0)
    # phase B: the intra lanes, after the NI inter lanes of each size, by
    # wave: K16 in one launch on the card (the host time of building the
    # task table and launching; the card's time lands in the fetch that
    # waits on it)
    t0 = time.perf_counter()
    table = wavefront.wave_tasks(sched, (F, R8, C8))
    if len(table.waves):
        wavefront.commit_wave(src, maps, lanes, table, dq_dc, dq_ac, bd, tx_ntypes, lam,
                              rdoq_qctx)
        profiler.add("commit/phase_b", time.perf_counter() - t0)
        profiler.count("commit/waves", len(table.waves))

    # assemble recon planes (one index write per size/plane), the skip map,
    # and pack levels
    recon = [zeros(F, AH, AW), zeros(F, AH // 2, AW // 2), zeros(F, AH // 2, AW // 2)]
    skip8 = torch.zeros((F, R8, C8), dtype=torch.bool, device=dev)
    parts = []
    for n, L in lanes.items():
        nc, n8 = n // 2, n // 8
        coords = L["coords"]
        fi, r8, c8 = coords[:, 0, None, None], coords[:, 1], coords[:, 2]
        for pl, m, cell, key in ((0, n, 8, "ry"), (1, nc, 4, "ru"), (2, nc, 4, "rv")):
            ar_m = ar_cache[m]
            yy = (r8 * cell)[:, None, None] + ar_m[None, :, None]
            xx = (c8 * cell)[:, None, None] + ar_m[None, None, :]
            recon[pl][fi, yy, xx] = L[key]
        blk_skip = (L["ly"].abs().sum(dim=(1, 2)) + L["lu"].abs().sum(dim=(1, 2))
                    + L["lv"].abs().sum(dim=(1, 2))) == 0
        ar8 = ar_cache[n8]
        rr8 = r8[:, None, None] + ar8[None, :, None]
        cc8 = c8[:, None, None] + ar8[None, None, :]
        skip8[fi, rr8, cc8] = blk_skip[:, None, None].expand(-1, n8, n8)
        parts += [L["ly"].reshape(-1), L["lu"].reshape(-1), L["lv"].reshape(-1)]
    return torch.cat(parts).to(torch.int16), recon[0], recon[1], recon[2], skip8


def commit_regions(src_dev, params: FrameParams, leaves, dec, plans: list, region,
                   refs_dev=None, ref_ids=None, which: int = 0, array_out: bool = False,
                   fetch_levels: bool = True, ref_origin=None):
    """Commit the decided leaves of one region: fills plans in place (or,
    with array_out, returns the op-stream arrays) and returns the region's
    DEVICE recon planes and skip map (ry, ru, rv, skip8).

    `src_dev` are put_frames() (F, H, W) device planes; `leaves`/`dec`/
    `plans` are per-frame lists. For inter frames pass `refs_dev` =
    (refs_y, refs_u, refs_v) stacked (NREF, ...) uint8 device planes and
    `ref_ids` mapping stack index -> RefFrame id; `ref_origin` = (y, x) are
    the luma plane coordinates of the region's origin inside `refs_dev`
    (default the region's own origin, for whole-frame references; a tile's
    halo-cropped references pass (0, halo)). One d2h transfer (levels
    int16) for the whole batch; with array_out and fetch_levels=False it is
    left to finish_levels (aux["levels_dev"]), so the caller can do other
    work first. The recon stays on the device for the filter stage."""
    from ..constants.av1 import InterMode, RefFrame
    from ..constants.cdf import get_q_ctx
    from .device_decide import qparams_np

    p = params
    x0, y0, rw, rh = region
    with profiler.stage("commit/schedule"):
        sched_np, _W = _build_schedule(leaves, dec, region)
    R8, C8 = rh // 8, rw // 8
    sy = src_dev[0][:, y0 : y0 + rh, x0 : x0 + rw]
    su = src_dev[1][:, y0 // 2 : (y0 + rh) // 2, x0 // 2 : (x0 + rw) // 2]
    sv = src_dev[2][:, y0 // 2 : (y0 + rh) // 2, x0 // 2 : (x0 + rw) // 2]
    dqv, lam = qparams_np(p.qindex, p.bd)
    with profiler.stage("commit/device"):
        levels_dev, ry, ru, rv, skip8 = _commit_device(
            sy, su, sv, sched_np, R8, C8, p.bd, dqv, int(p.sf_tx_ntypes), float(lam),
            get_q_ctx(p.qindex) if p.enable_rdoq else None, refs=refs_dev, which=which,
            ref_origin=(y0, x0) if ref_origin is None else tuple(ref_origin))
        levels_packed = levels_dev.cpu().numpy() if fetch_levels or not array_out else None

    if array_out:
        # vectorized path: the op stream is built by codec/array_plan from
        # the aux dict
        aux = dict(sched=sched_np, ref_ids=ref_ids)
        if fetch_levels:
            aux["levels_raw"] = levels_packed
            finish_levels(aux)
        else:
            aux["levels_dev"] = levels_dev
        return ry, ru, rv, skip8, aux
    _t_unpack = time.perf_counter()
    off = 0
    for n, s in sched_np.items():
        N = len(s["coords"])
        adj, nc = min(n, 32), n // 2
        ly = levels_packed[off : off + N * adj * adj].reshape(N, adj, adj).astype(np.int32)
        off += N * adj * adj
        lu = levels_packed[off : off + N * nc * nc].reshape(N, nc, nc).astype(np.int32)
        off += N * nc * nc
        lvv = levels_packed[off : off + N * nc * nc].reshape(N, nc, nc).astype(np.int32)
        off += N * nc * nc
        fs, r8, c8 = s["coords"][:, 0], s["coords"][:, 1], s["coords"][:, 2]
        skip = ((np.abs(ly).sum((1, 2)) + np.abs(lu).sum((1, 2)) + np.abs(lvv).sum((1, 2))) == 0)
        for i in range(N):
            mi_row = (y0 // 8 + int(r8[i])) * 2
            mi_col = (x0 // 8 + int(c8[i])) * 2
            sk = bool(skip[i])
            ri = int(s["ref"][i])
            if ri >= 0:
                mv = (int(s["mv"][i, 0]), int(s["mv"][i, 1]))
                gmv = tuple(p.gm_mvs[int(ref_ids[ri])])
                d = BlockDecision(
                    y_mode=int(InterMode.GLOBALMV) if mv == gmv else int(InterMode.NEWMV),
                    ref_frame=int(ref_ids[ri]), ref_frame1=int(RefFrame.NONE), mv=mv,
                    mv1=(0, 0), ref_mv_idx=0, skip=int(sk), tx_type=TX_SEARCH[int(s["tx"][i])],
                    levels_y=None if sk else ly[i], levels_u=None if sk else lu[i],
                    levels_v=None if sk else lvv[i])
            else:
                m = MODES[int(s["mode"][i])]
                d = BlockDecision(
                    y_mode=m, uv_mode=m, skip=int(sk),
                    tx_type=TX_SEARCH[int(s["tx"][i])],
                    levels_y=None if sk else ly[i], levels_u=None if sk else lu[i],
                    levels_v=None if sk else lvv[i])
            plans[int(fs[i])].blocks[(mi_row, mi_col, BSIZE_BY_N[n])] = d
    profiler.add("commit/unpack_plan", time.perf_counter() - _t_unpack)
    return ry, ru, rv, skip8


def _deblock_device(ry, ru, rv, src_y8, flens: list, levels: tuple, sharpness: int, bd: int,
                    lf_search: tuple = ()):
    """_filter_device's DLF (K4, vertical then horizontal edges, one launch
    for the luma at every searched level and one for U and V) on the
    (F, H, W) int32 recon planes. Returns ([y, u, v] int32 planes, lf_pick
    (F,) int32: the chosen lf_search index or -1)."""
    from ..filters import dlf_torch

    F = ry.shape[0]
    dev = ry.device
    planes = [ry, ru, rv]
    lf_pick = torch.full((F,), -1, dtype=torch.int32, device=dev)
    if any(levels) or lf_search:
        def lims(lvl):  # a pass's limits; None leaves the pass out (level 0)
            return dlf_torch._limits(lvl, sharpness) if lvl else None

        if lf_search:
            # K4 at every nonzero candidate level in one launch; level 0 is ry
            src_y = src_y8.to(torch.int32)
            nz = [lvl for lvl in lf_search if lvl]
            ydb = (dlf_torch.deblock([(ry, flens[0], flens[1], lims(lvl), lims(lvl))
                                      for lvl in nz], bd) if nz else None)
            cands = [ydb[nz.index(lvl)] if lvl else ry for lvl in lf_search]
            sses = torch.stack([((c - src_y).to(torch.int64) ** 2).sum(dim=(1, 2))
                                for c in cands])  # (K, F)
            lf_pick = torch.argmin(sses, dim=0).to(torch.int32)
            if ydb is None:
                y_out = ry
            else:
                pick = lf_pick.long()
                at = torch.tensor([nz.index(lvl) if lvl else 0 for lvl in lf_search], device=dev)
                zero = torch.tensor([lvl == 0 for lvl in lf_search], device=dev)
                y_out = torch.where(zero[pick][:, None, None], ry,
                                    ydb[at[pick], torch.arange(F, device=dev)])
            luma_on = lf_pick != (lf_search.index(0) if 0 in lf_search else -1)
        else:
            y_out = (dlf_torch.deblock([(ry, flens[0], flens[1], lims(levels[0]),
                                         lims(levels[1]))], bd)[0]
                     if levels[0] or levels[1] else ry)
            luma_on = torch.full((F,), bool(levels[0] or levels[1]), device=dev)
        # U and V in one K4 launch, each at its level
        uv = [(pl, flens[fi], flens[fi + 1], lims(lvl), lims(lvl))
              for pl, fi, lvl in ((planes[1], 2, levels[2]), (planes[2], 4, levels[3])) if lvl]
        duv = iter(dlf_torch.deblock(uv, bd) if uv else ())
        uv_out = [next(duv) if lvl else pl for pl, lvl in ((planes[1], levels[2]),
                                                            (planes[2], levels[3]))]
        # a frame whose luma levels are both 0 codes no chroma level and the
        # decoder filters none of its planes (spec 5.9.11, 7.14.1); the
        # reference filters its chroma all the same (ROADMAP queue 3)
        keep = luma_on[:, None, None]
        planes = [y_out, torch.where(keep, uv_out[0], planes[1]),
                  torch.where(keep, uv_out[1], planes[2])]
    return planes, lf_pick


def _filter_device(ry, ru, rv, src_y8, skip8, flens: list, levels: tuple, sharpness: int,
                   bd: int, damping: int, enable_cdef: bool, disp_dims=None, cdef_cands: int = 0,
                   lf_search: tuple = ()):
    """In-loop filters on the device (reference _filter_device): DLF (K4,
    vertical then horizontal edges, one launch for the luma at every
    searched level and one for U and V), then CDEF search and apply
    (K6, K7), then display-edge replication (spec 7.11.3.4 MC clamp;
    encoder.replicate_display_edges twin) when disp_dims=(width, height),
    then the pack to one uint8 (bd 8) or int16 buffer.

    flens: the six filter-length maps (plane, pass) as (F, rows/4, K) int32
    device tensors; src_y8 (F, H, W) source luma; skip8 (F, H/8, W/8) bool.
    lf_search: candidate luma levels (ascending); each is applied and the
    one with the least luma SSE against the source wins per frame (ties to
    the smaller level; the SSE is an exact int64 sum). Empty: apply
    levels[0] / levels[1]. Returns (packed, stats (F, 5) int32 device tensor
    [cdef y_pri, y_sec, uv_pri, uv_sec, lf_pick] with lf_pick the chosen
    lf_search index or -1, the [y, u, v] (F, H, W) uint8 (bd 8) or int16
    planes that `packed` concatenates: with disp_dims they can enter a
    device DPB as they are)."""
    from ..filters import cdef_torch

    F = ry.shape[0]
    dev = ry.device
    planes, lf_pick = _deblock_device(ry, ru, rv, src_y8, flens, levels, sharpness, bd, lf_search)
    if enable_cdef:
        planes, strengths = cdef_torch.cdef_frames(
            [pl.contiguous() for pl in planes], src_y8.to(torch.int32), ~skip8, damping, bd=bd,
            n_cand=cdef_cands)
    else:
        strengths = torch.zeros((F, 4), dtype=torch.int32, device=dev)
    if disp_dims is not None:
        w, h = disp_dims
        out = []
        for pi, pl in enumerate(planes):
            pw, ph = (w, h) if pi == 0 else (w >> 1, h >> 1)
            pl = pl.contiguous().clone() if (pw < pl.shape[2] or ph < pl.shape[1]) else pl
            if pw < pl.shape[2]:
                pl[:, :, pw:] = pl[:, :, pw - 1 : pw]
            if ph < pl.shape[1]:
                pl[:, ph:, :] = pl[:, ph - 1 : ph, :]
            out.append(pl)
        planes = out
    odt = torch.uint8 if bd == 8 else torch.int16
    planes = [pl.to(odt).contiguous() for pl in planes]
    packed = torch.cat([pl.reshape(-1) for pl in planes])
    return packed, torch.cat([strengths.to(torch.int32), lf_pick[:, None]], dim=1), planes


def _lf_candidates(base: int) -> tuple:
    """Frame-level DLF luma candidate ladder around the by-q guess
    (svt_av1_pick_filter_level search neighborhood at honest scale)."""
    if base <= 0:
        return ()
    return tuple(sorted({0, base // 2, base, min(63, base + max(base // 2, 2))}))


def _size_maps(leaves, F: int, R8: int, C8: int) -> np.ndarray:
    """(F, R8, C8) luma block size per 8px cell from the leaf lists."""
    sm = np.zeros((F, R8, C8), np.int32)
    for f, lv in enumerate(leaves):
        for (mi_row, mi_col, n) in lv:
            r8, c8, n8 = mi_row // 2, mi_col // 2, n // 8
            sm[f, r8 : r8 + n8, c8 : c8 + n8] = n
    return sm


def flen_maps(leaves, p: FrameParams, device) -> list:
    """_filter_device's six DLF filter-length maps (plane, pass) of F frames
    from their leaf lists, as int32 tensors on `device`. With
    TX_MODE_LARGEST every filtered edge is a prediction-block edge, so the
    skip/ref terms of the normative mask never suppress an edge and the
    leaf size map alone gives the maps, for intra and inter frames alike."""
    from ..filters import dlf_torch

    sm = _size_maps(leaves, len(leaves), p.aligned_height // 8, p.aligned_width // 8)
    return [torch.as_tensor(dlf_torch.flen_maps_from_sizes(sm, plane, tr, (p.width, p.height)),
                            dtype=torch.int32, device=device)
            for plane in range(3) for tr in (False, True)]


def restoration_filters(ry, ru, rv, src_y8, skip8, leaves, p: FrameParams,
                        enable_cdef: bool, deblocked: bool = True) -> list:
    """The in-loop filters of the reference's host route, on the device: DLF
    at the frame's levels p.lf_levels (K4, no level search), then CDEF (K6,
    K7) at the strengths the reference's host search picks
    (filters/cdef.search_strengths: the whole ladder, the luma SSE over
    every fourth non-skip 8x8 unit in raster order), and no display-edge
    replication (the restoration filter, or the caller, follows). The
    (F, H, W) int32 recon planes, source luma and skip map are
    _filter_device's; leaves: each frame's leaf list. Returns per frame
    (the CDEF output, filt): host int32 planes, and filt = dict(lf_levels,
    cdef=(y_pri, y_sec, uv_pri, uv_sec, damping)) with, when `deblocked`,
    deblocked=the deblocked planes, which the restoration search and
    filter read at stripe boundaries."""
    from ..filters import cdef as cdef_mod
    from ..filters import cdef_torch

    F = ry.shape[0]
    with profiler.stage("filter"):
        planes, _ = _deblock_device(ry, ru, rv, src_y8, flen_maps(leaves, p, ry.device),
                                    p.lf_levels, p.lf_sharpness, p.bd)
        damping, cdef_out = 3, planes
        strengths = torch.zeros((F, 4), dtype=torch.int32, device=ry.device)
        if enable_cdef:
            damping = cdef_mod.pick_damping(p.qindex)
            nonskip = ~skip8
            cdef_out, strengths = cdef_torch.cdef_frames(
                [pl.contiguous() for pl in planes], src_y8.to(torch.int32), nonskip, damping,
                bd=p.bd, search_mask=cdef_torch.sampled_cells(nonskip, 4))
        fetch = (planes + cdef_out) if deblocked else cdef_out
        odt = torch.uint8 if p.bd == 8 else torch.int16
        packed = torch.cat([pl.to(odt).reshape(F, -1) for pl in fetch], dim=1).cpu().numpy()
        strengths = strengths.cpu().numpy()
    out = []
    for f in range(F):
        off, got = 0, []
        for pl in fetch:
            shp = tuple(pl.shape[1:])
            got.append(packed[f, off : off + shp[0] * shp[1]].reshape(shp).astype(np.int32))
            off += shp[0] * shp[1]
        filt = dict(lf_levels=tuple(p.lf_levels),
                    cdef=tuple(int(v) for v in strengths[f]) + (damping,))
        if deblocked:
            filt["deblocked"] = got[:3]
        out.append((got[-3:], filt))
    return out


def plan_filters(plan: Plan, recon: list, src_y, p: FrameParams, device, enable_cdef: bool,
                 deblocked: bool = False) -> tuple:
    """DLF and CDEF of a host mode decision's frame on the device: the
    reference's _encode_one under mode_decision="numpy" runs
    filters/dlf.loop_filter_frame at p.lf_levels, then
    cdef.search_strengths and cdef_frame, on the mi grid of the plan
    (mi_from_plan); here restoration_filters runs on the uploaded recon
    with the plan's blocks as its leaves and their skip flags as its 8x8
    skip map. The host mode decision codes square blocks of 8x8 to 64x64
    with their largest transform, so the leaf size map gives every edge,
    as on the device route. recon: host [y, u, v] int32 planes (aligned
    dims); src_y: the source luma. Returns (the CDEF output as host int32
    planes, filt) as restoration_filters gives them for one frame."""
    from ..constants.av1 import BLOCK_W

    dt = plane_np_dtype(p.bd)
    skip8 = np.zeros((p.aligned_height // 8, p.aligned_width // 8), bool)
    leaves = []
    for (mi_row, mi_col, bsize), d in plan.blocks.items():
        n = int(BLOCK_W[bsize])
        leaves.append((mi_row, mi_col, n))
        r8, c8, n8 = mi_row // 2, mi_col // 2, n // 8
        skip8[r8 : r8 + n8, c8 : c8 + n8] = bool(d.skip)
    with profiler.stage("filter"):
        ry, ru, rv, src_y8 = (torch.from_numpy(np.asarray(pl, dt)[None]).to(device)
                              for pl in (*recon, src_y))
        skip8 = torch.from_numpy(skip8[None]).to(device)
    [out] = restoration_filters(ry.to(torch.int32), ru.to(torch.int32), rv.to(torch.int32),
                                src_y8, skip8, [leaves], p, enable_cdef, deblocked)
    return out


def encode_intra_frames(src_frames: list, params: FrameParams, device,
                        apply_filters: bool = False, enable_dlf: bool = True,
                        enable_cdef: bool = True, use_arrays: bool | None = None,
                        walk_fcs: list | None = None, restoration: bool = False):
    """Device intra encoder over a BATCH of independent frames on `device`:
    per tile (tiles are prediction boundaries, so each region runs alone),
    batched open-loop decide at all sizes, host partition DP per frame and
    wavefront commit; then, over the whole frame, (apply_filters) DLF with
    the by-q levels (the luma level searched when p.sf_dlf_search) and
    p.lf_sharpness, CDEF with its strength search (the 4-entry ladder when
    p.sf_cdef_fast), and display-edge replication; the entropy payloads,
    one per tile, are built by the vectorized array-plan path with the
    native walker (None when it is unavailable — the caller then walks the
    Plan). Tile 0 of frame f adapts walk_fcs[f] in place (its end state is
    the frame's stored context); later tiles restart from the
    frame-initial state, as the spec decodes them. restoration: the
    filters of the restoration route instead (restoration_filters, CDEF
    when enable_cdef), without payloads: the plan walk follows the
    restoration search.

    Returns [(plan, recon, filt, payloads), ...] per frame: filt =
    dict(lf_levels, cdef=(y_pri, y_sec, uv_pri, uv_sec, damping)) when
    apply_filters (restoration: restoration_filters' filt) else None.
    src_frames: list of [y, u, v] plane lists (aligned dims)."""
    from ..codec import array_plan
    from ..codec.tile_walk_native import run_tile_ops
    from ..constants.cdf import FrameContext
    from ..entropy import native
    from ..filters import cdef as cdef_mod
    from ..filters import dlf as dlf_mod
    from . import device_decide
    from .intra_md import rd_lambda

    p = params
    F = len(src_frames)
    fc = FrameContext(p.qindex)
    lam = float(rd_lambda(p.qindex, p.bd))
    aw, ah = p.aligned_width, p.aligned_height
    src_dev = device_decide.put_frames(src_frames, p.bd, device)
    if restoration:
        use_arrays = False
    elif use_arrays is None:
        use_arrays = native.available() and not p.enable_filter_intra
    plans = [Plan() for _ in range(F)]
    if walk_fcs is None:
        walk_fcs = [FrameContext(p.qindex) for _ in range(F)]
    tiles = p.tiles()
    fc_inits = [w.clone() for w in walk_fcs] if len(tiles) > 1 else None
    payloads = [[] for _ in range(F)] if use_arrays else [None] * F
    leaves_all = [[] for _ in range(F)]
    regions = []
    for ti, tile in enumerate(tiles):
        r0, r1, c0, c1 = tile
        x0, y0 = c0 * 64, r0 * 64
        region = (x0, y0, min(c1 * 64, aw) - x0, min(r1 * 64, ah) - y0)
        with profiler.stage("decide"):
            decs = device_decide.decide_intra_frames(src_dev, p, region)
        leaves, trees = [], []
        with profiler.stage("partition_dp"):
            for f in range(F):
                partitions, lv, tree = device_decide.partition_dp(decs[f], p, fc, lam, region)
                plans[f].partitions.update(partitions)
                leaves.append(lv)
                trees.append(tree)
                leaves_all[f].extend(lv)
        out = commit_regions(src_dev, p, leaves, decs, plans, region, array_out=use_arrays)
        if use_arrays:
            ry, ru, rv, skip8, aux = out
            with profiler.stage("entropy_walk"):
                for f in range(F):
                    ops = array_plan.build_tile_ops(p, trees[f], aux["sched"], aux["level_base"],
                                                    f, region, tile, None, TX_SEARCH, MODES)[0]
                    fc_t = walk_fcs[f] if ti == 0 else fc_inits[f].clone()
                    payloads[f].append(run_tile_ops(p, fc_t, ops, aux["levels_i32"], tile))
        else:
            ry, ru, rv, skip8 = out
        regions.append((region, ry, ru, rv, skip8))
    if len(regions) > 1:  # the frame's recon and skip map from its tiles
        dev = regions[0][1].device
        ry = torch.zeros((F, ah, aw), dtype=torch.int32, device=dev)
        ru = torch.zeros((F, ah // 2, aw // 2), dtype=torch.int32, device=dev)
        rv = torch.zeros((F, ah // 2, aw // 2), dtype=torch.int32, device=dev)
        skip8 = torch.zeros((F, ah // 8, aw // 8), dtype=torch.bool, device=dev)
        for (x0, y0, rw, rh), a, b, c, s8 in regions:
            ry[:, y0 : y0 + rh, x0 : x0 + rw] = a
            ru[:, y0 // 2 : (y0 + rh) // 2, x0 // 2 : (x0 + rw) // 2] = b
            rv[:, y0 // 2 : (y0 + rh) // 2, x0 // 2 : (x0 + rw) // 2] = c
            skip8[:, y0 // 8 : (y0 + rh) // 8, x0 // 8 : (x0 + rw) // 8] = s8

    if restoration:
        return [(plans[f], recon, filt, None) for f, (recon, filt) in enumerate(
            restoration_filters(ry, ru, rv, src_dev[0], skip8, leaves_all, p, enable_cdef))]
    filt = [None] * F
    with profiler.stage("filter"):
        if apply_filters:
            levels = (dlf_mod.pick_filter_levels(p.qindex, p.bd, True, p.height)
                      if enable_dlf else (0, 0, 0, 0))
            flens = flen_maps(leaves_all, p, ry.device)
            damping = cdef_mod.pick_damping(p.qindex)
            lf_search = _lf_candidates(levels[0]) if p.sf_dlf_search else ()
            packed, stats, _planes = _filter_device(
                ry, ru, rv, src_dev[0], skip8, flens, tuple(levels), p.lf_sharpness, p.bd,
                damping, enable_cdef, disp_dims=(p.width, p.height),
                cdef_cands=4 if p.sf_cdef_fast else 0, lf_search=lf_search)
            stats = stats.cpu().numpy()
            filt = []
            for f in range(F):
                ylvl = lf_search[int(stats[f, 4])] if lf_search else levels[0]
                filt.append(dict(lf_levels=(ylvl, ylvl, levels[2], levels[3]),
                                 cdef=(int(stats[f, 0]), int(stats[f, 1]),
                                       int(stats[f, 2]), int(stats[f, 3]), damping)))
        else:
            odt = torch.uint8 if p.bd == 8 else torch.int16
            packed = torch.cat([ry.to(odt).reshape(-1), ru.to(odt).reshape(-1),
                                rv.to(odt).reshape(-1)])
        packed = packed.cpu().numpy()

    ysz, csz = ah * aw, (ah // 2) * (aw // 2)
    yy = packed[: F * ysz].reshape(F, ah, aw).astype(np.int32)
    uu = packed[F * ysz : F * (ysz + csz)].reshape(F, ah // 2, aw // 2).astype(np.int32)
    vv = packed[F * (ysz + csz) :].reshape(F, ah // 2, aw // 2).astype(np.int32)
    return [(plans[f], [yy[f], uu[f], vv[f]], filt[f], payloads[f]) for f in range(F)]
