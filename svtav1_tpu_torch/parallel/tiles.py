"""Tile-parallel decide (PyTorch), ported from svtav1_tpu's
parallel/tiles.py: the tile columns of one frame are decided together and
assembled into ONE multi-tile bitstream.

The reference shards the decide over a `jax.sharding.Mesh` with
`shard_map`, one tile column per device, and reduces the frame's RD cost
with a `psum` over the tile axis. One card is one device, so here the mesh
axis becomes the batch dimension of one set of kernel launches and the
`psum` a `.sum()`:

- `_mesh_decide_fn` (the intra decide) stacks the T equal tile slabs and
  runs each block size's K1 (prediction), K2 (transform, quantization,
  recon) and K3 (coefficient rate) launches over all of them at once. Per
  tile penalty grids ride along as data, (T, R, C, 13), because the
  rightmost tile's edge availability differs.
- `_mesh_inter_fn` (the inter decide) gives every tile its references
  cropped with a HALO-column margin on each side (built on the card, the
  frame's edge columns replicated): per tile and reference the full-pel ME
  (K8) with `ref_off_x=HALO` and the subpel search (K9) at the tile's
  columns + HALO; the 7-mode intra candidates of all tiles in one batch;
  then each tile's inter candidates (`inter_device._decide_inter_size` on
  K10, K2, K3 with `ref_off_x=HALO`).

After the decide, each tile runs the host partition DP, the wavefront
commit (`device_commit.commit_regions`; inter tiles read the halo-cropped
references at `ref_origin=(0, HALO)`) and the native entropy walk; the
recon is assembled from the tiles. Filters are the caller's frame-wide
stage, as in the reference.

Limits kept from the reference: every tile has the same width and height
(uniform columns of whole superblocks, one tile row), and the inter decide
runs its ME on the unpadded tile, so its tiles' dims must be multiples of
64 (the reference's reshape at parallel/tiles.py:242 and :261 fails
otherwise).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..codec.tile_codec import FrameParams
from ..constants.cdf import FrameContext, get_q_ctx
from ..kernels import resolve_device

HALO = 128  # per-tile reference margin in luma columns: covers the full
# HME reach (L2 +-16 at quarter resolution = +-64 full pels, the +-2 L1
# and L0 refinements and the leaf maps' +-4) plus the 8-tap subpel margin,
# so every sample a tile's MC can touch is a real one


def _region_of(p: FrameParams, tile) -> tuple:
    """(x0, y0, w, h) in pixels of a (sb_row0, sb_row1, sb_col0, sb_col1)
    tile, clipped to the aligned frame."""
    r0, r1, c0, c1 = tile
    x0, y0 = c0 * 64, r0 * 64
    return (x0, y0, min(c1 * 64, p.aligned_width) - x0, min(r1 * 64, p.aligned_height) - y0)


def _tile_consts(p: FrameParams, qctx: int, tiles: list):
    """Per-tile penalty grids, stacked on axis 0 ({n: (T, R, C, 13)}), and
    the shared mode and tx-type rate tables of every size that fits in a
    tile."""
    from ..pipeline.device_decide import (SIZES, _penalty_grid_np, fc_for_qctx,
                                          intra_mode_cost_const, intra_txtype_cost_const)

    fc = fc_for_qctx(qctx)
    _x0, _y0, rw, rh = _region_of(p, tiles[0])
    sizes = [n for n in SIZES if rh // n and rw // n]
    pens = {}
    for n in sizes:
        per_tile = []
        for t in tiles:
            tx0, ty0, trw, trh = _region_of(p, t)
            mi_end = (min((ty0 + trh) // 4, p.mi_rows), min((tx0 + trw) // 4, p.mi_cols))
            per_tile.append(_penalty_grid_np(p, ty0, tx0, trh // n, trw // n, n, (tx0, ty0),
                                             mi_end))
        pens[n] = np.stack(per_tile)
    mode_cost = {n: intra_mode_cost_const(fc, n, bool(p.frame_is_intra)) for n in sizes}
    txt_cost = {n: intra_txtype_cost_const(fc, n) for n in sizes}
    return sizes, pens, mode_cost, txt_cost


def _mesh_params(width: int, height: int, bd: int, ntiles: int, is_key: bool) -> FrameParams:
    """The frame's parameters with ntiles uniform tile columns; raises
    ValueError unless they give ntiles tiles of equal dims."""
    log2 = int(ntiles).bit_length() - 1
    if ntiles < 1 or (1 << log2) != ntiles:
        raise ValueError(f"ntiles {ntiles}: a power of two")
    p = FrameParams(width=width, height=height, qindex=100, bd=bd, frame_is_intra=is_key,
                    tile_cols_log2=log2)
    tiles = p.tiles()
    if len(tiles) != ntiles:
        raise ValueError(f"{width}x{height} holds {len(tiles)} tile columns, not {ntiles}")
    regions = [_region_of(p, t) for t in tiles]
    if any(r[2:] != regions[0][2:] for r in regions):
        raise ValueError("the tile decide needs tiles of equal dims: "
                         f"{[r[2:] for r in regions]}")
    return p


def _slabs(planes, regions, sub: int):
    """(T, h, w) stack of the tiles' crops of one (F=1, H, W) device plane."""
    return torch.stack([planes[0, r[1] >> sub : (r[1] + r[3]) >> sub,
                               r[0] >> sub : (r[0] + r[2]) >> sub] for r in regions]).contiguous()


@functools.lru_cache(maxsize=8)
def _mesh_decide_fn(width: int, height: int, qctx: int, bd: int, ntiles: int, device: str):
    """The intra decide of an ntiles-column key frame with its per-frame
    constants on `device`. Returns (run, layout, tiles, regions):
    run(sy_pl, su_pl, sv_pl, dqv, lam) takes (T, h, w) tile slabs and returns
    (packed (T, L) float32: per size the cost, mode and tx grids of each
    tile; total, the frame's summed cost)."""
    from ..pipeline.device_decide import _decide_intra_size, _rate_fns

    p = _mesh_params(width, height, bd, ntiles, True)
    tiles = p.tiles()
    regions = [_region_of(p, t) for t in tiles]
    rw, rh = regions[0][2], regions[0][3]
    dev = torch.device(device)
    sizes, pens, mode_cost, txt_cost = _tile_consts(p, qctx, tiles)
    layout = [(n, rh // n, rw // n) for n in sizes]
    consts = {n: (torch.as_tensor(pens[n], device=dev), torch.as_tensor(mode_cost[n], device=dev),
                  torch.as_tensor(txt_cost[n], device=dev), _rate_fns(qctx, n, dev))
              for n in sizes}

    def run(sy_pl, su_pl, sv_pl, dqv, lam):
        T = sy_pl.shape[0]
        sy, su, sv = (x.to(torch.int32) for x in (sy_pl, su_pl, sv_pl))
        dq = (int(dqv[0]), int(dqv[1]))
        lam_t = torch.tensor(lam, dtype=torch.float32, device=dev)
        packed = []
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for n, R, C in layout:
            pen, mc, tc, rate_fns = consts[n]
            cost, mode, tx = _decide_intra_size(sy, su, sv, pen, mc, tc, n, rate_fns, dq, bd, R,
                                                C, lam_t)
            packed += [cost.reshape(T, -1), mode.to(torch.float32).reshape(T, -1),
                       tx.to(torch.float32).reshape(T, -1)]
            total = total + cost.sum()  # the reference's psum over the tile axis
        return torch.cat(packed, dim=1), total

    return run, layout, tiles, regions


def _unpack(row: np.ndarray, layout, fields) -> dict:
    """One tile's {n: {field: (R, C) grid}} from its packed row."""
    dec = {}
    off = 0
    for n, R, C in layout:
        g = {}
        for k in fields:
            arr = row[off : off + R * C].reshape(R, C)
            g[k] = arr.astype(np.float64) if k == "cost" else arr.astype(np.int32)
            off += R * C
        dec[n] = g
    return dec


def _walk_ready():
    from ..entropy import native

    if not native.available():
        raise RuntimeError("the tile encoders need the native entropy walker "
                           "(svtav1_tpu_torch/entropy/native, built with gcc at first use)")


def encode_intra_frame_mesh(src_planes: list, p_base: FrameParams, ntiles: int, device=None):
    """Encode ONE key frame in `ntiles` tile columns: the tiles' intra
    decide as one batch on the card, then per tile the host partition DP,
    the wavefront commit and the native walk. Returns (payloads, recon
    planes (aligned, int32 numpy), frame params); the caller wraps the
    payloads in one multi-tile frame OBU. No in-loop filters.

    src_planes: [y, u, v] at the aligned dims of p_base; device: None means
    CUDA (raises without a card), "cpu" runs the plain versions."""
    from ..codec import array_plan
    from ..codec.tile_walk_native import run_tile_ops
    from ..pipeline import device_commit, device_decide
    from ..pipeline.device_decide import MODES, TX_SEARCH, qparams_np
    from ..pipeline.intra_md import rd_lambda

    dev = resolve_device(device)
    qctx = get_q_ctx(p_base.qindex)
    run, layout, tiles, regions = _mesh_decide_fn(p_base.width, p_base.height, qctx, p_base.bd,
                                                  ntiles, str(dev))
    _walk_ready()
    p = FrameParams(width=p_base.width, height=p_base.height, qindex=p_base.qindex,
                    bd=p_base.bd, frame_is_intra=True, tile_cols_log2=int(np.log2(ntiles)))
    fc = FrameContext(p.qindex)
    lam = float(rd_lambda(p.qindex, p.bd))
    dqv, lam_op = qparams_np(p.qindex, p.bd)
    src_dev = device_decide.put_frames([src_planes], p.bd, dev)
    packed, total = run(_slabs(src_dev[0], regions, 0), _slabs(src_dev[1], regions, 1),
                        _slabs(src_dev[2], regions, 1), dqv, lam_op)
    packed = packed.cpu().numpy()
    if not float(total) >= 0.0:
        raise RuntimeError(f"tile decide: frame cost {float(total)}")

    aw, ah = p.aligned_width, p.aligned_height
    recon = [torch.zeros((ah, aw), dtype=torch.int32, device=dev),
             torch.zeros((ah // 2, aw // 2), dtype=torch.int32, device=dev),
             torch.zeros((ah // 2, aw // 2), dtype=torch.int32, device=dev)]
    payloads = []
    for ti, (tile, region) in enumerate(zip(tiles, regions)):
        dec = _unpack(packed[ti], layout, ("cost", "mode", "tx"))
        _parts, leaves, tree = device_decide.partition_dp(dec, p, fc, lam, region)
        ry, ru, rv, _skip8, aux = device_commit.commit_regions(
            src_dev, p, [leaves], [dec], [None], region, array_out=True)
        x0, y0, rw, rh = region
        recon[0][y0 : y0 + rh, x0 : x0 + rw] = ry[0]
        recon[1][y0 // 2 : (y0 + rh) // 2, x0 // 2 : (x0 + rw) // 2] = ru[0]
        recon[2][y0 // 2 : (y0 + rh) // 2, x0 // 2 : (x0 + rw) // 2] = rv[0]
        ops, _k = array_plan.build_tile_ops(p, tree, aux["sched"], aux["level_base"], 0, region,
                                            tile, None, TX_SEARCH, MODES)
        payloads.append(run_tile_ops(p, FrameContext(p.qindex), ops, aux["levels_i32"], tile))
    return payloads, [pl.cpu().numpy() for pl in recon], p


# ---------------------------------------------------------------- inter mesh

_INTER_FIELDS = ("cost", "is_inter", "mode", "tx", "ref", "mvy", "mvx", "ref2", "mv2y", "mv2x")


@functools.lru_cache(maxsize=8)
def _mesh_inter_fn(width: int, height: int, qctx: int, bd: int, ntiles: int, nref: int,
                   which: int, device: str):
    """The inter decide of an ntiles-column frame against nref references,
    per-tile ME on halo-cropped reference slabs, with its per-frame
    constants on `device`. Returns (run, layout, tiles, regions):
    run(sy_pl, su_pl, sv_pl, ry, ru, rv, dqv, lam) takes (T, h, w) tile slabs
    and (T, NREF, h, w + 2 * HALO) reference crops in
    me_torch.plane_dtype(bd) (chroma halves both) and returns (packed
    (T, L) float32: per size the ten decision grids of each tile; total,
    the frame's summed cost)."""
    from ..codec import rate_torch
    from ..ops import me_torch
    from ..pipeline.device_decide import _blocks_of, _decide_intra_size, _rate_fns, fc_for_qctx
    from ..pipeline.inter_device import (MAX_MV_ABS, _decide_inter_size, inter_cand_cost_const,
                                         inter_txtype_cost_const)

    p = _mesh_params(width, height, bd, ntiles, False)
    tiles = p.tiles()
    regions = [_region_of(p, t) for t in tiles]
    rw, rh = regions[0][2], regions[0][3]
    if rh % 64 or rw % 64:
        raise ValueError(f"the inter tile decide needs tile heights and widths that are "
                         f"multiples of 64 (its ME runs on the unpadded tile, as the "
                         f"reference's does); {width}x{height} gives {rw}x{rh} tiles")
    dev = torch.device(device)
    fc = fc_for_qctx(qctx)
    sizes, pens, mode_cost, txt_cost = _tile_consts(p, qctx, tiles)
    layout = [(n, rh // n, rw // n) for n in sizes]

    def t(a):
        return torch.as_tensor(a, device=dev)

    intra_consts = {n: (t(pens[n]), t(mode_cost[n]), t(txt_cost[n]), _rate_fns(qctx, n, dev))
                    for n in sizes}
    # the reference's mesh prices every reference's NEWMV as LAST's
    cb = inter_cand_cost_const(fc, (1,))
    cand_bits = dict(new=[t(np.float32(b)) for b in cb["new"]], glob=t(np.float32(cb["glob"])),
                     comp=None)
    inter_txt = {n: t(inter_txtype_cost_const(fc, n)) for n in sizes}
    joint = t(rate_torch.mv_joint_cost(fc))
    comp = t(rate_torch.mv_component_cost_lut(fc, MAX_MV_ABS))
    sbr, sbc = rh // 64, rw // 64

    def run(sy_pl, su_pl, sv_pl, ry, ru, rv, dqv, lam):
        T = sy_pl.shape[0]
        dq = (int(dqv[0]), int(dqv[1]))
        lam_t = torch.tensor(lam, dtype=torch.float32, device=dev)
        sy, su, sv = (x.to(torch.int32) for x in (sy_pl, su_pl, sv_pl))
        # the 7-mode intra candidates of every tile in one batch per size
        intra = {}
        for n, R, C in layout:
            pen, mc, tc, rate_fns = intra_consts[n]
            intra[n] = _decide_intra_size(sy, su, sv, pen, mc, tc, n, rate_fns, dq, bd, R, C,
                                          lam_t, nmodes=7)
        packed = [[] for _ in range(T)]
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for ti in range(T):
            sy_t = sy[ti : ti + 1]
            mv_by_ref = {n: [] for n in sizes}
            mc_by_ref = {n: [] for n in sizes}
            sb_pred = []
            src_pyr = me_torch.me_pyramid(sy_pl[ti], sbr, sbc, bd) if nref > 1 else None
            for ri in range(nref):
                ref = ry[ti, ri]
                mvs_fp, mv_sb = me_torch.me_fullpel_frame(sy_pl[ti], ref, sbr, sbc, ref_off_x=HALO,
                                                          src_pyr=src_pyr, bd=bd)
                sb_pred.append(mv_sb.reshape(sbr, sbc, 2) * 8)
                for n, R, C in layout:
                    fp = mvs_fp[n][:R, :C].reshape(R * C, 2)
                    ys = torch.arange(R, device=dev, dtype=torch.int32).repeat_interleave(C) * n
                    xs = torch.arange(C, device=dev, dtype=torch.int32).repeat(R) * n
                    mv8, mc8 = me_torch.subpel_pred_lanes(_blocks_of(sy_t, n, R, C), ref, ys,
                                                          xs + HALO, fp, which, bd)
                    mv_by_ref[n].append(mv8.clamp(-MAX_MV_ABS, MAX_MV_ABS))
                    mc_by_ref[n].append(mc8)
            for n, R, C in layout:
                k = 64 // n
                preds = [sb.repeat_interleave(k, 0).repeat_interleave(k, 1)[:R, :C]
                         .reshape(R * C, 2) for sb in sb_pred]
                cost_a, mode_a, tx_a = intra[n]
                outs = _decide_inter_size(
                    sy_t, su[ti : ti + 1], sv[ti : ti + 1], ry[ti], ru[ti], rv[ti],
                    mv_by_ref[n], preds, (cost_a[ti], mode_a[ti], tx_a[ti]),
                    (joint, comp, cand_bits, inter_txt[n]), n, intra_consts[n][3], dq, bd, R, C,
                    lam_t, which, mc_by_ref[n], ref_off_x=HALO)
                total = total + outs[0].sum()  # the reference's psum over the tile axis
                packed[ti] += [o.to(torch.float32) for o in outs]
        return torch.stack([torch.cat(row) for row in packed]), total

    return run, layout, tiles, regions


def _halo_crops(ref_planes, regions, sub: int):
    """(T, NREF, h, w + 2 * halo) crops of a (NREF, H, W) device stack
    around each tile, the frame's edge columns replicated (np.pad edge)."""
    W = ref_planes.shape[-1]
    halo = HALO >> sub
    dev = ref_planes.device
    out = []
    for x0, y0, rw, rh in regions:
        cols = (torch.arange(-halo, (rw >> sub) + halo, device=dev) + (x0 >> sub)).clamp(0, W - 1)
        out.append(ref_planes[:, y0 >> sub : (y0 + rh) >> sub][:, :, cols])
    return torch.stack(out).contiguous()


def encode_inter_frame_mesh(src_planes: list, p_base: FrameParams, refs: dict, ntiles: int,
                            device=None, walk_fc=None):
    """Encode ONE inter frame in `ntiles` tile columns: the tiles' decide
    on the card (per tile ME against halo-cropped references, cost summed
    over the tiles), then per tile the host partition DP, the wavefront
    commit on the cropped references and the native walk (tile 0 adapts
    `walk_fc` in place when given; every other tile starts from its
    frame-initial state). Returns (payloads, recon planes (aligned, int32
    numpy), params, frame_mi); the in-loop filters are the caller's
    frame-wide stage.

    refs: {RefFrame id: [y, u, v] aligned planes (numpy or tensors)};
    device: None means CUDA (raises without a card), "cpu" runs the plain
    versions. Raises ValueError unless the tiles' heights and widths are
    multiples of 64, as the reference's mesh needs."""
    from ..codec import array_plan
    from ..codec.tile_codec import Plan
    from ..codec.tile_walk_native import run_tile_ops
    from ..ops import me_torch
    from ..pipeline import device_commit, device_decide
    from ..pipeline.device_decide import MODES, TX_SEARCH, qparams_np
    from ..pipeline.intra_md import rd_lambda

    dev = resolve_device(device)
    if (1 << p_base.tile_cols_log2) != ntiles or p_base.tile_rows_log2:
        raise ValueError(f"p_base codes {len(p_base.tiles())} tiles, not {ntiles} tile columns")
    qctx = get_q_ctx(p_base.qindex)
    ref_ids = sorted(refs.keys())
    which = p_base.interp_filter
    run, layout, tiles, regions = _mesh_inter_fn(p_base.width, p_base.height, qctx, p_base.bd,
                                                 ntiles, len(ref_ids), which, str(dev))
    _walk_ready()
    p = p_base
    fc = FrameContext(p.qindex)
    lam = float(rd_lambda(p.qindex, p.bd))
    dqv, lam_op = qparams_np(p.qindex, p.bd)
    src_dev = device_decide.put_frames([src_planes], p.bd, dev)
    dt = me_torch.plane_dtype(p.bd)
    stacks = [torch.stack([torch.as_tensor(refs[r][pl]).to(dev, dt) for r in ref_ids])
              for pl in range(3)]
    crops = [_halo_crops(stacks[pl], regions, int(pl > 0)) for pl in range(3)]
    packed, total = run(_slabs(src_dev[0], regions, 0), _slabs(src_dev[1], regions, 1),
                        _slabs(src_dev[2], regions, 1), *crops, dqv, lam_op)
    packed = packed.cpu().numpy()
    if not float(total) >= 0.0:
        raise RuntimeError(f"tile decide: frame cost {float(total)}")

    aw, ah = p.aligned_width, p.aligned_height
    recon = [np.zeros((ah, aw), np.int32), np.zeros((ah // 2, aw // 2), np.int32),
             np.zeros((ah // 2, aw // 2), np.int32)]
    payloads = []
    frame_mi = None
    fc_init = walk_fc.clone() if walk_fc is not None else FrameContext(p.qindex)
    for ti, (tile, region) in enumerate(zip(tiles, regions)):
        dec = _unpack(packed[ti], layout, _INTER_FIELDS)
        partitions, leaves, tree = device_decide.partition_dp(dec, p, fc, lam, region)
        plan = Plan()
        plan.partitions.update(partitions)
        ry, ru, rv, _s8, aux = device_commit.commit_regions(
            src_dev, p, [leaves], [dec], [plan], region, refs_dev=[c[ti] for c in crops],
            ref_ids=ref_ids, which=which, array_out=True, ref_origin=(0, HALO))
        x0, y0, rw, rh = region
        recon[0][y0 : y0 + rh, x0 : x0 + rw] = ry[0].cpu().numpy()
        recon[1][y0 // 2 : (y0 + rh) // 2, x0 // 2 : (x0 + rw) // 2] = ru[0].cpu().numpy()
        recon[2][y0 // 2 : (y0 + rh) // 2, x0 // 2 : (x0 + rw) // 2] = rv[0].cpu().numpy()
        ops, _k = array_plan.build_tile_ops(p, tree, aux["sched"], aux["level_base"], 0, region,
                                            tile, ref_ids, TX_SEARCH, MODES)
        frame_mi = array_plan.mi_from_sched(p, aux["sched"], 0, region, ref_ids, MODES,
                                            mi=frame_mi)
        fc_t = walk_fc if (ti == 0 and walk_fc is not None) else fc_init.clone()
        payloads.append(run_tile_ops(p, fc_t, ops, aux["levels_i32"], tile))
    return payloads, recon, p, frame_mi
