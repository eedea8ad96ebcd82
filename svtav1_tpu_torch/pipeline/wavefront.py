"""Commit phase B, the intra wavefront, around the CUDA kernel
`csrc/commit.cu` (K16 commit_wave), with its plain PyTorch version beside it.

The commit (device_commit._commit_device) codes its inter lanes in phase A
and then its intra lanes in anti-diagonal waves: each wave's blocks read the
recon of blocks in earlier waves through the frontier maps. `wave_tasks`
turns the commit's schedule into one wave-major task table: a task is one
block of one plane (a size, a lane of that size's schedule and a plane),
and `wave_start` bounds each wave's tasks. Only the waves that hold intra
lanes are in the table. Beside it, the owner map: per plane and 8x8 luma
cell, the task that writes the cell's frontier samples. A task's
predecessors are the owners of the cells it reads.

`commit_wave` runs the whole table: on a CUDA tensor K16, one launch of warp
workers in which a task waits only for its predecessors; on a CPU tensor the
plain version `commit_wave_plain`, which walks the same table wave by wave
with the lanes of a wave batched by size and plane group, through K1
(predict), K2 (txfm_quant_recon, or its halves around K5 rdoq). On the card
the plain version launches those kernels per wave; chip_smoke.py holds K16
against it.

Both update, in place, the frontier maps and each size's level and recon
slots of the intra lanes. Frontier maps: `bmap[pl][f, r8, x]` = recon row
(r8+1)*cell-1, `rmap[pl][f, c8, y]` = recon column (c8+1)*cell-1,
`cmap[pl][f, r8, c8]` = the bottom-right sample of the 8x8 luma cell (cell
= 8 luma, 4 chroma samples). Each cell has one writer.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..constants.av1 import MAX_TXSIZE_RECT
from ..ops import quantize as quant_ops
from ..ops import transforms as T
from ..ops import transforms_torch as TT
from .device_decide import SIZES
from .intra_device import BSIZE_BY_N, _dr, _weights, predict

LANE_SHIFT, PLANE_SHIFT = 5, 3  # task code = lane << 5 | plane << 3 | size index
# FrameDesc of csrc/commit.cu, one int64 per field
FRAME_FIELDS = 13  # src[3], bmap[3], rmap[3], cmap[3], dr
SIZE_FIELDS = 10   # coords, mode, tx, uv_tx, lv[3], rec[3]
PLANE_FIELDS = 17  # see PlaneDesc
KEYS_LV, KEYS_REC = ("ly", "lu", "lv"), ("ry", "ru", "rv")


@dataclass
class WaveTable:
    """The wave-major task table of one commit (host numpy).

    tasks (T,) int32 codes, wave_start (nw + 1,) int32, waves (nw,) the
    schedule's wave numbers, tx (T,) the tasks' TX_SEARCH indices (luma tx
    or chroma uv_tx), max_n the largest luma block size among the tasks,
    max_tasks the widest wave; owner (3, F, R8p, C8p) int32: per plane and
    8x8 luma cell, the task that writes the cell's frontier samples, -1
    under an inter lane (phase A) or no lane, over the grid padded to whole
    superblocks (R8p, C8p = owner_grid(R8, C8)). Task t's predecessors are
    the owners of the cells it reads (`predecessors`)."""
    tasks: np.ndarray
    wave_start: np.ndarray
    waves: np.ndarray
    tx: np.ndarray
    max_n: int
    max_tasks: int
    owner: np.ndarray

    def decode(self):
        """(size index, plane, lane) arrays of the tasks."""
        c = self.tasks
        return c & 7, (c >> PLANE_SHIFT) & 3, c >> LANE_SHIFT


def owner_grid(R8: int, C8: int) -> tuple:
    """The owner map's rows and columns: the cell grid padded to whole
    64x64 superblocks (K16 pads R8 and C8 alike)."""
    return -(-R8 // 8) * 8, -(-C8 // 8) * 8


def wave_tasks(sched: dict, grid: tuple) -> WaveTable:
    """The task table of a commit schedule (device_commit._build_schedule)
    over a grid of (F, R8, C8) 8x8 luma cells: every intra lane of every
    size once per plane, ordered by wave, then larger blocks first, then
    plane, then lane, and the owner map of its cells. Vectorized numpy."""
    wave, n_of, pl_of, lane_of, code, tx, geo = [], [], [], [], [], [], []
    for si, n in enumerate(SIZES):
        s = sched.get(n)
        if s is None or not s["NW"]:
            continue
        NI, NW = int(s["NI"]), int(s["NW"])
        offs = np.asarray(s["offsets"], np.int64)
        w = np.repeat(np.arange(len(offs) - 1, dtype=np.int32), np.diff(offs))
        lane = NI + np.arange(NW, dtype=np.int32)
        if NI + NW >= 1 << (31 - LANE_SHIFT):
            raise ValueError(f"commit schedule too large for the task codes: {NI + NW} lanes")
        geo.append((np.asarray(s["coords"], np.int64)[NI:], n // 8))
        for pl in range(3):
            wave.append(w)
            n_of.append(np.full(NW, n, np.int32))
            pl_of.append(np.full(NW, pl, np.int32))
            lane_of.append(lane)
            code.append((lane << LANE_SHIFT) | (pl << PLANE_SHIFT) | si)
            tx.append(np.asarray(s["uv_tx" if pl else "tx"], np.int32)[NI:])
    F, R8, C8 = grid
    owner = np.full((3, F, *owner_grid(R8, C8)), -1, np.int32)
    if not code:
        z = np.zeros(0, np.int32)
        return WaveTable(z, np.zeros(1, np.int32), z, z, 8, 0, owner)
    wave, n_of, pl_of, lane_of = (np.concatenate(a) for a in (wave, n_of, pl_of, lane_of))
    code, tx = np.concatenate(code), np.concatenate(tx)
    order = np.lexsort((lane_of, pl_of, -n_of, wave))
    wave, code = wave[order], code[order]
    waves, counts = np.unique(wave, return_counts=True)
    start = np.zeros(len(waves) + 1, np.int32)
    np.cumsum(counts, out=start[1:])
    # each task's table index, in the unsorted order: per size, its lanes'
    # Y, then U, then V tasks; per size one assignment of every plane's
    # owners to whole n8 x n8 blocks of the map (lanes are aligned to their
    # size; the advanced indices' axis comes first, then plane and block)
    where = np.empty(len(order), np.int32)
    where[order] = np.arange(len(order), dtype=np.int32)
    at = 0
    for coords, n8 in geo:
        NW = len(coords)
        f, r8, c8 = coords.T
        blocks = owner.reshape(3, F, owner.shape[2] // n8, n8, owner.shape[3] // n8, n8)
        blocks[:, f, r8 // n8, :, c8 // n8, :] = where[at : at + 3 * NW].reshape(3, NW).T[
            :, :, None, None]
        at += 3 * NW
    return WaveTable(code.astype(np.int32), start, waves.astype(np.int32), tx[order],
                     int(n_of.max()), int(counts.max()), owner)


def read_cells(table: WaveTable):
    """(task, plane, f, r8, c8) of every 8x8 luma cell each task reads, as
    K16 reads them: the row above over [c8 - 1, c8 + n8) (the top-left cell
    only where there is a left column), the column to the left over [r8,
    r8 + n8). A task's own cells, and so its geometry, come from the owner
    map."""
    own = table.owner
    _, F, R8, C8 = own.shape
    T = len(table.tasks)
    idx = np.flatnonzero(own.ravel() >= 0)
    task = own.ravel()[idx]
    first = np.full(T, own.size, np.int64)
    np.minimum.at(first, task, idx)  # row-major: each task's top-left cell
    n8 = np.rint(np.sqrt(np.bincount(task, minlength=T))).astype(np.int64)
    pf, rest = np.divmod(first, R8 * C8)
    r8, c8 = np.divmod(rest, C8)
    k = np.arange(17)[None, :]  # a lane per cell: the corner, n8 above, n8 left
    above = k <= n8[:, None]
    rr = np.where(above, r8[:, None] - 1, r8[:, None] + k - n8[:, None] - 1)
    cc = np.where(above, c8[:, None] - 1 + k, c8[:, None] - 1)
    ok = (k <= 2 * n8[:, None]) & (rr >= 0) & (cc >= 0)
    t = np.broadcast_to(np.arange(T)[:, None], ok.shape)[ok]
    pf = np.broadcast_to(pf[:, None], ok.shape)[ok]
    return t, pf // F, pf % F, rr[ok], cc[ok]


def predecessors(table: WaveTable):
    """CSR lists (pred_start (T + 1,), preds) of the tasks' predecessors:
    the owners of the cells each reads (read_cells), each once, in
    ascending order. For the chain bound and the tests; K16 reads the
    owner map itself."""
    t, pl, f, r8, c8 = read_cells(table)
    o = table.owner[pl, f, r8, c8].astype(np.int64)
    T = len(table.tasks)
    key = np.unique(t[o >= 0] * T + o[o >= 0])
    pred_start = np.zeros(T + 1, np.int32)
    np.cumsum(np.bincount(key // T, minlength=T), out=pred_start[1:])
    return pred_start, (key % T).astype(np.int32)


def chain_length(table: WaveTable, weight=None, edge: float = 0.0) -> float:
    """The longest path through the predecessor DAG: each task on it counts
    weight[t] (1 when None), each edge `edge`. With neither, the dependency
    depth in tasks. A wave at a time: predecessors lie in earlier waves."""
    T = len(table.tasks)
    if not T:
        return 0.0
    w = np.ones(T) if weight is None else np.asarray(weight, np.float64)
    dist = np.zeros(T)
    ps, pr = predecessors(table)
    ws = table.wave_start
    for k in range(len(table.waves)):
        a, b = int(ws[k]), int(ws[k + 1])
        best = np.zeros(b - a)
        e0, e1 = int(ps[a]), int(ps[b])
        if e1 > e0:
            owner = np.repeat(np.arange(b - a), np.diff(ps[a : b + 1]))
            np.maximum.at(best, owner, dist[pr[e0:e1]] + edge)
        dist[a:b] = best + w[a:b]
    return float(dist.max())


# ---------------------------------------------------------------------------
# shared pieces of the commit (phase A uses src_blocks and frontier_write)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _arange(m: int, device: str) -> torch.Tensor:
    return torch.arange(m, device=device)


def edges_from(maps, pl: int, fidx, r8, c8, ha, hl, xx, yy, m: int, base: int):
    """Above row, left column and top-left sample of lanes of plane pl from
    the frontier maps, with the commit's fills: no above row takes the left
    column's first sample (base - 1 without it), no left column the above
    row's first sample (base + 1 without it)."""
    bmap, rmap, cmap = maps
    ar_m = _arange(m, str(fidx.device))
    rr = (r8 - 1).clamp(min=0)
    cc = (c8 - 1).clamp(min=0)
    ar = bmap[pl][fidx[:, None], rr[:, None], xx[:, None] + ar_m[None, :]]
    lc = rmap[pl][fidx[:, None], cc[:, None], yy[:, None] + ar_m[None, :]]
    tl = cmap[pl][fidx, rr, cc]
    left_fill = torch.where(ha, ar[:, 0], base + 1)
    above_fill = torch.where(hl, lc[:, 0], base - 1)
    ar = torch.where(ha[:, None], ar, above_fill[:, None])
    lc = torch.where(hl[:, None], lc, left_fill[:, None])
    tl = torch.where(ha & hl, tl,
                     torch.where(ha, ar[:, 0], torch.where(hl, lc[:, 0], base)))
    return ar, lc, tl


def src_blocks(plane, fidx, xx, yy, m: int):
    """(L, m, m) blocks of the (F, H, W) plane at (yy, xx) of frames fidx."""
    ar_m = _arange(m, str(fidx.device))
    return plane[fidx[:, None, None], yy[:, None, None] + ar_m[None, :, None],
                 xx[:, None, None] + ar_m[None, None, :]]


def frontier_write(maps, pl: int, fidx, r8, c8, xx, yy, n8: int, rec, step: int):
    """Write the frontier cells of lanes' recon (L, m, m) of plane pl."""
    bmap, rmap, cmap = maps
    m = rec.shape[-1]
    dev = str(fidx.device)
    ar_m = _arange(m, dev)
    bmap[pl][fidx[:, None], (r8 + n8 - 1)[:, None], xx[:, None] + ar_m[None, :]] = rec[:, -1, :]
    rmap[pl][fidx[:, None], (c8 + n8 - 1)[:, None], yy[:, None] + ar_m[None, :]] = rec[:, :, -1]
    ar8 = _arange(n8, dev)
    rr8 = r8[:, None, None] + ar8[None, :, None]
    cc8 = c8[:, None, None] + ar8[None, None, :]
    cmap[pl][fidx[:, None, None], rr8, cc8] = rec[:, step - 1::step, step - 1::step]


def tx_lanes(tx_idx, ntypes: int):
    """(v_adst, h_adst) of TX_SEARCH indices (DCT_DCT, ADST_ADST, ADST_DCT,
    DCT_ADST); all DCT where the size has one type."""
    if ntypes == 1:
        z = torch.zeros(tx_idx.shape, dtype=torch.bool, device=tx_idx.device)
        return z, z
    return (tx_idx == 1) | (tx_idx == 2), (tx_idx == 1) | (tx_idx == 3)


@functools.lru_cache(maxsize=None)
def _rdoq_fns_cached(qctx: int, n: int, device: str):
    from ..codec import rate_torch
    from ..codec.tile_codec import max_uv_txsize
    from .device_decide import fc_for_qctx

    fc = fc_for_qctx(qctx)
    bsize = BSIZE_BY_N[n]
    return (rate_torch.make_rdoq_fn(fc, int(MAX_TXSIZE_RECT[bsize]), 0, device=device),
            rate_torch.make_rdoq_fn(fc, int(max_uv_txsize(bsize)), 1, txb_skip_ctx=7,
                                    device=device))


def rdoq_fns(qctx: int, n: int, device):
    """(luma, chroma) RDOQ tables of block size n, keyed on the
    coefficient-CDF qindex bucket (reference device_commit._rdoq_fns)."""
    return _rdoq_fns_cached(qctx, n, str(torch.device(device)))


def code_blocks(src, pred, va, ha, dq_dc: int, dq_ac: int, bd: int, rdoq_fn, lam):
    """select_txfm + _quant_rdoq of the reference: (levels (L, adj, adj),
    recon (L, n, n)); with rdoq_fn, K2's halves around K5, else fused K2."""
    if rdoq_fn is None:
        lv, rec, _ = TT.txfm_quant_recon(src, pred, va, ha, dq_dc, dq_ac, bd)
        return lv, rec
    lv, coeff = TT.txfm_quant(src, pred, va, ha, dq_dc, dq_ac, bd)
    lv = rdoq_fn(lv, coeff, dq_dc, dq_ac, lam)
    return lv, TT.recon_from_levels(lv, pred, va, ha, dq_dc, dq_ac, bd)


# ---------------------------------------------------------------------------
# plain version: the wave loop of K1, K2 and K5
# ---------------------------------------------------------------------------


def _code_group(src, maps, L: dict, n: int, planes: tuple, idxs: list, dq_dc: int, dq_ac: int,
                bd: int, ntypes: int, lam: float, rdoq_fn) -> None:
    """One plane group of one size in one wave: luma (planes (0,)) or the
    chroma planes stacked into one batch; idxs are each plane's lanes."""
    chroma = planes[0] != 0
    m, cell, n8 = (n // 2 if chroma else n), (4 if chroma else 8), n // 8
    base = 1 << (bd - 1)
    geo, edges, blocks, modes, txs = [], [], [], [], []
    for pl, idx in zip(planes, idxs):
        rc = L["coords"][idx]
        fidx, r8, c8 = rc[:, 0], rc[:, 1], rc[:, 2]
        x, y = c8 * cell, r8 * cell
        ha, hl = r8 > 0, c8 > 0
        geo.append((fidx, r8, c8, x, y))
        edges.append(edges_from(maps, pl, fidx, r8, c8, ha, hl, x, y, m, base) + (ha, hl))
        blocks.append(src_blocks(src[pl], fidx, x, y, m))
        modes.append(L["mode"][idx])
        txs.append(L["uv_tx" if chroma else "tx"][idx])
    cat = [torch.cat(parts) for parts in zip(*edges)]
    pred = predict(*cat, m, mode=torch.cat(modes), bd=bd)
    va, hv = tx_lanes(torch.cat(txs), ntypes)
    lv, rec = code_blocks(torch.cat(blocks), pred, va, hv, dq_dc, dq_ac, bd, rdoq_fn, lam)
    a = 0
    for pl, idx, (fidx, r8, c8, x, y) in zip(planes, idxs, geo):
        b = a + len(fidx)
        L[KEYS_LV[pl]][idx] = lv[a:b]
        L[KEYS_REC[pl]][idx] = rec[a:b]
        frontier_write(maps, pl, fidx, r8, c8, x, y, n8, rec[a:b], cell)
        a = b


def commit_wave_plain(src, maps, lanes: dict, table: WaveTable, dq_dc: int, dq_ac: int, bd: int,
                      tx_ntypes: int, lam: float, rdoq_qctx: int | None) -> None:
    """Plain version of K16; same arguments and effects as commit_wave."""
    dev = src[0].device
    si_all, pl_all, lane_all = table.decode()
    for k in range(len(table.waves)):
        a, b = int(table.wave_start[k]), int(table.wave_start[k + 1])
        si, pl, lane = si_all[a:b], pl_all[a:b], lane_all[a:b]
        for s in np.unique(si):
            n = SIZES[int(s)]
            rq_y, rq_uv = (rdoq_fns(rdoq_qctx, n, dev) if rdoq_qctx is not None
                           else (None, None))
            idx = [_lane_index(lane[(si == s) & (pl == p)], dev) for p in range(3)]
            args = (dq_dc, dq_ac, bd)
            if idx[0] is not None:
                _code_group(src, maps, lanes[n], n, (0,), idx[:1], *args,
                            tx_ntypes if n <= 16 else 1, lam, rq_y)
            if idx[1] is not None:
                _code_group(src, maps, lanes[n], n, (1, 2), idx[1:], *args,
                            4 if n // 2 <= 16 else 1, lam, rq_uv)


def _lane_index(lanes: np.ndarray, dev):
    """An index of these lanes: a slice where they are consecutive (the
    table's order within a wave, size and plane), else a tensor; None for
    no lane."""
    if not len(lanes):
        return None
    if (np.diff(lanes) == 1).all():
        return slice(int(lanes[0]), int(lanes[-1]) + 1)
    return torch.as_tensor(lanes, dtype=torch.long, device=dev)


# ---------------------------------------------------------------------------
# K16
# ---------------------------------------------------------------------------


def _f32_bits(x: float) -> int:
    return int(np.array(x, np.float32).view(np.int32))


@functools.lru_cache(maxsize=None)
def _plane_fields(n: int, chroma: bool, tx_ntypes: int, rdoq_qctx: int | None,
                  device: str) -> np.ndarray:
    """PlaneDesc of luma size n's luma or chroma blocks (every table stays
    alive in its own cache)."""
    m = n // 2 if chroma else n
    ntypes = (4 if m <= 16 else 1) if chroma else (tx_ntypes if n <= 16 else 1)
    s0, s1, s2 = T.FWD_SHIFTS[(m, m)]
    sh_row, sh_col = T.INV_SHIFTS[(m, m)]
    f = np.zeros(PLANE_FIELDS, np.int64)
    f[0] = _weights(m, device).data_ptr()
    if rdoq_qctx is not None:
        rt = rdoq_fns(rdoq_qctx, n, device)[int(chroma)]
        f[1:4] = (rt.rate.flut.data_ptr(), rt.rate.ilut.data_ptr(), rt.scan.data_ptr())
        f[8], f[9] = rt.ls, int(math.log2(rt.w))
        f[15], f[16] = _f32_bits(rt.dscale), _f32_bits(rt.skip_delta)
    f[4:8] = (m, int(math.log2(m)), ntypes, quant_ops.tx_scale(m, m))
    f[10:15] = (-s0, -s1, -s2, sh_row, sh_col)
    return f


def _frame_desc(src, maps, lanes: dict, tx_ntypes: int, rdoq_qctx, device: str) -> np.ndarray:
    bmap, rmap, cmap = maps
    fd = np.zeros(FRAME_FIELDS + len(SIZES) * (SIZE_FIELDS + 2 * PLANE_FIELDS), np.int64)
    fd[:FRAME_FIELDS] = [t.data_ptr() for t in (*src, *bmap, *rmap, *cmap)] + \
        [_dr(device).data_ptr()]
    for si, n in enumerate(SIZES):
        if n not in lanes:
            continue
        L = lanes[n]
        o = FRAME_FIELDS + si * (SIZE_FIELDS + 2 * PLANE_FIELDS)
        fd[o : o + SIZE_FIELDS] = [L[k].data_ptr() for k in
                                   ("coords", "mode", "tx", "uv_tx", *KEYS_LV, *KEYS_REC)]
        o += SIZE_FIELDS
        for chroma in (False, True):
            fd[o : o + PLANE_FIELDS] = _plane_fields(n, chroma, tx_ntypes, rdoq_qctx, device)
            o += PLANE_FIELDS
    return fd


@functools.lru_cache(maxsize=None)
def _co_resident(max_n: int, device_index: int) -> int:
    del device_index  # the card the answer holds for (the cache key)
    g = kernels.lib().commit_wave_grid(max_n, 1 << 30)
    if g <= 0:
        raise RuntimeError(f"commit_wave: no co-resident CTA fits (cudaError {-g})")
    return g


def grid_of(max_n: int, T: int, device_index: int) -> int:
    """K16's grid: the co-resident CTAs (one warp worker each) of the card,
    at most T."""
    return min(_co_resident(max_n, device_index), max(T, 1))


def commit_wave(src, maps, lanes: dict, table: WaveTable, dq_dc: int, dq_ac: int, bd: int,
                tx_ntypes: int, lam: float, rdoq_qctx: int | None) -> None:
    """Commit phase B: every task of `table`, each after its predecessors.

    src: the [y, u, v] (F, H, W) int32 source planes of the region; maps:
    (bmap, rmap, cmap), each a list of the three planes' int32 frontier
    maps (F, R8, W), (F, C8, H), (F, R8, C8) with phase A's cells written;
    lanes: {n: dict(coords (N, 3) int64, mode, tx, uv_tx (N,) int32, ly,
    lu, lv (N, adj, adj) / (N, n/2, n/2) and ry, ru, rv (N, n, n) /
    (N, n/2, n/2) int32)}, the intra lanes' slots written here; rdoq_qctx:
    the RDOQ tables' qindex bucket, None for no RDOQ. K16 on CUDA tensors
    (one launch), the plain version on CPU tensors."""
    if src[0].device.type == "cpu":
        return commit_wave_plain(src, maps, lanes, table, dq_dc, dq_ac, bd, tx_ntypes, lam,
                                 rdoq_qctx)
    if not len(table.waves):
        return None
    dev = src[0].device
    F, H, W = src[0].shape
    R8, C8 = H // 8, W // 8
    for pl in range(3):
        s = 1 if pl else 0
        kernels.check(src[pl], "src", torch.int32, (F, H >> s, W >> s))
        kernels.check(maps[0][pl], "bmap", torch.int32, (F, R8, W >> s))
        kernels.check(maps[1][pl], "rmap", torch.int32, (F, C8, H >> s))
        kernels.check(maps[2][pl], "cmap", torch.int32, (F, R8, C8))
    for n, L in lanes.items():
        N, adj, nc = L["coords"].shape[0], min(n, 32), n // 2
        kernels.check(L["coords"], "coords", torch.int64, (N, 3))
        for k in ("mode", "tx", "uv_tx"):
            kernels.check(L[k], k, torch.int32, (N,))
        for k, shape in zip(KEYS_LV + KEYS_REC, ((adj, adj), (nc, nc), (nc, nc), (n, n),
                                                  (nc, nc), (nc, nc))):
            kernels.check(L[k], k, torch.int32, (N, *shape))
    if table.owner.shape != (3, F, *owner_grid(R8, C8)):
        raise ValueError(f"commit_wave: owner map {table.owner.shape} for planes of {(F, H, W)}")
    fd = _frame_desc(src, maps, lanes, tx_ntypes, rdoq_qctx, str(dev))
    T = len(table.tasks)
    # one upload per commit: the descriptors, the table, its owner map and
    # room for the queue's counter and the ready flags (the launch zeroes
    # those)
    parts = [fd, table.tasks, table.owner.ravel(), np.zeros(T + 1, np.int32)]
    blob_d = torch.as_tensor(np.concatenate([a.view(np.uint8) for a in parts]), device=dev)
    ptrs = blob_d.data_ptr() + np.cumsum([0] + [a.nbytes for a in parts[:-1]])
    grid = grid_of(table.max_n, T, dev.index or 0)
    kernels.launch("commit_wave", *(int(p) for p in ptrs), T, F, R8, C8, int(dq_dc), int(dq_ac),
                   bd, int(rdoq_qctx is not None), float(lam), table.max_n, grid,
                   kernels.stream_ptr(src[0]))
    return None


def handoff_ms(device, rounds: int = 2000) -> float:
    """Milliseconds of one handoff of a ready flag between two CTAs (K16's
    cost per dependency edge): `rounds` round trips of one flag in device
    memory, CUDA events around them after a warm launch, over 2 x rounds."""
    dev = torch.device(device)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = kernels.lib().flag_pingpong_launch
    if fn(flag.data_ptr(), 10, stream):
        raise RuntimeError("flag_pingpong failed to launch")
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    err = fn(flag.data_ptr(), rounds, stream)
    b.record()
    torch.cuda.synchronize(dev)
    if err:
        raise RuntimeError(f"flag_pingpong failed to launch: cudaError {err}")
    return a.elapsed_time(b) / (2 * rounds)
