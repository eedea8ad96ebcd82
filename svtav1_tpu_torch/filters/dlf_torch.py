"""Deblocking on the device — PyTorch port of filters/dlf_jax.py around the
CUDA kernel `csrc/dlf_edges.cu` (K4), with a plain PyTorch version beside it.

Planes carry a leading frame dimension (F, H, W) int32. Filter-length maps
are built on the host from per-8px-cell block-size maps (all-intra frames:
an edge filters iff it is a transform edge), as in the reference. K4
deblocks whole planes, both passes, for up to three jobs in one launch
(`deblock`): the luma level search's candidate levels, or U and V.
`filter_vertical_edges_plain`, one pass of the reference, is the plain
version's building block.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from .dlf import _limits  # noqa: F401 (re-exported: the filter limits of a level)
from .dlf import offscreen


def size_map_tx_w(size_map: np.ndarray, plane: int) -> np.ndarray:
    """Per-8px-cell tx width in plane samples. size_map holds luma block
    sizes (8/16/32/64); luma tx = block size (TX_MODE_LARGEST), chroma tx
    width = clip(n/2, 4, 32)."""
    if plane == 0:
        return size_map.astype(np.int32)
    return np.clip(size_map.astype(np.int32) >> 1, 4, 32)


def flen_maps_from_sizes(size_map: np.ndarray, plane: int, transpose: bool,
                         disp_dims: tuple) -> np.ndarray:
    """(F, mi4_rows, K) filter-length map for vertical edges (columns at
    x = 4(k+1) plane samples) of one plane, for ALL-INTRA frames.

    size_map: (F, R8, C8) luma block size per 8px cell. transpose=True
    builds the map for the horizontal pass (rows/cols swapped).
    disp_dims = (width, height) of the displayed luma frame: the edge
    segments outside it get length 0, as the spec leaves them unfiltered
    (dlf.offscreen)."""
    sm = np.swapaxes(size_map, 1, 2) if transpose else size_map
    F, R8, C8 = sm.shape
    ss = 0 if plane == 0 else 1
    pw = C8 * (8 >> ss)
    ph = R8 * (8 >> ss)
    n_rows = ph // 4
    K = pw // 4 - 1
    tw = size_map_tx_w(sm, plane)
    x = (np.arange(1, K + 1)) * 4
    cell = x // (8 >> ss)
    mid_cell = (x % (8 >> ss)) != 0
    prev_cell = np.where(mid_cell, cell, np.maximum(cell - 1, 0))
    tw_c = tw[:, :, cell]
    tw_p = tw[:, :, prev_cell]
    is_tx_edge = (x[None, None, :] % tw_c) == 0
    min_tw = np.minimum(tw_c, tw_p)
    if plane == 0:
        f = np.where(min_tw == 4, 4, np.where(min_tw == 8, 8, 14))
    else:
        f = np.where(min_tw == 4, 4, 6)
    flen_band = np.where(is_tx_edge, f, 0).astype(np.int8)
    reps = (8 >> ss) // 4
    flen = np.repeat(flen_band, reps, axis=1)[:, :n_rows]
    cw, ch = ((d + ss) >> ss for d in disp_dims)
    flen[:, offscreen(n_rows, K, *((ch, cw) if transpose else (cw, ch)))] = 0
    return flen


def filter_vertical_edges_plain(planes, flen4, lim: int, blim: int, thr: int, bd: int = 8):
    """Plain PyTorch version of K4 (dlf_jax.filter_vertical_edges_j):
    (F, H, W) int32 planes, flen4 (F, H//4, K) -> new filtered planes."""
    F, H, W = planes.shape
    K = flen4.shape[2]
    if K == 0:
        return planes.clone()
    dev = planes.device
    sh = bd - 8
    lim, blim, thr = lim << sh, blim << sh, thr << sh
    half = 128 << sh
    fthr = 1 << sh
    planes = planes.clone()

    def clip8(v):
        return v.clamp(-half, half - 1)

    flen_s = flen4.to(torch.int32).repeat_interleave(4, dim=1)[:, :H]
    cols = (np.arange(K) + 1) * 4

    def col(off):
        return planes[:, :, torch.as_tensor(np.clip(cols + off, 0, W - 1), device=dev)].to(torch.int32)

    p = [col(-1 - i) for i in range(7)]
    q = [col(i) for i in range(7)]
    a = torch.abs

    def narrow(mask):
        ps1, ps0 = p[1] - half, p[0] - half
        qs0, qs1 = q[0] - half, q[1] - half
        hev = (a(p[1] - p[0]) > thr) | (a(q[1] - q[0]) > thr)
        f = clip8(ps1 - qs1) * hev
        f = clip8(f + 3 * (qs0 - ps0)) * mask
        f1 = clip8(f + 4) >> 3
        f2 = clip8(f + 3) >> 3
        oq0 = clip8(qs0 - f1) + half
        op0 = clip8(ps0 + f2) + half
        t = ((f1 + 1) >> 1) * (~hev)
        oq1 = clip8(qs1 - t) + half
        op1 = clip8(ps1 + t) + half
        return op1, op0, oq0, oq1

    def fmask2():
        return ((a(p[1] - p[0]) <= lim) & (a(q[1] - q[0]) <= lim) &
                (a(p[0] - q[0]) * 2 + a(p[1] - q[1]) // 2 <= blim))

    def fmask3():
        return fmask2() & (a(p[2] - p[1]) <= lim) & (a(q[2] - q[1]) <= lim)

    def fmask_full():
        return fmask3() & (a(p[3] - p[2]) <= lim) & (a(q[3] - q[2]) <= lim)

    def flat_n(nn):
        m = (a(p[1] - p[0]) <= fthr) & (a(q[1] - q[0]) <= fthr)
        for i in range(2, nn):
            m &= (a(p[i] - p[0]) <= fthr) & (a(q[i] - q[0]) <= fthr)
        return m

    def r2(v, s):
        return (v + (1 << (s - 1))) >> s

    sel4, sel6, sel8, sel14 = flen_s == 4, flen_s == 6, flen_s == 8, flen_s == 14
    w = torch.where
    out = {}

    def base(off):
        return p[-off - 1] if off < 0 else q[off]

    n4 = narrow(fmask2() & sel4)
    for off, v in zip((-2, -1, 0, 1), n4):
        out[off] = w(sel4, v, base(off))

    mask6 = fmask3() & sel6
    flat6 = flat_n(3) & mask6
    n6 = narrow(mask6 & ~flat6)
    l6 = {-2: r2(p[2] * 3 + p[1] * 2 + p[0] * 2 + q[0], 3),
          -1: r2(p[2] + p[1] * 2 + p[0] * 2 + q[0] * 2 + q[1], 3),
          0: r2(p[1] + p[0] * 2 + q[0] * 2 + q[1] * 2 + q[2], 3),
          1: r2(p[0] + q[0] * 2 + q[1] * 2 + q[2] * 3, 3)}
    for off, nar in zip((-2, -1, 0, 1), n6):
        out[off] = w(sel6, w(flat6, l6[off], nar), out.get(off, base(off)))

    mask8 = fmask_full() & sel8
    flat8 = flat_n(4) & mask8
    n8 = dict(zip((-2, -1, 0, 1), narrow(mask8 & ~flat8)))
    l8 = {-3: r2(p[3] * 3 + p[2] * 2 + p[1] + p[0] + q[0], 3),
          -2: r2(p[3] * 2 + p[2] + p[1] * 2 + p[0] + q[0] + q[1], 3),
          -1: r2(p[3] + p[2] + p[1] + p[0] * 2 + q[0] + q[1] + q[2], 3),
          0: r2(p[2] + p[1] + p[0] + q[0] * 2 + q[1] + q[2] + q[3], 3),
          1: r2(p[1] + p[0] + q[0] + q[1] * 2 + q[2] + q[3] * 2, 3),
          2: r2(p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 3, 3)}
    for off in range(-3, 3):
        v = w(flat8, l8[off], n8.get(off, base(off)))
        out[off] = w(sel8, v, out.get(off, base(off)))

    mask14 = fmask_full() & sel14
    flat14 = flat_n(4) & mask14
    flat2 = ((a(p[6] - p[0]) <= fthr) & (a(p[5] - p[0]) <= fthr) &
             (a(p[4] - p[0]) <= fthr) & (a(q[4] - q[0]) <= fthr) &
             (a(q[5] - q[0]) <= fthr) & (a(q[6] - q[0]) <= fthr) &
             (a(p[1] - p[0]) <= fthr) & (a(q[1] - q[0]) <= fthr)) & flat14
    n14 = dict(zip((-2, -1, 0, 1), narrow(mask14 & ~flat14)))
    l14 = {
        -6: r2(p[6] * 7 + p[5] * 2 + p[4] * 2 + p[3] + p[2] + p[1] + p[0] + q[0], 4),
        -5: r2(p[6] * 5 + p[5] * 2 + p[4] * 2 + p[3] * 2 + p[2] + p[1] + p[0] + q[0] + q[1], 4),
        -4: r2(p[6] * 4 + p[5] + p[4] * 2 + p[3] * 2 + p[2] * 2 + p[1] + p[0] + q[0] + q[1] + q[2], 4),
        -3: r2(p[6] * 3 + p[5] + p[4] + p[3] * 2 + p[2] * 2 + p[1] * 2 + p[0] + q[0] + q[1] + q[2]
               + q[3], 4),
        -2: r2(p[6] * 2 + p[5] + p[4] + p[3] + p[2] * 2 + p[1] * 2 + p[0] * 2 + q[0] + q[1] + q[2]
               + q[3] + q[4], 4),
        -1: r2(p[6] + p[5] + p[4] + p[3] + p[2] + p[1] * 2 + p[0] * 2 + q[0] * 2 + q[1] + q[2]
               + q[3] + q[4] + q[5], 4),
        0: r2(p[5] + p[4] + p[3] + p[2] + p[1] + p[0] * 2 + q[0] * 2 + q[1] * 2 + q[2] + q[3]
              + q[4] + q[5] + q[6], 4),
        1: r2(p[4] + p[3] + p[2] + p[1] + p[0] + q[0] * 2 + q[1] * 2 + q[2] * 2 + q[3] + q[4]
              + q[5] + q[6] * 2, 4),
        2: r2(p[3] + p[2] + p[1] + p[0] + q[0] + q[1] * 2 + q[2] * 2 + q[3] * 2 + q[4] + q[5]
              + q[6] * 3, 4),
        3: r2(p[2] + p[1] + p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 2 + q[4] * 2 + q[5] + q[6] * 4, 4),
        4: r2(p[1] + p[0] + q[0] + q[1] + q[2] + q[3] * 2 + q[4] * 2 + q[5] * 2 + q[6] * 5, 4),
        5: r2(p[0] + q[0] + q[1] + q[2] + q[3] + q[4] * 2 + q[5] * 2 + q[6] * 7, 4),
    }
    for off in range(-6, 6):
        orig = base(off)
        v = w(flat2, l14[off], w(flat14, l8.get(off, orig), n14.get(off, orig)))
        out[off] = w(sel14, v, out.get(off, orig))

    def classmask(off):
        m = sel14
        if -3 <= off <= 2:
            m = m | sel8
        if -2 <= off <= 1:
            m = m | sel4 | sel6
        return m

    # stores in offset order, as the reference (later offsets win)
    for off in sorted(out):
        tcols = cols + off
        valid = (tcols >= 0) & (tcols < W)
        tc = torch.as_tensor(tcols[valid], device=dev)
        cur = planes[:, :, tc]
        planes[:, :, tc] = w(classmask(off)[:, :, valid], out[off][:, :, valid], cur)
    return planes


def deblock_plain(jobs, bd: int = 8):
    """Plain PyTorch version of K4 (`deblock`): per job the vertical pass,
    then the horizontal pass through the transpose (dlf_jax's
    filter_vertical_edges_j both ways, as the reference's _filter_device)."""
    out = []
    for planes, flen_v, flen_h, lim_v, lim_h in jobs:
        pl = planes
        if lim_v is not None:
            pl = filter_vertical_edges_plain(pl, flen_v, *lim_v, bd)
        if lim_h is not None:
            pl = filter_vertical_edges_plain(pl.transpose(1, 2), flen_h, *lim_h, bd).transpose(1, 2)
        out.append(pl)
    return torch.stack(out)


def deblock(jobs, bd: int = 8):
    """Deblock whole planes, both passes, for up to three jobs in one K4
    launch (CUDA tensors) or by the plain version (CPU tensors).

    jobs: (planes (F, H, W) int32, flen_v (F, H//4, W//4 - 1), flen_h (F,
    W//4, H//4 - 1) int32 maps (flen_maps_from_sizes without and with the
    transpose), limits_v, limits_h), the limits (lim, blim, thr) of the
    pass's level (`_limits`), None for a pass at level 0; every job's
    planes of one shape, H and W multiples of 4. Returns (J, F, H, W) int32:
    job j's planes with their vertical, then their horizontal edges
    filtered."""
    if jobs[0][0].device.type == "cpu":
        return deblock_plain(jobs, bd)
    F, H, W = jobs[0][0].shape
    if not 1 <= len(jobs) <= 3 or H % 4 or W % 4:
        raise ValueError("deblock: 1 to 3 jobs on planes whose sides are multiples of 4")
    out = torch.empty((len(jobs), F, H, W), dtype=torch.int32, device=jobs[0][0].device)
    ptrs, lv = [], []
    for j, (planes, flen_v, flen_h, lim_v, lim_h) in enumerate(jobs):
        kernels.check(planes, "planes", torch.int32, (F, H, W))
        kernels.check(flen_v, "flen_v", torch.int32, (F, H // 4, W // 4 - 1))
        kernels.check(flen_h, "flen_h", torch.int32, (F, W // 4, H // 4 - 1))
        ptrs += [planes.data_ptr(), flen_v.data_ptr(), flen_h.data_ptr(), out[j].data_ptr()]
        for lim in (lim_v, lim_h):
            lv += [0, 0, 0, 0] if lim is None else [1, *(int(x) for x in lim)]
    kernels.launch("dlf_edges", (ctypes.c_longlong * len(ptrs))(*ptrs),
                   (ctypes.c_int * len(lv))(*lv), len(jobs), F, H, W, bd,
                   kernels.stream_ptr(out))
    return out
