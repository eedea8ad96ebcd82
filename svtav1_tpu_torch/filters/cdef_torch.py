"""PyTorch port of filters/cdef_jax.py: CDEF direction search, frame-level
strength search and apply over a batch of frames, around the CUDA kernels of
`csrc/cdef.cu` — K6 `cdef_dir` (direction and variance per 8x8 luma cell)
and K7, two launches per batch: `cdef_search` (the masked luma SSE of every
strength candidate of a ladder) and `cdef_apply` (each frame's best
candidate, the derived chroma strengths, and Y, U and V filtered) — with a
plain PyTorch version beside each (`cdef_filter_plain` filters a plane for
one or several candidates, or takes their SSE). Bit-exact with the JAX
package's integer arithmetic; the search's SSE is an exact int64 sum here,
where the reference sums float32 squares (cdef_jax.py:246-247).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from .cdef import CDEF_DIRS, CDEF_VERY_LARGE, PRI_TAPS, SEC_TAPS, _CWEIGHTS, SEARCH_CANDIDATES


@functools.lru_cache(maxsize=None)
def _bins(device: str) -> torch.Tensor:
    """(8, 64) long: partial-sum bin of each sample of an 8x8 cell per
    direction (filters/cdef.py _partial_matrices)."""
    from .cdef import _PMATS

    return torch.as_tensor(_PMATS.argmax(axis=2), dtype=torch.long, device=device)


@functools.lru_cache(maxsize=None)
def _cweights(device: str) -> torch.Tensor:
    return torch.as_tensor(_CWEIGHTS, dtype=torch.int64, device=device)


def _msb(v):
    return torch.where(v > 0, torch.floor(torch.log2(v.clamp(min=1).to(torch.float32))),
                       torch.zeros((), device=v.device)).to(torch.int32)


def find_dir_plain(plane, coeff_shift: int = 0):
    """Plain PyTorch version of K6: (F, H, W) int32 luma -> (dirs, var),
    both (F, H // 8, W // 8) int32 (cdef_jax.find_dir_j)."""
    F, H, W = plane.shape
    R, C = H // 8, W // 8
    dev = plane.device
    cells = plane[:, : R * 8, : C * 8].reshape(F, R, 8, C, 8).permute(0, 1, 3, 2, 4)
    x = (cells.reshape(-1, 64).to(torch.int64) >> coeff_shift) - 128
    bins, cw = _bins(str(dev)), _cweights(str(dev))
    costs = []
    for d in range(8):
        part = torch.zeros((x.shape[0], 15), dtype=torch.int64, device=dev)
        part.index_add_(1, bins[d], x)
        costs.append((part * part * cw[d][None]).sum(dim=1))
    costs = torch.stack(costs, dim=1)
    best = costs.argmax(dim=1)  # first index wins, like np.argmax
    rows = torch.arange(costs.shape[0], device=dev)
    var = (costs[rows, best] - costs[rows, (best + 4) & 7]) >> 10
    return (best.to(torch.int32).reshape(F, R, C), var.to(torch.int32).reshape(F, R, C))


def find_dir(plane, coeff_shift: int = 0):
    """Direction and variance per 8x8 luma cell: K6 for CUDA tensors, the
    plain version for CPU tensors."""
    if plane.device.type == "cpu":
        return find_dir_plain(plane, coeff_shift)
    F, H, W = plane.shape
    kernels.check(plane, "plane", torch.int32)
    if H % 8 or W % 8:
        raise ValueError(f"cdef find_dir: plane dims must be multiples of 8, got {(H, W)}")
    dirs = torch.empty((F, H // 8, W // 8), dtype=torch.int32, device=plane.device)
    var = torch.empty_like(dirs)
    kernels.launch("cdef_dir", plane.data_ptr(), dirs.data_ptr(), var.data_ptr(), F, H, W,
                   coeff_shift, kernels.stream_ptr(plane))
    return dirs, var


def _adjust_strength(strength, var):
    i = torch.where((var >> 6) > 0, _msb(var >> 6).clamp(max=12), torch.zeros_like(var))
    return torch.where(var != 0, (strength * (4 + i) + 8) >> 4, torch.zeros_like(var))


def _constrain(diff, s, damping: int):
    shift = (damping - _msb(s)).clamp(min=0)
    ad = diff.abs()
    mag = torch.minimum(ad, (s - (ad >> shift)).clamp(min=0))
    return torch.sign(diff) * torch.where(s > 0, mag, torch.zeros_like(mag))


def _up(cellvals, m: int):
    return cellvals.repeat_interleave(m, dim=1).repeat_interleave(m, dim=2)


def cdef_filter_plain(plane, dirs, var, pri, sec, mask, damping: int, coeff_shift: int = 0,
                      src=None, want_out: bool = True):
    """CDEF-filter (F, H, W) int32 `plane` whose m x m cells (m = H // R)
    carry directions `dirs` (F, R, C) int32, for K candidates at once, in
    plain PyTorch (K7's arithmetic).

    pri/sec (K, F) int32: per candidate and frame the primary strength
    (adjusted per cell by `var` (F, R, C) int32 when given, as for luma) and
    the secondary strength; `mask` (F, R, C) bool: the non-skip cells, the
    only ones filtered. Returns (out (K, F, H, W) int32 or None, sse (K, F)
    int64 or None): sse is the masked SSE against `src` (F, H, W) when
    given."""
    F, H, W = plane.shape
    m = H // dirs.shape[1]
    dev = plane.device
    B = 2
    P = torch.nn.functional.pad(plane, (B, B, B, B), value=CDEF_VERY_LARGE)
    Wp = W + 2 * B
    dpx = _up(dirs, m).long()  # (F, H, W)
    yy = torch.arange(H, device=dev)[None, :, None] + B
    xx = torch.arange(W, device=dev)[None, None, :] + B
    dtab = torch.as_tensor(CDEF_DIRS, dtype=torch.long, device=dev)  # (8, 2, 2)
    Pf = P.reshape(F, -1)

    def tap(dd, k, sgn):
        off = dtab[dd, k]  # (F, H, W, 2)
        idx = (yy + sgn * off[..., 0]) * Wp + xx + sgn * off[..., 1]
        return torch.gather(Pf, 1, idx.reshape(F, -1)).reshape(F, H, W)

    pri_taps = [(tap(dpx, k, sg), k) for k in range(2) for sg in (1, -1)]
    sec_taps = [(tap(dd, k, sg), k) for dd in ((dpx + 2) & 7, (dpx - 2) & 7)
                for k in range(2) for sg in (1, -1)]
    maskpx = _up(mask, m)
    outs, sses = [], []
    for kc in range(pri.shape[0]):
        ps = pri[kc][:, None, None].expand(F, H, W)
        if var is not None:
            ps = _adjust_strength(ps, _up(var, m))
        ss = sec[kc][:, None, None]
        sel = (ps >> coeff_shift) & 1
        sum_ = torch.zeros_like(plane)
        mx, mn = plane.clone(), plane.clone()
        for pv, k in pri_taps:
            w = torch.where(sel == 0, int(PRI_TAPS[0, k]), int(PRI_TAPS[1, k]))
            sum_ = sum_ + w * _constrain(pv - plane, ps, damping)
            mx = torch.maximum(mx, torch.where(pv == CDEF_VERY_LARGE, mx, pv))
            mn = torch.minimum(mn, pv)
        for sv, k in sec_taps:
            sum_ = sum_ + int(SEC_TAPS[0, k]) * _constrain(sv - plane, ss, damping)
            mx = torch.maximum(mx, torch.where(sv == CDEF_VERY_LARGE, mx, sv))
            mn = torch.minimum(mn, sv)
        res = torch.minimum(torch.maximum(plane + ((8 + sum_ - (sum_ < 0).to(torch.int32)) >> 4),
                                          mn), mx)
        res = torch.where(maskpx, res, plane).to(torch.int32)
        if want_out:
            outs.append(res)
        if src is not None:
            d = torch.where(maskpx, res - src, torch.zeros_like(res)).to(torch.int64)
            sses.append((d * d).sum(dim=(1, 2)))
    return (torch.stack(outs) if want_out else None,
            torch.stack(sses) if src is not None else None)


def _ladder_args(ladder):
    """(pri, sec, K) of a ladder of (pri, sec) candidates for a K7 launch:
    two int32 arrays in host memory, passed by value to the kernel."""
    import ctypes

    K = len(ladder)
    if not 1 <= K <= 8:
        raise ValueError(f"cdef: 1 to 8 strength candidates, got {K}")
    return ((ctypes.c_int * K)(*(int(p) for p, _ in ladder)),
            (ctypes.c_int * K)(*(int(q) for _, q in ladder)), K)


def _check_cells(plane, dirs, mask, var=None):
    F, H, W = plane.shape
    if H % 8 or W % 8:
        raise ValueError(f"cdef: luma dims must be multiples of 8, got {(H, W)}")
    kernels.check(plane, "plane", torch.int32)
    kernels.check(dirs, "dirs", torch.int32, (F, H // 8, W // 8))
    kernels.check(mask, "mask", torch.bool, (F, H // 8, W // 8))
    if var is not None:
        kernels.check(var, "var", torch.int32, (F, H // 8, W // 8))


def cdef_search_plain(plane, dirs, var, mask, src, ladder, damping: int, coeff_shift: int = 0):
    """Plain PyTorch version of K7's search; same arguments and result as
    cdef_search."""
    F = plane.shape[0]
    cand = torch.as_tensor(np.array(ladder, np.int32).reshape(-1, 2), device=plane.device)
    pri = (cand[:, 0:1] << coeff_shift).expand(-1, F)
    sec = (cand[:, 1:2] << coeff_shift).expand(-1, F)
    return cdef_filter_plain(plane, dirs, var, pri, sec, mask, damping + coeff_shift,
                             coeff_shift, src=src, want_out=False)[1]


def cdef_search(plane, dirs, var, mask, src, ladder, damping: int, coeff_shift: int = 0):
    """The frame-level strength search: the int64 SSE (K, F) of the masked
    CDEF-filtered luma `plane` (F, H, W) int32 against `src` (F, H, W) int32
    for each of the K <= 8 (pri, sec) candidates of `ladder` (shifted left
    by coeff_shift; pri adjusted per cell by `var`), with the cells'
    directions `dirs` and variances `var` (F, H // 8, W // 8) int32, the
    non-skip cells `mask` (F, H // 8, W // 8) bool and the frame's luma
    damping (coeff_shift added). K7 `cdef_search` for CUDA tensors, the
    plain version for CPU tensors."""
    if plane.device.type == "cpu":
        return cdef_search_plain(plane, dirs, var, mask, src, ladder, damping, coeff_shift)
    _check_cells(plane, dirs, mask, var)
    F, H, W = plane.shape
    kernels.check(src, "src", torch.int32, (F, H, W))
    pri, sec, K = _ladder_args(ladder)
    sse = torch.zeros((K, F), dtype=torch.int64, device=plane.device)
    kernels.launch("cdef_search", plane.data_ptr(), dirs.data_ptr(), var.data_ptr(),
                   mask.data_ptr(), src.data_ptr(), sse.data_ptr(), pri, sec, K, F, H, W,
                   damping, coeff_shift, kernels.stream_ptr(plane))
    return sse


def cdef_apply_plain(planes, dirs, var, mask, sse, ladder, damping: int, coeff_shift: int = 0):
    """Plain PyTorch version of K7's apply; same arguments and results as
    cdef_apply."""
    cand = torch.as_tensor(np.array(ladder, np.int32).reshape(-1, 2), device=planes[0].device)
    best = torch.argmin(sse, dim=0)  # (F,), the first index on ties
    y_pri, y_sec = cand[best, 0], cand[best, 1]
    uv_pri, uv_sec = y_pri >> 1, y_sec >> 1  # ladder sec 0/1/2 -> 0/1, never 3
    new_y = cdef_filter_plain(planes[0], dirs, var, (y_pri << coeff_shift)[None],
                              (y_sec << coeff_shift)[None], mask, damping + coeff_shift,
                              coeff_shift)[0][0]
    uv = [cdef_filter_plain(pl, dirs, None, (uv_pri << coeff_shift)[None],
                            (uv_sec << coeff_shift)[None], mask, damping + coeff_shift - 1,
                            coeff_shift)[0][0]
          for pl in planes[1:]]
    return [new_y, uv[0], uv[1]], torch.stack([y_pri, y_sec, uv_pri, uv_sec], dim=-1)


def cdef_apply(planes, dirs, var, mask, sse, ladder, damping: int, coeff_shift: int = 0):
    """CDEF with each frame's best candidate: the candidate of `ladder` with
    the least `sse` (K, F) int64 (the first on ties), its strengths for
    luma (pri adjusted per cell by `var`) and (pri >> 1, sec >> 1) for
    chroma, shifted left by coeff_shift; luma damping + coeff_shift,
    chroma one less. planes [y, u, v] (F, H, W) / (F, H // 2, W // 2) int32.
    Returns (the filtered planes, strengths (F, 4) int32 [y_pri, y_sec,
    uv_pri, uv_sec]). K7 `cdef_apply` (one launch for the three planes) for
    CUDA tensors, the plain version for CPU tensors."""
    if planes[0].device.type == "cpu":
        return cdef_apply_plain(planes, dirs, var, mask, sse, ladder, damping, coeff_shift)
    y = planes[0]
    _check_cells(y, dirs, mask, var)
    F, H, W = y.shape
    for i, pl in enumerate(planes[1:]):
        kernels.check(pl, "uv"[i], torch.int32, (F, H // 2, W // 2))
    pri, sec, K = _ladder_args(ladder)
    kernels.check(sse, "sse", torch.int64, (K, F))
    out = [torch.empty_like(pl) for pl in planes]
    strengths = torch.empty((F, 4), dtype=torch.int32, device=y.device)
    kernels.launch("cdef_apply", *(pl.data_ptr() for pl in planes),
                   *(o.data_ptr() for o in out), dirs.data_ptr(), var.data_ptr(),
                   mask.data_ptr(), sse.data_ptr(), strengths.data_ptr(), pri, sec, K, F, H, W,
                   damping, coeff_shift, kernels.stream_ptr(y))
    return out, strengths


def check_ladder(ladder) -> None:
    """The apply omits the decoder's "dir = 0 when pri_strength == 0"
    forcing (filters/cdef.py:198,206): it is unreachable only while the
    ladder never yields pri == 0 with sec > 0, at luma directly and at
    chroma after the uv = y >> 1 derivation. Raise ValueError otherwise."""
    for p, s in ladder:
        if (p == 0 and s > 0) or ((p >> 1) == 0 and (s >> 1) > 0):
            raise ValueError(f"CDEF ladder entry {(p, s)}: a zero primary strength with a "
                             "secondary one needs the decoder's direction forcing")


def sampled_cells(mask, stride: int):
    """Every stride-th set cell, in raster order, of each frame's (F, R, C)
    bool mask: the units that the reference's host CDEF search
    (filters/cdef.search_strengths) samples from the non-skip 8x8 units. A
    plain PyTorch mask."""
    rank = torch.cumsum(mask.reshape(mask.shape[0], -1).to(torch.int32), dim=1) - 1
    return mask & (rank.reshape(mask.shape) % stride == 0)


def cdef_frames(planes, src_y, nonskip8, damping: int, bd: int = 8, n_cand: int = 0,
                search_mask=None):
    """Search and apply CDEF for a batch of frames on their device
    (cdef_jax.cdef_frames_j). planes [y, u, v] (F, H, W) int32 post-DLF;
    src_y (F, H, W) int32; nonskip8 (F, H // 8, W // 8) bool. The ladder is
    SEARCH_CANDIDATES, or its first n_cand entries; each frame takes the
    candidate of least luma SSE over the cells of search_mask (default
    nonskip8; ties to the first) and filters the cells of nonskip8. Returns
    (new planes, strengths (F, 4) int32 [y_pri, y_sec, uv_pri, uv_sec]).
    On the card: K6, then K7's two launches."""
    coeff_shift = max(bd - 8, 0)
    ladder = SEARCH_CANDIDATES[:n_cand] if n_cand else SEARCH_CANDIDATES
    check_ladder(ladder)
    dirs, var = find_dir(planes[0], coeff_shift)
    sse = cdef_search(planes[0], dirs, var, nonskip8 if search_mask is None else search_mask,
                      src_y, ladder, damping, coeff_shift)
    return cdef_apply(planes, dirs, var, nonskip8, sse, ladder, damping, coeff_shift)
