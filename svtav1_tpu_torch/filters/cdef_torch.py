"""PyTorch port of filters/cdef_jax.py: CDEF direction search, frame-level
strength search and apply over a batch of frames, around the CUDA kernels of
`csrc/cdef.cu` — K6 `cdef_dir` (direction and variance per 8x8 luma cell)
and K7 `cdef_filter` (filter a plane for one or several strength candidates,
or take the masked SSE of each against the source) — with a plain PyTorch
version beside each. Bit-exact with the JAX package's integer arithmetic;
the search's SSE is an exact int64 sum here, where the reference sums
float32 squares (cdef_jax.py:246-247).
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
    """Plain PyTorch version of K7; same arguments and results as
    cdef_filter."""
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


def cdef_filter(plane, dirs, var, pri, sec, mask, damping: int, coeff_shift: int = 0,
                src=None, want_out: bool = True):
    """CDEF-filter (F, H, W) int32 `plane` whose m x m cells (m = H // R)
    carry directions `dirs` (F, R, C) int32, for K candidates at once.

    pri/sec (K, F) int32: per candidate and frame the primary strength
    (adjusted per cell by `var` (F, R, C) int32 when given, as for luma) and
    the secondary strength; `mask` (F, R, C) bool: the non-skip cells, the
    only ones filtered. Returns (out (K, F, H, W) int32 or None, sse (K, F)
    int64 or None): sse is the masked SSE against `src` (F, H, W) when
    given. K7 for CUDA tensors, the plain version for CPU tensors."""
    if plane.device.type == "cpu":
        return cdef_filter_plain(plane, dirs, var, pri, sec, mask, damping, coeff_shift, src,
                                 want_out)
    F, H, W = plane.shape
    R, C = dirs.shape[1:]
    m = H // R
    if m not in (4, 8) or (R * m, C * m) != (H, W):
        raise ValueError(f"cdef_filter: {(H, W)} plane with a {(R, C)} cell grid")
    K = pri.shape[0]
    kernels.check(plane, "plane", torch.int32)
    kernels.check(dirs, "dirs", torch.int32, (F, R, C))
    if var is not None:
        kernels.check(var, "var", torch.int32, (F, R, C))
    kernels.check(pri, "pri", torch.int32, (K, F))
    kernels.check(sec, "sec", torch.int32, (K, F))
    kernels.check(mask, "mask", torch.bool, (F, R, C))
    dev = plane.device
    out = torch.empty((K, F, H, W), dtype=torch.int32, device=dev) if want_out else None
    sse = None
    if src is not None:
        kernels.check(src, "src", torch.int32, (F, H, W))
        sse = torch.zeros((K, F), dtype=torch.int64, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    kernels.launch("cdef_filter", plane.data_ptr(), dirs.data_ptr(), ptr(var), pri.data_ptr(),
                   sec.data_ptr(), mask.data_ptr(), ptr(src), ptr(sse), ptr(out), K, F, H, W,
                   int(m).bit_length() - 1, damping, coeff_shift, kernels.stream_ptr(plane))
    return out, sse


def cdef_frames(planes, src_y, nonskip8, damping: int, bd: int = 8, n_cand: int = 0):
    """Search and apply CDEF for a batch of frames on their device
    (cdef_jax.cdef_frames_j). planes [y, u, v] (F, H, W) int32 post-DLF;
    src_y (F, H, W) int32; nonskip8 (F, H // 8, W // 8) bool. The ladder is
    SEARCH_CANDIDATES, or its first n_cand entries; each frame takes the
    candidate of least masked luma SSE (ties to the first). Returns
    (new planes, strengths (F, 4) int32 [y_pri, y_sec, uv_pri, uv_sec])."""
    coeff_shift = max(bd - 8, 0)
    F = planes[0].shape[0]
    dev = planes[0].device
    ladder = SEARCH_CANDIDATES[:n_cand] if n_cand else SEARCH_CANDIDATES
    # The apply below omits the decoder's "dir = 0 when pri_strength == 0"
    # forcing (filters/cdef.py:198,206): it is unreachable only while the
    # ladder never yields pri == 0 with sec > 0 — at luma directly, and at
    # chroma after the uv = y >> 1 derivation. Keep that invariant.
    assert all(p > 0 or s == 0 for p, s in ladder), ladder
    assert all((p >> 1) > 0 or (s >> 1) == 0 for p, s in ladder)
    dirs, var = find_dir(planes[0], coeff_shift)
    cand = torch.as_tensor(np.array(ladder, np.int32), device=dev)  # (K, 2)
    pri = (cand[:, 0:1] << coeff_shift).expand(-1, F).contiguous()
    sec = (cand[:, 1:2] << coeff_shift).expand(-1, F).contiguous()
    _, sse = cdef_filter(planes[0], dirs, var, pri, sec, nonskip8, damping + coeff_shift,
                         coeff_shift, src=src_y, want_out=False)
    best = torch.argmin(sse, dim=0)  # (F,)
    y_pri, y_sec = cand[best, 0], cand[best, 1]
    uv_pri, uv_sec = y_pri >> 1, y_sec >> 1  # ladder sec 0/1/2 -> 0/1, never 3
    new_y = cdef_filter(planes[0], dirs, var, (y_pri << coeff_shift)[None].contiguous(),
                        (y_sec << coeff_shift)[None].contiguous(), nonskip8,
                        damping + coeff_shift, coeff_shift)[0][0]
    uv = [cdef_filter(pl, dirs, None, (uv_pri << coeff_shift)[None].contiguous(),
                      (uv_sec << coeff_shift)[None].contiguous(), nonskip8,
                      damping + coeff_shift - 1, coeff_shift)[0][0]
          for pl in planes[1:]]
    return [new_y, uv[0], uv[1]], torch.stack([y_pri, y_sec, uv_pri, uv_sec], dim=-1)
