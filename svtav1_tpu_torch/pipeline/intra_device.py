"""Batched intra prediction for the device pipeline (decide and commit) —
PyTorch port of svtav1_tpu's pipeline/intra_device.py around the CUDA
kernel `csrc/intra_pred.cu` (K1), with a plain PyTorch version beside it.
One lane per block; the thirteen key-frame modes in MODES order: DC, V, H,
SMOOTH, SMOOTH_V, SMOOTH_H, PAETH, then the directional D45, D135, D113,
D157, D203, D67 from edges extended by replicating their last sample.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import kernels
from ..constants.av1 import BlockSize, PredMode
from . import intra_md

MODES = [int(m) for m in intra_md.MODES]  # DC,V,H,SMOOTH,SMOOTH_V,SMOOTH_H,PAETH,D45..D67
NMODES_MAX = len(MODES)
DIRECTIONAL = (PredMode.D45_PRED, PredMode.D135_PRED, PredMode.D113_PRED, PredMode.D157_PRED,
               PredMode.D203_PRED, PredMode.D67_PRED)  # MODES[7:]
B64, B32, B16, B8 = (int(BlockSize.BLOCK_64X64), int(BlockSize.BLOCK_32X32),
                     int(BlockSize.BLOCK_16X16), int(BlockSize.BLOCK_8X8))
BSIZE_BY_N = {8: B8, 16: B16, 32: B32, 64: B64}


def _smooth_weights(n: int):
    from ..ops.intra import SM_WEIGHTS

    return SM_WEIGHTS[n]


@functools.lru_cache(maxsize=None)
def _weights(n: int, device: str) -> torch.Tensor:
    return torch.as_tensor(_smooth_weights(n), dtype=torch.int32, device=device)


def _dr_params() -> np.ndarray:
    """(6, 3) int32 (dx, dy, zone) of the directional modes in MODES order
    (ops/intra.py _dr_derivative; zone 1 reads above, 3 left, 2 both)."""
    from ..ops.intra import MODE_ANGLE, _dr_derivative

    rows = []
    for m in DIRECTIONAL:
        angle = MODE_ANGLE[int(m)]
        rows.append((*_dr_derivative(angle), 1 if angle < 90 else (3 if angle > 180 else 2)))
    return np.asarray(rows, np.int32)


@functools.lru_cache(maxsize=None)
def _dr(device: str) -> torch.Tensor:
    return torch.as_tensor(_dr_params(), device=device)


@functools.lru_cache(maxsize=None)
def _dr_index(n: int, device: str):
    """Per directional mode the plain version's gather tables over the
    extended edges [topleft, edge, edge repeated], each (6, n, n): bool
    source (False above, True left), long index (the base, offset by one for
    the top-left slot) and int32 shift (ops/intra.py dr_tables)."""
    from ..ops.intra import MODE_ANGLE, dr_tables

    tabs = [dr_tables(MODE_ANGLE[int(m)], n, n) for m in DIRECTIONAL]
    sel, base, shift = (np.stack([t[i] for t in tabs]) for i in range(3))
    return (torch.as_tensor(sel, dtype=torch.bool, device=device),
            torch.as_tensor(base + 1, dtype=torch.long, device=device),
            torch.as_tensor(shift, dtype=torch.int32, device=device))


def _directional_plain(above, left, topleft, n: int):
    """(B, 6, n, n) directional predictions (ops/intra.py dr_pred's gather
    branch on replicated extensions)."""
    B = above.shape[0]
    sel, bi, bs = _dr_index(n, str(above.device))
    tl = topleft[:, None]
    a = torch.cat([tl, above, above[:, -1:].expand(B, n)], dim=1)  # (B, 1 + 2n)
    l = torch.cat([tl, left, left[:, -1:].expand(B, n)], dim=1)
    i0 = bi.reshape(-1)
    i1 = (bi + 1).clamp(max=2 * n).reshape(-1)
    w1 = bs.reshape(1, -1)
    va = a[:, i0] * (32 - w1) + a[:, i1] * w1
    vl = l[:, i0] * (32 - w1) + l[:, i1] * w1
    val = torch.where(sel.reshape(1, -1), vl, va)
    return ((val + 16) >> 5).reshape(B, len(DIRECTIONAL), n, n)


def predict_plain(above, left, topleft, have_above, have_left, n: int, mode=None,
                  nmodes: int = NMODES_MAX, bd: int = 8):
    """Plain PyTorch version of K1 (intra_device._predict_modes).

    above/left (B, n) int32, topleft (B,), have_above/have_left (B,) bool.
    mode None -> (B, nmodes, n, n); mode (B,) int -> (B, n, n), that mode
    per lane (any of the 13). DC with neither neighbour is 1 << (bd - 1),
    as the spec predicts it (the reference's 128 is a fault at 10 bits)."""
    B = above.shape[0]
    ha = have_above.to(torch.int32)
    hl = have_left.to(torch.int32)
    sa = above.sum(dim=1, dtype=torch.int32)
    sl = left.sum(dim=1, dtype=torch.int32)
    log2n = int(math.log2(n))
    dc_both = (sa + sl + n) >> (log2n + 1)
    dc_a = (sa + (n >> 1)) >> log2n
    dc_l = (sl + (n >> 1)) >> log2n
    dc_none = torch.full_like(dc_a, 1 << (bd - 1))
    dc = torch.where((ha & hl).bool(), dc_both,
                     torch.where(ha.bool(), dc_a, torch.where(hl.bool(), dc_l, dc_none)))
    t = above[:, None, :]
    l = left[:, :, None]
    tl = topleft[:, None, None]
    shape = (B, n, n)
    base = t + l - tl
    pt, pl_, ptl = (base - t).abs(), (base - l).abs(), (base - tl).abs()
    use_l = (pl_ <= pt) & (pl_ <= ptl)
    use_t = pt <= ptl
    paeth = torch.where(use_l, l.expand(shape), torch.where(use_t, t.expand(shape), tl.expand(shape)))
    wn = _weights(n, str(above.device))
    wh = wn[None, :, None]
    ww = wn[None, None, :]
    below = left[:, -1, None, None]
    right = above[:, -1, None, None]
    smooth = (wh * t + (256 - wh) * below + ww * l + (256 - ww) * right + 256) >> 9
    smooth_v = ((wh * t + (256 - wh) * below + 128) >> 8).expand(shape)
    smooth_h = ((ww * l + (256 - ww) * right + 128) >> 8).expand(shape)
    out = torch.stack([dc[:, None, None].expand(shape), t.expand(shape), l.expand(shape), smooth,
                       smooth_v, smooth_h, paeth], dim=1).to(torch.int32)
    need_dr = nmodes > 7 if mode is None else bool((mode >= 7).any())
    if need_dr:
        out = torch.cat([out, _directional_plain(above, left, topleft, n).to(torch.int32)], dim=1)
    if mode is None:
        return out[:, :nmodes].contiguous()
    return out[torch.arange(B, device=out.device), mode.long()].contiguous()


def predict(above, left, topleft, have_above, have_left, n: int, mode=None,
            nmodes: int = NMODES_MAX, bd: int = 8):
    """Intra predictions of B lanes: K1 for CUDA tensors, the plain version
    for CPU tensors. Same arguments and results as predict_plain."""
    if not 1 <= nmodes <= NMODES_MAX:
        raise ValueError(f"nmodes must be 1..{NMODES_MAX}, got {nmodes}")
    if above.device.type == "cpu":
        return predict_plain(above, left, topleft, have_above, have_left, n, mode, nmodes, bd)
    B = above.shape[0]
    kernels.check(above, "above", torch.int32, (B, n))
    kernels.check(left, "left", torch.int32, (B, n))
    kernels.check(topleft, "topleft", torch.int32, (B,))
    kernels.check(have_above, "have_above", torch.bool, (B,))
    kernels.check(have_left, "have_left", torch.bool, (B,))
    if mode is not None:
        kernels.check(mode, "mode", torch.int32, (B,))
    shape = (B, n, n) if mode is not None else (B, nmodes, n, n)
    dev = str(above.device)
    out = torch.empty(shape, dtype=torch.int32, device=above.device)
    kernels.launch("intra_pred", above.data_ptr(), left.data_ptr(), topleft.data_ptr(),
                   have_above.data_ptr(), have_left.data_ptr(),
                   mode.data_ptr() if mode is not None else None,
                   _weights(n, dev).data_ptr(), _dr(dev).data_ptr(), out.data_ptr(), B, n,
                   int(math.log2(n)), nmodes, bd, kernels.stream_ptr(above))
    return out


def _predict_modes(above, left, topleft, have_above, have_left, n: int,
                   nmodes: int = NMODES_MAX, bd: int = 8):
    """(B, nmodes, n, n) in MODES order (reference _predict_modes)."""
    return predict(above, left, topleft, have_above, have_left, n, nmodes=nmodes, bd=bd)
