"""Batched non-directional intra prediction for the device pipeline (decide
and commit) — PyTorch port of svtav1_tpu's pipeline/intra_device.py around
the CUDA kernel `csrc/intra_pred.cu` (K1), with a plain PyTorch version
beside it. One lane per block; the seven modes DC, V, H, SMOOTH, SMOOTH_V,
SMOOTH_H, PAETH (the key-frame mode set of the fast preset).
"""
from __future__ import annotations

import functools
import math

import torch

from .. import kernels
from ..constants.av1 import BlockSize
from . import intra_md

MODES = [int(m) for m in intra_md.MODES]  # DC,V,H,SMOOTH,SMOOTH_V,SMOOTH_H,PAETH,...
NMODES_MAX = 7  # the directional modes (dr_pred) are not ported yet
B64, B32, B16, B8 = (int(BlockSize.BLOCK_64X64), int(BlockSize.BLOCK_32X32),
                     int(BlockSize.BLOCK_16X16), int(BlockSize.BLOCK_8X8))
BSIZE_BY_N = {8: B8, 16: B16, 32: B32, 64: B64}


def _smooth_weights(n: int):
    from ..ops.intra import SM_WEIGHTS

    return SM_WEIGHTS[n]


@functools.lru_cache(maxsize=None)
def _weights(n: int, device: str) -> torch.Tensor:
    return torch.as_tensor(_smooth_weights(n), dtype=torch.int32, device=device)


def predict_plain(above, left, topleft, have_above, have_left, n: int, mode=None):
    """Plain PyTorch version of K1 (intra_device._predict_modes, nmodes=7).

    above/left (B, n) int32, topleft (B,), have_above/have_left (B,) bool.
    mode None -> (B, 7, n, n); mode (B,) int -> (B, n, n), that mode per lane."""
    B = above.shape[0]
    ha = have_above.to(torch.int32)
    hl = have_left.to(torch.int32)
    sa = above.sum(dim=1, dtype=torch.int32)
    sl = left.sum(dim=1, dtype=torch.int32)
    log2n = int(math.log2(n))
    dc_both = (sa + sl + n) >> (log2n + 1)
    dc_a = (sa + (n >> 1)) >> log2n
    dc_l = (sl + (n >> 1)) >> log2n
    dc = torch.where((ha & hl).bool(), dc_both,
                     torch.where(ha.bool(), dc_a,
                                 torch.where(hl.bool(), dc_l, torch.full_like(dc_a, 128))))
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
    if mode is None:
        return out
    return out[torch.arange(B, device=out.device), mode.long()].contiguous()


def predict(above, left, topleft, have_above, have_left, n: int, mode=None):
    """Intra predictions of B lanes: K1 for CUDA tensors, the plain version
    for CPU tensors. Same arguments and results as predict_plain."""
    if above.device.type == "cpu":
        return predict_plain(above, left, topleft, have_above, have_left, n, mode)
    B = above.shape[0]
    kernels.check(above, "above", torch.int32, (B, n))
    kernels.check(left, "left", torch.int32, (B, n))
    kernels.check(topleft, "topleft", torch.int32, (B,))
    kernels.check(have_above, "have_above", torch.bool, (B,))
    kernels.check(have_left, "have_left", torch.bool, (B,))
    if mode is not None:
        kernels.check(mode, "mode", torch.int32, (B,))
    shape = (B, n, n) if mode is not None else (B, NMODES_MAX, n, n)
    out = torch.empty(shape, dtype=torch.int32, device=above.device)
    kernels.launch("intra_pred", above.data_ptr(), left.data_ptr(), topleft.data_ptr(),
                   have_above.data_ptr(), have_left.data_ptr(),
                   mode.data_ptr() if mode is not None else None,
                   _weights(n, str(above.device)).data_ptr(), out.data_ptr(), B, n,
                   int(math.log2(n)), kernels.stream_ptr(above))
    return out


def _predict_modes(above, left, topleft, have_above, have_left, n: int, nmodes: int = 7):
    """(B, nmodes, n, n) in MODES order (reference _predict_modes)."""
    if nmodes > NMODES_MAX:
        raise NotImplementedError("directional intra modes (dr_pred): ROADMAP queue 1, "
                                  "'directional modes' — not ported yet")
    return predict(above, left, topleft, have_above, have_left, n)[:, :nmodes]
