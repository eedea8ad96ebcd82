"""PyTorch port of codec/rate_jax.py::make_txb_bits_fn: exact coefficient
bits of transform blocks from CDF cost LUTs, around the CUDA kernel
`csrc/txb_rate.cu` (K3), with a plain PyTorch version beside it.

The host part (`txb_rate_arrays`) builds one txb configuration's LUTs and
maps from a FrameContext exactly as the reference does; `TxbRateTables`
holds them on a device and is called on levels. Results agree with the
reference up to float32 summation order (codec/rate_jax.py:11-12).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import kernels
from ..constants.av1 import TX_H, TX_TYPE_CLASS, TX_W, TxSize
from . import rate as rate_np
from . import txb as txb_mod

# float LUT layout shared with csrc/txb_rate.cu
F_BASE, F_BASE_EOB, F_BR, F_SKIP, F_DCS, F_EOB = 0, 168, 180, 453, 455, 457


def _eob_cost_lut(fc, tx_size: int, tx_type: int, plane_type: int) -> np.ndarray:
    """(n+1,) float32: total eob-token cost (eob flag + eob_extra cdf bit +
    raw offset bits) for every possible eob value 1..n; index 0 unused."""
    tx_class = int(TX_TYPE_CLASS[tx_type])
    txs_ctx = txb_mod.get_txsize_entropy_ctx(tx_size)
    adj = txb_mod.adjusted_tx_size(tx_size)
    n = int(TX_W[adj]) * int(TX_H[adj])
    emc = 0 if tx_class == txb_mod.TX_CLASS_2D else 1
    nsz = 16 << txb_mod.eob_multi_size(tx_size)
    flag_lut = rate_np.cdf_cost_table(fc[f"eob_flag_{nsz}"], int(math.log2(nsz)) + 1)
    extra_lut = rate_np.cdf_cost_table(fc["eob_extra"], 2)
    out = np.zeros(n + 1, np.float32)
    for eob in range(1, n + 1):
        eob_pt, eob_extra = txb_mod.get_eob_pos_token(eob)
        bits = float(flag_lut[plane_type, emc, eob_pt - 1])
        ob = int(txb_mod.EOB_OFFSET_BITS[eob_pt])
        if ob > 0:
            bit = (eob_extra >> (ob - 1)) & 1
            bits += float(extra_lut[txs_ctx, plane_type, eob_pt, bit])
            bits += ob - 1
        out[eob] = bits
    return out


def _base_eob_ctx_lut(tx_size: int) -> np.ndarray:
    """(n,) int32: get_base_eob_ctx for scan_idx = eob-1 over all eob."""
    adj = txb_mod.adjusted_tx_size(tx_size)
    h, w = int(TX_H[adj]), int(TX_W[adj])
    bwl = int(math.log2(w))
    return np.array([txb_mod.get_base_eob_ctx(i, bwl, h) for i in range(h * w)], np.int32)


def txb_rate_arrays(fc, tx_size: int, tx_type: int, plane_type: int,
                    txb_skip_ctx: int = 0, dc_sign_ctx: int = 0) -> dict:
    """Host LUTs and maps of one txb configuration — the same arrays the
    reference's make_txb_bits_fn closes over (names kept)."""
    tx_class = int(TX_TYPE_CLASS[tx_type])
    txs_ctx = txb_mod.get_txsize_entropy_ctx(tx_size)
    adj = txb_mod.adjusted_tx_size(tx_size)
    h, w = int(TX_H[adj]), int(TX_W[adj])
    lut = rate_np.cdf_cost_table
    base_lut = lut(fc["coeff_base"], 4)[txs_ctx, plane_type]  # (42, 4)
    base_eob_lut = lut(fc["coeff_base_eob"], 3)[txs_ctx, plane_type]  # (4, 3)
    br_raw = lut(fc["coeff_br"], 4)[min(txs_ctx, int(TxSize.TX_32X32)), plane_type]  # (21,4)
    br_lut = np.zeros((21, 13), np.float32)
    for r in range(13):
        cost, rem = np.zeros(21, np.float32), r
        for _ in range(4):
            k = min(rem, 3)
            cost += br_raw[:, k]
            if k < 3:
                break
            rem -= 3
        br_lut[:, r] = cost
    scan = txb_mod.get_scan(tx_size, tx_type).astype(np.int32)
    iscan = np.argsort(scan).astype(np.int32)
    if tx_class == txb_mod.TX_CLASS_2D:
        nz_off = txb_mod.nz_map_ctx_offset_2d(tx_size).reshape(h, w)
    elif tx_class == txb_mod.TX_CLASS_HORIZ:
        nz_off = np.broadcast_to(txb_mod.NZ_MAP_CTX_OFFSET_1D[np.arange(w)][None, :], (h, w))
    else:
        nz_off = np.broadcast_to(txb_mod.NZ_MAP_CTX_OFFSET_1D[np.arange(h)][:, None], (h, w))
    rows = np.arange(h)[:, None]
    cols = np.arange(w)[None, :]
    if tx_class == txb_mod.TX_CLASS_2D:
        br_grp = np.where((rows < 2) & (cols < 2), 7, 14).astype(np.int32)
    elif tx_class == txb_mod.TX_CLASS_HORIZ:
        br_grp = np.where(cols == 0, 7, 14).astype(np.int32) + np.zeros((h, w), np.int32)
    else:
        br_grp = np.where(rows == 0, 7, 14).astype(np.int32) + np.zeros((h, w), np.int32)
    return dict(
        tx_class=tx_class, h=h, w=w,
        base_lut=base_lut, base_eob_lut=base_eob_lut, br_lut=br_lut,
        skip_lut=lut(fc["txb_skip"], 2)[txs_ctx, txb_skip_ctx],
        dc_sign_lut=lut(fc["dc_sign"], 2)[plane_type, dc_sign_ctx],
        eob_cost=_eob_cost_lut(fc, tx_size, tx_type, plane_type),
        ectx_lut=_base_eob_ctx_lut(tx_size), iscan=iscan, nz_off=nz_off, br_grp=br_grp)


class TxbRateTables:
    """One txb configuration's rate tables on one device; call on levels
    (B, h, w) int32 -> (B,) float32 bits (K3 on CUDA, plain on CPU)."""

    def __init__(self, arrays: dict, device):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.tx_class = int(arrays["tx_class"])
        self.h, self.w = int(arrays["h"]), int(arrays["w"])
        n = self.h * self.w

        def f32(name):
            return torch.as_tensor(np.asarray(arrays[name], np.float32), device=dev)

        def i64(name):
            return torch.as_tensor(np.asarray(arrays[name], np.int64).reshape(-1), device=dev)

        self.base_lut, self.base_eob_lut, self.br_lut = f32("base_lut"), f32("base_eob_lut"), f32("br_lut")
        self.skip_lut, self.dc_sign_lut, self.eob_cost = f32("skip_lut"), f32("dc_sign_lut"), f32("eob_cost")
        self.ectx_lut, self.iscan = i64("ectx_lut"), i64("iscan")
        self.nz_off, self.br_grp = i64("nz_off"), i64("br_grp")
        flut = np.concatenate([np.asarray(arrays[k], np.float32).ravel() for k in
                               ("base_lut", "base_eob_lut", "br_lut", "skip_lut", "dc_sign_lut",
                                "eob_cost")])
        assert flut.size == F_EOB + n + 1, flut.size
        self.flut = torch.as_tensor(flut, device=dev)
        self.ilut = torch.as_tensor(np.concatenate(
            [np.asarray(arrays[k], np.int32).ravel() for k in ("ectx_lut", "iscan", "nz_off", "br_grp")]),
            device=dev)

    @classmethod
    def from_numpy(cls, arrays: dict, device=None) -> "TxbRateTables":
        """Device tables from txb_rate_arrays()'s numpy arrays."""
        return cls(arrays, device if device is not None else "cuda")

    def __call__(self, levels):
        if levels.device.type == "cpu":
            return txb_bits_plain(levels, self)
        return txb_bits(levels, self)


def txb_bits_plain(levels, t: TxbRateTables):
    """Plain PyTorch version of K3 (written from rate_jax.make_txb_bits_fn)."""
    h, w, n = t.h, t.w, t.h * t.w
    lv = levels.to(torch.int32)
    B = lv.shape[0]
    absl = lv.abs()
    flat = lv.reshape(B, n)
    aflat = absl.reshape(B, n)
    nz = aflat != 0
    iscan = t.iscan[None]
    eob = torch.where(nz, iscan + 1, torch.zeros_like(iscan)).amax(dim=-1)
    P = torch.nn.functional.pad(absl.clamp(max=127), (0, 4, 0, 4))
    M = P.clamp(max=3)
    mag = M[:, 0:h, 1:w + 1] + M[:, 1:h + 1, 0:w]
    if t.tx_class == txb_mod.TX_CLASS_2D:
        mag = mag + M[:, 1:h + 1, 1:w + 1] + M[:, 0:h, 2:w + 2] + M[:, 2:h + 2, 0:w]
    elif t.tx_class == txb_mod.TX_CLASS_VERT:
        mag = mag + M[:, 2:h + 2, 0:w] + M[:, 3:h + 3, 0:w] + M[:, 4:h + 4, 0:w]
    else:
        mag = mag + M[:, 0:h, 2:w + 2] + M[:, 0:h, 3:w + 3] + M[:, 0:h, 4:w + 4]
    bctx = (((mag + 1) >> 1).clamp(max=4).reshape(B, n) + t.nz_off[None]).long()
    if t.tx_class == txb_mod.TX_CLASS_2D:
        bctx[:, 0] = 0
    sym = aflat.clamp(max=3).long()
    before = iscan < (eob[:, None] - 1)
    is_eob = iscan == (eob[:, None] - 1)
    bits = torch.where(before, t.base_lut[bctx, sym], torch.zeros((), device=lv.device)).sum(-1)
    sym_eob = torch.where(is_eob, sym, torch.zeros_like(sym)).sum(-1)
    ectx = t.ectx_lut[(eob - 1).clamp(min=0)]
    bits = bits + t.base_eob_lut[ectx, (sym_eob - 1).clamp(min=0)]
    bits = bits + t.eob_cost[eob]
    magb = P[:, 0:h, 1:w + 1] + P[:, 1:h + 1, 0:w]
    if t.tx_class == txb_mod.TX_CLASS_2D:
        magb = magb + P[:, 1:h + 1, 1:w + 1]
    elif t.tx_class == txb_mod.TX_CLASS_VERT:
        magb = magb + P[:, 2:h + 2, 0:w]
    else:
        magb = magb + P[:, 0:h, 2:w + 2]
    grp = t.br_grp.clone()
    grp[0] = 0  # position 0 takes no group offset
    brctx = (((magb + 1) >> 1).clamp(max=6).reshape(B, n) + grp[None]).long()
    big = aflat > 2
    brc = t.br_lut[brctx, (aflat - 3).clamp(0, 12).long()]
    bits = bits + torch.where(big, brc, torch.zeros((), device=lv.device)).sum(-1)
    gx = (aflat - 14).clamp(min=1).to(torch.float32)
    glens = torch.floor(torch.log2(gx)) + 1.0
    bits = bits + torch.where(aflat > 14, 2.0 * glens - 1.0, torch.zeros((), device=lv.device)).sum(-1)
    nnz = nz.sum(-1).to(torch.float32)
    dc = flat[:, 0]
    dc_cost = torch.where(dc < 0, t.dc_sign_lut[1], t.dc_sign_lut[0])
    bits = bits + torch.where(dc != 0, dc_cost + (nnz - 1.0), nnz)
    return torch.where(eob == 0, t.skip_lut[1], bits + t.skip_lut[0]).to(torch.float32)


def txb_bits(levels, t: TxbRateTables):
    """K3: bits of B transform blocks (B, h, w) int32 on the card."""
    B = levels.shape[0]
    kernels.check(levels, "levels", torch.int32, (B, t.h, t.w))
    if levels.device != t.device:
        raise ValueError(f"txb_bits: levels on {levels.device}, tables on {t.device}")
    out = torch.empty((B,), dtype=torch.float32, device=levels.device)
    kernels.launch("txb_rate", levels.data_ptr(), t.flut.data_ptr(), t.ilut.data_ptr(),
                   out.data_ptr(), B, t.h, t.w, int(math.log2(t.w)), t.tx_class,
                   kernels.stream_ptr(levels))
    return out


def make_txb_bits_fn(fc, tx_size: int, tx_type: int, plane_type: int,
                     txb_skip_ctx: int = 0, dc_sign_ctx: int = 0, device=None) -> TxbRateTables:
    """Counterpart of rate_jax.make_txb_bits_fn: a callable levels -> bits."""
    return TxbRateTables.from_numpy(
        txb_rate_arrays(fc, tx_size, tx_type, plane_type, txb_skip_ctx, dc_sign_ctx), device)
