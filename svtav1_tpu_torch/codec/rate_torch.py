"""PyTorch port of codec/rate_jax.py: exact coefficient bits of transform
blocks from CDF cost LUTs (make_txb_bits_fn) around the CUDA kernel
`csrc/txb_rate.cu` (K3), and the commit's two-pass RDOQ (make_rdoq_fn)
around `csrc/rdoq.cu` (K5), each with a plain PyTorch version beside it.

The host part (`txb_rate_arrays`) builds one txb configuration's LUTs and
maps from a FrameContext exactly as the reference does; `TxbRateTables`
holds them on a device and is called on levels, `RdoqTables` adds RDOQ's
scalars and is called on levels and coefficients. Bits agree with the
reference up to float32 summation order (codec/rate_jax.py:11-12). The
inter decide's MV-rate LUTs (`mv_component_cost_lut`, `mv_joint_cost`) are
host tables built as the reference builds them.
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


# coefficient-domain -> pixel-domain distortion divisor per full tx width
# (rate_jax.make_rdoq_fn); the 1.12 margin rejects borderline moves
_RDOQ_DIV = {4: 132.0, 8: 124.0, 16: 120.0, 32: 36.0, 64: 6.0}


class RdoqTables:
    """One RDOQ configuration on one device (rate_jax.make_rdoq_fn): the
    TX_CLASS_2D rate tables of the DCT scan plus the quant scale `ls` of the
    ORIGINAL tx size (64-point transforms are optimized on their coded
    32x32), the distortion scale, and the skip-flag delta. Call on (levels,
    coeff, dq_dc, dq_ac, lam) -> new levels (K5 on CUDA, plain on CPU)."""

    def __init__(self, fc, tx_size: int, plane_type: int, txb_skip_ctx: int = 0,
                 dc_sign_ctx: int = 0, device=None):
        from ..constants.av1 import TxType

        arrays = txb_rate_arrays(fc, tx_size, int(TxType.DCT_DCT), plane_type, txb_skip_ctx,
                                 dc_sign_ctx)
        self.rate = TxbRateTables(arrays, device if device is not None else "cuda")
        self.device = self.rate.device
        self.h, self.w = self.rate.h, self.rate.w
        full_w, full_h = int(TX_W[tx_size]), int(TX_H[tx_size])
        self.ls = int(full_w * full_h > 256) + int(full_w * full_h > 1024)
        self.dscale = float(np.float32(1.12 / _RDOQ_DIV[full_w]))
        skip = np.asarray(arrays["skip_lut"], np.float32)
        self.skip_delta = float(skip[1] - skip[0])
        scan = np.argsort(np.asarray(arrays["iscan"])).astype(np.int32)
        self.scan = torch.as_tensor(scan, device=self.device)

    def __call__(self, levels, coeff, dq_dc: int, dq_ac: int, lam: float):
        if levels.device.type == "cpu":
            return rdoq_plain(levels, coeff, dq_dc, dq_ac, lam, self)
        return rdoq(levels, coeff, dq_dc, dq_ac, lam, self)


def _rdoq_ctx(a, t: TxbRateTables):
    """(bctx, brctx) (B, n) long of TX_CLASS_2D levels a (B, h, w)."""
    h, w, B = t.h, t.w, a.shape[0]
    P = torch.nn.functional.pad(a.clamp(max=127), (0, 4, 0, 4))
    M = P.clamp(max=3)
    mag = (M[:, 0:h, 1:w + 1] + M[:, 1:h + 1, 0:w] + M[:, 1:h + 1, 1:w + 1]
           + M[:, 0:h, 2:w + 2] + M[:, 2:h + 2, 0:w])
    bctx = (((mag + 1) >> 1).clamp(max=4).reshape(B, -1) + t.nz_off[None]).long()
    bctx[:, 0] = 0
    magb = P[:, 0:h, 1:w + 1] + P[:, 1:h + 1, 0:w] + P[:, 1:h + 1, 1:w + 1]
    grp = t.br_grp.clone()
    grp[0] = 0  # position 0 takes no group offset
    brctx = (((magb + 1) >> 1).clamp(max=6).reshape(B, -1) + grp[None]).long()
    return bctx, brctx


def rdoq_plain(levels, coeff, dq_dc: int, dq_ac: int, lam: float, rt: RdoqTables):
    """Plain PyTorch version of K5 (written from rate_jax.make_rdoq_fn),
    float32 in the reference's order of operations. The reverse-scan suffix
    sums are taken in float64 and rounded to float32, in both this version
    and the kernel, so that the two agree bit for bit."""
    t = rt.rate
    h, w = t.h, t.w
    n = h * w
    B = levels.shape[0]
    dev = levels.device
    f32 = torch.float32
    lv = levels.to(torch.int32).reshape(B, n)
    a0 = lv.abs()
    c_abs = coeff.to(torch.int32).reshape(B, n).abs().to(f32)
    dqv = torch.full((n,), int(dq_ac), dtype=torch.int32, device=dev)
    dqv[0] = int(dq_dc)
    lam_t = torch.tensor(lam, dtype=f32, device=dev)
    dscale = torch.tensor(rt.dscale, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)

    def err(a):
        return ((a * dqv[None]) >> rt.ls).to(f32) - c_abs

    dc_cost = torch.where(lv[:, 0] < 0, t.dc_sign_lut[1], t.dc_sign_lut[0])
    sign_cost = torch.ones((B, n), dtype=f32, device=dev)
    sign_cost[:, 0] = dc_cost

    def own_cost(a, bctx, brctx):
        base = t.base_lut[bctx, a.clamp(max=3).long()]
        brc = torch.where(a > 2, t.br_lut[brctx, (a - 3).clamp(0, 12).long()], zero)
        gx = (a - 14).clamp(min=1).to(f32)
        gol = torch.where(a > 14, 2.0 * (torch.floor(torch.log2(gx)) + 1.0) - 1.0, zero)
        return base + brc + gol + torch.where(a > 0, sign_cost, zero)

    # pass 1: eob truncation by reverse-scan suffix sums of the zeroing gain
    bctx, brctx = _rdoq_ctx(a0.reshape(B, h, w), t)
    e0 = err(a0)
    zd = (c_abs * c_abs - e0 * e0) * dscale
    g = torch.where(a0 > 0, zd, zero) - lam_t * own_cost(a0, bctx, brctx)
    scan = rt.scan.long()
    g_scan, a_scan, bctx_scan = g[:, scan], a0[:, scan], bctx[:, scan]
    ks = torch.arange(1, n + 1, device=dev)
    eob0 = torch.where(a_scan > 0, ks[None], torch.zeros_like(ks)[None]).amax(dim=-1)
    g_scan = torch.where(ks[None] - 1 < eob0[:, None], g_scan, zero)
    S = torch.cumsum(g_scan.to(torch.float64).flip(-1), dim=-1).flip(-1).to(f32)
    S = torch.cat([S, torch.zeros((B, 1), dtype=f32, device=dev)], dim=-1)
    sym = a_scan.clamp(max=3).long()
    beob = t.base_eob_lut[t.ectx_lut[None], (sym - 1).clamp(min=0)]
    bnorm = t.base_lut[bctx_scan, sym]
    score_k = S[:, 1:] + lam_t * (t.eob_cost[1:][None] + beob - bnorm)
    valid = (a_scan > 0) & (ks[None] <= eob0[:, None])
    score_k = torch.where(valid, score_k, torch.full((), float("inf"), device=dev))
    score_0 = S[:, 0] + lam_t * torch.tensor(rt.skip_delta, dtype=f32, device=dev)
    kbest = torch.argmin(torch.cat([score_0[:, None], score_k], dim=-1), dim=-1)
    isc = t.iscan[None]
    keep = isc < kbest[:, None]
    a1 = torch.where(keep, a0, torch.zeros_like(a0))

    # pass 2: level-down with contexts refreshed from the truncated levels
    bctx, brctx = _rdoq_ctx(a1.reshape(B, h, w), t)
    is_eob = isc == (kbest[:, None] - 1)
    e1 = err(a1)
    adn = (a1 - 1).clamp(min=0)
    edn = err(adn)
    dd = (edn * edn - e1 * e1) * dscale
    c_now = own_cost(a1, bctx, brctx)
    c_dn = own_cost(adn, bctx, brctx)
    ectx_k = t.ectx_lut[(kbest - 1).clamp(min=0)][:, None]
    beob_now = t.base_eob_lut[ectx_k, (a1.clamp(max=3) - 1).clamp(min=0).long()]
    beob_dn = t.base_eob_lut[ectx_k, (adn.clamp(max=3) - 1).clamp(min=0).long()]
    b_now = t.base_lut[bctx, a1.clamp(max=3).long()]
    b_dn = t.base_lut[bctx, adn.clamp(max=3).long()]
    c_now = torch.where(is_eob, c_now - b_now + beob_now, c_now)
    c_dn = torch.where(is_eob, c_dn - b_dn + beob_dn, c_dn)
    allow = (a1 > 0) & keep & (~is_eob | (a1 >= 2))
    better = allow & (dd + lam_t * (c_dn - c_now) < 0.0)
    a2 = a1 - better.to(torch.int32)
    return torch.where(lv < 0, -a2, a2).reshape(levels.shape).to(torch.int32)


def rdoq(levels, coeff, dq_dc: int, dq_ac: int, lam: float, rt: RdoqTables):
    """K5: RDOQ of B transform blocks (levels and unquantized coefficients
    (B, h, w) int32 on the card) -> new levels."""
    B = levels.shape[0]
    kernels.check(levels, "levels", torch.int32, (B, rt.h, rt.w))
    kernels.check(coeff, "coeff", torch.int32, (B, rt.h, rt.w))
    if levels.device != rt.device:
        raise ValueError(f"rdoq: levels on {levels.device}, tables on {rt.device}")
    t = rt.rate
    out = torch.empty_like(levels)
    kernels.launch("rdoq", levels.data_ptr(), coeff.data_ptr(), t.flut.data_ptr(),
                   t.ilut.data_ptr(), rt.scan.data_ptr(), out.data_ptr(), B, rt.h, rt.w,
                   int(math.log2(rt.w)), rt.ls, int(dq_dc), int(dq_ac), float(lam), rt.dscale,
                   rt.skip_delta, kernels.stream_ptr(levels))
    return out


def make_rdoq_fn(fc, tx_size: int, plane_type: int, txb_skip_ctx: int = 0,
                 dc_sign_ctx: int = 0, device=None) -> RdoqTables:
    """Counterpart of rate_jax.make_rdoq_fn: a callable (levels, coeff,
    dq_dc, dq_ac, lam) -> levels."""
    return RdoqTables(fc, tx_size, plane_type, txb_skip_ctx, dc_sign_ctx, device)


def mv_component_cost_lut(fc, max_abs: int = 1 << 11) -> np.ndarray:
    """(2, max_abs+1) float32 per component (0=row, 1=col): bits to code one
    NEWMV difference of magnitude d (1/8-pel units; without allow_hp only even
    values are codable — odd entries get an effectively-infinite cost). Cost
    includes the sign bit. Host LUT for the inter decide's MV rates. d=0 -> 0."""
    from .mv import MvCoder

    out = np.zeros((2, max_abs + 1), np.float32)
    coder = MvCoder(fc, update=False, allow_hp=False)
    for comp in range(2):
        for d in range(2, max_abs + 1, 2):
            bc = rate_np.BitCounter()
            coder._write_component(bc, comp, d)
            out[comp, d] = bc.bits
    out[:, 1::2] = 1e9
    return out


def mv_joint_cost(fc) -> np.ndarray:
    """(2,2) float32: nmv joint symbol cost indexed [row!=0][col!=0]."""
    j = rate_np.cdf_cost_table(fc["nmv_joints"], 4)
    return np.array([[j[0], j[1]], [j[2], j[3]]], np.float32)
