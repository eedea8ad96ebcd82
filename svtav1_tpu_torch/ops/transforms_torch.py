"""PyTorch port of ops/transforms_jax.py for the square DCT/ADST blocks of the
intra path: forward 2-D transform, dead-zone quant clipped to +-32767,
dequant, inverse 2-D transform + prediction, and the recon's SSE — fused in
the CUDA kernel `csrc/txfm_quant_recon.cu` (K2), with a plain PyTorch version
beside it. K2 also runs as its two halves around RDOQ: `txfm_quant` (levels
and unquantized coefficients) and `recon_from_levels`. K15 `tpl_cost`, a
second entry point of the same source, fuses the TPL's two transform-domain
costs (the SATD proxy; the quantization error with the recon) on K2's lines:
the same compiled DCT networks, staging and quantizer.

Each wrapper launches K2 for CUDA tensors and takes the plain version only
for CPU tensors. Both run the same int32 stage networks as the
reference (tables from constants/data/txfm_stages.npz via ops/transforms),
with int32 arithmetic that wraps like XLA's, so levels and recon are
bit-exact with fwd_txfm2d_j / quantize_j / dequantize_j / inv_txfm2d_add_j.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import kernels
from ..constants.av1 import TX_TYPE_1D, Tx1D, TxType
from . import quantize as quant_ops
from . import transforms as T

SIZES = (4, 8, 16, 32, 64)


def _cos_bits(n: int) -> tuple[int, int]:
    wi = int(math.log2(n)) - 2
    return T.FWD_COS_BIT_COL[wi][wi], T.FWD_COS_BIT_ROW[wi][wi]


def numpy_stage_tables(n: int) -> dict:
    """{(name, cos_bit): [(ia, wa, ib, wb, sh, clamp2), ...]} of every 1-D
    network a square n-point DCT/ADST 2-D transform uses (ADST4 is not a
    table: it is computed from sinpi)."""
    cb_col, cb_row = _cos_bits(n)
    names = [("fdct", cb_col), ("fdct", cb_row), ("idct", T.INV_COS_BIT)]
    if 4 < n <= 16:
        names += [("fadst", cb_col), ("fadst", cb_row), ("iadst", T.INV_COS_BIT)]
    return {(f"{b}{n}", cb): T.stage_table(f"{b}{n}", cb) for b, cb in names}


class StageTables:
    """The stage networks of one block size on one device, as the plain
    version's per-table stage tensors (the kernels run the same networks
    compiled in, csrc/txfm_nets.cuh)."""

    def __init__(self, n: int, tables: dict, device):
        self.n = n
        self.device = torch.device(device)
        self.cb_col, self.cb_row = _cos_bits(n)
        self.stages = {}
        for key, stages in tables.items():
            self.stages[key] = [
                (torch.as_tensor(np.asarray(ia), dtype=torch.long, device=device),
                 torch.as_tensor(np.asarray(wa), dtype=torch.int32, device=device),
                 torch.as_tensor(np.asarray(ib), dtype=torch.long, device=device),
                 torch.as_tensor(np.asarray(wb), dtype=torch.int32, device=device),
                 torch.as_tensor(np.asarray(sh), dtype=torch.int32, device=device),
                 torch.as_tensor(np.where(np.asarray(sh) > 0,
                                          (1 << np.maximum(np.asarray(sh), 1)) >> 1, 0),
                                 dtype=torch.int32, device=device),
                 torch.as_tensor(np.asarray(clamp2), dtype=torch.bool, device=device))
                for ia, wa, ib, wb, sh, clamp2 in stages]


@functools.lru_cache(maxsize=None)
def _tables(n: int, device: str) -> StageTables:
    return StageTables(n, numpy_stage_tables(n), device)


def tables_for(n: int, device) -> StageTables:
    return _tables(n, str(torch.device(device)))


# ---------------------------------------------------------------------------
# plain PyTorch version (written from transforms_jax.py)
# ---------------------------------------------------------------------------


def _round_shift(x, bit: int):
    return x if bit == 0 else (x + (1 << (bit - 1))) >> bit


def _apply_shift(x, bit: int):
    if bit > 0:
        return _round_shift(x, bit)
    if bit < 0:
        return x << (-bit)
    return x


def _clamp_bits(x, bits: int):
    return x.clamp(-(1 << (bits - 1)), (1 << (bits - 1)) - 1)


def _txfm1d_table(x, stages, clamp_range):
    for ia, wa, ib, wb, sh, rnd, clamp2 in stages:
        # torch.gather: on the CPU many times faster than x[..., ia]
        y = (torch.gather(x, -1, ia.expand(x.shape)) * wa
             + torch.gather(x, -1, ib.expand(x.shape)) * wb + rnd) >> sh
        if clamp_range is not None:
            y = torch.where(clamp2, _clamp_bits(y, clamp_range), y)
        x = y
    return x


def _adst4(x, cos_bit: int, inverse: bool):
    sp = [int(v) for v in T.sinpi_arr(cos_bit)]
    x0, x1, x2, x3 = (x[..., i] for i in range(4))
    if inverse:
        s0 = sp[1] * x0 + sp[4] * x2 + sp[2] * x3
        s1 = sp[2] * x0 - sp[1] * x2 - sp[4] * x3
        s2 = sp[3] * ((x0 - x2) + x3)
        s3 = sp[3] * x1
        out = [s0 + s3, s1 + s3, s2, s0 + s1 - s3]
    else:
        a0 = sp[1] * x0 + sp[2] * x1 + sp[4] * x3
        a1 = sp[3] * (x0 + x1 - x3)
        a2 = sp[4] * x0 - sp[1] * x1 + sp[2] * x3
        a3 = sp[3] * x2
        out = [a0 + a3, a1, a2 - a3, a2 - a0 + a3]
    return _round_shift(torch.stack(out, dim=-1), cos_bit)


def _sel_kinds(x, adst, tabs: StageTables, prefix: str, cos_bit: int, clamp_range):
    """1-D DCT, or ADST where `adst` (per lane) holds, along the last axis."""
    n = tabs.n
    inverse = prefix == "i"
    xd = _txfm1d_table(x, tabs.stages[(f"{prefix}dct{n}", cos_bit)], clamp_range)
    if n > 16:
        return xd
    if n == 4:
        xa = _adst4(x, cos_bit, inverse)
    else:
        xa = _txfm1d_table(x, tabs.stages[(f"{prefix}adst{n}", cos_bit)], clamp_range)
    return torch.where(adst.view(adst.shape + (1,) * (x.dim() - adst.dim())), xa, xd)


def _forward_plain(src, pred, v_adst, h_adst, bd: int, rep: int, tabs: StageTables):
    """Forward 2-D transform of src - pred (fwd_txfm2d_sel_j), with the
    64-point zero-out: (L, n, n) int32 coefficients."""
    n = pred.shape[-1]
    s0, s1, s2 = T.FWD_SHIFTS[(n, n)]
    srcL = src.repeat_interleave(rep, dim=0) if rep > 1 else src
    x = (srcL - pred).transpose(-1, -2)
    x = _apply_shift(x, -s0)
    x = _sel_kinds(x, v_adst, tabs, "f", tabs.cb_col, None)
    x = _apply_shift(x, -s1).transpose(-1, -2)
    x = _sel_kinds(x, h_adst, tabs, "f", tabs.cb_row, None)
    x = _apply_shift(x, -s2)
    if n == 64:
        x = x.clone()
        x[..., :, 32:] = 0
        x[..., 32:, :] = 0
    return x


def _dq_grid(n: int, dq_dc: int, dq_ac: int, device):
    dq = torch.full((n, n), dq_ac, dtype=torch.int32, device=device)
    dq[0, 0] = dq_dc
    return dq


def _quant_plain(x, dq_dc: int, dq_ac: int):
    """quantize_j + clip to +-32767 of (L, n, n) coefficients."""
    n = x.shape[-1]
    dq = _dq_grid(n, dq_dc, dq_ac, x.device)
    lv = torch.div((x.abs() << quant_ops.tx_scale(n, n)) + dq // 2, dq, rounding_mode="floor")
    return (torch.sign(x) * lv).clamp(-32767, 32767).to(torch.int32)


def _dequant_plain(lv, dq_dc: int, dq_ac: int, bd: int):
    """dequantize_j of (L, n, n) levels, |dqc| at most 2^(bd + 7) - 1."""
    n = lv.shape[-1]
    dq = _dq_grid(n, dq_dc, dq_ac, lv.device)
    return torch.sign(lv) * ((lv.abs() * dq) >> quant_ops.tx_scale(n, n)) \
        .clamp(max=(1 << (bd + 7)) - 1)


def _inverse_plain(lv, pred, v_adst, h_adst, dq_dc: int, dq_ac: int, bd: int,
                   tabs: StageTables):
    """dequantize_j + inv_txfm2d_add_sel_j: (L, n, n) levels -> recon."""
    n = pred.shape[-1]
    sh_row, sh_col = T.INV_SHIFTS[(n, n)]
    y = _clamp_bits(_dequant_plain(lv, dq_dc, dq_ac, bd), bd + 8)
    y = _sel_kinds(y, h_adst, tabs, "i", T.INV_COS_BIT, 16 if bd == 8 else 18)
    y = _round_shift(y, sh_row).transpose(-1, -2)
    y = _clamp_bits(y, max(bd + 6, 16))
    y = _sel_kinds(y, v_adst, tabs, "i", T.INV_COS_BIT, 16)
    y = _round_shift(y, sh_col).transpose(-1, -2)
    return (pred + y).clamp(0, (1 << bd) - 1).to(torch.int32).contiguous()


def txfm_quant_recon_plain(src, pred, v_adst, h_adst, dq_dc: int, dq_ac: int, bd: int,
                           rep: int = 1, want_recon: bool = True, want_sse: bool = False):
    """Plain PyTorch version of K2; same arguments and results as
    txfm_quant_recon."""
    n = pred.shape[-1]
    tabs = tables_for(n, pred.device)
    lv = _quant_plain(_forward_plain(src, pred, v_adst, h_adst, bd, rep, tabs), dq_dc, dq_ac)
    recon = _inverse_plain(lv, pred, v_adst, h_adst, dq_dc, dq_ac, bd, tabs)
    adj = min(n, 32)
    levels = lv[:, :adj, :adj].contiguous()
    sse = None
    if want_sse:
        d = (recon - (src.repeat_interleave(rep, dim=0) if rep > 1 else src)).to(torch.int64)
        sse = (d * d).sum(dim=(-2, -1))
    return levels, (recon if want_recon else None), sse


def txfm_quant_plain(src, pred, v_adst, h_adst, dq_dc: int, dq_ac: int, bd: int):
    """Plain PyTorch version of K2's forward half; same arguments and
    results as txfm_quant."""
    n = pred.shape[-1]
    tabs = tables_for(n, pred.device)
    x = _forward_plain(src, pred, v_adst, h_adst, bd, 1, tabs)
    adj = min(n, 32)
    return (_quant_plain(x, dq_dc, dq_ac)[:, :adj, :adj].contiguous(),
            x[:, :adj, :adj].contiguous())


def recon_from_levels_plain(levels, pred, v_adst, h_adst, dq_dc: int, dq_ac: int, bd: int):
    """Plain PyTorch version of K2's inverse half; same arguments and
    results as recon_from_levels."""
    L, n = pred.shape[0], pred.shape[-1]
    tabs = tables_for(n, pred.device)
    adj = levels.shape[-1]
    lv = levels
    if adj < n:
        lv = torch.zeros((L, n, n), dtype=torch.int32, device=levels.device)
        lv[:, :adj, :adj] = levels
    return _inverse_plain(lv, pred, v_adst, h_adst, dq_dc, dq_ac, bd, tabs)


def tpl_cost_plain(src, pred, mode: int, dq_dc: int, dq_ac: int, bd: int, rep: int = 1,
                   want_recon: bool = False):
    """Plain PyTorch version of K15; same arguments and results as tpl_cost
    (written from the expressions of the reference's pipeline/tpl.py)."""
    L, n = pred.shape[0], pred.shape[-1]
    tabs = tables_for(n, pred.device)
    va, ha = tx_flags(int(TxType.DCT_DCT), L, pred.device)
    co = _forward_plain(src, pred, va, ha, bd, rep, tabs)
    if mode == 0:
        return (co.abs().sum(dim=(-2, -1)).to(torch.int32) >> 2).contiguous()
    lv = _quant_plain(co, dq_dc, dq_ac)
    e = ((co - _dequant_plain(lv, dq_dc, dq_ac, bd)) >> 2).to(torch.int64)
    err = (e * e).sum(dim=(-2, -1))
    recon = _inverse_plain(lv, pred, va, ha, dq_dc, dq_ac, bd, tabs) if want_recon else None
    return err, recon


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _launch(stage: int, src, pred, v_adst, h_adst, levels, coeff, recon, sse, dq_dc: int,
            dq_ac: int, bd: int, rep: int) -> None:
    L, n = pred.shape[0], pred.shape[-1]
    s0, s1, s2 = T.FWD_SHIFTS[(n, n)]
    sh_row, sh_col = T.INV_SHIFTS[(n, n)]

    def ptr(t):
        return t.data_ptr() if t is not None else None

    kernels.launch("txfm_quant_recon", ptr(src), pred.data_ptr(), v_adst.data_ptr(),
                   h_adst.data_ptr(), levels.data_ptr(), ptr(coeff), ptr(recon), ptr(sse),
                   stage, L, rep, n, -s0, -s1, -s2, sh_row, sh_col, int(dq_dc), int(dq_ac),
                   quant_ops.tx_scale(n, n), bd, kernels.stream_ptr(pred))


def _check_lanes(pred, v_adst, h_adst):
    L, n = pred.shape[0], pred.shape[-1]
    if n not in SIZES or pred.shape[1:] != (n, n):
        raise ValueError(f"txfm_quant_recon: square blocks of {SIZES} only, got {tuple(pred.shape)}")
    kernels.check(pred, "pred", torch.int32)
    kernels.check(v_adst, "v_adst", torch.bool, (L,))
    kernels.check(h_adst, "h_adst", torch.bool, (L,))
    return L, n


def txfm_quant_recon(src, pred, v_adst, h_adst, dq_dc: int, dq_ac: int, bd: int,
                     rep: int = 1, want_recon: bool = True, want_sse: bool = False):
    """Transform, quantize and reconstruct L square blocks.

    src (L // rep, n, n) int32 source blocks (lane i uses src[i // rep]);
    pred (L, n, n) int32 predictions; v_adst / h_adst (L,) bool per-lane
    vertical / horizontal ADST (DCT where False; ADST exists up to 16
    points). Returns (levels (L, adj, adj) int32 with adj = min(n, 32),
    recon (L, n, n) int32 or None, sse (L,) int64 or None)."""
    if pred.device.type == "cpu":
        return txfm_quant_recon_plain(src, pred, v_adst, h_adst, dq_dc, dq_ac, bd, rep,
                                      want_recon, want_sse)
    L, n = _check_lanes(pred, v_adst, h_adst)
    if L % rep or src.shape[0] != L // rep:
        raise ValueError("txfm_quant_recon: src must hold L // rep blocks")
    kernels.check(src, "src", torch.int32, (L // rep, n, n))
    adj = min(n, 32)
    dev = pred.device
    levels = torch.empty((L, adj, adj), dtype=torch.int32, device=dev)
    recon = torch.empty((L, n, n), dtype=torch.int32, device=dev) if want_recon else None
    sse = torch.empty((L,), dtype=torch.int64, device=dev) if want_sse else None
    _launch(0, src, pred, v_adst, h_adst, levels, None, recon, sse, dq_dc, dq_ac, bd, rep)
    return levels, recon, sse


def txfm_quant(src, pred, v_adst, h_adst, dq_dc: int, dq_ac: int, bd: int):
    """K2's forward half: transform and quantize L blocks (src and pred
    (L, n, n) int32). Returns (levels, coeff), both (L, adj, adj) int32: the
    levels clipped to +-32767 and the unquantized coefficients of the coded
    region (adj = min(n, 32)), as RDOQ takes them."""
    if pred.device.type == "cpu":
        return txfm_quant_plain(src, pred, v_adst, h_adst, dq_dc, dq_ac, bd)
    L, n = _check_lanes(pred, v_adst, h_adst)
    kernels.check(src, "src", torch.int32, (L, n, n))
    adj = min(n, 32)
    levels = torch.empty((L, adj, adj), dtype=torch.int32, device=pred.device)
    coeff = torch.empty_like(levels)
    _launch(1, src, pred, v_adst, h_adst, levels, coeff, None, None, dq_dc, dq_ac, bd, 1)
    return levels, coeff


def recon_from_levels(levels, pred, v_adst, h_adst, dq_dc: int, dq_ac: int, bd: int):
    """K2's inverse half: dequantize (L, adj, adj) levels (zero outside the
    coded region), inverse transform, add pred (L, n, n) and clip. Returns
    the recon (L, n, n) int32."""
    if pred.device.type == "cpu":
        return recon_from_levels_plain(levels, pred, v_adst, h_adst, dq_dc, dq_ac, bd)
    L, n = _check_lanes(pred, v_adst, h_adst)
    adj = min(n, 32)
    kernels.check(levels, "levels", torch.int32, (L, adj, adj))
    recon = torch.empty((L, n, n), dtype=torch.int32, device=pred.device)
    _launch(2, None, pred, v_adst, h_adst, levels, None, recon, None, dq_dc, dq_ac, bd, 1)
    return recon


def tpl_cost(src, pred, mode: int, dq_dc: int, dq_ac: int, bd: int, rep: int = 1,
             want_recon: bool = False):
    """The TPL's transform-domain costs of L square DCT_DCT blocks (K15).

    src (L // rep, n, n) int32 source blocks (lane i uses src[i // rep]),
    pred (L, n, n) int32 predictions, n <= 32. mode 0 returns the SATD proxy
    sum |fwd_txfm2d(src - pred)| >> 2, (L,) int32. mode 1 quantizes the
    coefficients co (levels clipped to +-32767), dequantizes them to dqc and
    returns (err (L,) int64 = sum ((co - dqc) >> 2)^2, recon (L, n, n) int32
    = inv_txfm2d_add(dqc, pred) clipped, or None unless want_recon)."""
    if pred.device.type == "cpu":
        return tpl_cost_plain(src, pred, mode, dq_dc, dq_ac, bd, rep, want_recon)
    L, n = pred.shape[0], pred.shape[-1]
    if n not in SIZES[:-1] or pred.shape[1:] != (n, n) or mode not in (0, 1):
        raise ValueError(f"tpl_cost: mode 0 or 1 on square blocks of {SIZES[:-1]}, got mode "
                         f"{mode}, {tuple(pred.shape)}")
    if L % rep:
        raise ValueError("tpl_cost: src must hold L // rep blocks")
    kernels.check(pred, "pred", torch.int32)
    kernels.check(src, "src", torch.int32, (L // rep, n, n))
    dev = pred.device
    satd = torch.empty((L,), dtype=torch.int32, device=dev) if mode == 0 else None
    err = torch.empty((L,), dtype=torch.int64, device=dev) if mode == 1 else None
    recon = torch.empty((L, n, n), dtype=torch.int32, device=dev) if mode == 1 and want_recon \
        else None
    s0, s1, s2 = T.FWD_SHIFTS[(n, n)]
    sh_row, sh_col = T.INV_SHIFTS[(n, n)]

    def ptr(t):
        return t.data_ptr() if t is not None else None

    kernels.launch("tpl_cost", src.data_ptr(), pred.data_ptr(), ptr(satd), ptr(err), ptr(recon),
                   mode, L, rep, n, -s0, -s1, -s2, sh_row, sh_col, int(dq_dc), int(dq_ac),
                   quant_ops.tx_scale(n, n), bd, kernels.stream_ptr(pred))
    return satd if mode == 0 else (err, recon)


def tx_flags(tx_type: int, L: int, device) -> tuple:
    """(v_adst, h_adst) lanes for a static DCT/ADST 2-D type."""
    vk, hk = TX_TYPE_1D[TxType(tx_type)]
    if vk not in (Tx1D.DCT, Tx1D.ADST) or hk not in (Tx1D.DCT, Tx1D.ADST):
        raise NotImplementedError("txfm_quant_recon covers the DCT/ADST types only")
    return (torch.full((L,), vk == Tx1D.ADST, dtype=torch.bool, device=device),
            torch.full((L,), hk == Tx1D.ADST, dtype=torch.bool, device=device))
