"""AV1 integer transforms as a batched, table-driven stage interpreter.

TPU-first design: instead of per-size unrolled scalar butterflies (reference:
Source/Lib/Codec/transforms.c svt_av1_fdct*_new, inv_transforms.c
svt_av1_idct*_new), every 1-D transform is a sequence of data-parallel stages
  out[lane] = round_shift(wa[lane]*x[ia[lane]] + wb[lane]*x[ib[lane]], sh[lane])
applied to a whole batch of vectors at once — gathers + elementwise int32 math
on the VPU, `vmap`-free static shapes. Stage tables are extracted normative
math (constants/data/txfm_stages.npz, validated numerically against the ideal
DCT/ADST bases in tests/test_transforms.py).

The *inverse* path is normative (defines decoder recon — reference behavior:
inv_transforms.c:2459 inv_txfm2d_add_c, shifts at :17-35, per-stage clamping
via svt_av1_gen_inv_stage_range at :41). The forward path mirrors the
reference forward (transforms.c:2266, shift tables transforms.h:26-44) so
coefficients carry the conventional AV1 scale.

Both a numpy engine (used by the conformance decoder and tests) and a JAX
engine (device path) share the same precomputed stage tables.
"""
from __future__ import annotations

import functools
import math
import os

import numpy as np

from ..constants.av1 import TX_H, TX_W, TX_TYPE_1D, Tx1D, TxType

_DATA = os.path.join(os.path.dirname(__file__), "..", "constants", "data")

INV_COS_BIT = 12
NEW_SQRT2 = 5793  # round(sqrt(2) * 2^12)
NEW_INV_SQRT2 = 2896  # round(1/sqrt(2) * 2^12)
NEW_SQRT2_BITS = 12


def cospi_arr(cos_bit: int) -> np.ndarray:
    i = np.arange(64)
    return np.round(np.cos(i * math.pi / 128.0) * (1 << cos_bit)).astype(np.int64)


def sinpi_arr(cos_bit: int) -> np.ndarray:
    i = np.arange(5)
    return np.round(np.sqrt(2.0) * np.sin(i * math.pi / 9.0) * 2.0 / 3.0 * (1 << cos_bit)).astype(np.int64)


# ---------------------------------------------------------------------------
# Stage tables
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _raw_stage_tables() -> dict:
    with np.load(os.path.join(_DATA, "txfm_stages.npz")) as z:
        return {k: z[k].copy() for k in z.files}


@functools.lru_cache(maxsize=None)
def stage_table(name: str, cos_bit: int):
    """Materialize (ia, wa, ib, wb, sh, clamp2) int32 arrays per stage.

    clamp2 marks two-term add/sub lanes (clamped in the inverse path only).
    """
    raw = _raw_stage_tables()[name]
    cospi = cospi_arr(cos_bit)
    stages = []
    for s in range(raw.shape[0]):
        ia, ka, ib, kb, mode = (raw[s, i] for i in range(5))
        wa = np.where(mode == 1, np.sign(ka) * cospi[np.abs(ka) - 1], ka).astype(np.int64)
        wb = np.where(mode == 1, np.sign(kb) * cospi[np.maximum(np.abs(kb), 1) - 1] * (kb != 0), kb).astype(np.int64)
        sh = np.where(mode == 1, cos_bit, 0).astype(np.int32)
        clamp2 = ((mode == 0) & (kb != 0)).astype(bool)
        stages.append((ia.astype(np.int32), wa, ib.astype(np.int32), wb, sh, clamp2))
    return stages


# ---------------------------------------------------------------------------
# numpy 1-D engine
# ---------------------------------------------------------------------------


def _round_shift(x, bit):
    if bit == 0:
        return x
    return (x + (1 << (bit - 1))) >> bit


def _clamp_bits(x, bits):
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return np.clip(x, lo, hi)


def _txfm1d_np(x: np.ndarray, name: str, cos_bit: int, clamp_range: int | None) -> np.ndarray:
    """Apply a butterfly-table 1-D transform to x of shape (..., n), int64."""
    for ia, wa, ib, wb, sh, clamp2 in stage_table(name, cos_bit):
        a = x[..., ia]
        b = x[..., ib]
        y = a * wa + b * wb
        rnd = np.where(sh > 0, (1 << np.maximum(sh, 1)) >> 1, 0)
        y = (y + rnd) >> sh
        if clamp_range is not None:
            y = np.where(clamp2, _clamp_bits(y, clamp_range), y)
        x = y
    return x


def _adst4_np(x: np.ndarray, cos_bit: int, inverse: bool) -> np.ndarray:
    """4-point ADST (sinpi-based, AV1 spec 7.13.2.6; behavior:
    inv_transforms.c:722 svt_av1_iadst4_new / transforms.c:1415 fadst4)."""
    sp = sinpi_arr(cos_bit)
    x0, x1, x2, x3 = (x[..., i] for i in range(4))
    if inverse:
        s0 = sp[1] * x0
        s1 = sp[2] * x0
        s2 = sp[3] * x1
        s3 = sp[4] * x2
        s4 = sp[1] * x2
        s5 = sp[2] * x3
        s6 = sp[4] * x3
        s7 = (x0 - x2) + x3
        s0 = s0 + s3
        s1 = s1 - s4
        s3 = s2
        s2 = sp[3] * s7
        s0 = s0 + s5
        s1 = s1 - s6
        o0 = s0 + s3
        o1 = s1 + s3
        o2 = s2
        o3 = s0 + s1 - s3
    else:
        s0 = sp[1] * x0
        s1 = sp[4] * x0
        s2 = sp[2] * x1
        s3 = sp[1] * x1
        s4 = sp[3] * x2
        s5 = sp[4] * x3
        s6 = sp[2] * x3
        s7 = x0 + x1 - x3
        a0 = s0 + s2
        a1 = sp[3] * s7
        a2 = s1 - s3
        a3 = s4
        a0 = a0 + s5
        a2 = a2 + s6
        o0 = a0 + a3
        o1 = a1
        o2 = a2 - a3
        o3 = a2 - a0 + a3
    out = np.stack([o0, o1, o2, o3], axis=-1)
    return _round_shift(out, cos_bit)


_IDT_MULS = {4: (NEW_SQRT2, NEW_SQRT2_BITS), 8: (2, 0), 16: (2 * NEW_SQRT2, NEW_SQRT2_BITS), 32: (4, 0)}


def _identity_np(x: np.ndarray, n: int) -> np.ndarray:
    mul, bits = _IDT_MULS[n]
    return _round_shift(x * mul, bits)


def txfm1d_np(x: np.ndarray, kind: Tx1D, n: int, cos_bit: int, inverse: bool, clamp_range: int | None) -> np.ndarray:
    if kind == Tx1D.IDT:
        return _identity_np(x, n)
    if kind in (Tx1D.ADST, Tx1D.FLIPADST) and n == 4:
        return _adst4_np(x, cos_bit, inverse)
    prefix = "i" if inverse else "f"
    base = "adst" if kind in (Tx1D.ADST, Tx1D.FLIPADST) else "dct"
    return _txfm1d_np(x, f"{prefix}{base}{n}", cos_bit, clamp_range)


# ---------------------------------------------------------------------------
# 2-D drivers (numpy)
# ---------------------------------------------------------------------------

# inverse shifts per tx size (inv_transforms.c:17-35): (shift_after_rows, shift_after_cols)
INV_SHIFTS = {
    (4, 4): (0, 4), (8, 8): (1, 4), (16, 16): (2, 4), (32, 32): (2, 4), (64, 64): (2, 4),
    (4, 8): (0, 4), (8, 4): (0, 4), (8, 16): (1, 4), (16, 8): (1, 4), (16, 32): (1, 4),
    (32, 16): (1, 4), (32, 64): (1, 4), (64, 32): (1, 4), (4, 16): (1, 4), (16, 4): (1, 4),
    (8, 32): (2, 4), (32, 8): (2, 4), (16, 64): (2, 4), (64, 16): (2, 4),
}
# forward shifts (transforms.h:26-44): (pre_col, post_col, post_row); positive = left shift
FWD_SHIFTS = {
    (4, 4): (2, 0, 0), (8, 8): (2, -1, 0), (16, 16): (2, -2, 0), (32, 32): (2, -4, 0),
    (64, 64): (0, -2, -2), (4, 8): (2, -1, 0), (8, 4): (2, -1, 0), (8, 16): (2, -2, 0),
    (16, 8): (2, -2, 0), (16, 32): (2, -4, 0), (32, 16): (2, -4, 0), (32, 64): (0, -2, -2),
    (64, 32): (2, -4, -2), (4, 16): (2, -1, 0), (16, 4): (2, -1, 0), (8, 32): (2, -2, 0),
    (32, 8): (2, -2, 0), (16, 64): (0, -2, 0), (64, 16): (2, -4, 0),
}
# forward cos bits indexed [log2(w)-2][log2(h)-2] (transforms.h:46-49)
FWD_COS_BIT_COL = [[13, 13, 13, 0, 0], [13, 13, 13, 12, 0], [13, 13, 13, 12, 13], [0, 13, 13, 12, 13], [0, 0, 13, 12, 13]]
FWD_COS_BIT_ROW = [[13, 13, 12, 0, 0], [13, 13, 13, 12, 0], [13, 13, 12, 13, 12], [0, 12, 13, 12, 11], [0, 0, 12, 11, 10]]


def _flips(tx_type: TxType) -> tuple[bool, bool]:
    """(ud_flip, lr_flip): vertical FLIPADST flips up-down, horizontal flips left-right."""
    v, h = TX_TYPE_1D[TxType(tx_type)]
    return v == Tx1D.FLIPADST, h == Tx1D.FLIPADST


def _apply_shift_arr(x, bit):
    """round_shift_array semantics: bit>0 -> round_shift; bit<0 -> left shift."""
    if bit > 0:
        return _round_shift(x, bit)
    if bit < 0:
        return x << (-bit)
    return x


def inv_txfm2d_add_np(coeff: np.ndarray, pred: np.ndarray, tx_type: int, bd: int = 8) -> np.ndarray:
    """Normative inverse 2-D transform + reconstruction.

    coeff: (..., h, w) int32 dequantized coefficients (w/h <= 64, coeffs
    outside top-left 32x32 must be zero for 64-point dims).
    pred: (..., h, w) prediction samples. Returns recon clipped to bit depth.
    """
    h, w = coeff.shape[-2], coeff.shape[-1]
    vkind, hkind = TX_TYPE_1D[TxType(tx_type)]
    ud_flip, lr_flip = _flips(tx_type)
    sh_row, sh_col = INV_SHIFTS[(w, h)]
    opt_range_row = 16 if bd == 8 else (18 if bd == 10 else 20)
    opt_range_col = 16 if bd <= 10 else 18

    x = coeff.astype(np.int64)
    rect = abs(int(math.log2(w)) - int(math.log2(h)))
    if rect == 1:
        x = _round_shift(x * NEW_INV_SQRT2, NEW_SQRT2_BITS)
    x = _clamp_bits(x, bd + 8)
    # rows: transform along w
    x = txfm1d_np(x, hkind, w, INV_COS_BIT, True, opt_range_row)
    x = _round_shift(x, sh_row) if sh_row else x
    # columns
    x = np.swapaxes(x, -1, -2)  # (..., w, h)
    x = _clamp_bits(x, max(bd + 6, 16))
    x = txfm1d_np(x, vkind, h, INV_COS_BIT, True, opt_range_col)
    x = _round_shift(x, sh_col)
    x = np.swapaxes(x, -1, -2)  # (..., h, w)
    if lr_flip:
        x = x[..., ::-1]
    if ud_flip:
        x = x[..., ::-1, :]
    recon = pred.astype(np.int64) + x
    return np.clip(recon, 0, (1 << bd) - 1).astype(np.int32)


def fwd_txfm2d_np(resid: np.ndarray, tx_type: int, bd: int = 8) -> np.ndarray:
    """Forward 2-D transform of residuals (..., h, w) -> coefficients, matching
    the reference scale (transforms.c:2266 av1_tranform_two_d flow)."""
    h, w = resid.shape[-2], resid.shape[-1]
    vkind, hkind = TX_TYPE_1D[TxType(tx_type)]
    ud_flip, lr_flip = _flips(tx_type)
    s0, s1, s2 = FWD_SHIFTS[(w, h)]
    wi, hi = int(math.log2(w)) - 2, int(math.log2(h)) - 2
    cb_col, cb_row = FWD_COS_BIT_COL[wi][hi], FWD_COS_BIT_ROW[wi][hi]

    x = resid.astype(np.int64)
    if ud_flip:
        x = x[..., ::-1, :]
    # columns first: transform along h
    x = np.swapaxes(x, -1, -2)  # (..., w, h)
    x = _apply_shift_arr(x, -s0)
    x = txfm1d_np(x, vkind, h, cb_col, False, None)
    x = _apply_shift_arr(x, -s1)
    x = np.swapaxes(x, -1, -2)  # (..., h, w)
    if lr_flip:
        x = x[..., ::-1]
    # rows
    x = txfm1d_np(x, hkind, w, cb_row, False, None)
    x = _apply_shift_arr(x, -s2)
    rect = abs(int(math.log2(w)) - int(math.log2(h)))
    if rect == 1:
        x = _round_shift(x * NEW_SQRT2, NEW_SQRT2_BITS)
    # 64-point dims: zero everything outside the top-left 32x32 (spec)
    if w == 64:
        x[..., :, 32:] = 0
    if h == 64:
        x[..., 32:, :] = 0
    return x.astype(np.int32)
