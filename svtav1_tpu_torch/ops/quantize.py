"""Quantization / dequantization (AV1 spec 7.12.2-7.12.3).

Dequant is normative: level * dq >> tx_scale, dq from the spec's qindex
lookup tables (constants/data/qlookup.npz; reference behavior:
inv_transforms.c:3263-3393, full_loop.c svt_aom_quantize_inv_quantize).
Forward quant is an encoder choice; we use a dead-zone rounding quantizer
(RDOQ refines it later in the pipeline).
"""
from __future__ import annotations

import functools
import os

import numpy as np

from ..constants.av1 import TX_H, TX_W

_DATA = os.path.join(os.path.dirname(__file__), "..", "constants", "data")


@functools.lru_cache(maxsize=None)
def _qlookup() -> dict:
    with np.load(os.path.join(_DATA, "qlookup.npz")) as z:
        return {k: z[k].copy() for k in z.files}


def dc_q(qindex: int, bd: int = 8) -> int:
    t = _qlookup()
    name = {8: "dc_qlookup_QTX", 10: "dc_qlookup_10_QTX", 12: "dc_qlookup_12_QTX"}[bd]
    return int(t[name][np.clip(qindex, 0, 255)])


def ac_q(qindex: int, bd: int = 8) -> int:
    t = _qlookup()
    name = {8: "ac_qlookup_QTX", 10: "ac_qlookup_10_QTX", 12: "ac_qlookup_12_QTX"}[bd]
    return int(t[name][np.clip(qindex, 0, 255)])


def tx_scale(tx_w: int, tx_h: int) -> int:
    """log-scale shift for large transforms (spec av1_get_tx_scale:
    (pels > 256) + (pels > 1024))."""
    pels = tx_w * tx_h
    return int(pels > 256) + int(pels > 1024)


def quantize_np(coeff: np.ndarray, qindex: int, tx_w: int, tx_h: int, bd: int = 8,
                bias_num: int = 1, bias_den: int = 2) -> np.ndarray:
    """Dead-zone scalar quantizer. coeff (..., h, w) int32; returns levels.

    level = floor((|coeff| << tx_scale) / dq + bias), bias = bias_num/bias_den.
    DC position uses dc_q, the rest ac_q.
    """
    ls = tx_scale(tx_w, tx_h)
    dqac = ac_q(qindex, bd)
    dqdc = dc_q(qindex, bd)
    absc = np.abs(coeff.astype(np.int64)) << ls
    dq = np.full(coeff.shape[-2:], dqac, np.int64)
    dq[0, 0] = dqdc
    level = (absc + dq * bias_num // bias_den) // dq
    return (np.sign(coeff) * level).astype(np.int32)


def dequantize_np(level: np.ndarray, qindex: int, tx_w: int, tx_h: int, bd: int = 8) -> np.ndarray:
    """Normative dequant: (level * dq) >> tx_scale, sign preserved."""
    ls = tx_scale(tx_w, tx_h)
    dq = np.full(level.shape[-2:], ac_q(qindex, bd), np.int64)
    dq[0, 0] = dc_q(qindex, bd)
    v = (np.abs(level.astype(np.int64)) * dq) >> ls
    # clamp to valid coefficient range (spec: [-(1<<(bd+7)), (1<<(bd+7))-1])
    v = np.minimum(v, (1 << (bd + 7)) - 1)
    return (np.sign(level) * v).astype(np.int32)
