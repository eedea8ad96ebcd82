"""Inter-prediction subpel convolution (AV1 spec 7.11.3.4).

Normative 8-tap separable interpolation for motion compensation: horizontal
pass at round_0=3 into 16-bit intermediates, vertical pass at round_1=11,
with the spec's offset terms (behavioral reference:
Source/Lib/Codec/inter_prediction.c svt_av1_convolve_2d_sr_c; filter kernels
inter_prediction.c:223 sub_pel_filters_*, extracted to
constants/data/subpel_filters.npz).

Batched TPU-first layout: (B, h+7, w+7) source patches -> (B, h, w)
predictions; the taps loop unrolls into 8 shifted adds (VPU work, fusable).
Works with numpy or jax.numpy.
"""
from __future__ import annotations

import functools
import os

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "..", "constants", "data")

FILTER_BITS = 7
ROUND0 = 3
ROUND1 = 11  # 2*FILTER_BITS - ROUND0

# interp filter enum (spec): EIGHTTAP_REGULAR, EIGHTTAP_SMOOTH, EIGHTTAP_SHARP, BILINEAR
# + the 4-tap variants selected for <=4-sample dimensions (spec Subpel_Filters rows 4/5)
REGULAR, SMOOTH, SHARP, BILINEAR, REGULAR4, SMOOTH4 = 0, 1, 2, 3, 4, 5
_FILTER_TABLE = {REGULAR: "sub_pel_filters_8", SMOOTH: "sub_pel_filters_8smooth",
                 SHARP: "sub_pel_filters_8sharp", BILINEAR: "bilinear_filters",
                 REGULAR4: "sub_pel_filters_4", SMOOTH4: "sub_pel_filters_4smooth"}


def filter_for_dim(which: int, dim: int) -> int:
    """spec 7.11.3.4: dimensions <= 4 use the 4-tap filter variants."""
    if dim > 4:
        return which
    if which in (REGULAR, SHARP):
        return REGULAR4
    if which == SMOOTH:
        return SMOOTH4
    return which


@functools.lru_cache(maxsize=None)
def filter_kernels(which: int) -> np.ndarray:
    """(16, 8) int32 kernels per subpel phase 0..15."""
    with np.load(os.path.join(_DATA, "subpel_filters.npz")) as z:
        return z[_FILTER_TABLE[which]].astype(np.int32)


def _round_pow2(x, n, xp):
    return (x + (1 << (n - 1))) >> n


def convolve_2d_batch(patches, subpel_x: int, subpel_y: int, which: int = REGULAR,
                      bd: int = 8, xp=np, which_y: int | None = None):
    """Normative single-ref subpel interpolation.

    patches: (B, h + 7, w + 7) int32 source windows whose (3, 3) offset is
    the full-pel position (fo = taps/2 - 1 = 3). subpel_x/y in 1/16 units
    (0..15). `which` selects the horizontal filter (and vertical unless
    which_y given). Returns (B, h, w) int32 predictions.
    """
    B, hp, wp = patches.shape
    h, w = hp - 7, wp - 7
    fx = filter_kernels(which)[subpel_x & 15]
    fy = filter_kernels(which if which_y is None else which_y)[subpel_y & 15]
    bits = 2 * FILTER_BITS - ROUND0 - ROUND1
    offset_bits = bd + 2 * FILTER_BITS - ROUND0

    # horizontal: rows 0..h+6, cols 0..w-1
    acc = xp.zeros((B, hp, w), xp.int32) + (1 << (bd + FILTER_BITS - 1))
    for k in range(8):
        acc = acc + int(fx[k]) * patches[:, :, k : k + w]
    im = _round_pow2(acc, ROUND0, xp)

    acc = xp.zeros((B, h, w), xp.int32) + (1 << offset_bits)
    for k in range(8):
        acc = acc + int(fy[k]) * im[:, k : k + h, :]
    res = _round_pow2(acc, ROUND1, xp) - ((1 << (offset_bits - ROUND1)) + (1 << (offset_bits - ROUND1 - 1)))
    if bits > 0:
        res = _round_pow2(res, bits, xp)
    return xp.clip(res, 0, (1 << bd) - 1).astype(xp.int32)


COMPOUND_ROUND1 = 7  # spec COMPOUND_ROUND1_BITS (InterRound1 when compound)


def convolve_2d_batch_compound(patches, subpel_x: int, subpel_y: int,
                               which: int = REGULAR, bd: int = 8, xp=np,
                               which_y: int | None = None):
    """Compound-path interpolation: returns the CONV_BUF intermediate
    (offset-carrying, round_1 = 7) for one reference of a compound pair
    (spec 7.11.3.4 is_compound; libaom av1_dist_wtd_convolve_2d_c)."""
    B, hp, wp = patches.shape
    h, w = hp - 7, wp - 7
    fx = filter_kernels(which)[subpel_x & 15]
    fy = filter_kernels(which if which_y is None else which_y)[subpel_y & 15]
    offset_bits = bd + 2 * FILTER_BITS - ROUND0

    acc = xp.zeros((B, hp, w), xp.int32) + (1 << (bd + FILTER_BITS - 1))
    for k in range(8):
        acc = acc + int(fx[k]) * patches[:, :, k : k + w]
    im = _round_pow2(acc, ROUND0, xp)

    acc = xp.zeros((B, h, w), xp.int32) + (1 << offset_bits)
    for k in range(8):
        acc = acc + int(fy[k]) * im[:, k : k + h, :]
    return _round_pow2(acc, COMPOUND_ROUND1, xp)


def compound_average(conv0, conv1, bd: int = 8, xp=np):
    """Average two CONV_BUF intermediates into final pixels (spec compound
    blend without jnt weights: tmp = (p0 + p1) >> 1, offsets removed,
    round_bits = 2*FILTER_BITS - round_0 - round_1 = 4)."""
    offset_bits = bd + 2 * FILTER_BITS - ROUND0
    tmp = (conv0 + conv1) >> 1
    tmp = tmp - ((1 << (offset_bits - COMPOUND_ROUND1))
                 + (1 << (offset_bits - COMPOUND_ROUND1 - 1)))
    round_bits = 2 * FILTER_BITS - ROUND0 - COMPOUND_ROUND1
    return xp.clip(_round_pow2(tmp, round_bits, xp), 0, (1 << bd) - 1)


def convolve_2d_scalar_compound(plane: np.ndarray, x: int, y: int, w: int, h: int,
                                mv_x_q4: int, mv_y_q4: int, which: int = REGULAR,
                                bd: int = 8) -> np.ndarray:
    """Scalar compound-path MC for one reference: CONV_BUF intermediates."""
    fx = (x << 4) + mv_x_q4
    fy = (y << 4) + mv_y_q4
    ix, sx = fx >> 4, fx & 15
    iy, sy = fy >> 4, fy & 15
    H, W = plane.shape
    ys = np.clip(np.arange(iy - 3, iy + h + 4), 0, H - 1)
    xs = np.clip(np.arange(ix - 3, ix + w + 4), 0, W - 1)
    patch = plane[np.ix_(ys, xs)].astype(np.int32)
    return convolve_2d_batch_compound(patch[None], sx, sy, filter_for_dim(which, w),
                                      bd, which_y=filter_for_dim(which, h))[0]


def convolve_2d_scalar(plane: np.ndarray, x: int, y: int, w: int, h: int,
                       mv_x_q4: int, mv_y_q4: int, which: int = REGULAR, bd: int = 8) -> np.ndarray:
    """Scalar helper: motion-compensate one block from `plane` with a
    1/16-pel MV (mv in q4... q3? units of 1/16 pel => q4 naming per spec).
    Used by the (round-2) inter decoder path and tests."""
    fx = (x << 4) + mv_x_q4
    fy = (y << 4) + mv_y_q4
    ix, sx = fx >> 4, fx & 15
    iy, sy = fy >> 4, fy & 15
    H, W = plane.shape
    # gather padded window with edge replication (spec clips sample coords)
    ys = np.clip(np.arange(iy - 3, iy + h + 4), 0, H - 1)
    xs = np.clip(np.arange(ix - 3, ix + w + 4), 0, W - 1)
    patch = plane[np.ix_(ys, xs)].astype(np.int32)
    return convolve_2d_batch(patch[None], sx, sy, filter_for_dim(which, w), bd,
                             which_y=filter_for_dim(which, h))[0]
