"""Synthetic test clip (gradient + texture + motion), the same content as
tools/make_test_video.make_frames, so port and reference runs encode
identical frames. At 10 bits the 8-bit clip is shifted left by 2 and its low
two bits are seeded noise, so that they carry signal."""
from __future__ import annotations

import numpy as np


def make_frames(w: int, h: int, n: int, noise: float = 3.0, seed: int = 0, bd: int = 8):
    """n frames of (y, u, v) planes, 4:2:0, from `seed`: uint8 at bd=8,
    uint16 at bd=10 (the 8-bit frames << 2, plus 0..3 from a generator of
    its own, so the 8-bit part is the same clip)."""
    if bd not in (8, 10):
        raise ValueError(f"bd {bd}: 8 or 10")
    rng = np.random.default_rng(seed)
    low = np.random.default_rng((seed, bd))
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        dx = 3 * t
        y = (110 + 70 * np.sin((xx + dx) / 19.0) + 45 * np.cos(yy / 13.0)
             + 25 * np.sin((xx + 2 * yy + 5 * t) / 41.0)
             + rng.normal(0, noise, (h, w))).clip(0, 255).astype(np.uint8)
        u = (128 + 35 * np.sin((xx[::2, ::2] + dx) / 29.0)).clip(0, 255).astype(np.uint8)
        v = (128 - 30 * np.cos((yy[::2, ::2] + 2 * t) / 23.0)).clip(0, 255).astype(np.uint8)
        if bd == 10:
            y, u, v = ((p.astype(np.uint16) << 2) | low.integers(0, 4, p.shape, np.uint16)
                       for p in (y, u, v))
        frames.append((y, u, v))
    return frames


def cdef_extreme_cells(bd: int = 8) -> np.ndarray:
    """(24, 8, 8) int32 cells at the edges of CDEF's direction search, samples
    0 and 2^bd - 1: flat, checkerboards, row and column stripes, 45-degree
    steps along both diagonals and steps of slopes 2 and 1/2 (the odd
    directions), each also inverted (flat 0 gives the largest cost any cell
    can have)."""
    i, j = np.mgrid[0:8, 0:8]
    shapes = [np.zeros((8, 8), bool), (i + j) % 2 == 1, i % 2 == 1, j % 2 == 1,
              i + j >= 8, i + j >= 4, i >= j, i >= j + 3,
              2 * i >= j + 4, i >= 2 * j - 4, 2 * i + j >= 10, i + 2 * j >= 10]
    return np.stack([s ^ inv for s in shapes for inv in (False, True)]).astype(np.int32) \
        * ((1 << bd) - 1)


def cdef_extreme_plane(F: int, H: int, W: int, bd: int = 8, seed: int = 0) -> np.ndarray:
    """(F, H, W) int32 planes of whole 8x8 cells from `cdef_extreme_cells`:
    every cell once in order, then cells drawn from `seed`."""
    cells = cdef_extreme_cells(bd)
    n = F * (H // 8) * (W // 8)
    pick = np.concatenate([np.arange(len(cells)),
                           np.random.default_rng(seed).integers(0, len(cells), n)])[:n]
    return (cells[pick].reshape(F, H // 8, W // 8, 8, 8).transpose(0, 1, 3, 2, 4)
            .reshape(F, H, W))
