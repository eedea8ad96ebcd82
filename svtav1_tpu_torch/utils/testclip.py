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
