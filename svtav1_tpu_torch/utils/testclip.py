"""Synthetic test clip (gradient + texture + motion), the same content as
tools/make_test_video.make_frames, so port and reference runs encode
identical frames."""
from __future__ import annotations

import numpy as np


def make_frames(w: int, h: int, n: int, noise: float = 3.0, seed: int = 0):
    """n frames of (y, u, v) uint8 planes, 4:2:0, from `seed`."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        dx = 3 * t
        y = (110 + 70 * np.sin((xx + dx) / 19.0) + 45 * np.cos(yy / 13.0)
             + 25 * np.sin((xx + 2 * yy + 5 * t) / 41.0)
             + rng.normal(0, noise, (h, w))).clip(0, 255).astype(np.uint8)
        u = (128 + 35 * np.sin((xx[::2, ::2] + dx) / 29.0)).clip(0, 255).astype(np.uint8)
        v = (128 - 30 * np.cos((yy[::2, ::2] + 2 * t) / 23.0)).clip(0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames
