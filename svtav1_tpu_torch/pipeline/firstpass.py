"""First-pass statistics + two-pass VBR, copied from svtav1_tpu's
pipeline/firstpass.py (host numpy; an honest-scale analog of firstpass.c
FIRSTPASS_STATS and pass2_strategy.c GOP bit allocation).

Pass 1 collects per-frame spatial/temporal complexity on decimated luma —
the structural counterparts of FIRSTPASS_STATS.intra_error / coded_error
(firstpass.h:30-50) without running the full encode pipeline (the
reference likewise short-circuits EncDec in pass 1, enc_dec_process.c:3215
svt_aom_is_pic_skipped). Pass 2 turns the stats into per-frame bit targets
proportional to each frame's complexity share of its keyint window
(pass2_strategy.c:1636 kf-group allocation at honest scale) and runs the
same bits/MB q regulation + correction-factor feedback as the one-pass
controller.

Stats file: JSON {"version", "frames": [{"intra_error", "coded_error"}]}
— the durable cross-run artifact (the reference's --stats file,
app_config.c:404 / rc_stats_buffer EbSvtAv1Enc.h:591).
"""
from __future__ import annotations

import json

import numpy as np

from .rc import VbrController

STATS_VERSION = 1


def analyze_frame(y: np.ndarray, prev_y: np.ndarray | None) -> dict:
    """Per-frame complexity on 1/4-decimated luma: intra_error = mean
    gradient energy (spatial), coded_error = mean abs temporal difference
    (the pass-1 inter residual proxy; equals intra_error for the first
    frame, as the reference seeds coded_error with intra_error)."""
    small = np.asarray(y, np.float64)[::4, ::4]
    gx = np.abs(np.diff(small, axis=1)).mean()
    gy = np.abs(np.diff(small, axis=0)).mean()
    intra_error = float(gx + gy)
    if prev_y is None or prev_y.shape != y.shape:
        coded_error = intra_error
    else:
        psmall = np.asarray(prev_y, np.float64)[::4, ::4]
        coded_error = float(np.abs(small - psmall).mean())
    return dict(intra_error=round(intra_error, 4), coded_error=round(coded_error, 4))


class FirstPassCollector:
    """Pass-1 collector: feed display-order frames, then write_stats()."""

    def __init__(self):
        self.records: list = []
        self._prev = None

    def send_frame(self, y: np.ndarray) -> None:
        self.records.append(analyze_frame(y, self._prev))
        self._prev = np.asarray(y)

    def write_stats(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dict(version=STATS_VERSION, frames=self.records), f)


def read_stats(path: str) -> list:
    with open(path) as f:
        d = json.load(f)
    if d.get("version") != STATS_VERSION:
        raise ValueError(f"{path}: stats version {d.get('version')}, expected {STATS_VERSION}")
    return d["frames"]


class TwoPassVbrController(VbrController):
    """Pass-2 VBR: per-frame targets weighted by the first-pass complexity
    share of the frame's keyint window, on top of the one-pass q
    regulation/correction machinery (rc_process.c postencode feedback)."""

    def __init__(self, stats: list, target_bps: float, fps: float,
                 qindex_init: int = 120, keyint: int = 1, minigop: int = 1,
                 bd: int = 8):
        super().__init__(target_bps, fps, qindex_init, keyint=keyint,
                         minigop=minigop, bd=bd)
        self.stats = stats
        n = len(stats)
        # per-frame complexity weight: sqrt of the pass-1 error (the
        # reference's modified_error power law at honest scale), floored so
        # static frames still get a share
        w = np.array([max(s["coded_error"], 1e-3) for s in stats], np.float64)
        w = np.sqrt(w)
        w = np.maximum(w, 0.2 * w.mean() if n else 1.0)
        # normalize per keyint window (kf-group allocation)
        self._share = np.ones(n)
        for g0 in range(0, n, self.keyint):
            g1 = min(g0 + self.keyint, n)
            seg = w[g0:g1]
            self._share[g0:g1] = seg / seg.mean()

    def frame_qindex(self, is_key: bool, layer: int, disp: int | None = None) -> int:
        cls = 0 if is_key else 1 + min(layer, 2)
        base_target = self._scale * self._BOOST[cls]
        if disp is not None and disp < len(self._share):
            base_target *= float(self._share[disp])
        target = base_target + np.clip(self.budget_err / max(self.keyint // 4, 2),
                                       -0.6 * base_target, 1.5 * base_target)
        target = max(target, self.avg_target * 0.05)
        lo, hi = self.q_clamp
        best = hi
        while lo <= hi:
            mid = (lo + hi) // 2
            if self._projected(is_key, mid, self.mbs) <= target:
                best = mid
                hi = mid - 1
            else:
                lo = mid + 1
        q = int(best)
        if not is_key:
            q = int(np.clip(q, self._q_prev - 40, self._q_prev + 40))
        self._q_prev = q
        q = max(1, min(255, q))
        self._last = (is_key, q, base_target, self._projected(is_key, q, self.mbs))
        return q
