"""Rate control + scene analysis, copied from svtav1_tpu's pipeline/rc.py
(host numpy; a simplified analog of rc_process.c and pd_process.c
scene_transition_detector).

CBR-lite: a virtual-buffer proportional controller on the frame qindex —
the structural counterpart of the reference's correction-factor loop
(rc_process.c av1_rc_update_rate_correction_factors :2236 /
 av1_rc_postencode_update :2407), not a port of its exact math.
Scene cut: mean-abs-difference of downsampled luma vs the previous source
frame (pd_process.c scene_transition_detector :261 uses histograms; MAD on
the decimated plane captures the same events for round-1).
"""
from __future__ import annotations

import numpy as np

SCENE_CUT_MAD = 22.0  # mean abs diff on 1/4-decimated luma


class SceneDetector:
    def __init__(self, threshold: float = SCENE_CUT_MAD):
        self.threshold = threshold
        self._prev = None

    def is_cut(self, y: np.ndarray) -> bool:
        small = np.asarray(y, np.int32)[::4, ::4]
        prev, self._prev = self._prev, small
        if prev is None or prev.shape != small.shape:
            return False
        mad = float(np.abs(small - prev).mean())
        return mad > self.threshold


class VbrController:
    """One-pass VBR on the reference's bits-per-MB model.

    Semantics ported (not code) from rc_process.c: projected frame size =
    enumerator * correction_factor / q_real * MBs (svt_av1_rc_bits_per_mb
    :602), q chosen so the projection meets the frame target
    (av1_rc_regulate_q analog), and the correction factor is updated from
    actual vs projected size after every frame
    (av1_rc_update_rate_correction_factors :2236 / postencode :2407).
    Frame targets follow a key/layer boost ladder normalized over the
    keyint window, with a slow budget-error feedback (vbr bias analog) so
    the sequence converges on the target bitrate."""

    _ENUM_KEY = 2000000.0
    _ENUM_INTER = 1350000.0
    _MIN_CF, _MAX_CF = 0.25, 4.0
    # per-class relative boosts: key, layer0 (base / low-delay P), l1, l2+
    _BOOST = (7.0, 1.4, 0.9, 0.6)

    def __init__(self, target_bps: float, fps: float, qindex_init: int = 120,
                 keyint: int = 1, minigop: int = 1, bd: int = 8):
        self.bd = bd
        self.avg_target = target_bps / max(fps, 1e-6)
        self.keyint = max(keyint, 1)
        # normalize boosts over one keyint window's class counts
        counts = [0, 0, 0, 0]
        if keyint <= 1:
            counts[0] = 1
        else:
            counts[0] = 1
            for d in range(1, keyint):
                if minigop <= 1:
                    counts[1] += 1
                else:
                    pos = (d - 1) % minigop + 1
                    layer = 0 if pos == minigop else (1 if pos == minigop // 2 else 2)
                    counts[1 + layer] += 1
        total_w = sum(c * b for c, b in zip(counts, self._BOOST))
        self._scale = self.avg_target * sum(counts) / max(total_w, 1e-9)
        self.cf = {True: 1.0, False: 1.0}  # per-class correction factors
        self.budget_err = 0.0  # +ve = underspent so far
        self._last = None  # (is_key, q, target, projected)
        self.q_clamp = (1, 255)
        self._q_prev = qindex_init

    def _q_real(self, qindex: int) -> float:
        from ..ops import quantize as quant_ops

        return max(quant_ops.dc_q(qindex, self.bd) / 4.0, 0.25)

    def _projected(self, is_key: bool, qindex: int, mbs: float) -> float:
        # bits_per_mb is in 1/512-bit units (BPER_MB_NORMBITS = 9, the
        # av1_estimate_bits_at_q normalization)
        enum = self._ENUM_KEY if is_key else self._ENUM_INTER
        return enum * self.cf[is_key] / self._q_real(qindex) * mbs / 512.0

    def set_frame_geometry(self, width: int, height: int) -> None:
        self.mbs = max((width + 15) // 16 * ((height + 15) // 16), 1)

    def frame_qindex(self, is_key: bool, layer: int, disp: int | None = None) -> int:
        cls = 0 if is_key else 1 + min(layer, 2)
        base_target = self._scale * self._BOOST[cls]
        # spread the accumulated budget error over ~a window of frames
        target = base_target + np.clip(self.budget_err / max(self.keyint // 4, 2),
                                       -0.6 * base_target, 1.5 * base_target)
        target = max(target, self.avg_target * 0.05)
        # regulate q: smallest q whose projection fits the target (the
        # projection is monotonically decreasing in q)
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
        if not is_key:  # limit inter q swings (reference q window clamps)
            q = int(np.clip(q, self._q_prev - 40, self._q_prev + 40))
        self._q_prev = q  # keys seed the window too (reference kf carry-over)
        q = max(1, min(255, q))
        self._last = (is_key, q, base_target, self._projected(is_key, q, self.mbs))
        return q

    def update(self, actual_bits: float) -> None:
        if self._last is None:
            return
        is_key, q, base_target, projected = self._last
        self._last = None
        self.budget_err += base_target - actual_bits
        ratio = actual_bits / max(projected, 1.0)
        # step-limited correction factor update (rc_process.c:2236)
        ratio = float(np.clip(ratio, 0.5, 2.0))
        self.cf[is_key] = float(np.clip(self.cf[is_key] * ratio,
                                        self._MIN_CF, self._MAX_CF))


class CbrController:
    """Virtual-buffer qindex controller.

    Each update drains `target_bits` and fills with the actual frame bits;
    qindex moves proportionally to buffer fullness, with a fast path for
    large overshoot."""

    def __init__(self, target_bps: float, fps: float, qindex_init: int = 120):
        self.target_bits = target_bps / max(fps, 1e-6)
        self.buffer = 0.0
        self.q = qindex_init

    def frame_qindex(self, is_key: bool, layer: int, disp: int | None = None) -> int:
        from . import gop

        q = self.q + (gop.KEY_Q_OFFSET if is_key else gop.LAYER_Q_OFFSET[min(layer, 2)])
        return int(max(1, min(255, q)))

    def update(self, actual_bits: float) -> None:
        # proportional control on the log bit ratio (damped, with deadband),
        # plus a slow integral term from the virtual buffer
        self.buffer += actual_bits - self.target_bits
        cap = 8 * self.target_bits
        self.buffer = max(-cap, min(cap, self.buffer))
        err = np.log2(max(actual_bits, 1.0) / max(self.target_bits, 1.0))
        step = 0.0
        if abs(err) > 0.15:
            step += 8.0 * err
        step += 0.5 * self.buffer / max(self.target_bits, 1.0)
        self.q = int(max(1, min(255, self.q + max(-12.0, min(12.0, step)))))
