"""Quality metrics: PSNR + SSIM (analog of svt_psnr.c / ssim kernels for
--enable-stat-report and tune=SSIM groundwork)."""
from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view


def psnr(ref: np.ndarray, rec: np.ndarray, bd: int = 8) -> float:
    peak = (1 << bd) - 1
    mse = float(((np.asarray(ref, np.float64) - rec) ** 2).mean())
    return 10.0 * np.log10(peak * peak / max(mse, 1e-12))


def ssim(ref: np.ndarray, rec: np.ndarray, bd: int = 8) -> float:
    """Mean SSIM over 8x8 windows stepped by 4 (the aom ssim convention:
    reference ssim kernels aom_dsp_rtcd svt_ssim_8x8)."""
    a = np.asarray(ref, np.float64)
    b = np.asarray(rec, np.float64)
    L = (1 << bd) - 1
    c1 = (0.01 * L) ** 2
    c2 = (0.03 * L) ** 2
    # vectorized over all windows
    wa = sliding_window_view(a, (8, 8))[::4, ::4].reshape(-1, 64)
    wb = sliding_window_view(b, (8, 8))[::4, ::4].reshape(-1, 64)
    mu_a = wa.mean(axis=1)
    mu_b = wb.mean(axis=1)
    var_a = wa.var(axis=1)
    var_b = wb.var(axis=1)
    cov = (wa * wb).mean(axis=1) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return float(s.mean())
