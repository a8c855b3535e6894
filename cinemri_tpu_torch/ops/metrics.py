"""Offline evaluation metrics (host-side numpy).

A numpy copy of ``cinemri_tpu/ops/metrics.py`` (the port imports nothing of
the JAX package). This is the evaluation SSIM, not the training loss of
``ops/ssim.py``. scipy is imported inside :func:`ssim2d`, not with the
module: importing ``scipy.ndimage`` runs a subprocess (numpy.testing's CPU
probe).

Parity target: reference reconstruction/utils/evaluate.py:6-50, which wraps
``skimage.metrics`` (not installed here). The SSIM below reimplements
``skimage.metrics.structural_similarity`` exactly for the configuration the
reference uses: 2-D input, uniform 7x7 window, ``K1=0.01 / K2=0.03``,
``data_range`` given, border of ``win//2`` cropped before averaging.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["mse", "nmse", "psnr", "ssim", "ssim2d", "METRIC_FUNCS"]


def mse(gt: np.ndarray, pred: np.ndarray) -> float:
    """Mean squared error (evaluate.py:6-8)."""
    return float(np.mean((gt - pred) ** 2))


def nmse(gt: np.ndarray, pred: np.ndarray) -> float:
    """Normalized MSE (evaluate.py:11-13)."""
    return float(np.linalg.norm(gt - pred) ** 2 / np.linalg.norm(gt) ** 2)


def psnr(gt: np.ndarray, pred: np.ndarray, maxval: Optional[float] = None) -> float:
    """Peak SNR (evaluate.py:16-22 / skimage.peak_signal_noise_ratio)."""
    if maxval is None:
        maxval = float(gt.max())
    err = mse(gt, pred)
    return float(10 * np.log10((maxval ** 2) / err))


def ssim2d(
    gt: np.ndarray,
    pred: np.ndarray,
    data_range: float,
    win_size: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """2-D SSIM, identical to skimage.structural_similarity defaults.

    Uniform filter, sample covariance normalization NP/(NP-1), and the
    final mean taken over the image cropped by ``win_size//2`` on every
    border (skimage crops the filter-edge region before averaging).
    """
    from scipy.ndimage import uniform_filter

    if gt.ndim != 2:
        raise ValueError("ssim2d expects 2-D images")
    x = gt.astype(np.float64)
    y = pred.astype(np.float64)

    np_ = win_size ** 2
    cov_norm = np_ / (np_ - 1)
    f = lambda im: uniform_filter(im, size=win_size)

    ux, uy = f(x), f(y)
    uxx, uyy, uxy = f(x * x), f(y * y), f(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1, a2 = 2 * ux * uy + c1, 2 * vxy + c2
    b1, b2 = ux * ux + uy * uy + c1, vx + vy + c2
    s = (a1 * a2) / (b1 * b2)

    pad = (win_size - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


def ssim(gt: np.ndarray, pred: np.ndarray, maxval: Optional[float] = None) -> float:
    """Frame-averaged SSIM on a (t, h, w) volume (evaluate.py:25-42)."""
    if gt.ndim != 3:
        raise ValueError("Unexpected number of dimensions in ground truth.")
    if gt.ndim != pred.ndim:
        raise ValueError("Ground truth dimensions does not match pred.")
    maxval = float(gt.max()) if maxval is None else float(maxval)
    total = 0.0
    for frame in range(gt.shape[0]):
        total += ssim2d(gt[frame], pred[frame], data_range=maxval)
    return total / gt.shape[0]


METRIC_FUNCS = dict(MSE=mse, NMSE=nmse, PSNR=psnr, SSIM=ssim)
