"""Time-averaged differentiable SSIM loss.

Counterpart of ``cinemri_tpu/ops/ssim.py``, with the same two definitions
that make the training objective:

  * each (sample, frame)'s data range is the max of that frame of the
    target, whatever ``data_range`` a caller has in mind;
  * a uniform ``win x win`` window with VALID padding, ``k1 = 0.01``,
    ``k2 = 0.03`` and covariance normalization ``NP / (NP - 1)``.

The window mean is a 2-D convolution with a uniform kernel over all frames
at once, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssim_loss", "ssim_index_per_frame", "ssim_index_per_sample"]


def _window_mean(x: torch.Tensor, win: int) -> torch.Tensor:
    """Mean over a sliding ``win x win`` window, VALID; ``x (n, h, w)``."""
    kernel = torch.full((1, 1, win, win), 1.0 / (win * win), dtype=x.dtype, device=x.device)
    return F.conv2d(x[:, None], kernel)[:, 0]


def ssim_index_per_sample(
    pred: torch.Tensor,
    target: torch.Tensor,
    win_size: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM per (sample, frame) of ``(b, t, h, w)`` images: ``(b, t)``."""
    if pred.shape != target.shape or pred.ndim != 4:
        raise ValueError(f"expected matching (b,t,h,w), got {tuple(pred.shape)} vs {tuple(target.shape)}")
    b, t, h, w = pred.shape
    x = pred.reshape(b * t, h, w)
    y = target.reshape(b * t, h, w)

    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1)

    ux = _window_mean(x, win_size)
    uy = _window_mean(y, win_size)
    uxx = _window_mean(x * x, win_size)
    uyy = _window_mean(y * y, win_size)
    uxy = _window_mean(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    data_range = target.amax(dim=(2, 3))  # (b, t)
    c1 = ((k1 * data_range) ** 2).reshape(b * t, 1, 1)
    c2 = ((k2 * data_range) ** 2).reshape(b * t, 1, 1)

    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)
    return s.reshape(b, t, *s.shape[-2:]).mean(dim=(2, 3))


def ssim_index_per_frame(
    pred: torch.Tensor,
    target: torch.Tensor,
    win_size: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM per frame, averaged over the batch: ``(t,)``."""
    return ssim_index_per_sample(pred, target, win_size, k1, k2).mean(dim=0)


def ssim_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    win_size: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
    sample_weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """Time-averaged SSIM loss: the mean over t of ``1 - mean SSIM``, per
    sample, then the mean over samples weighted by ``sample_weight (b,)``
    (weight 0 drops a padded sample; the denominator is at least 1)."""
    s = ssim_index_per_sample(pred, target, win_size, k1, k2)  # (b, t)
    per_sample = (1.0 - s).mean(dim=1)  # (b,)
    if sample_weight is None:
        return per_sample.mean()
    w = sample_weight.to(per_sample.dtype)
    return (per_sample * w).sum() / torch.clamp(w.sum(), min=1.0)
