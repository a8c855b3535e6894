"""Fully-sampled low-frequency band detection for sensitivity estimation.

Counterpart of ``cinemri_tpu/physics/lowfreq.py``. From frame 0 of a line
mask along the phase-encode axis:

  * ``left``  = index of the last unsampled line left of center,
    ``right`` = index of the first unsampled line at or right of center;
  * ``num_low = right - left`` (kept exactly as the reference writes it,
    PARITY.md C15) and ``pad = (h - num_low + 1) // 2``;
  * keep only rows ``[pad, pad + num_low)``.

The band is found with masked max/min reductions and applied with an index
comparison, so the band edges stay tensors on the device: no host sync on
the serving path.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cinemri_tpu_torch.ops.cplx import Complex, cmean

__all__ = ["center_band", "center_band_rows", "mask_center_band", "low_frequency_kspace"]


def center_band_rows(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pad, num_low)`` for mask rows ``m (..., h)``; one pair per row."""
    h = m.shape[-1]
    cent = h // 2
    idx = torch.arange(h, device=m.device)
    is_zero = m == 0
    left = torch.where(is_zero & (idx < cent), idx, -1).amax(dim=-1)
    right = torch.where(is_zero & (idx >= cent), idx, h).amin(dim=-1)
    num_low = right - left
    pad = torch.div(h - num_low + 1, 2, rounding_mode="floor")
    return pad, num_low


def center_band(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pad, num_low)`` as 0-d tensors from a ``(b, t, 1, h, 1)`` mask,
    read from sample 0 / frame 0."""
    return center_band_rows(mask[0, 0, 0, :, 0])


def mask_center_band(
    x: torch.Tensor, pad: torch.Tensor, num_low: torch.Tensor, axis: int = -2
) -> torch.Tensor:
    """Zero everything outside rows ``[pad, pad+num_low)`` along ``axis``.

    ``pad``/``num_low`` are 0-d, or ``(b,)`` for one band per leading-axis
    sample of ``x``.
    """
    h = x.shape[axis]
    idx = torch.arange(h, device=x.device)
    pad = torch.as_tensor(pad, device=x.device)
    num_low = torch.as_tensor(num_low, device=x.device)
    band = (idx >= pad[..., None]) & (idx < (pad + num_low)[..., None])  # (..., h)
    shape = list(pad.shape) + [1] * (x.ndim - pad.ndim)
    shape[axis % x.ndim] = h
    return x * band.reshape(shape).to(x.dtype)


def low_frequency_kspace(kspace, mask: torch.Tensor):
    """Time-averaged k-space restricted to the fully-sampled central band.

    Input ``(b, t, c, h, w)`` (Complex or a complex tensor) -> ``(b, c, h,
    w)`` (time collapsed). The band of each sample is read from frame 0 of
    its own mask (``mask`` of batch b or 1), as the JAX package's VarNet
    computes it (a vmap over the batch). The JAX package's function reads
    sample 0's band for the whole batch: the same for one volume or a shared
    mask.
    """
    pad, num_low = center_band_rows(mask[:, 0, 0, :, 0])
    x = cmean(kspace, axis=1) if isinstance(kspace, Complex) else kspace.mean(dim=1)
    return mask_center_band(x, pad, num_low, axis=-2)
