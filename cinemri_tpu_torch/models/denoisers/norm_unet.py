"""Normalized U-Nets on Complex input.

Counterpart of ``cinemri_tpu/models/denoisers/norm_unet.py``: the real and
the imaginary parts become two channels, each normalized per sample by its
mean and Bessel-corrected std over all pixels, padded to a multiple of 16
(floor left, ceil right), run through the U-Net, then unpadded and
de-normalized.

  * :class:`NormUnet`   — input ``(n, h, w)`` Complex, a 2-D U-Net;
  * :class:`NormUnet3D` — input ``(n, t, h, w)`` Complex, a 3-D U-Net over
    ``(t, h, w)`` (t padded too).

``dtype`` is the U-Net's activation dtype; the normalization around it stays
f32.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from cinemri_tpu_torch.models.denoisers.unet import Unet
from cinemri_tpu_torch.ops.cplx import Complex, from_channels, to_channels
from cinemri_tpu_torch.ops.pad import pad_to_multiple, unpad

__all__ = ["NormUnet", "NormUnet3D"]


def _norm_groups(x: torch.Tensor, guard_zero_std: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalize each channel of ``(n, ch, ...)`` over its spatial axes:
    mean and unbiased std per (sample, channel).

    ``guard_zero_std`` maps a constant channel (std 0) to zeros instead of
    0/0 = NaN, as XPDNet's ``norm_buffers`` needs (a t = 1 volume's planes
    are constant after the temporal mean is taken off). The NormUnets keep
    the unguarded division, as the JAX package and the reference do."""
    axes = tuple(range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    std = x.var(dim=axes, keepdim=True, correction=1).sqrt()
    if guard_zero_std:
        std = torch.where(std == 0, torch.ones_like(std), std)
    return (x - mean) / std, mean, std


class NormUnet(nn.Module):
    """Input ``(n, h, w)`` Complex; a 2-D U-Net."""

    dims = 2

    def __init__(self, chans: int, num_pools: int, packed: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.unet = Unet(chans=chans, num_pool_layers=num_pools, in_chans=2,
                         out_chans=2, dims=self.dims, packed=packed, dtype=dtype)

    def forward(self, x: Complex) -> Complex:
        if not isinstance(x, Complex) or x.ndim != self.dims + 1:
            raise ValueError(f"{type(self).__name__} expects a Complex of rank "
                             f"{self.dims + 1}, got {x!r}")
        axes = tuple(range(2, self.dims + 2))
        r = to_channels(x, axis=1)  # (n, 2, [t,] h, w)
        r, mean, std = _norm_groups(r)
        r, spec = pad_to_multiple(r, 16, axes=axes)
        r = self.unet(r)
        r = unpad(r, spec, axes=axes)
        r = r * std + mean
        return from_channels(r, axis=1)


class NormUnet3D(NormUnet):
    """Input ``(n, t, h, w)`` Complex; a 3-D U-Net over ``(t, h, w)``."""

    dims = 3
