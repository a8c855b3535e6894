"""Normalized U-Net on Complex ``(n, h, w)`` input.

Counterpart of ``cinemri_tpu/models/denoisers/norm_unet.py::NormUnet``: the
real and the imaginary parts become two channels, each normalized per
sample by its mean and Bessel-corrected std over all pixels, padded to a
multiple of 16 (floor left, ceil right), run through the U-Net, then
unpadded and de-normalized.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from cinemri_tpu_torch.models.denoisers.unet import Unet
from cinemri_tpu_torch.ops.cplx import Complex, from_channels, to_channels
from cinemri_tpu_torch.ops.pad import pad_to_multiple, unpad

__all__ = ["NormUnet"]


def _norm_groups(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalize each channel of ``(n, ch, ...)`` over its spatial axes:
    mean and unbiased std per (sample, channel)."""
    axes = tuple(range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    std = x.var(dim=axes, keepdim=True, correction=1).sqrt()
    return (x - mean) / std, mean, std


class NormUnet(nn.Module):
    def __init__(self, chans: int, num_pools: int, packed: bool = False):
        super().__init__()
        self.unet = Unet(chans=chans, num_pool_layers=num_pools, in_chans=2,
                         out_chans=2, dims=2, packed=packed)

    def forward(self, x: Complex) -> Complex:
        if not isinstance(x, Complex) or x.ndim != 3:
            raise ValueError(f"expected Complex (n, h, w), got {x!r}")
        r = to_channels(x, axis=1)  # (n, 2, h, w)
        r, mean, std = _norm_groups(r)
        r, spec = pad_to_multiple(r, 16, axes=(2, 3))
        r = self.unet(r)
        r = unpad(r, spec, axes=(2, 3))
        r = r * std + mean
        return from_channels(r, axis=1)
