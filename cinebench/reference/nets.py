"""The U-Net and the normalized U-Net as functions of a parameter dict.

U-Net: ``pools`` levels of two (3x3 conv without bias -> instance norm, eps
1e-5, no affine -> LeakyReLU 0.2) with 2x average pooling (floor), a bottom
block, transposed 2x2 stride-2 convolutions (no bias) with the same norm and
activation, the output zero-padded at the trailing edge to the skip's size,
concatenated ``[up, skip]``, and a final 1x1 convolution with bias. The
channel count doubles at each level from ``chans``.

Normalized U-Net: a complex ``(n, a, b)`` input as two channels ``[re, im]``,
each normalized by its mean and Bessel-corrected std over the plane, padded
to multiples of 16 (floor before, ceil after), the U-Net, unpadded and
de-normalized.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["unet", "norm_unet"]


def _norm_act(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(F.instance_norm(x, eps=1e-5), 0.2)


def _block(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    for i in (0, 1):
        x = _norm_act(F.conv2d(x, p[f"{name}.conv{i}.weight"], padding=1))
    return x


def unet(x: torch.Tensor, p: dict, name: str, pools: int) -> torch.Tensor:
    """``(n, 2, a, b)`` -> ``(n, 2, a, b)`` with the parameters under ``name``."""
    skips = []
    for j in range(pools):
        x = _block(x, p, f"{name}.down.{j}")
        skips.append(x)
        x = F.avg_pool2d(x, 2)
    x = _block(x, p, f"{name}.bottom")
    for i in range(pools):
        skip = skips.pop()
        x = _norm_act(F.conv_transpose2d(x, p[f"{name}.up_transpose.{i}.conv.weight"], stride=2))
        x = F.pad(x, (0, skip.shape[-1] - x.shape[-1], 0, skip.shape[-2] - x.shape[-2]))
        x = _block(torch.cat([x, skip], dim=1), p, f"{name}.up_conv.{i}")
    return F.conv2d(x, p[f"{name}.final.weight"], p[f"{name}.final.bias"])


def _pads(n: int) -> tuple:
    total = -(-n // 16) * 16 - n
    return total // 2, total - total // 2


def norm_unet(x: torch.Tensor, p: dict, name: str, pools: int) -> torch.Tensor:
    """Complex ``(n, a, b)`` -> complex ``(n, a, b)``."""
    r = torch.stack([x.real, x.imag], dim=1)
    mean = r.mean(dim=(2, 3), keepdim=True)
    std = r.var(dim=(2, 3), keepdim=True, correction=1).sqrt()
    r = (r - mean) / std
    (ta, ba), (lb, rb) = _pads(r.shape[2]), _pads(r.shape[3])
    r = F.pad(r, (lb, rb, ta, ba))
    r = unet(r, p, name, pools)
    r = r[:, :, ta:r.shape[2] - ba, lb:r.shape[3] - rb]
    r = r * std + mean
    return torch.complex(r[:, 0], r[:, 1])
