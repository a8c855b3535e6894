"""Coil combination (counterpart of ``cinemri_tpu/ops/coil.py``)."""

from __future__ import annotations

import torch

from cinemri_tpu_torch.ops.cplx import Complex

__all__ = ["rss", "rss_complex"]


def rss(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Root-sum-of-squares over the coil axis for real input."""
    return torch.sqrt((x * x).sum(dim=axis))


def rss_complex(x, axis: int = 0) -> torch.Tensor:
    """Root-sum-of-squares over the coil axis (Complex pair or complex tensor)."""
    if isinstance(x, Complex):
        return torch.sqrt(x.abs_sq().sum(dim=axis))
    return torch.sqrt((x.real * x.real + x.imag * x.imag).sum(dim=axis))
