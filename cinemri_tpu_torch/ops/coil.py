"""Coil combination (counterpart of ``cinemri_tpu/ops/coil.py``).

With a ``coil_axis`` (a dim of the ambient mesh, ``parallel.set_mesh``)
the input holds this rank's coils, and the sum of squares is completed by
one all-reduce over the coil group; the result is replicated, its gradient
passed through to each rank's coils (``parallel/autograd.py``).
"""

from __future__ import annotations

import torch

from cinemri_tpu_torch.ops.cplx import Complex
from cinemri_tpu_torch.parallel.autograd import reduce_from_group
from cinemri_tpu_torch.parallel.mesh import mesh_axis

__all__ = ["rss", "rss_complex"]


def rss(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Root-sum-of-squares over the coil axis for real input."""
    return torch.sqrt((x * x).sum(dim=axis))


def rss_complex(x, axis: int = 0, coil_axis: str = "") -> torch.Tensor:
    """Root-sum-of-squares over the coil axis (Complex pair or complex tensor)."""
    if isinstance(x, Complex):
        sq = x.abs_sq().sum(dim=axis)
    else:
        sq = (x.real * x.real + x.imag * x.imag).sum(dim=axis)
    ax = mesh_axis(coil_axis)
    return torch.sqrt(sq if ax is None else reduce_from_group(ax, sq)[0])
