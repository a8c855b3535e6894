"""HOST-side complex-layout adapters (reference utils/math.py).

Counterpart of ``cinemri_tpu/ops/complex.py``, on complex torch tensors.
The compute path carries :class:`cinemri_tpu_torch.ops.cplx.Complex` (re,
im) float pairs; this module handles the other layouts at the boundaries:
``complex64`` tensors, the reference's trailing real/imag dim of size 2
(reconstruction/utils/math.py:5-79), and its ``2n``-channel multi-complex
packing for XPDNet buffers (math.py:97-135).
"""

from __future__ import annotations

import torch

__all__ = [
    "to_real2",
    "from_real2",
    "complex_abs",
    "complex_abs_sq",
    "split_to_real_channels",
    "merge_real_channels",
]


def to_real2(x: torch.Tensor) -> torch.Tensor:
    """complex (...,) -> real (..., 2) stacked layout (reference to_tensor)."""
    return torch.stack((x.real, x.imag), dim=-1)


def from_real2(x: torch.Tensor) -> torch.Tensor:
    """real (..., 2) stacked layout -> complex64 (...,)."""
    if x.shape[-1] != 2:
        raise ValueError("last dimension must be 2 (real/imag)")
    return torch.complex(x[..., 0].to(torch.float32), x[..., 1].to(torch.float32))


def complex_abs(x: torch.Tensor) -> torch.Tensor:
    """|x| for native complex input (reference math.py:48-62)."""
    return x.abs()


def complex_abs_sq(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 for native complex input (reference math.py:65-79)."""
    return x.real * x.real + x.imag * x.imag


def split_to_real_channels(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack n complex channels into 2n real channels along ``axis``.

    Layout: first n entries are real parts, last n are imaginary parts —
    the reference's ``complex_to_real_multi_ch`` (math.py:121-135), which is
    also what ``torch.repeat_interleave(kspace, n, dim=-1)`` produces when
    seeding XPDNet buffers (xpdnet.py:306-307).
    """
    return torch.cat([x.real, x.imag], dim=axis)


def merge_real_channels(x: torch.Tensor, n: int, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`split_to_real_channels` (reference math.py:97-118)."""
    if x.shape[axis] != 2 * n:
        raise ValueError(f"axis {axis} must have size {2 * n}, got {x.shape[axis]}")
    re, im = torch.chunk(x, 2, dim=axis)
    return torch.complex(re.to(torch.float32), im.to(torch.float32))
