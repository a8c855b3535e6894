"""Static padding helpers for the denoisers (counterpart of
``cinemri_tpu/ops/pad.py``, NormUnet's pad-to-multiple only).

Split is floor-left / ceil-right, as NormUnet pads.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["pad_to_multiple", "unpad"]

PadSpec = Tuple[Tuple[int, int], ...]  # ((lo, hi) per padded axis, in ``axes`` order)


def pad_to_multiple(
    x: torch.Tensor, multiple: int, axes: Sequence[int]
) -> Tuple[torch.Tensor, PadSpec]:
    """Zero-pad ``axes`` up to the next multiple of ``multiple``."""
    pads = [(0, 0)] * x.ndim
    spec = []
    for ax in axes:
        n = x.shape[ax]
        target = -(-n // multiple) * multiple
        lo = (target - n) // 2
        hi = target - n - lo
        pads[ax % x.ndim] = (lo, hi)
        spec.append((lo, hi))
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad: last axis first
    if any(flat):
        x = F.pad(x, flat)
    return x, tuple(spec)


def unpad(x: torch.Tensor, spec: PadSpec, axes: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`pad_to_multiple`."""
    sl = [slice(None)] * x.ndim
    for (lo, hi), ax in zip(spec, axes):
        n = x.shape[ax % x.ndim]
        sl[ax % x.ndim] = slice(lo, n - hi)
    return x[tuple(sl)]
