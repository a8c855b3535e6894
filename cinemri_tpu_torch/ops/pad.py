"""Static padding helpers for the denoisers (counterpart of
``cinemri_tpu/ops/pad.py``).

  * ``pad_to_multiple`` / ``unpad``: NormUnet's pad-to-16, split floor-left /
    ceil-right.
  * ``pad_for_mwcnn`` / ``unpad_from_mwcnn``: MWCNN's pad-to-``2**n_scales``
    with the reference's odd-size asymmetry (the left side gets the extra
    sample when the size is odd and padding is needed).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["pad_to_multiple", "unpad", "pad_for_mwcnn", "unpad_from_mwcnn"]

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
    return _pad(x, pads), tuple(spec)


def _pad(x: torch.Tensor, pads) -> torch.Tensor:
    """Zero-pad by ``pads``, one ``(lo, hi)`` per axis of ``x``."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad: last axis first
    return F.pad(x, flat) if any(flat) else x


def unpad(x: torch.Tensor, spec: PadSpec, axes: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`pad_to_multiple`."""
    sl = [slice(None)] * x.ndim
    for (lo, hi), ax in zip(spec, axes):
        n = x.shape[ax % x.ndim]
        sl[ax % x.ndim] = slice(lo, n - hi)
    return x[tuple(sl)]


def _mwcnn_amounts(n: int, n_scales: int) -> Tuple[int, int]:
    """The reference's padding amounts for one axis of size ``n``."""
    block = 2 ** n_scales
    if n % block == 0:
        return 0, 0
    n_pad = (n // block + 1) * block - n
    left = n_pad // 2 if n % 2 == 0 else 1 + n_pad // 2
    return left, n_pad // 2


def pad_for_mwcnn(
    x: torch.Tensor, n_scales: int, axes: Sequence[int] = (-2, -1)
) -> Tuple[torch.Tensor, List[int]]:
    """Pad the two ``axes`` (second-to-last, last) so each is divisible by
    ``2**n_scales``. Returns the padded tensor and the reference-format pad
    list ``[last_lo, last_hi, second_last_lo, second_last_hi]``."""
    ax2, ax1 = (a % x.ndim for a in axes)
    l1, r1 = _mwcnn_amounts(x.shape[ax1], n_scales)
    l2, r2 = _mwcnn_amounts(x.shape[ax2], n_scales)
    pads = [(0, 0)] * x.ndim
    pads[ax1], pads[ax2] = (l1, r1), (l2, r2)
    return _pad(x, pads), [l1, r1, l2, r2]


def unpad_from_mwcnn(
    x: torch.Tensor, pad: Sequence[int], axes: Sequence[int] = (-2, -1)
) -> torch.Tensor:
    """Inverse of :func:`pad_for_mwcnn`."""
    l1, r1, l2, r2 = pad
    ax2, ax1 = (a % x.ndim for a in axes)
    sl = [slice(None)] * x.ndim
    sl[ax1] = slice(l1, x.shape[ax1] - r1)
    sl[ax2] = slice(l2, x.shape[ax2] - r2)
    return x[tuple(sl)]
