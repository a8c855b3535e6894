"""Center crops (the port's copy of two functions of
``cinemri_tpu/data/transforms.py``; the rest of that module comes with the
host data path). They slice, so they take numpy arrays and tensors alike."""

from __future__ import annotations

from typing import Tuple

__all__ = ["center_crop", "center_crop_to_smallest"]


def center_crop(data, shape: Tuple[int, int]):
    """Center crop over the last two axes."""
    if not (0 < shape[0] <= data.shape[-2] and 0 < shape[1] <= data.shape[-1]):
        raise ValueError("Invalid shapes.")
    h0 = (data.shape[-2] - shape[0]) // 2
    w0 = (data.shape[-1] - shape[1]) // 2
    return data[..., h0 : h0 + shape[0], w0 : w0 + shape[1]]


def center_crop_to_smallest(x, y):
    """Crop both to the smaller of each trailing dim."""
    h = min(x.shape[-2], y.shape[-2])
    w = min(x.shape[-1], y.shape[-1])
    return center_crop(x, (h, w)), center_crop(y, (h, w))
