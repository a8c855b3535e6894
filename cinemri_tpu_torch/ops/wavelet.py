"""Haar-like DWT / IWT pooling used by MWCNN.

Counterpart of ``cinemri_tpu/ops/wavelet.py`` (``dwt2``, ``iwt2``): both
transforms are reshape and stack arithmetic, with no scatter. The channel
order of the DWT output is ``[LL, HL, LH, HH]`` blocks, each as wide as the
input's channels.

Layout: channels-last ``(b, h, w, c)`` by default, the JAX package's;
``channel_axis=1`` takes the port's NCHW ``(b, c, h, w)``, which MWCNN's
convolutions use. The packed forms (``dwt2_from_packed``,
``iwt2_to_packed``) serve the packed MWCNN: on a tensor space-to-depth
packed with block (2, 2) (``models/denoisers/packed_unet.py``, packed
channel ``c·4 + 2·ph + pw``) the 2x2 Haar stencil is the phase block, so the
butterfly runs in channel space and the dense tensor is never formed.
"""

from __future__ import annotations

import torch

__all__ = ["dwt2", "iwt2", "dwt2_from_packed", "iwt2_to_packed"]


def _axes(x: torch.Tensor, channel_axis: int):
    """(h axis, channel axis) of a 4-D tensor, channels last or at 1."""
    if x.ndim != 4 or channel_axis % 4 not in (1, 3):
        raise ValueError(f"expected (b, h, w, c) or (b, c, h, w) with channel_axis -1 or 1, "
                         f"got shape {tuple(x.shape)}, channel_axis {channel_axis}")
    return (1, 3) if channel_axis % 4 == 3 else (2, 1)


def dwt2(x: torch.Tensor, channel_axis: int = -1) -> torch.Tensor:
    """``(b, h, w, c)`` -> ``(b, h/2, w/2, 4c)`` (or ``(b, c, h, w)`` ->
    ``(b, 4c, h/2, w/2)`` with ``channel_axis=1``)."""
    ha, ca = _axes(x, channel_axis)
    h, w = x.shape[ha], x.shape[ha + 1]
    # split h and w into (h/2, 2) and (w/2, 2): the phase axes sit after each
    y = x.unflatten(ha + 1, (w // 2, 2)).unflatten(ha, (h // 2, 2)) / 2

    def phase(ph, pw):
        return y.select(ha + 3, pw).select(ha + 1, ph)

    x1, x2, x3, x4 = phase(0, 0), phase(1, 0), phase(0, 1), phase(1, 1)
    ll = x1 + x2 + x3 + x4
    hl = -x1 - x2 + x3 + x4
    lh = -x1 + x2 - x3 + x4
    hh = x1 - x2 - x3 + x4
    return torch.cat([ll, hl, lh, hh], dim=ca)


def iwt2(x: torch.Tensor, channel_axis: int = -1) -> torch.Tensor:
    """``(b, h, w, 4c)`` -> ``(b, 2h, 2w, c)`` (or ``(b, 4c, h, w)`` ->
    ``(b, c, 2h, 2w)`` with ``channel_axis=1``)."""
    ha, ca = _axes(x, channel_axis)
    x1, x2, x3, x4 = (v / 2 for v in x.chunk(4, dim=ca))
    a00 = x1 - x2 - x3 + x4  # out[0::2, 0::2]
    a10 = x1 - x2 + x3 - x4  # out[1::2, 0::2]
    a01 = x1 + x2 - x3 - x4  # out[0::2, 1::2]
    a11 = x1 + x2 + x3 + x4  # out[1::2, 1::2]
    # interleave along w (phase axis after w), then along h (after h)
    row0 = torch.stack([a00, a01], dim=ha + 2).flatten(ha + 1, ha + 2)
    row1 = torch.stack([a10, a11], dim=ha + 2).flatten(ha + 1, ha + 2)
    return torch.stack([row0, row1], dim=ha + 1).flatten(ha, ha + 1)


def dwt2_from_packed(x: torch.Tensor, channel_axis: int = -1) -> torch.Tensor:
    """:func:`dwt2` of a tensor packed with block (2, 2): ``(b, h/2, w/2, 4c)``
    packed -> ``(b, h/2, w/2, 4c)`` subbands ``[LL, HL, LH, HH]`` (or channels
    at 1), equal to ``dwt2(unpack(x, (2, 2)))``."""
    _, ca = _axes(x, channel_axis)
    y = x.unflatten(ca, (x.shape[ca] // 4, 2, 2)) / 2

    def phase(ph, pw):
        return y.select(ca + 2, pw).select(ca + 1, ph)

    x1, x2, x3, x4 = phase(0, 0), phase(1, 0), phase(0, 1), phase(1, 1)
    ll = x1 + x2 + x3 + x4
    hl = -x1 - x2 + x3 + x4
    lh = -x1 + x2 - x3 + x4
    hh = x1 - x2 - x3 + x4
    return torch.cat([ll, hl, lh, hh], dim=ca)


def iwt2_to_packed(x: torch.Tensor, channel_axis: int = -1) -> torch.Tensor:
    """:func:`iwt2` packed with block (2, 2): ``(b, h, w, 4c)`` subbands ->
    ``(b, h, w, 4c)`` packed (or channels at 1), equal to
    ``pack(iwt2(x), (2, 2))``."""
    _, ca = _axes(x, channel_axis)
    x1, x2, x3, x4 = (v / 2 for v in x.chunk(4, dim=ca))
    a00 = x1 - x2 - x3 + x4  # offset (0, 0)
    a01 = x1 + x2 - x3 - x4  # offset (0, 1)
    a10 = x1 - x2 + x3 - x4  # offset (1, 0)
    a11 = x1 + x2 + x3 + x4  # offset (1, 1)
    return torch.stack([a00, a01, a10, a11], dim=ca + 1).flatten(ca, ca + 1)
