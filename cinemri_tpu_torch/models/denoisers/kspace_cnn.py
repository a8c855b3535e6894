"""K-space interpolation CNN for XPDNet's dual-buffer mode.

Counterpart of ``cinemri_tpu/models/denoisers/kspace_cnn.py``: ``n_convs``
3x3x3 convolutions (with bias, ReLU between them) over ``(t, h, w)``,
each coil on its own (coils folded into the batch). Used only when XPDNet
runs with ``primal_only=False``. ``convs[i]`` = the flax tree's ``Conv_i``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["KSpaceCNN"]


class KSpaceCNN(nn.Module):
    """Input ``(b, t, c, h, w, in_chans)`` real -> ``(b, t, c, h, w, out_chans)``,
    the JAX package's channels-last layout."""

    def __init__(self, in_chans: int, out_chans: int, n_convs: int = 3, n_filters: int = 16):
        super().__init__()
        chans = [in_chans] + [n_filters] * (n_convs - 1) + [out_chans]
        self.convs = nn.ModuleList(nn.Conv3d(a, b, 3, padding=1) for a, b in zip(chans, chans[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c, h, w, ch = x.shape
        y = x.permute(0, 2, 5, 1, 3, 4).reshape(b * c, ch, t, h, w)
        for i, conv in enumerate(self.convs):
            y = conv(y)
            if i < len(self.convs) - 1:
                y = F.relu(y)
        return y.reshape(b, c, -1, t, h, w).permute(0, 3, 1, 4, 5, 2)
