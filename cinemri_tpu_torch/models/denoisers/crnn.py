"""Convolutional RNN building blocks of the CRNN dynamic variants.

Counterpart of ``cinemri_tpu/models/denoisers/crnn.py`` (dense layout).
The reference's cell sums three convolutions, one each of the input, the
hidden state along t and the hidden state of the previous unrolled
iteration. ``conv(x, Wx) + conv(h, Wh) + conv(g, Wg) = conv([x, h, g],
[Wx; Wh; Wg])``, so each sum is ONE convolution over the
channel-concatenated inputs (:class:`FusedSumConv2d`): one cuDNN launch per
cell step instead of three. Its weight is the flax kernel ``(3, 3, Σsizes,
out)`` transposed (``interop.flax_params.conv_weight``), and
``models.init`` draws each input slice with the fan-in of the separate
convolution it replaces.

Both temporal directions of :class:`BCRNN` ride one loop over t, stacked on
the batch axis (inputs ``[x, flip_t(x)]``), with one shared cell and a zero
initial hidden state; the result is ``out[:, :b] + flip_t(out[:, b:])``.

Layout: NCHW, with t leading: ``x (t, b, ch, h, w)``. The packed (space to
depth) layout, ``pack2`` / ``unpack2`` and the packed fused conv, is not
ported (ROADMAP Queue 1, item 14).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["FusedSumConv2d", "CRNNCell", "BCRNN"]


class FusedSumConv2d(nn.Conv2d):
    """``Σᵢ convᵢ(inputsᵢ)`` as one ``k x k`` convolution (same padding) over
    the inputs concatenated on the channel axis, in the order of
    ``sizes``, the per-input channel counts."""

    def __init__(self, sizes: Sequence[int], out_channels: int, kernel_size: int = 3):
        super().__init__(sum(sizes), out_channels, kernel_size, padding=kernel_size // 2)
        self.sizes = tuple(int(s) for s in sizes)

    def forward(self, *inputs: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[1] for x in inputs) != self.sizes:
            raise ValueError(f"expected inputs of {self.sizes} channels, got "
                             f"{tuple(x.shape[1] for x in inputs)}")
        return super().forward(torch.cat(inputs, dim=1) if len(inputs) > 1 else inputs[0])


class CRNNCell(nn.Module):
    """One CRNN step: ``relu(conv([x, h_time, h_iteration]))``, NCHW."""

    def __init__(self, in_channels: int, hidden_size: int, kernel_size: int = 3):
        super().__init__()
        self.conv = FusedSumConv2d((in_channels, hidden_size, hidden_size), hidden_size,
                                   kernel_size)

    def forward(self, x: torch.Tensor, hidden: torch.Tensor,
                hidden_iteration: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv(x, hidden, hidden_iteration))


class BCRNN(nn.Module):
    """Bidirectional CRNN layer: ``x (t, b, ch, h, w)`` and this layer's
    output at the previous iteration ``hidden_iteration (t, b, hidden, h,
    w)`` -> ``(t, b, hidden, h, w)``, the forward sweep plus the backward
    sweep of one shared cell."""

    def __init__(self, in_channels: int, hidden_size: int, kernel_size: int = 3):
        super().__init__()
        self.hidden_size = hidden_size
        self.cell = CRNNCell(in_channels, hidden_size, kernel_size)

    def forward(self, x: torch.Tensor, hidden_iteration: torch.Tensor) -> torch.Tensor:
        t, b, _, h, w = x.shape
        xx = torch.cat([x, torch.flip(x, (0,))], dim=1)  # (t, 2b, ch, h, w)
        hh = torch.cat([hidden_iteration, torch.flip(hidden_iteration, (0,))], dim=1)
        hidden = x.new_zeros((2 * b, self.hidden_size, h, w))
        outs = []
        for i in range(t):
            hidden = self.cell(xx[i], hidden, hh[i])
            outs.append(hidden)
        out = torch.stack(outs)
        return out[:, :b] + torch.flip(out[:, b:], (0,))
