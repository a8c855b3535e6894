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

Layout: NCHW, with t leading: ``x (t, b, ch, h, w)``. With a ``block``
(the packed trunk, ``models/denoisers/packed_unet.py``) the inputs and the
hidden states are space-to-depth packed over ``(h, w)`` (:func:`pack2`,
c-major, so the packed concatenation of the inputs is the packing of the
logical one) and :class:`FusedSumConv2d` runs on the packed grid with the
same parameters: the JAX package's ``_PackedFusedConv``.

``dtype`` is the activation dtype (``models/denoisers/activations.py``): in
bf16, :class:`BCRNN` casts its inputs and starts from a bf16 hidden state, and
every fused convolution runs in bf16, as in the JAX package. Each fused
convolution's output is tagged for the ``"convs"`` remat policy
(``models/remat.py::tag_conv_out``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cinemri_tpu_torch.models.denoisers.activations import act_dtype
from cinemri_tpu_torch.models.denoisers.packed_unet import PackedConv2d, block_size, pack, unpack
from cinemri_tpu_torch.models.remat import tag_conv_out

__all__ = ["FusedSumConv2d", "CRNNCell", "BCRNN", "pack2", "unpack2"]


def pack2(x: torch.Tensor, block) -> torch.Tensor:
    """Space-to-depth over the trailing ``(h, w)`` of ``(..., c, h, w)``
    (``packed_unet.pack`` with free leading dims)."""
    y = pack(x.reshape(-1, *x.shape[-3:]), tuple(block))
    return y.reshape(*x.shape[:-3], *y.shape[1:])


def unpack2(x: torch.Tensor, block) -> torch.Tensor:
    """Inverse of :func:`pack2`."""
    y = unpack(x.reshape(-1, *x.shape[-3:]), tuple(block))
    return y.reshape(*x.shape[:-3], *y.shape[1:])


class FusedSumConv2d(PackedConv2d):
    """``Σᵢ convᵢ(inputsᵢ)`` as one ``k x k`` convolution (same padding) over
    the inputs concatenated on the channel axis, in the order of
    ``sizes``, the per-input channel counts; computed in ``dtype`` and
    tagged for the ``"convs"`` remat policy. With a ``block`` the inputs
    are packed with it, and so is the output."""

    def __init__(self, sizes: Sequence[int], out_channels: int, kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__(sum(sizes), out_channels, kernel_size, padding=kernel_size // 2)
        self.sizes = tuple(int(s) for s in sizes)
        self.dtype = dtype

    def forward(self, *inputs: torch.Tensor, block=()) -> torch.Tensor:
        n = block_size(block)
        if tuple(x.shape[1] for x in inputs) != tuple(s * n for s in self.sizes):
            raise ValueError(f"expected inputs of {self.sizes} channels x {n}, got "
                             f"{tuple(x.shape[1] for x in inputs)}")
        x = torch.cat(inputs, dim=1) if len(inputs) > 1 else inputs[0]
        with tag_conv_out():
            return super().forward(x, block, self.dtype)


class CRNNCell(nn.Module):
    """One CRNN step: ``relu(conv([x, h_time, h_iteration]))``, NCHW."""

    def __init__(self, in_channels: int, hidden_size: int, kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = FusedSumConv2d((in_channels, hidden_size, hidden_size), hidden_size,
                                   kernel_size, dtype)

    def forward(self, x: torch.Tensor, hidden: torch.Tensor, hidden_iteration: torch.Tensor,
                block=()) -> torch.Tensor:
        return F.relu(self.conv(x, hidden, hidden_iteration, block=block))


class BCRNN(nn.Module):
    """Bidirectional CRNN layer: ``x (t, b, ch, h, w)`` and this layer's
    output at the previous iteration ``hidden_iteration (t, b, hidden, h,
    w)`` -> ``(t, b, hidden, h, w)``, the forward sweep plus the backward
    sweep of one shared cell; the inputs are cast to ``dtype``, the
    activation dtype, and the initial hidden state is zeros of it. With a
    ``block`` the inputs, the hidden states and the output are packed."""

    def __init__(self, in_channels: int, hidden_size: int, kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.dtype = dtype
        self.cell = CRNNCell(in_channels, hidden_size, kernel_size, dtype)

    def forward(self, x: torch.Tensor, hidden_iteration: torch.Tensor, block=()) -> torch.Tensor:
        t, b, _, h, w = x.shape
        dtype = act_dtype(self.dtype, x)
        x, hidden_iteration = x.to(dtype), hidden_iteration.to(dtype)
        xx = torch.cat([x, torch.flip(x, (0,))], dim=1)  # (t, 2b, ch, h, w)
        hh = torch.cat([hidden_iteration, torch.flip(hidden_iteration, (0,))], dim=1)
        hidden = x.new_zeros((2 * b, self.hidden_size * block_size(block), h, w))
        outs = []
        for i in range(t):
            hidden = self.cell(xx[i], hidden, hh[i], block)
            outs.append(hidden)
        out = torch.stack(outs)
        return out[:, :b] + torch.flip(out[:, b:], (0,))
