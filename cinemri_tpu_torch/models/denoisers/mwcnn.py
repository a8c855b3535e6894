"""Multi-scale Wavelet CNN (MWCNN) in NCHW layout.

Counterpart of ``cinemri_tpu/models/denoisers/mwcnn.py``: a U-Net-shaped
denoiser whose pooling and unpooling are the Haar DWT / IWT
of :mod:`cinemri_tpu_torch.ops.wavelet`, with per-scale conv stacks,
additive skips, optional first convs (and their skip around the whole
net), and an optional global residual. XPDNet's image-space denoiser.
Convolutions and instance norm are PyTorch/cuDNN ops, as the JAX package
wrote no Pallas kernel for them.

``packed=True`` runs each grid level above the deepest (level g: after g
DWTs) on the space-to-depth layout of block (2, 2)
(``models/denoisers/packed_unet.py``), with the same parameters: the blocks'
and the final conv's kernels are assembled from the logical ones, instance
norm is one group per logical channel, and the DWT / IWT between packed
levels run in channel space (``ops.wavelet.dwt2_from_packed``,
``iwt2_to_packed``); the deepest level stays dense, as in the JAX package.

Module names map onto the flax tree (``interop/flax_params.py``):
``blocks[i]`` = ``MWConvBlock_i`` in call order, ``final`` = ``Conv_0``
(the last conv with a bias: after the first-conv skip, or, with
``n_first_convs < 1``, the plain conv to ``4 * out_chans`` before the
last IWT).

``dtype`` is the activation dtype (``models/denoisers/activations.py``): in
bf16 the convolutions, the DWT / IWT and the skips run on bf16 activations,
instance norm takes f32 statistics, and the output (before the residual) is
cast to f32, as in the JAX package. Its convolutions are not tagged for the
``"convs"`` remat policy, as the JAX package does not tag them.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from cinemri_tpu_torch.models.denoisers.activations import leaky_relu, output
from cinemri_tpu_torch.models.denoisers.packed_unet import (
    PackedConv2d,
    pack,
    packed_group_norm,
    unpack,
)
from cinemri_tpu_torch.ops.wavelet import dwt2, dwt2_from_packed, iwt2, iwt2_to_packed

__all__ = ["MWCNN", "MWConvBlock"]


class MWConvBlock(nn.Module):
    """conv3x3 (no bias) -> InstanceNorm (eps 1e-5, no affine; flax's
    GroupNorm with one group per channel) -> LeakyReLU(0.2), in ``dtype``;
    on the layout packed with ``block`` (``()``: dense)."""

    def __init__(self, in_chans: int, n_filters: int, dtype: torch.dtype = torch.float32,
                 block: tuple = ()):
        super().__init__()
        self.dtype = dtype
        self.block = tuple(block)
        self.conv = PackedConv2d(in_chans, n_filters, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x, self.block, self.dtype)
        return leaky_relu(packed_group_norm(x, self.conv.out_channels), 0.2)


def _repack(v: torch.Tensor, b_from: tuple, b_to: tuple, down: bool) -> torch.Tensor:
    """The DWT (``down``) or IWT between grid levels packed with ``b_from``
    and ``b_to`` (``()`` dense, else (2, 2)), NCHW, without forming the dense
    full-resolution tensor: the packed DWT reads the phases, the packed IWT
    writes them."""
    if down:
        v = dwt2_from_packed(v, 1) if b_from else dwt2(v, 1)
        return pack(v, b_to) if b_to else v
    if b_from:
        v = unpack(v, b_from)
    return iwt2_to_packed(v, 1) if b_to else iwt2(v, 1)


class MWCNN(nn.Module):
    """Input/output ``(n, chans, h, w)``; ``h`` and ``w`` divisible by
    ``2**n_scales`` (callers pad with ``ops.pad.pad_for_mwcnn``)."""

    def __init__(
        self,
        in_chans: int,
        out_chans: int,
        n_scales: int = 3,
        n_filters_per_scale: Sequence[int] = (16, 32, 64),
        n_convs_per_scale: Sequence[int] = (2, 2, 2),
        n_first_convs: int = 1,
        first_conv_n_filters: int = 16,
        res: bool = False,
        packed: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.packed = packed
        # the block of each grid level; the deepest stays dense
        self.levels = [(2, 2) if packed and g < n_scales else () for g in range(n_scales + 1)]
        self.n_scales = n_scales
        self.n_convs = tuple(n_convs_per_scale)
        self.n_first_convs = n_first_convs
        self.res = res
        self.dtype = dtype
        nf, f0 = tuple(n_filters_per_scale), first_conv_n_filters

        def chans_for(i_scale: int, i_conv: int) -> int:
            if i_conv == self.n_convs[i_scale] * 2 - 1:
                if i_scale == 0:
                    return max(4 * f0, 4 * out_chans)
                return 4 * nf[i_scale - 1]
            return nf[i_scale]

        blocks = []

        def block(cin: int, cout: int, g: int) -> int:
            blocks.append(MWConvBlock(cin, cout, dtype, self.levels[g]))
            return cout

        # the blocks in call order with their grid levels, tracking the channels
        ch = in_chans
        for _ in range(n_first_convs):
            ch = block(ch, f0, 0)
        for i_scale in range(n_scales):
            ch *= 4  # dwt2
            for i_conv in range(self.n_convs[i_scale]):
                ch = block(ch, chans_for(i_scale, i_conv), i_scale + 1)
        for i_scale in range(n_scales - 1, -1, -1):
            if i_scale != n_scales - 1:
                ch //= 4  # iwt2, then the additive skip
            n = self.n_convs[i_scale]
            for i_conv in range(n, 2 * n):
                if i_scale == 0 and i_conv == 2 * n - 1 and n_first_convs < 1:
                    self.final = PackedConv2d(ch, 4 * out_chans, 3, padding=1)
                    self.final_level = 1
                    ch = 4 * out_chans
                else:
                    ch = block(ch, chans_for(i_scale, i_conv), i_scale + 1)
        ch //= 4  # iwt2
        if n_first_convs > 0:
            for _ in range(n_first_convs - 1):
                ch = block(ch, f0, 0)
            self.final = PackedConv2d(ch, out_chans, 3, padding=1)
            self.final_level = 0
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        block = 2 ** self.n_scales
        if x.ndim != 4 or x.shape[2] % block or x.shape[3] % block:
            raise ValueError(f"MWCNN needs (n, c, h, w) with h, w divisible by {block}, "
                             f"got {tuple(x.shape)}")
        blocks, lvl = iter(self.blocks), self.levels
        cur = pack(x, lvl[0]) if lvl[0] else x
        for _ in range(self.n_first_convs):
            cur = next(blocks)(cur)
        first_conv_feature = cur
        skips = []
        for i_scale in range(self.n_scales):
            cur = _repack(cur, lvl[i_scale], lvl[i_scale + 1], down=True)
            for _ in range(self.n_convs[i_scale]):
                cur = next(blocks)(cur)
            skips.append(cur)
        for i_scale in range(self.n_scales - 1, -1, -1):
            if i_scale != self.n_scales - 1:
                cur = _repack(cur, lvl[i_scale + 2], lvl[i_scale + 1], down=False) + skips[i_scale]
            n = self.n_convs[i_scale]
            for i_conv in range(n, 2 * n):
                if i_scale == 0 and i_conv == 2 * n - 1 and self.n_first_convs < 1:
                    # plain conv straight to 4 * out_chans
                    cur = self.final(cur, lvl[self.final_level], self.dtype)
                else:
                    cur = next(blocks)(cur)
        cur = _repack(cur, lvl[1], lvl[0], down=False)
        if self.n_first_convs > 0:
            cur = cur + first_conv_feature
            for _ in range(self.n_first_convs - 1):
                cur = next(blocks)(cur)
            cur = self.final(cur, lvl[self.final_level], self.dtype)
        if lvl[0]:
            cur = unpack(cur, lvl[0])
        cur = output(cur, self.dtype)
        return x + cur if self.res else cur
