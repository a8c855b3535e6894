"""2-D / 3-D U-Net denoiser in channels-first layout (NCHW / NCDHW).

Counterpart of ``cinemri_tpu/models/denoisers/unet.py`` (``dims`` 2 and 3):
encoder/decoder with 2x average-pool downsampling (floor crop on
odd sizes), transpose-conv upsampling, skip concatenation, and blocks of
conv3 (no bias) -> InstanceNorm (eps 1e-5, no affine) -> LeakyReLU(0.2).
The decoder pads odd sizes at the trailing edge of every spatial axis
(t = 15 goes 15 -> 7 -> 3 -> 1 and back); the final 1x1 conv has a bias. Convolutions, instance norm and pooling are PyTorch/cuDNN ops: the
JAX package wrote no Pallas kernel for them.

``dtype`` is the activation dtype (``models/denoisers/activations.py``): in
bf16 every activation is stored in bf16, instance norm takes f32 statistics,
and the output is f32. Each convolution's output is tagged for the
``"convs"`` remat policy (``models/remat.py::tag_conv_out``), as in the JAX
package.

A level pooled from a size of 1 is empty along that axis, as in the JAX
package (t = 3 at 2 pools goes 3 -> 1 -> 0): its blocks give empty levels
with their channel counts, as JAX's convolutions of an empty array do, and
the decoder's trailing-edge pad fills them back with zeros.

``packed=True`` runs the same function, with the same parameters, on the
space-to-depth layout of ``models/denoisers/packed_unet.py``: the input is
packed with level 0's block of ``choose_blocks``, each level runs
:class:`PackedConvBlock` on its block, pools with ``packed_avg_pool_2x``
into the next level's, and the decoder's :class:`PackedTransposeConvBlock`
goes from a level's block back to its parent's; the odd-size pad falls on
the packed grid (only dims with a block of 1 can be odd), and the output is
unpacked after the final 1x1 conv. The packed blocks are subclasses of the
dense ones with the same children, so the state dicts are one.

Module names map one to one onto the flax tree (see
``interop/flax_params.py``): ``down[j]`` = ``ConvBlock_j``, ``bottom`` =
``ConvBlock_{pools}``, ``up_transpose[i]`` = ``TransposeConvBlock_i``,
``up_conv[i]`` = ``ConvBlock_{pools+1+i}``, ``final`` = ``Conv_0``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cinemri_tpu_torch.models.denoisers.activations import (
    act_dtype,
    conv,
    instance_norm,
    is_reduced,
    leaky_relu,
    output,
)
from cinemri_tpu_torch.models.denoisers.packed_unet import (
    PACKED_CONV,
    PACKED_CONV_T,
    block_size,
    choose_blocks,
    pack,
    packed_avg_pool_2x,
    packed_group_norm,
    unpack,
)
from cinemri_tpu_torch.models.remat import tag_conv_out

__all__ = ["Unet", "ConvBlock", "TransposeConvBlock", "PackedConvBlock",
           "PackedTransposeConvBlock"]


_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_CONV_T = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}
_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _avg_pool_2x(x: torch.Tensor, dims: int) -> torch.Tensor:
    """2x average pool with floor semantics, JAX's ``_avg_pool_2x``: the
    crop to even sizes, then the mean of each 2-window. A level whose result
    is empty (a spatial size of 1) comes out empty, where ``F.avg_pool``
    raises; any other goes through ``F.avg_pool``, which floors the same
    way in one kernel with its own summation order, unchanged. A 3-D bf16
    input (which the CPU's ``avg_pool3d`` does not take) is pooled as JAX
    pools it: crop, then the f32 mean of each window, rounded to bf16."""
    spatial = x.shape[2:]
    if min(spatial) < 2:
        return x.new_zeros((*x.shape[:2], *(s // 2 for s in spatial)))
    if dims == 3 and is_reduced(x):
        n, c, t, h, w = x.shape
        y = x[:, :, : t // 2 * 2, : h // 2 * 2, : w // 2 * 2].float()
        return y.reshape(n, c, t // 2, 2, h // 2, 2, w // 2, 2).mean(dim=(3, 5, 7)).to(x.dtype)
    return _POOL[dims](x, 2)


def _is_empty(x: torch.Tensor) -> bool:
    return 0 in x.shape[2:]


class ConvBlock(nn.Module):
    """Two (conv3 -> InstanceNorm -> LeakyReLU(0.2)) stages, activations in
    ``dtype``."""

    convs = _CONV

    def __init__(self, in_chans: int, out_chans: int, dims: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = self.convs[dims](in_chans, out_chans, 3, padding=1, bias=False)
        self.conv1 = self.convs[dims](out_chans, out_chans, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _is_empty(x):  # an empty level (padding 1 keeps the sizes)
            return x.new_zeros((x.shape[0], self.conv1.out_channels, *x.shape[2:]),
                               dtype=act_dtype(self.dtype, x))
        for module in (self.conv0, self.conv1):
            with tag_conv_out():
                x = conv(module, x, self.dtype)
            x = leaky_relu(instance_norm(x), 0.2)
        return x


class TransposeConvBlock(nn.Module):
    """convT(k=2, s=2, no bias) -> InstanceNorm -> LeakyReLU(0.2), in ``dtype``."""

    convs = _CONV_T

    def __init__(self, in_chans: int, out_chans: int, dims: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = self.convs[dims](in_chans, out_chans, 2, stride=2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _is_empty(x):  # an empty level (stride 2 doubles the sizes)
            return x.new_zeros((x.shape[0], self.conv.out_channels, *(2 * s for s in x.shape[2:])),
                               dtype=act_dtype(self.dtype, x))
        with tag_conv_out():
            x = conv(self.conv, x, self.dtype)
        return leaky_relu(instance_norm(x), 0.2)


class PackedConvBlock(ConvBlock):
    """:class:`ConvBlock` on the packed layout of ``block`` (same parameters)."""

    convs = PACKED_CONV

    def forward(self, x: torch.Tensor, block=()) -> torch.Tensor:
        if _is_empty(x):
            out = self.conv1.out_channels * block_size(block)
            return x.new_zeros((x.shape[0], out, *x.shape[2:]), dtype=act_dtype(self.dtype, x))
        for module in (self.conv0, self.conv1):
            with tag_conv_out():
                x = module(x, block, self.dtype)
            x = leaky_relu(packed_group_norm(x, module.out_channels), 0.2)
        return x


class PackedTransposeConvBlock(TransposeConvBlock):
    """:class:`TransposeConvBlock` from the packed layout of ``block_in`` to
    that of ``block_out`` (same parameters)."""

    convs = PACKED_CONV_T

    def forward(self, x: torch.Tensor, block_in=(), block_out=()) -> torch.Tensor:
        if _is_empty(x):
            out = self.conv.out_channels * block_size(block_out)
            grid = (s * 2 * bi // bo for s, bi, bo in zip(x.shape[2:], block_in, block_out))
            return x.new_zeros((x.shape[0], out, *grid), dtype=act_dtype(self.dtype, x))
        with tag_conv_out():
            x = self.conv(x, block_in, block_out, self.dtype)
        return leaky_relu(packed_group_norm(x, self.conv.out_channels), 0.2)


class Unet(nn.Module):
    """Input/output ``(n, chans, h, w)``, or ``(n, chans, t, h, w)`` with
    ``dims=3``; the output is f32 from bf16 activations."""

    def __init__(
        self,
        chans: int = 32,
        num_pool_layers: int = 4,
        in_chans: int = 2,
        out_chans: int = 2,
        dims: int = 2,
        packed: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if dims not in (2, 3):
            raise ValueError(f"Unet dims must be 2 or 3, got {dims}")
        self.dims = dims
        self.dtype = dtype
        self.chans = chans
        self.num_pool_layers = num_pool_layers
        self.packed = packed
        block, tblock = (PackedConvBlock, PackedTransposeConvBlock) if packed else (
            ConvBlock, TransposeConvBlock)
        ch = chans
        self.down = nn.ModuleList([block(in_chans, ch, dims, dtype)])
        for _ in range(num_pool_layers - 1):
            self.down.append(block(ch, ch * 2, dims, dtype))
            ch *= 2
        self.bottom = block(ch, ch * 2, dims, dtype)
        self.up_transpose = nn.ModuleList()
        self.up_conv = nn.ModuleList()
        for _ in range(num_pool_layers - 1):
            self.up_transpose.append(tblock(ch * 2, ch, dims, dtype))
            self.up_conv.append(block(ch * 2, ch, dims, dtype))
            ch //= 2
        self.up_transpose.append(tblock(ch * 2, ch, dims, dtype))
        self.up_conv.append(block(ch * 2, ch, dims, dtype))
        self.final = (PACKED_CONV if packed else _CONV)[dims](ch, out_chans, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != self.dims + 2:
            raise ValueError(f"Unet(dims={self.dims}) expects rank {self.dims + 2}, "
                             f"got {tuple(x.shape)}")
        if self.packed:
            return self._packed_forward(x)
        stack = []
        out = x
        for block in self.down:
            out = block(out)
            stack.append(out)
            out = _avg_pool_2x(out, self.dims)  # floor crop on odd sizes
        out = self.bottom(out)
        for tconv, block in zip(self.up_transpose, self.up_conv):
            skip = stack.pop()
            out = tconv(out)
            # trailing-edge pad where the encoder level was odd (F.pad: last axis first)
            pads = [p for a in range(-1, -self.dims - 1, -1)
                    for p in (0, skip.shape[a] - out.shape[a])]
            if any(pads):
                out = F.pad(out, pads)
            out = block(torch.cat([out, skip], dim=1))
        return output(conv(self.final, out, self.dtype), self.dtype)

    def _packed_forward(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`forward` on the packed layout, level by level."""
        blocks = choose_blocks(x.shape[2:], self.chans, self.num_pool_layers)
        stack = []
        out = pack(x, blocks[0])
        for depth, block in enumerate(self.down):
            out = block(out, blocks[depth])
            stack.append(out)
            out = packed_avg_pool_2x(out, blocks[depth], blocks[depth + 1])
        out = self.bottom(out, blocks[-1])
        for depth, tconv, block in zip(range(self.num_pool_layers - 1, -1, -1), self.up_transpose,
                                       self.up_conv):
            skip = stack.pop()
            out = tconv(out, blocks[depth + 1], blocks[depth])
            pads = [p for a in range(-1, -self.dims - 1, -1)
                    for p in (0, skip.shape[a] - out.shape[a])]
            if any(pads):
                out = F.pad(out, pads)
            out = block(torch.cat([out, skip], dim=1), blocks[depth])
        return output(unpack(self.final(out, blocks[0], self.dtype), blocks[0]), self.dtype)
