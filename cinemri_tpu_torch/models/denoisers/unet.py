"""2-D U-Net denoiser in NCHW layout.

Counterpart of ``cinemri_tpu/models/denoisers/unet.py`` (``dims=2``,
unpacked): encoder/decoder with 2x average-pool downsampling (floor crop on
odd sizes), transpose-conv upsampling, skip concatenation, and blocks of
conv3x3 (no bias) -> InstanceNorm (eps 1e-5, no affine) -> LeakyReLU(0.2).
The decoder pads odd sizes at the trailing edge; the final 1x1 conv has a
bias. Convolutions, instance norm and pooling are PyTorch/cuDNN ops: the
JAX package wrote no Pallas kernel for them.

Module names map one to one onto the flax tree (see
``interop/flax_params.py``): ``down[j]`` = ``ConvBlock_j``, ``bottom`` =
``ConvBlock_{pools}``, ``up_transpose[i]`` = ``TransposeConvBlock_i``,
``up_conv[i]`` = ``ConvBlock_{pools+1+i}``, ``final`` = ``Conv_0``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Unet", "ConvBlock", "TransposeConvBlock"]


class ConvBlock(nn.Module):
    """Two (conv3x3 -> InstanceNorm -> LeakyReLU(0.2)) stages."""

    def __init__(self, in_chans: int, out_chans: int):
        super().__init__()
        self.conv0 = nn.Conv2d(in_chans, out_chans, 3, padding=1, bias=False)
        self.conv1 = nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in (self.conv0, self.conv1):
            x = F.leaky_relu(F.instance_norm(conv(x), eps=1e-5), 0.2)
        return x


class TransposeConvBlock(nn.Module):
    """convT(k=2, s=2, no bias) -> InstanceNorm -> LeakyReLU(0.2)."""

    def __init__(self, in_chans: int, out_chans: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_chans, out_chans, 2, stride=2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(F.instance_norm(self.conv(x), eps=1e-5), 0.2)


class Unet(nn.Module):
    """Input/output ``(n, chans, h, w)``."""

    def __init__(
        self,
        chans: int = 32,
        num_pool_layers: int = 4,
        in_chans: int = 2,
        out_chans: int = 2,
        dims: int = 2,
        packed: bool = False,
    ):
        super().__init__()
        if dims != 2:
            raise NotImplementedError(
                "Unet(dims=3) is not ported yet (ROADMAP Queue 1, item 5: "
                "3-D U-Net / NormUnet3D)"
            )
        if packed:
            raise NotImplementedError(
                "packed Unet is not ported (ROADMAP Queue 1, item 14: "
                "models/denoisers/packed_unet.py)"
            )
        self.num_pool_layers = num_pool_layers
        ch = chans
        self.down = nn.ModuleList([ConvBlock(in_chans, ch)])
        for _ in range(num_pool_layers - 1):
            self.down.append(ConvBlock(ch, ch * 2))
            ch *= 2
        self.bottom = ConvBlock(ch, ch * 2)
        self.up_transpose = nn.ModuleList()
        self.up_conv = nn.ModuleList()
        for _ in range(num_pool_layers - 1):
            self.up_transpose.append(TransposeConvBlock(ch * 2, ch))
            self.up_conv.append(ConvBlock(ch * 2, ch))
            ch //= 2
        self.up_transpose.append(TransposeConvBlock(ch * 2, ch))
        self.up_conv.append(ConvBlock(ch * 2, ch))
        self.final = nn.Conv2d(ch, out_chans, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 4:
            raise ValueError(f"Unet expects (n, c, h, w), got {tuple(x.shape)}")
        stack = []
        out = x
        for block in self.down:
            out = block(out)
            stack.append(out)
            out = F.avg_pool2d(out, 2)  # floor crop on odd sizes
        out = self.bottom(out)
        for tconv, conv in zip(self.up_transpose, self.up_conv):
            skip = stack.pop()
            out = tconv(out)
            dh = skip.shape[-2] - out.shape[-2]
            dw = skip.shape[-1] - out.shape[-1]
            if dh or dw:  # trailing-edge pad where the encoder level was odd
                out = F.pad(out, (0, dw, 0, dh))
            out = conv(torch.cat([out, skip], dim=1))
        return self.final(out)
