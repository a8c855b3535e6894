"""Torch-style parameter initialization from an explicit generator.

Counterpart of ``cinemri_tpu/models/init.py``: every conv kernel is drawn
uniform in ±1/sqrt(fan_in), with fan_in = in_channels x prod(kernel dims)
(2-D and 3-D convolutions, transposed or not), and every conv bias with its kernel's bound. For a transpose conv the
in_channels are its input channels, as in the JAX package (weight
``(in, out, k...)``). A fused sum of convolutions (``FusedSumConv2d``, the
CRNN cells and trunk) draws each input slice of its kernel with the fan-in
of the separate convolution it replaces, ``sᵢ x k x k``, and its bias as the
sum of one draw per slice, as the JAX package does; one fan-in of ``Σsᵢ x k
x k`` would start the 2-channel image slice about 3x too small. Other
parameters (``lambda_reg``) keep their explicit initial values. :func:`lecun_normal_init` draws flax's default
instead (``lecun_normal``: truncated normal at ±2σ, σ = 1/sqrt(fan_in)
corrected for the truncation; biases 0; per slice for a fused conv), the JAX
package's init with ``torch_init`` off.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["torch_style_init", "lecun_normal_init"]


def _convs(model: nn.Module):
    """(module, [(weight slice, fan_in), ...]) of every conv (2-D and 3-D,
    transposed or not) in module order: one slice of the weight's input axis
    per fused input, the whole weight for any other conv."""
    for module in model.modules():
        if not isinstance(module, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)):
            continue
        w = module.weight
        in_axis = 0 if isinstance(module, (nn.ConvTranspose2d, nn.ConvTranspose3d)) else 1
        sizes = getattr(module, "sizes", (w.shape[in_axis],))  # FusedSumConv2d's inputs
        spatial = math.prod(w.shape[2:])
        yield module, [(part, s * spatial) for part, s in zip(w.split(list(sizes), in_axis), sizes)]


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def torch_style_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw ``model``'s conv parameters in module order from ``generator``
    (a CPU generator; the draws are copied to the parameters' device)."""
    for module, slices in _convs(model):
        bounds = [1.0 / math.sqrt(fan_in) for _, fan_in in slices]
        for (part, _), bound in zip(slices, bounds):
            part.copy_(_uniform(part.shape, bound, generator))
        if module.bias is not None:
            module.bias.copy_(sum(_uniform(module.bias.shape, bound, generator) for bound in bounds))
    return model


@torch.no_grad()
def lecun_normal_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw ``model``'s conv kernels as flax's ``lecun_normal`` in module
    order from ``generator`` (a CPU generator) and zero their biases."""
    for module, slices in _convs(model):
        for part, fan_in in slices:
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # flax's truncation correction
            draw = torch.empty(part.shape, dtype=torch.float32)
            torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
            part.copy_(draw * std)
        if module.bias is not None:
            module.bias.zero_()
    return model
