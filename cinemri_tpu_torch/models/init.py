"""Torch-style parameter initialization from an explicit generator.

Counterpart of ``cinemri_tpu/models/init.py``: every conv kernel is drawn
uniform in ±1/sqrt(fan_in), with fan_in = in_channels x prod(kernel dims)
(2-D and 3-D convolutions, transposed or not), and every conv bias with its kernel's bound. For a transpose conv the
in_channels are its input channels, as in the JAX package (weight
``(in, out, k...)``). Other parameters (``lambda_reg``) keep their
explicit initial values. :func:`lecun_normal_init` draws flax's default
instead (``lecun_normal``: truncated normal at ±2σ, σ = 1/sqrt(fan_in)
corrected for the truncation; biases 0), the JAX package's init with
``torch_init`` off.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["torch_style_init", "lecun_normal_init"]


def _convs(model: nn.Module):
    """(module, fan_in) of every conv (2-D and 3-D, transposed or not) in
    module order."""
    for module in model.modules():
        if isinstance(module, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
            yield module, module.weight.shape[0] * math.prod(module.weight.shape[2:])
        elif isinstance(module, (nn.Conv2d, nn.Conv3d)):
            yield module, module.weight.shape[1] * math.prod(module.weight.shape[2:])


@torch.no_grad()
def torch_style_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw ``model``'s conv parameters in module order from ``generator``
    (a CPU generator; the draws are copied to the parameters' device)."""
    for module, fan_in in _convs(model):
        bound = 1.0 / math.sqrt(fan_in)
        for p in (module.weight, module.bias):
            if p is not None:
                draw = torch.empty(p.shape, dtype=p.dtype).uniform_(-bound, bound, generator=generator)
                p.copy_(draw)
    return model


@torch.no_grad()
def lecun_normal_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw ``model``'s conv kernels as flax's ``lecun_normal`` in module
    order from ``generator`` (a CPU generator) and zero their biases."""
    for module, fan_in in _convs(model):
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # flax's truncation correction
        draw = torch.empty(module.weight.shape, dtype=module.weight.dtype)
        torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
        module.weight.copy_(draw * std)
        if module.bias is not None:
            module.bias.zero_()
    return model
