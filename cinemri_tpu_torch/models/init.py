"""Torch-style parameter initialization from an explicit generator.

Counterpart of ``cinemri_tpu/models/init.py``: every conv kernel is drawn
uniform in ±1/sqrt(fan_in), with fan_in = in_channels x prod(kernel dims),
and every conv bias with its kernel's bound. For a transpose conv the
in_channels are its input channels, as in the JAX package (weight
``(in, out, kh, kw)``). Other parameters (``lambda_reg``) keep their
explicit initial values.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["torch_style_init"]


@torch.no_grad()
def torch_style_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw ``model``'s conv parameters in module order from ``generator``
    (a CPU generator; the draws are copied to the parameters' device)."""
    for module in model.modules():
        if isinstance(module, nn.ConvTranspose2d):
            fan_in = module.weight.shape[0] * math.prod(module.weight.shape[2:])
        elif isinstance(module, nn.Conv2d):
            fan_in = module.weight.shape[1] * math.prod(module.weight.shape[2:])
        else:
            continue
        bound = 1.0 / math.sqrt(fan_in)
        for p in (module.weight, module.bias):
            if p is not None:
                draw = torch.empty(p.shape, dtype=p.dtype).uniform_(-bound, bound, generator=generator)
                p.copy_(draw)
    return model
