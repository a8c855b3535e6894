"""The activation dtype of the conv stacks (the JAX package's ``dtype`` field).

With ``dtype=torch.bfloat16`` (a model's ``bf16=True``) a conv stack stores
its activations in bf16, as flax's ``nn.Conv(dtype=bfloat16)`` does: each
convolution casts its input and its f32 weight (and bias) to bf16
(:func:`conv`); instance norm takes its statistics in f32 and returns the
activation dtype (:func:`instance_norm`); pooling, LeakyReLU / ReLU,
transposed convolutions and concatenations stay in bf16; each stack returns
f32. The roundings fall where flax's do: a convolution's bias is added in
bf16 after the convolution's own rounding, and LeakyReLU's slope is taken in
bf16 (JAX's weakly typed ``0.2 * x`` on a bf16 ``x``). Parameters, their
gradients and everything outside the stacks stay f32.
The casts are written out rather than left to ``torch.autocast``, which
decides per op and per device (it would keep instance norm's output in f32),
so the CPU runs the dtypes the card runs. With ``dtype=torch.float32`` (the
default) nothing is cast: the stacks compute in the dtype they are given,
f32, or f64 when a model is cast to float64 for a reference evaluation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["act_dtype", "conv", "conv_in_dtype", "instance_norm", "is_reduced", "leaky_relu",
           "output", "resolve_dtype"]

_TRANSPOSED = {nn.ConvTranspose2d: F.conv_transpose2d, nn.ConvTranspose3d: F.conv_transpose3d}


def resolve_dtype(bf16: bool) -> torch.dtype:
    """The activation dtype of a model's ``bf16`` flag."""
    return torch.bfloat16 if bf16 else torch.float32


def act_dtype(dtype: torch.dtype, x: torch.Tensor) -> torch.dtype:
    """The dtype of a stack's activations under ``dtype``, given an input
    ``x``: ``dtype`` when reduced (bf16), else ``x``'s own."""
    return x.dtype if dtype == torch.float32 else dtype


def output(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A stack's output: f32 from reduced activations, else as computed."""
    return x if dtype == torch.float32 else x.float()


def is_reduced(x: torch.Tensor) -> bool:
    """Whether ``x`` holds reduced-precision activations (bf16)."""
    return x.dtype in (torch.bfloat16, torch.float16)


def conv_in_dtype(fn, x: torch.Tensor, weight: torch.Tensor, bias, dtype: torch.dtype,
                  **kw) -> torch.Tensor:
    """The convolution ``fn(x, weight, bias, **kw)`` computed in ``dtype`` as
    flax's ``nn.Conv(dtype=...)`` computes it: the input and the weight cast
    to ``dtype``, the convolution rounded to it, then the bias (cast too)
    added; ``fn(x, weight, bias, **kw)`` itself at f32."""
    if dtype == torch.float32:
        return fn(x, weight, bias, **kw)
    y = fn(x.to(dtype), weight.to(dtype), None, **kw)
    return y if bias is None else y + bias.to(dtype).reshape(-1, *(1,) * (y.ndim - 2))


def conv(module: nn.Module, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``module(x)`` computed in ``dtype`` (:func:`conv_in_dtype`); ``module(x)``
    itself at f32."""
    if dtype == torch.float32:
        return module(x)
    transposed = _TRANSPOSED.get(type(module))
    if transposed is None:
        return conv_in_dtype(module._conv_forward, x, module.weight, module.bias, dtype)
    return conv_in_dtype(transposed, x, module.weight, module.bias, dtype, stride=module.stride,
                         padding=module.padding, output_padding=module.output_padding,
                         groups=module.groups, dilation=module.dilation)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """``F.leaky_relu``; on reduced activations, the slope rounded to their
    dtype first, as JAX multiplies a bf16 array by a weakly typed ``0.2``."""
    if not is_reduced(x):
        return F.leaky_relu(x, slope)
    return torch.where(x >= 0, x, x * torch.tensor(slope, dtype=x.dtype))


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """Instance norm (eps 1e-5, no affine), returned in the dtype of ``x``;
    reduced activations take f32 statistics."""
    if not is_reduced(x):
        return F.instance_norm(x, eps=1e-5)
    return F.instance_norm(x.float(), eps=1e-5).to(x.dtype)
