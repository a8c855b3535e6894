"""Weights drawn from the seed on the device, by parameter name and shape.

One uniform draw in [0, 1) from a generator on the device covers every
parameter, in the order of their sorted names, and is cut and scaled: a
parameter of two or more dims (a convolution's kernel) uniform in ±1 /
sqrt(fan-in), fan-in the product of its dims after the first; a ``.bias``
with the bound of the kernel beside it; any other parameter uniform in
``center ± 0.25``, its center given by the configuration's
``param_centers`` (VarNet's and CineNet's λ). The program and the reference
get the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

__all__ = ["draw_weights", "seed_for"]


def seed_for(seed: int, stream: int) -> int:
    """A generator seed for ``stream`` of a run seeded ``seed`` (any integer)."""
    import numpy as np

    return int(np.random.default_rng([seed % 2 ** 64, stream]).integers(2 ** 62))


def _bound(name: str, shapes: Mapping[str, Tuple[int, ...]]) -> float:
    shape = shapes[name]
    if len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape[1:]))
    if name.endswith(".bias"):
        return _bound(name[: -len("bias")] + "weight", shapes)
    raise KeyError(name)


def draw_weights(shapes: Mapping[str, Tuple[int, ...]], seed: int, centers: Mapping[str, float],
                 device) -> Dict[str, torch.Tensor]:
    """``{name: float32 tensor}`` for ``shapes`` (name -> shape)."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed_for(seed, 0))
    u = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32) * 2 - 1
    out = {}
    for name, part in zip(names, torch.split(u, sizes)):
        part = part.reshape(shapes[name])
        if name in centers:
            out[name] = centers[name] + 0.25 * part
        else:
            out[name] = _bound(name, shapes) * part
    return out
