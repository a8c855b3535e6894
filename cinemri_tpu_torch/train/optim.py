"""Optimizer: Adam + step-decay schedule + optional global-norm clip.

Counterpart of ``cinemri_tpu/train/optim.py``, whose optax chain is
``[clip_by_global_norm] -> [add_decayed_weights] -> adam(schedule)``:

  * Adam's ``weight_decay`` is torch's own (``wd·θ`` added to the gradient
    before the moment updates), which is what ``add_decayed_weights`` in
    front of ``adam`` computes (not AdamW);
  * the learning rate is ``lr · γ^((step // steps_per_epoch) // step_size)``
    through a ``LambdaLR`` stepped once per train step, so step 0 uses
    ``lr · γ^0``, as optax counts;
  * the clip is computed as optax computes it, ``g`` when ``‖g‖ < max_norm``
    and ``(g / ‖g‖) · max_norm`` otherwise (``clip_grad_norm_`` would add
    1e-6 to the denominator).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
from torch.optim.lr_scheduler import LambdaLR

__all__ = ["step_decay_schedule", "make_optimizer", "Optimizer"]


def _decay(gamma: float, step_size_epochs: int, steps_per_epoch: int) -> Callable[[int], float]:
    def factor(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return gamma ** (epoch // step_size_epochs)

    return factor


def step_decay_schedule(
    lr: float, step_size_epochs: int, gamma: float, steps_per_epoch: int
) -> Callable[[int], float]:
    """``step -> lr · γ^(epoch // step_size)``, the epoch from the step count."""
    factor = _decay(gamma, step_size_epochs, steps_per_epoch)
    return lambda step: lr * factor(step)


class Optimizer:
    """Adam with its schedule and clip, stepped once per train step."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float, lr_step_size: int,
                 lr_gamma: float, weight_decay: float, steps_per_epoch: int,
                 clip_grad_norm: float):
        self.params = list(params)
        self.adam = torch.optim.Adam(self.params, lr=lr, weight_decay=weight_decay)
        self.scheduler = LambdaLR(self.adam, _decay(lr_gamma, lr_step_size, steps_per_epoch))
        self.clip_grad_norm = clip_grad_norm

    @torch.no_grad()
    def step(self, grad_norm: torch.Tensor) -> None:
        """Clip by ``grad_norm`` (the global norm of the current grads) when
        a clip is set, take one Adam step and advance the schedule."""
        if self.clip_grad_norm > 0:
            keep = grad_norm < self.clip_grad_norm
            for p in self.params:
                if p.grad is not None:
                    p.grad.copy_(torch.where(keep, p.grad, p.grad / grad_norm * self.clip_grad_norm))
        self.adam.step()
        self.scheduler.step()


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    lr: float = 1e-4,
    lr_step_size: int = 140,
    lr_gamma: float = 0.01,
    weight_decay: float = 0.0,
    steps_per_epoch: int = 1,
    clip_grad_norm: float = 0.0,
) -> Optimizer:
    """Adam + StepLR over ``params``; ``clip_grad_norm`` 0 means no clip
    (the reference recipe)."""
    return Optimizer(params, lr, lr_step_size, lr_gamma, weight_decay, steps_per_epoch,
                     clip_grad_norm)
