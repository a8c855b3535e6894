"""Train and eval steps.

Counterpart of ``cinemri_tpu/train/step.py`` (single device): crop output
and target to the common center size, take the time-averaged SSIM loss,
backpropagate, and take one optimizer step. A batch is a dict with
``masked_kspace`` (Complex ``(b, t, c, h, w)``), ``mask``
(``(b, t|1, 1, h, 1)``), ``target`` (``(b, t, h', w')``), an optional
``sample_weight`` (``(b,)``) and, for models that take them (CineNet),
``sens_maps`` (Complex ``(b, 1, c, h, w)``), handed to the model as its
third argument. PyTorch updates the model's parameters in
place, so a step returns the same state object, advanced.

The data-parallel ``shard_map`` step is not ported yet (ROADMAP Queue 1,
item 13).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch
from torch import nn

from cinemri_tpu_torch import resolve_device
from cinemri_tpu_torch.data.transforms import center_crop_to_smallest
from cinemri_tpu_torch.ops.cplx import Complex
from cinemri_tpu_torch.ops.ssim import ssim_loss
from cinemri_tpu_torch.train.optim import Optimizer, make_optimizer

__all__ = ["TrainState", "create_train_state", "make_train_step", "make_eval_step", "global_norm"]


@dataclass
class TrainState:
    """The model, its optimizer (with the schedule) and the step count."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0


def create_train_state(model: nn.Module, device=None, **optimizer_kwargs) -> TrainState:
    """Move ``model`` to ``device`` (CUDA by default; raises without a CUDA
    device) and build its optimizer from ``optimizer_kwargs``
    (:func:`~cinemri_tpu_torch.train.optim.make_optimizer`)."""
    model = model.to(resolve_device(device))
    return TrainState(model, make_optimizer(model.parameters(), **optimizer_kwargs))


def _to(a, device: torch.device):
    if isinstance(a, Complex):
        return Complex(a.re.to(device), a.im.to(device))
    return a.to(device)


def _loss_and_output(model: nn.Module, batch: Dict):
    dev = next(model.parameters()).device
    args = (batch["masked_kspace"], batch["mask"])
    if "sens_maps" in batch:
        args = args + (batch["sens_maps"],)
    output = model(*(_to(a, dev) for a in args))
    target, output_c = center_crop_to_smallest(_to(batch["target"], dev), output)
    weight = batch.get("sample_weight")
    loss = ssim_loss(output_c, target, sample_weight=None if weight is None else _to(weight, dev))
    return loss, output_c, target


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(Σ ‖t‖²)`` over ``tensors``, as ``optax.global_norm``."""
    return torch.sqrt(sum((t * t).sum() for t in tensors))


def make_train_step() -> Callable:
    """``(state, batch) -> (state, aux)`` with aux ``loss``, ``output`` and
    ``target`` (both cropped) and ``grad_norm``, the global L2 norm of the
    gradients before any clip."""

    def train_step(state: TrainState, batch: Dict):
        opt = state.optimizer
        opt.adam.zero_grad(set_to_none=True)
        loss, output, target = _loss_and_output(state.model, batch)
        loss.backward()
        gnorm = global_norm(p.grad for p in opt.params if p.grad is not None)
        opt.step(gnorm)
        state.step += 1
        return state, {"loss": loss.detach(), "output": output.detach(), "target": target,
                       "grad_norm": gnorm}

    return train_step


def make_eval_step() -> Callable:
    """``(state, batch) -> aux`` with ``loss``, ``output`` and ``target``,
    without gradients."""

    def eval_step(state: TrainState, batch: Dict):
        with torch.no_grad():
            loss, output, target = _loss_and_output(state.model, batch)
        return {"loss": loss, "output": output, "target": target}

    return eval_step
