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

With a ``data`` mesh, :func:`make_train_step` is the explicit schedule of
the JAX package's ``shard_map`` step, one process per device: the global
weight denominator first, each rank's loss contribution over it, a backward
with no communication, then **one** all-reduce of the whole gradient as a
flat buffer, the loss all-reduced as a scalar, and the same clip and Adam
update on every rank. Not ``DistributedDataParallel``: DDP averages
gradients where the JAX step sums contributions over a global denominator
(padded rows carry weight 0), and its bucket hooks interact with the remat
replay (``models/remat.py``) and with parameters a call leaves unused.

On a mesh with ``plane`` and ``coil`` dims beside ``data`` (or without
``data``), the model splits its plane batches and coils over them
(``plane_axis``, ``coil_axis``) and makes its own collectives in the forward
and backward (``parallel/autograd.py``); every rank of a plane and coil
group holds the same rows, and the step keeps two rules. A weight's
gradient is summed over ``data`` and over each axis whose ranks computed a
part of it (``model.partial_parameters()``: the plane nets on ``plane``,
the sens nets on ``coil``), but counted once where every rank of an axis
computed it whole (λ, the CRNN trunk, the plane nets on ``coil``): each
gradient is scaled by 1 / (the number of ranks that hold it replicated)
and the one flat buffer is all-reduced over the whole world, so every rank
takes the same update and the weights stay bit-identical. And every rank
agrees on the stop flag: the scalar all-reduces run over the whole world,
with only the ranks at plane and coil index 0 contributing the weights and
the loss, so each data shard counts once.

A step opens the program spans ``cinemri.train.forward`` (the loss and
output), ``cinemri.train.backward`` and ``cinemri.train.optimizer`` (the
gradient all-reduces, the global norm and the update; ``instrument.span``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict

import torch
from torch import nn

from cinemri_tpu_torch import resolve_device
from cinemri_tpu_torch.data.transforms import center_crop_to_smallest
from cinemri_tpu_torch.instrument import span
from cinemri_tpu_torch.ops.cplx import Complex
from cinemri_tpu_torch.ops.ssim import ssim_loss
from cinemri_tpu_torch.parallel.distributed import all_reduce_sum
from cinemri_tpu_torch.parallel.mesh import mesh_lead, set_mesh
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


def _loss_and_output(model: nn.Module, batch: Dict, denominator=None):
    """The step's loss, cropped output and target. With ``denominator`` (a
    data-parallel step's global weight sum), the loss is this rank's
    contribution ``Σ w·l / denominator``, rows without a weight counting 1."""
    dev = next(model.parameters()).device
    args = (batch["masked_kspace"], batch["mask"])
    if "sens_maps" in batch:
        args = args + (batch["sens_maps"],)
    output = model(*(_to(a, dev) for a in args))
    target, output_c = center_crop_to_smallest(_to(batch["target"], dev), output)
    weight = batch.get("sample_weight")
    if denominator is not None:
        weight = _sample_weight(batch, dev)
    elif weight is not None:
        weight = _to(weight, dev)
    loss = ssim_loss(output_c, target, sample_weight=weight, denominator=denominator)
    return loss, output_c, target


def _sample_weight(batch: Dict, dev: torch.device) -> torch.Tensor:
    weight = batch.get("sample_weight")
    if weight is None:
        return torch.ones(batch["target"].shape[0], device=dev)
    return _to(weight, dev).to(torch.float32)


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(Σ ‖t‖²)`` over ``tensors``, as ``optax.global_norm``."""
    return torch.sqrt(sum((t * t).sum() for t in tensors))


def _all_reduce_grads(params, scales, group=None) -> None:
    """THE one gradient all-reduce: every parameter in a fixed layout,
    zeros where this call left a parameter unused, each gradient scaled by
    its ``scales`` entry (1 / its replica count) first."""
    parts = []
    for p, s in zip(params, scales):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        parts.append((g if s == 1.0 else g * s).reshape(-1))
    flat = torch.cat(parts)
    all_reduce_sum(flat, "grad", group)
    offset = 0
    for p in params:
        if p.grad is not None:
            p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()


def _replica_scales(model: nn.Module, params, sizes: Dict[str, int]):
    """Per parameter of ``params``, 1 / the number of ranks over the model
    axes of the mesh (``sizes``, all dims but ``data``) that hold its
    gradient replicated: the axes not in its ``partial_parameters()``
    entry. The model must name every one of those axes and, where one has
    more than one rank, say which of its weights are partial on it."""
    split = {a: n for a, n in sizes.items() if n > 1}
    named = set(filter(None, (getattr(model, "plane_axis", ""), getattr(model, "coil_axis", ""))))
    missing = [a for a in split if a not in named]
    if missing:
        raise ValueError(
            f"mesh dims {missing} are not axes of the model: build it with plane_axis / "
            "coil_axis naming them (the batch's coils are split over 'coil' by shard_batch)")
    if split and not hasattr(model, "partial_parameters"):
        raise ValueError(
            f"{type(model).__name__} has no partial_parameters(): on the mesh dims {list(split)} "
            "the step cannot tell which of its gradients each rank holds only a part of")
    partial = model.partial_parameters() if split else {}
    by_id = {id(p): partial.get(n, ()) for n, p in model.named_parameters()}
    return [1.0 / math.prod(n for a, n in split.items() if a not in by_id.get(id(p), ()))
            for p in params]


def make_train_step(mesh=None, data_axis: str = "data") -> Callable:
    """``(state, batch, stop=False) -> (state, aux)`` with aux ``loss``,
    ``output`` and ``target`` (both cropped) and ``grad_norm``, the global
    L2 norm of the gradients before any clip. Without a mesh ``stop`` is
    unused and the step makes no collective.

    With a ``mesh`` (:func:`~cinemri_tpu_torch.parallel.make_mesh`), the
    parallel step, run under :func:`~cinemri_tpu_torch.parallel.set_mesh`:
    ``batch`` holds this rank's rows (and coils, on a ``coil`` dim),
    ``loss`` and ``grad_norm`` are the global batch's (the same on every
    rank), ``output`` and ``target`` this rank's rows, and aux ``stop`` (a
    device bool) is true on every rank when any rank passed ``stop=True``:
    the flag rides the step's scalar all-reduce, so the ranks agree on a
    preemption without another collective. Per step: one gradient
    all-reduce of Σ numel × 4 bytes and two scalar all-reduces
    (``parallel.distributed.COLLECTIVES``), plus the model's own ``plane``
    and ``coil`` collectives (module docstring)."""
    lead = mesh_lead(mesh, data_axis)
    sizes = {} if mesh is None else {
        n: k for n, k in zip(mesh.mesh_dim_names, mesh.shape) if n != data_axis}
    scales = {}  # the model -> its replica scales on this mesh, taken at its first step

    def train_step(state: TrainState, batch: Dict, stop: bool = False):
        opt = state.optimizer
        opt.adam.zero_grad(set_to_none=True)
        if mesh is not None and scales.get("model") is not state.model:
            scales.update(model=state.model, of=_replica_scales(state.model, opt.params, sizes))
        gden = None
        with set_mesh(mesh):
            with span("cinemri.train.forward"):
                if mesh is not None:
                    # the global weight denominator first: it depends on no
                    # parameter, so each rank's loss is a contribution whose
                    # sum is the global weighted mean, and the gradients sum
                    # the same way; the ranks at plane and coil index 0 count
                    # each row
                    dev = next(state.model.parameters()).device
                    w = _sample_weight(batch, dev).sum().reshape(1)
                    gden = all_reduce_sum(w if lead else torch.zeros_like(w),
                                          "scalar").clamp_min(1.0)[0]
                loss, output, target = _loss_and_output(state.model, batch, gden)
            with span("cinemri.train.backward"):
                loss.backward()
        aux = {}
        with span("cinemri.train.optimizer"):
            if mesh is not None:
                _all_reduce_grads(opt.params, scales["of"])
                loss = loss.detach() if lead else torch.zeros_like(loss.detach())
                scalars = torch.stack([loss, torch.full((), float(stop), device=loss.device)])
                all_reduce_sum(scalars, "scalar")
                loss, aux["stop"] = scalars[0], scalars[1] > 0
            gnorm = global_norm(p.grad for p in opt.params if p.grad is not None)
            opt.step(gnorm)
        state.step += 1
        aux.update(loss=loss.detach(), output=output.detach(), target=target, grad_norm=gnorm)
        return state, aux

    return train_step


def make_eval_step(mesh=None) -> Callable:
    """``(state, batch) -> aux`` with ``loss``, ``output`` and ``target``,
    without gradients; under :func:`~cinemri_tpu_torch.parallel.set_mesh`
    with a ``mesh`` (the batch is this rank's part, as in the train step,
    and ``loss`` this rank's rows')."""

    def eval_step(state: TrainState, batch: Dict):
        with torch.no_grad(), set_mesh(mesh):
            loss, output, target = _loss_and_output(state.model, batch)
        return {"loss": loss, "output": output, "target": target}

    return eval_step
