"""Serving: bind a model's weights once and answer reconstruction requests.

Counterpart of ``cinemri_tpu/serve.py``. A request is
``(kspace_re, kspace_im, mask) -> image`` in float32, the signature of the
JAX package's exported artifact: k-space ``(n, t, c, h, w)`` twice, mask
``(n, t|1, 1, h, 1)``, image ``(n, t, h, w)``. A model that takes
sensitivity maps (CineNet) gets them with the request, as ``(sens_re,
sens_im)`` of shape ``(n, 1, c, h, w)``, the JAX artifact's extra two
arguments. A batch of n volumes is reconstructed one volume at a time
(:func:`serial_batch`), maps included, as the JAX package serves batches.
Requests run under ``torch.inference_mode()``, in the program spans
``cinemri.serve`` and, for the copies to the device, ``cinemri.serve.h2d``
(``instrument.span``). A model with a ``coil_axis``
takes the whole request and keeps this rank's coils of the k-space and maps
(``parallel.coil_shard``), under the ambient mesh (``parallel.set_mesh``)
that every rank of its coil group serves in.

:func:`export_model` writes the weight-bound forward as a ``torch.export``
artifact (``.pt2``, where the JAX package writes ``.stablehlo``) with the
same raw-f32 signature, and :func:`load_exported` serves it. The JAX
artifact runs without the model code; this one runs without the model
classes but calls the port's CUDA kernels as the custom ops
``torch.ops.cinemri.*``, so the process that loads it needs
``cinemri_tpu_torch.ops.kernels`` (imported by :func:`load_exported`).
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import Callable, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from cinemri_tpu_torch import resolve_device
from cinemri_tpu_torch.instrument import span
from cinemri_tpu_torch.ops.cplx import Complex
from cinemri_tpu_torch.parallel.mesh import coil_shard

__all__ = ["serial_batch", "bind_model", "export_model", "load_exported"]


def serial_batch(fn: Callable) -> Callable:
    """Wrap a single-volume forward into a batched one that reconstructs the
    volumes sequentially: batch n costs n single-volume forwards, each
    with the single-volume working set."""

    def batched(*args):
        n = args[0].shape[0]
        outs = [fn(*(a[i : i + 1] for a in args)) for i in range(n)]
        return torch.cat(outs, dim=0)

    return batched


def _as_f32(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return a.to(device=device, dtype=torch.float32).contiguous()


def _unit(model: nn.Module) -> Callable:
    """The single-volume forward on raw tensors: ``(kspace_re, kspace_im,
    mask[, sens_re, sens_im]) -> image``, this rank's coils on a
    ``coil_axis``."""
    coil_axis = getattr(model, "coil_axis", "")

    def unit(kre, kim, mask, *sens):
        k = coil_shard(Complex(kre, kim), coil_axis)
        if sens:
            return model(k, mask, coil_shard(Complex(*sens), coil_axis))
        return model(k, mask)

    return unit


def bind_model(
    model: nn.Module,
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    device=None,
) -> Callable:
    """Bind ``model`` (and ``state_dict``, when given) to ``device`` once;
    return ``serve(kspace_re, kspace_im, mask, sens_re=None, sens_im=None)
    -> image``.

    Sensitivity maps go to models that take them (CineNet) and are left
    out for models that estimate their own (VarNet). ``device`` defaults to
    CUDA and raises without a CUDA device. Inputs may be numpy arrays or
    tensors; the image is a float32 tensor on ``device``.
    """
    dev = resolve_device(device)
    model = model.to(dev)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model.eval()

    batched = serial_batch(_unit(model))

    def serve(kspace_re, kspace_im, mask, sens_re=None, sens_im=None) -> torch.Tensor:
        if (sens_re is None) != (sens_im is None):
            raise ValueError("pass both sens_re and sens_im, or neither")
        args = (kspace_re, kspace_im, mask) + (() if sens_re is None else (sens_re, sens_im))
        with span("cinemri.serve"), torch.inference_mode():
            with span("cinemri.serve.h2d"):
                args = [_as_f32(a, dev) for a in args]
            return batched(*args)

    return serve


class _Served(nn.Module):
    """The exported forward: raw f32 tensors in, the image out; the model's
    weights are its own parameters, so the artifact carries them."""

    def __init__(self, model: nn.Module, serial: bool):
        super().__init__()
        self.model = model
        self.fn = serial_batch(_unit(model)) if serial else _unit(model)

    def forward(self, kspace_re, kspace_im, mask, sens_re=None, sens_im=None):
        sens = () if sens_re is None else (sens_re, sens_im)
        return self.fn(kspace_re, kspace_im, mask, *sens)


def export_model(
    model: nn.Module,
    state_dict: Optional[Mapping[str, torch.Tensor]],
    example_kspace: Complex,
    example_mask: torch.Tensor,
    path: Optional[Union[str, Path]] = None,
    sens_maps: Optional[Complex] = None,
    serial: bool = False,
) -> bytes:
    """Export a weight-bound forward to a serialized ``torch.export``
    artifact; returns its bytes and writes them to ``path`` when given.

    The artifact's signature is ``(kspace_re, kspace_im, mask) -> image``,
    plus ``(sens_re, sens_im)`` when ``sens_maps`` is given (CineNet), at the
    example's shapes, on the device of the model's weights. ``state_dict``,
    when given, is loaded first. ``serial=True`` bakes :func:`serial_batch`
    in, so a batch-n example gives an artifact that reconstructs its volumes
    one at a time. The kernels enter the graph as the custom ops
    ``torch.ops.cinemri.*``. One eager forward on the example runs first,
    outside any trace, so the DFT matrices and constant λ it caches on the
    device go into the artifact as constants (``ops.kernels.trace_safe``).
    The trace runs under ``no_grad`` and outside ``inference_mode``.
    """
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model.eval()
    dev = next(model.parameters()).device
    args = [example_kspace.re, example_kspace.im, example_mask]
    if sens_maps is not None:
        args += [sens_maps.re, sens_maps.im]
    args = tuple(_as_f32(a, dev) for a in args)
    served = _Served(model, serial)
    with torch.inference_mode(False), torch.no_grad():
        served(*args)
        exported = torch.export.export(served, args)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = buf.getvalue()
    if path is not None:
        Path(path).write_bytes(blob)
    return blob


def load_exported(source: Union[bytes, bytearray, str, Path]) -> Callable:
    """Load an artifact of :func:`export_model` (bytes or a path); returns
    ``fn(kspace_re, kspace_im, mask[, sens_re, sens_im]) -> image``, which
    takes numpy arrays or tensors, moves them as f32 to the artifact's
    device and runs under ``torch.inference_mode()``. Imports
    ``cinemri_tpu_torch.ops.kernels``, which registers the ops the artifact
    calls."""
    import cinemri_tpu_torch.ops.kernels  # noqa: F401  (the torch.ops.cinemri namespace)

    blob = bytes(source) if isinstance(source, (bytes, bytearray)) else Path(source).read_bytes()
    exported = torch.export.load(io.BytesIO(blob))
    weights = list(exported.state_dict.values()) + list(exported.constants.values())
    dev = weights[0].device if weights else torch.device("cpu")
    module = exported.module()

    def fn(*args) -> torch.Tensor:
        with torch.inference_mode():
            return module(*(_as_f32(a, dev) for a in args))

    return fn
