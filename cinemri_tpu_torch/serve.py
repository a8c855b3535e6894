"""Serving: bind a model's weights once and answer reconstruction requests.

Counterpart of ``cinemri_tpu/serve.py``. A request is
``(kspace_re, kspace_im, mask) -> image`` in float32, the signature of the
JAX package's exported artifact: k-space ``(n, t, c, h, w)`` twice, mask
``(n, t|1, 1, h, 1)``, image ``(n, t, h, w)``. A model that takes
sensitivity maps (CineNet) gets them with the request, as ``(sens_re,
sens_im)`` of shape ``(n, 1, c, h, w)``, the JAX artifact's extra two
arguments. A batch of n volumes is reconstructed one volume at a time
(:func:`serial_batch`), maps included, as the JAX package serves batches.
Requests run under ``torch.inference_mode()``. A model with a ``coil_axis``
takes the whole request and keeps this rank's coils of the k-space and maps
(``parallel.coil_shard``), under the ambient mesh (``parallel.set_mesh``)
that every rank of its coil group serves in.

The ``torch.export`` artifact is not ported yet (ROADMAP Queue 1, item 14).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from cinemri_tpu_torch import resolve_device
from cinemri_tpu_torch.ops.cplx import Complex
from cinemri_tpu_torch.parallel.mesh import coil_shard

__all__ = ["serial_batch", "bind_model"]


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

    coil_axis = getattr(model, "coil_axis", "")

    def unit(kre, kim, mask, *sens):
        k = coil_shard(Complex(kre, kim), coil_axis)
        if sens:
            return model(k, mask, coil_shard(Complex(*sens), coil_axis))
        return model(k, mask)

    batched = serial_batch(unit)

    def serve(kspace_re, kspace_im, mask, sens_re=None, sens_im=None) -> torch.Tensor:
        if (sens_re is None) != (sens_im is None):
            raise ValueError("pass both sens_re and sens_im, or neither")
        args = (kspace_re, kspace_im, mask) + (() if sens_re is None else (sens_re, sens_im))
        with torch.inference_mode():
            return batched(*(_as_f32(a, dev) for a in args))

    return serve
