"""Serving: bind a model's weights once and answer reconstruction requests.

Counterpart of ``cinemri_tpu/serve.py``. A request is
``(kspace_re, kspace_im, mask) -> image`` in float32, the signature of the
JAX package's exported artifact: k-space ``(n, t, c, h, w)`` twice, mask
``(n, t|1, 1, h, 1)``, image ``(n, t, h, w)``. A batch of n volumes is
reconstructed one volume at a time (:func:`serial_batch`), as the JAX
package serves batches. Requests run under ``torch.inference_mode()``.

The ``torch.export`` artifact is not ported yet (ROADMAP Queue 1, item 14).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from cinemri_tpu_torch import resolve_device
from cinemri_tpu_torch.ops.cplx import Complex

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
    return ``serve(kspace_re, kspace_im, mask) -> image``.

    ``device`` defaults to CUDA and raises without a CUDA device. Inputs
    may be numpy arrays or tensors; the image is a float32 tensor on
    ``device``.
    """
    dev = resolve_device(device)
    model = model.to(dev)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model.eval()

    def unit(kre, kim, mask):
        return model(Complex(kre, kim), mask)

    batched = serial_batch(unit)

    def serve(kspace_re, kspace_im, mask) -> torch.Tensor:
        with torch.inference_mode():
            return batched(_as_f32(kspace_re, dev), _as_f32(kspace_im, dev), _as_f32(mask, dev))

    return serve
