"""cinemri_tpu_torch — the PyTorch/CUDA port of cinemri_tpu.

Dynamic cine cardiac MRI reconstruction (VarNet and its relatives) in
PyTorch, with the JAX package's Pallas kernels replaced by CUDA kernels
written by hand for Hopper (``csrc/``, bound with ctypes in
``ops/kernels/``). The layout mirrors ``cinemri_tpu/``: each
``cinemri_tpu_torch/<path>.py`` holds the counterpart of
``cinemri_tpu/<path>.py`` with the same public names and the same array
layouts at public functions:

  * k-space             : ``(b, t, c, h, w)`` Complex (re, im) f32 pair;
  * sampling mask       : ``(b, t|1, 1, h, 1)`` float32;
  * sensitivity maps    : ``(b, 1, c, h, w)`` Complex;
  * model output        : ``(b, t, h, w)`` float32 magnitude.

Entry points run on the CUDA device unless the caller asks for the CPU;
:func:`resolve_device` raises when no CUDA device is present.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["__version__", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says otherwise.

    ``None`` means ``"cuda"``. Asking for CUDA on a machine without a CUDA
    device raises instead of running on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
