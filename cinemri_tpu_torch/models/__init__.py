"""Model layer of the port (counterpart of ``cinemri_tpu/models``).

Every non-recurrent variant of the three families is ported: VarNet and
CineNet 2D / 3D / XT / XF, XPDNet 2D / XT / XF. The CRNN variants raise
``NotImplementedError`` naming their ROADMAP item (Queue 1, item 12).
"""

from __future__ import annotations

from typing import Optional

import torch

from cinemri_tpu_torch import resolve_device
from cinemri_tpu_torch.models import denoisers
from cinemri_tpu_torch.models.cinenet import CineNet, CineNetCascade
from cinemri_tpu_torch.models.init import torch_style_init
from cinemri_tpu_torch.models.varnet import SensitivityModel, VarNet, VarNetCascade
from cinemri_tpu_torch.models.xpdnet import XPDNet, XPDNetBlock, XPDNetSensitivityModel

__all__ = [
    "VarNet",
    "VarNetCascade",
    "SensitivityModel",
    "CineNet",
    "CineNetCascade",
    "XPDNet",
    "XPDNetBlock",
    "XPDNetSensitivityModel",
    "denoisers",
    "build_model",
    "torch_style_init",
]

_MODELS = {"varnet": VarNet, "cinenet": CineNet, "xpdnet": XPDNet}


def build_model(
    family: str,
    dynamic_type: str = "XF",
    device=None,
    generator: Optional[torch.Generator] = None,
    **kwargs,
):
    """Build a model by family and dynamic type, torch-style initialized.

    ``device`` defaults to CUDA and raises without a CUDA device; pass
    ``device="cpu"`` to build on the CPU. ``generator`` draws the initial
    weights (a CPU ``torch.Generator`` seeded 0 when omitted). Keyword
    arguments go to the model class under the JAX package's names
    (VarNet: ``num_cascades``, ``sens_chans``, ``sens_pools``, ``chans``,
    ``pools``, ...; CineNet: ``num_cascades``, ``cg_iters``, ``chans``,
    ``pools``, ``weight_sharing``, ``kernel_dc``, ``remat``,
    ``remat_policy``; XPDNet: ``num_cascades``, ``sens_chans``,
    ``sens_pools``, ``n_scales``, ``n_filters_per_scale``,
    ``n_convs_per_scale``, ``n_first_convs``, ``first_conv_n_filters``,
    ``res``, ``primal_only``, ``n_primal``, ``n_dual``, ``norm_buffers``,
    ...); unknown keys raise.
    """
    dev = resolve_device(device)
    family = family.lower()
    allowed = {
        "varnet": ("2D", "3D", "XT", "XF", "CRNN"),
        "cinenet": ("2D", "3D", "XT", "XF", "CRNN"),
        "xpdnet": ("2D", "XT", "XF", "CRNN"),
    }
    if family not in allowed:
        raise ValueError(f"unknown model family {family!r}")
    if dynamic_type not in allowed[family]:
        raise ValueError(
            f"dynamic_type {dynamic_type!r} not supported for {family}: {allowed[family]}"
        )
    if dynamic_type == "CRNN":
        raise NotImplementedError(
            f"{family} CRNN is not ported yet (ROADMAP Queue 1, item 12: CRNN)")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = _MODELS[family](dynamic_type=dynamic_type, **kwargs)
    torch_style_init(model, generator)
    return model.to(dev)
