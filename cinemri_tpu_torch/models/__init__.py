"""Model layer of the port (counterpart of ``cinemri_tpu/models``).

Every variant of the three families is ported: VarNet and CineNet 2D / 3D
/ XT / XF / CRNN, XPDNet 2D / XT / XF / CRNN (the CRNN hybrids are
``models/recurrent.py``). What is not ported of them (the packed layouts,
bf16) raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch

from cinemri_tpu_torch import resolve_device
from cinemri_tpu_torch.models import denoisers
from cinemri_tpu_torch.models.cinenet import CineNet, CineNetCascade
from cinemri_tpu_torch.models.init import torch_style_init
from cinemri_tpu_torch.models.recurrent import CineNetRNN, CRNNTrunk, VarNetRNN, XPDNetRNN
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
    "VarNetRNN",
    "CineNetRNN",
    "XPDNetRNN",
    "CRNNTrunk",
    "denoisers",
    "build_model",
    "check_plane_axis",
    "torch_style_init",
]

_MODELS = {"varnet": VarNet, "cinenet": CineNet, "xpdnet": XPDNet}
_CRNN_MODELS = {"varnet": VarNetRNN, "cinenet": CineNetRNN, "xpdnet": XPDNetRNN}


def check_plane_axis(dynamic_type: str, plane_axis) -> None:
    """The JAX CLI's check: only XT and XF have plane batches to split."""
    if plane_axis and dynamic_type not in ("XT", "XF"):
        raise ValueError(
            "--plane_devices shards the XT/XF rotated-plane batches; "
            f"dynamic_type {dynamic_type!r} has none"
        )


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
    ...; CRNN: ``num_cascades``, ``chans``, ``kernel_dc``, ``remat``, and
    ``sens_chans`` / ``sens_pools`` (VarNet, XPDNet), ``cg_iters``
    (CineNet), ``primal_only`` / ``n_primal`` / ``n_dual`` (XPDNet));
    unknown keys raise. ``coil_axis`` (every family and type) and
    ``plane_axis`` (XT and XF only; another type raises the JAX CLI's
    ``ValueError``) name dims of the ambient mesh (``parallel.set_mesh``)
    the model splits its coils and its plane batches over.
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
    check_plane_axis(dynamic_type, kwargs.get("plane_axis", ""))
    if dynamic_type == "CRNN" and "plane_axis" in kwargs:
        kwargs.pop("plane_axis")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if dynamic_type == "CRNN":
        model = _CRNN_MODELS[family](**kwargs)
    else:
        model = _MODELS[family](dynamic_type=dynamic_type, **kwargs)
    torch_style_init(model, generator)
    return model.to(dev)
