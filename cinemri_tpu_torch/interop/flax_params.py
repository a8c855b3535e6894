"""JAX-package params (nested dict of numpy arrays) -> the port's state_dict.

Carries weights from ``cinemri_tpu`` flax models into the port's modules
without importing JAX: the caller hands over the params tree with numpy
leaves (``jax.tree.map(np.asarray, params)``). The inverse of
``cinemri_tpu/interop/port.py::conv_w`` / ``convT_w``:

  * a Conv kernel goes HWIO -> OIHW;
  * a ConvTranspose kernel goes ``(kh, kw, I, O)`` -> ``(I, O, kh, kw)`` with
    both spatial axes flipped (torch correlates with the flipped kernel,
    flax's ``ConvTranspose`` with the kernel as stored).

Tree names, VarNet: ``sens_net/NormUnet_0/Unet_0/…``,
``cascades/net_xf|net_yf/Unet_0/…`` (or ``cascades/plane_net`` with weight
sharing; shared by all cascades, no cascade axis) and ``lambda_reg
(num_cascades,)``. CineNet: ``cascades/net_xf|net_yf/…`` (or
``cascades/plane_net``), each a plain ``Unet`` tree, and ``lambda_reg``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = [
    "conv_weight",
    "conv_transpose_weight",
    "unet_state_dict",
    "varnet_state_dict",
    "cinenet_state_dict",
]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable C-order copy


def conv_weight(kernel) -> torch.Tensor:
    """flax Conv kernel (kh, kw, I, O) -> torch Conv2d weight (O, I, kh, kw)."""
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def conv_transpose_weight(kernel) -> torch.Tensor:
    """flax ConvTranspose kernel (kh, kw, I, O) -> torch ConvTranspose2d
    weight (I, O, kh, kw), spatially flipped."""
    w = np.transpose(np.asarray(kernel), (2, 3, 0, 1))
    return _t(np.flip(w, axis=(2, 3)))


def unet_state_dict(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """flax ``Unet`` params -> entries of the port's ``Unet`` under ``prefix``."""
    pools = sum(1 for k in tree if k.startswith("TransposeConvBlock_"))
    out = {}

    def block(name: str, dst: str):
        out[f"{prefix}{dst}.conv0.weight"] = conv_weight(tree[name]["Conv_0"]["kernel"])
        out[f"{prefix}{dst}.conv1.weight"] = conv_weight(tree[name]["Conv_1"]["kernel"])

    for j in range(pools):
        block(f"ConvBlock_{j}", f"down.{j}")
    block(f"ConvBlock_{pools}", "bottom")
    for i in range(pools):
        out[f"{prefix}up_transpose.{i}.conv.weight"] = conv_transpose_weight(
            tree[f"TransposeConvBlock_{i}"]["ConvTranspose_0"]["kernel"]
        )
        block(f"ConvBlock_{pools + 1 + i}", f"up_conv.{i}")
    out[f"{prefix}final.weight"] = conv_weight(tree["Conv_0"]["kernel"])
    out[f"{prefix}final.bias"] = _t(tree["Conv_0"]["bias"])
    return out


def varnet_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``VarNet`` params (with or without the ``params`` collection key)
    -> ``cinemri_tpu_torch.models.VarNet`` state_dict."""
    p = params.get("params", params)
    out = unet_state_dict(p["sens_net"]["NormUnet_0"]["Unet_0"], "sens_net.norm_unet.unet.")
    for name, sub in p["cascades"].items():  # net_xf + net_yf, or plane_net
        out.update(unet_state_dict(sub["Unet_0"], f"cascades.{name}.unet."))
    out["lambda_reg"] = _t(p["lambda_reg"])
    return out


def cinenet_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``CineNet`` params (with or without the ``params`` collection
    key) -> ``cinemri_tpu_torch.models.CineNet`` state_dict."""
    p = params.get("params", params)
    out = {}
    for name, sub in p["cascades"].items():  # net_xf + net_yf, or plane_net
        out.update(unet_state_dict(sub, f"cascades.{name}."))
    out["lambda_reg"] = _t(p["lambda_reg"])
    return out
