"""JAX-package params (nested dict of numpy arrays) -> the port's state_dict.

Carries weights from ``cinemri_tpu`` flax models into the port's modules
without importing JAX: the caller hands over the params tree with numpy
leaves (``jax.tree.map(np.asarray, params)``). The inverse of
``cinemri_tpu/interop/port.py::conv_w`` / ``convT_w``:

  * a Conv kernel goes ``(k..., I, O)`` -> ``(O, I, k...)`` (2-D and 3-D);
  * a ConvTranspose kernel goes ``(k..., I, O)`` -> ``(I, O, k...)`` with
    every spatial axis flipped (torch correlates with the flipped kernel,
    flax's ``ConvTranspose`` with the kernel as stored).

Tree names, VarNet: ``sens_net/NormUnet_0/Unet_0/…``,
``cascades/net_xf|net_yf/Unet_0/…`` (or ``cascades/plane_net`` with weight
sharing; ``cascades/net`` for 2D and 3D, a NormUnet or NormUnet3D; shared
by all cascades, no cascade axis) and ``lambda_reg (num_cascades,)``.
CineNet: ``cascades/net_xf|net_yf/…`` (or ``cascades/plane_net``;
``cascades/net`` for 2D and 3D), each a plain ``Unet`` tree, and
``lambda_reg``. XPDNet: ``sens_net/Unet_0/…``, and per cascade (a leading
axis of length ``num_cascades`` on every leaf) the MWCNNs
``cascades/image_net_xf|image_net_yf`` (or ``cascades/image_net``: 2D, or
weight sharing) and, with ``primal_only`` off, ``cascades/kspace_net``.
CRNN models: the trunk ``iterations/trunk`` (``trunk`` for XPDNet with
``primal_only`` off) holds ``bcrnn/cell/i2h_h2h_ih2ih__f<sizes>``,
``conv{1,2,3}_xh__f<sizes>`` and ``conv4_x``, the fused convs named with
their per-input channel counts (matched here by prefix); VarNet and CineNet
add one ``iterations/lambda_reg``, VarNet and XPDNet their ``sens_net``,
and XPDNet with ``primal_only`` off ``kspace_net_{i}``.
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
    "mwcnn_state_dict",
    "kspace_cnn_state_dict",
    "xpdnet_state_dict",
    "crnn_trunk_state_dict",
    "varnet_rnn_state_dict",
    "cinenet_rnn_state_dict",
    "xpdnet_rnn_state_dict",
]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable C-order copy


def conv_weight(kernel) -> torch.Tensor:
    """flax Conv kernel (k..., I, O) -> torch Conv2d / Conv3d weight (O, I, k...)."""
    k = np.asarray(kernel)
    d = k.ndim - 2
    return _t(np.transpose(k, (d + 1, d) + tuple(range(d))))


def conv_transpose_weight(kernel) -> torch.Tensor:
    """flax ConvTranspose kernel (k..., I, O) -> torch ConvTranspose2d /
    ConvTranspose3d weight (I, O, k...), flipped along every spatial axis."""
    k = np.asarray(kernel)
    d = k.ndim - 2
    w = np.transpose(k, (d, d + 1) + tuple(range(d)))
    return _t(np.flip(w, axis=tuple(range(2, d + 2))))


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
    for name, sub in p["cascades"].items():  # net_xf + net_yf, plane_net, or net (2D / 3D)
        out.update(unet_state_dict(sub["Unet_0"], f"cascades.{name}.unet."))
    out["lambda_reg"] = _t(p["lambda_reg"])
    return out


def mwcnn_state_dict(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """flax ``MWCNN`` params -> entries of the port's ``MWCNN`` under ``prefix``."""
    n = sum(1 for k in tree if k.startswith("MWConvBlock_"))
    out = {f"{prefix}blocks.{i}.conv.weight": conv_weight(tree[f"MWConvBlock_{i}"]["Conv_0"]["kernel"])
           for i in range(n)}
    out[f"{prefix}final.weight"] = conv_weight(tree["Conv_0"]["kernel"])
    out[f"{prefix}final.bias"] = _t(tree["Conv_0"]["bias"])
    return out


def kspace_cnn_state_dict(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """flax ``KSpaceCNN`` params -> entries of the port's ``KSpaceCNN``."""
    out = {}
    for i in range(sum(1 for k in tree if k.startswith("Conv_"))):
        out[f"{prefix}convs.{i}.weight"] = conv_weight(tree[f"Conv_{i}"]["kernel"])
        out[f"{prefix}convs.{i}.bias"] = _t(tree[f"Conv_{i}"]["bias"])
    return out


def xpdnet_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``XPDNet`` params (with or without the ``params`` collection
    key) -> ``cinemri_tpu_torch.models.XPDNet`` state_dict: cascade ``i``
    takes slice ``i`` of the leading axis of every ``cascades`` leaf."""
    p = params.get("params", params)
    out = unet_state_dict(p["sens_net"]["Unet_0"], "sens_net.unet.")
    cascades = p["cascades"]
    num = len(next(iter(cascades.values()))["Conv_0"]["kernel"])  # every net has a Conv_0
    for i in range(num):
        for name, sub in cascades.items():
            sub_i = _slice(sub, i)
            if name == "kspace_net":
                out.update(kspace_cnn_state_dict(sub_i, f"cascades.{i}.kspace_net."))
            else:  # image_net_xf, image_net_yf or image_net
                out.update(mwcnn_state_dict(sub_i, f"cascades.{i}.{name}."))
    return out


def _slice(tree: Mapping, i: int):
    return {k: _slice(v, i) if isinstance(v, Mapping) else np.asarray(v)[i] for k, v in tree.items()}


def cinenet_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``CineNet`` params (with or without the ``params`` collection
    key) -> ``cinemri_tpu_torch.models.CineNet`` state_dict."""
    p = params.get("params", params)
    out = {}
    for name, sub in p["cascades"].items():  # net_xf + net_yf, plane_net, or net (2D / 3D)
        out.update(unet_state_dict(sub, f"cascades.{name}."))
    out["lambda_reg"] = _t(p["lambda_reg"])
    return out


def _by_prefix(tree: Mapping, prefix: str) -> Mapping:
    """The one entry of ``tree`` whose name is ``prefix`` or starts with
    ``prefix + "__f"`` (a fused conv's suffix carries its input widths)."""
    hits = [v for k, v in tree.items() if k == prefix or k.startswith(prefix + "__f")]
    if len(hits) != 1:
        raise KeyError(f"expected one module named {prefix!r}[__f...], found {len(hits)}")
    return hits[0]


def crnn_trunk_state_dict(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """flax ``CRNNTrunk`` params -> entries of the port's ``CRNNTrunk``."""
    out = {}
    for src, dst in ((_by_prefix(tree["bcrnn"]["cell"], "i2h_h2h_ih2ih"), "bcrnn.cell.conv"),
                     (_by_prefix(tree, "conv1_xh"), "conv1"), (_by_prefix(tree, "conv2_xh"), "conv2"),
                     (_by_prefix(tree, "conv3_xh"), "conv3"), (_by_prefix(tree, "conv4_x"), "conv4")):
        out[f"{prefix}{dst}.weight"] = conv_weight(src["kernel"])
        out[f"{prefix}{dst}.bias"] = _t(src["bias"])
    return out


def varnet_rnn_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``VarNetRNN`` params -> ``cinemri_tpu_torch.models.VarNetRNN`` state_dict."""
    p = params.get("params", params)
    out = unet_state_dict(p["sens_net"]["NormUnet_0"]["Unet_0"], "sens_net.norm_unet.unet.")
    out.update(crnn_trunk_state_dict(p["iterations"]["trunk"], "trunk."))
    out["lambda_reg"] = _t(p["iterations"]["lambda_reg"])
    return out


def cinenet_rnn_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``CineNetRNN`` params -> ``cinemri_tpu_torch.models.CineNetRNN`` state_dict."""
    p = params.get("params", params)
    out = crnn_trunk_state_dict(p["iterations"]["trunk"], "trunk.")
    out["lambda_reg"] = _t(p["iterations"]["lambda_reg"])
    return out


def xpdnet_rnn_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``XPDNetRNN`` params -> ``cinemri_tpu_torch.models.XPDNetRNN``
    state_dict (the trunk under ``iterations`` with ``primal_only``, at the
    top level with the per-iteration ``kspace_net_{i}`` without it)."""
    p = params.get("params", params)
    out = unet_state_dict(p["sens_net"]["Unet_0"], "sens_net.unet.")
    out.update(crnn_trunk_state_dict(p["iterations"]["trunk"] if "iterations" in p else p["trunk"],
                                     "trunk."))
    for name, sub in p.items():
        if name.startswith("kspace_net_"):
            out.update(kspace_cnn_state_dict(sub, f"kspace_nets.{name[len('kspace_net_'):]}."))
    return out
