"""Reference-layout checkpoints written from a seed.

The reference PyTorch code is not needed to make a checkpoint in its
layout: :func:`reference_checkpoint` writes the Lightning dict that the
reference's ``trainer.save_checkpoint`` would hold for a model of the given
``hyper_parameters``, with the keys and shapes of the reference modules that
:mod:`cinemri_tpu_torch.interop.port` reads (its docstrings cite their
sources) and weights drawn from ``numpy.random.default_rng(seed)``. The
tests hold :func:`~cinemri_tpu_torch.interop.import_torch_checkpoint`
against the JAX package's import of such dicts, and ``chip_smoke.py``
serves one at full width.

Module layouts (keys relative to the module):

* ``Unet`` (unet.py:6-125): ``down_sample_layers.{j}``, ``conv`` and
  ``up_conv.{i}`` are ConvBlocks, their 3x3 convs (no bias) at
  ``layers.0`` and ``layers.4``; ``up_transpose_conv.{i}.layers.0`` a 2x2
  stride-2 transpose conv (no bias); the last ``up_conv`` is a
  Sequential of a ConvBlock and a 1x1 conv with a bias.
* ``NormUnet`` / ``NormUnet3D``: ``unet``. VarNet's sensitivity model:
  ``norm_unet``; XPDNet's: ``unet_model``.
* ``MWCNN`` (mwcnn.py:8-179): ``first_convs`` (``2 n_first_convs``
  entries, the last a plain conv with a bias) and
  ``conv_blocks_per_scale.{i}`` (``2 n_convs_per_scale[i]`` entries, the
  last of scale 0 a plain conv when ``n_first_convs`` is 0); a block's
  3x3 conv (no bias) at ``layers.0``.
* ``KSpaceCNN`` (kspace_net.py:6-61): 3x3x3 convs with biases at
  ``layers.{0,2,4}``.
* CRNN trunks (recurrent_varnet.py:49-58): ``bcrnn.CRNN_model.{i2h, h2h,
  ih2ih}``, ``conv{1,2,3}_{x,h}`` and ``conv4_x``, 3x3 convs with biases.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["reference_state_dict", "reference_checkpoint"]


class _Writer:
    """Draws each weight from one generator in key order: normal with a
    standard deviation of 1/sqrt(fan-in); biases and λ positive-uniform."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.out: Dict[str, torch.Tensor] = {}

    def conv(self, key: str, shape, bias: bool = False, transpose: bool = False):
        fan_in = shape[0] if transpose else shape[1]
        fan_in *= int(np.prod(shape[2:]))
        w = self.rng.standard_normal(shape) / np.sqrt(fan_in)
        self.out[f"{key}.weight"] = torch.from_numpy(w.astype(np.float32))
        if bias:
            self.bias(f"{key}.bias", shape[1] if transpose else shape[0])

    def bias(self, key: str, n: int):
        self.out[key] = torch.from_numpy(self.rng.uniform(-0.1, 0.1, n).astype(np.float32))

    def lam(self, key: str):
        self.out[key] = torch.from_numpy(self.rng.uniform(0.05, 0.5, 1).astype(np.float32))


def _unet(wr: _Writer, prefix: str, chans: int, pools: int, in_ch: int = 2, out_ch: int = 2,
          dims: int = 2) -> None:
    k3, k2, k1 = (3,) * dims, (2,) * dims, (1,) * dims

    def block(name: str, cin: int, cout: int):
        wr.conv(f"{prefix}{name}.layers.0", (cout, cin, *k3))
        wr.conv(f"{prefix}{name}.layers.4", (cout, cout, *k3))

    ch = chans
    block("down_sample_layers.0", in_ch, ch)
    for j in range(1, pools):
        block(f"down_sample_layers.{j}", ch, 2 * ch)
        ch *= 2
    block("conv", ch, 2 * ch)
    for i in range(pools):
        wr.conv(f"{prefix}up_transpose_conv.{i}.layers.0", (2 * ch, ch, *k2), transpose=True)
        if i < pools - 1:
            block(f"up_conv.{i}", 2 * ch, ch)
            ch //= 2
        else:
            block(f"up_conv.{i}.0", 2 * ch, ch)
            wr.conv(f"{prefix}up_conv.{i}.1", (out_ch, ch, *k1), bias=True)


def _mwcnn(wr: _Writer, prefix: str, in_chans: int, out_chans: int, n_scales: int,
           n_filters_per_scale, n_convs_per_scale, n_first_convs: int,
           first_conv_n_filters: int) -> None:
    nf, nc, f0 = tuple(n_filters_per_scale), tuple(n_convs_per_scale), first_conv_n_filters

    def chans_for(i_scale: int, i_conv: int) -> int:
        if i_conv == nc[i_scale] * 2 - 1:
            return max(4 * f0, 4 * out_chans) if i_scale == 0 else 4 * nf[i_scale - 1]
        return nf[i_scale]

    def block(key: str, cin: int, cout: int) -> int:
        wr.conv(f"{prefix}{key}.layers.0", (cout, cin, 3, 3))
        return cout

    ch = in_chans
    for k in range(n_first_convs):
        ch = block(f"first_convs.{k}", ch, f0)
    for i in range(n_scales):
        ch *= 4  # DWT
        for k in range(nc[i]):
            ch = block(f"conv_blocks_per_scale.{i}.{k}", ch, chans_for(i, k))
    for i in range(n_scales - 1, -1, -1):
        if i != n_scales - 1:
            ch //= 4  # IWT, then the additive skip
        for k in range(nc[i], 2 * nc[i]):
            if i == 0 and k == 2 * nc[i] - 1 and n_first_convs < 1:
                wr.conv(f"{prefix}conv_blocks_per_scale.0.{k}", (4 * out_chans, ch, 3, 3), bias=True)
                ch = 4 * out_chans
            else:
                ch = block(f"conv_blocks_per_scale.{i}.{k}", ch, chans_for(i, k))
    ch //= 4  # IWT
    if n_first_convs > 0:
        for k in range(n_first_convs, 2 * n_first_convs - 1):
            ch = block(f"first_convs.{k}", ch, f0)
        wr.conv(f"{prefix}first_convs.{2 * n_first_convs - 1}", (out_chans, ch, 3, 3), bias=True)


def _kspace_cnn(wr: _Writer, prefix: str, in_chans: int, out_chans: int,
                n_convs: int = 3, n_filters: int = 16) -> None:
    chans = [in_chans] + [n_filters] * (n_convs - 1) + [out_chans]
    for j, (a, b) in enumerate(zip(chans, chans[1:])):
        wr.conv(f"{prefix}layers.{2 * j}", (b, a, 3, 3, 3), bias=True)


def _crnn_trunk(wr: _Writer, chans: int, in_ch: int = 2, out_ch: int = 2) -> None:
    cell = "bcrnn.CRNN_model."
    wr.conv(f"{cell}i2h", (chans, in_ch, 3, 3), bias=True)
    wr.conv(f"{cell}h2h", (chans, chans, 3, 3), bias=True)
    wr.conv(f"{cell}ih2ih", (chans, chans, 3, 3), bias=True)
    for n in (1, 2, 3):
        wr.conv(f"conv{n}_x", (chans, chans, 3, 3), bias=True)
        wr.conv(f"conv{n}_h", (chans, chans, 3, 3), bias=True)
    wr.conv("conv4_x", (out_ch, chans, 3, 3), bias=True)


def _plane_prefixes(root: str, dynamic_type: str, weight_sharing: bool):
    """The reference's per-type denoisers: an XF/XT pair ``root.0`` /
    ``root.1``, else one net at ``root``."""
    if dynamic_type in ("XF", "XT") and not weight_sharing:
        return [f"{root}.0.", f"{root}.1."]
    return [f"{root}."]


def reference_state_dict(family: str, hparams: Mapping, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The reference model's ``state_dict()`` (no Lightning prefix) for
    ``hparams``, the reference's hyper-parameter names: ``dynamic_type``
    (default ``"XF"``), ``weight_sharing`` (default off), and the
    architecture's sizes (VarNet: ``num_cascades``, ``sens_chans``,
    ``sens_pools``, ``chans``, ``pools`` but no pools for CRNN; CineNet:
    ``num_cascades``, ``chans``, ``pools``; XPDNet: ``num_cascades``,
    ``sens_chans``, ``sens_pools``, ``n_scales``, ``n_filters_per_scale``,
    ``n_convs_per_scale``, ``n_first_convs``, ``first_conv_n_filters``,
    ``n_primal``, ``primal_only``, ``n_dual``; XPDNet-CRNN ``crnn_chans``
    and ``n_primal``)."""
    hp = dict(hparams)
    dyn = hp.get("dynamic_type", "XF")
    sharing = bool(hp.get("weight_sharing", False))
    wr = _Writer(seed)
    if family == "varnet":
        _unet(wr, "sens_net.norm_unet.unet.", hp["sens_chans"], hp["sens_pools"])
        if dyn == "CRNN":
            _crnn_trunk(wr, hp["chans"])
            wr.lam("lambda_reg")
        else:
            for p in _plane_prefixes("model", dyn, sharing):
                _unet(wr, f"{p}unet.", hp["chans"], hp["pools"], dims=3 if dyn == "3D" else 2)
            for i in range(hp["num_cascades"]):
                wr.lam(f"cascades.{i}.lambda_reg")
    elif family == "cinenet":
        if dyn == "CRNN":
            _crnn_trunk(wr, hp["chans"])
            wr.lam("lambda_reg")
        else:
            for p in _plane_prefixes("model", dyn, sharing):
                _unet(wr, p, hp["chans"], hp["pools"], dims=3 if dyn == "3D" else 2)
            for i in range(hp["num_cascades"]):
                wr.lam(f"cascades.{i}.lambda_reg")
    elif family == "xpdnet":
        _unet(wr, "sens_net.unet_model.", hp["sens_chans"], hp["sens_pools"])
        n_primal = hp["n_primal"]
        if dyn == "CRNN":
            _crnn_trunk(wr, hp["crnn_chans"], in_ch=2 * (n_primal + 1), out_ch=2 * n_primal)
        else:
            for i in range(hp["num_cascades"]):
                for p in _plane_prefixes(f"image_net.{i}", dyn, sharing):
                    _mwcnn(wr, p, 2 * (n_primal + 1), 2 * n_primal, hp["n_scales"],
                           hp["n_filters_per_scale"], hp["n_convs_per_scale"],
                           hp["n_first_convs"], hp["first_conv_n_filters"])
            if not hp.get("primal_only", True):
                n_dual = hp.get("n_dual", 1)
                for i in range(hp["num_cascades"]):
                    _kspace_cnn(wr, f"kspace_net.{i}.", 2 * (n_dual + 2), 2 * n_dual)
    else:
        raise ValueError(f"unknown family {family!r}")
    return wr.out


def reference_checkpoint(family: str, hparams: Mapping, seed: int = 0) -> dict:
    """The Lightning checkpoint dict of :func:`reference_state_dict`: keys
    under the pl-module's ``<family>.`` prefix, and ``hparams`` as its
    ``hyper_parameters`` (write it with ``torch.save``)."""
    sd = reference_state_dict(family, hparams, seed)
    return {"state_dict": {f"{family}.{k}": v for k, v in sd.items()},
            "hyper_parameters": dict(hparams)}
