"""Dynamic End-to-End Variational Network (VarNet), forward pass.

Counterpart of ``cinemri_tpu/models/varnet.py`` for the 2D, 3D, XT and XF
dynamic types (CRNN is a separate model, ``models/recurrent.py``): unrolled cascades with a learned-λ soft data-consistency step, a
learned sensitivity-map U-Net, and a regularizer shared by every cascade
(one :class:`VarNetCascade` module called ``num_cascades`` times, as the
flax ``nn.scan`` broadcasts its params). The cascade loop is a Python loop.

With ``kernel_dc`` and a line mask, cascades run in image space through the
precomputed h-axis normal kernel (``physics.soft_dc_image_kernel``);
otherwise they run the direct k-space form through ``sens_expand`` /
``soft_dc``. The regularizer: XT / XF, NormUnets over the rotated (w, t)
and (h, t) planes; 2D, a NormUnet per frame (frames folded into the
batch); 3D, a NormUnet3D over ``(t, h, w)``. With ``remat`` (the default, as in the JAX package) each
cascade is checkpointed when autograd records, under ``remat_policy``
(``models/remat.py``). ``bf16`` stores the activations of every NormUnet
(the sens net's and the regularizer's) in bf16 (``models/denoisers/
activations.py``); the parameters, data consistency, the DFT and
normal-apply kernels and the output stay f32, as in the JAX package. The
sens net, each cascade's regularizer and its data consistency open the
program spans ``cinemri.sens_net``, ``cinemri.regularizer`` and
``cinemri.dc`` (``instrument.span``).

On a mesh (``parallel.set_mesh``), ``plane_axis`` splits the XT / XF
plane batches over that dim: each rank runs the plane nets on its share of
the ``b·h`` and ``b·w`` planes and the outputs are gathered
(``parallel.autograd.split_rows``). ``coil_axis`` splits the coils: the
k-space (and so the maps) hold this rank's coils, the sens net runs on them,
and every coil sum is all-reduced over the coil group
(``physics/operators.py``). :meth:`VarNet.partial_parameters` names the
weights whose gradient each rank of an axis computes only a part of.

I/O: ``masked_kspace (b, t, c, h, w)`` Complex, ``mask (b, t|1, 1, h, 1)``
float32 -> magnitude image ``(b, t, h, w)`` float32.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cinemri_tpu_torch.instrument import span
from cinemri_tpu_torch.models.denoisers.activations import resolve_dtype
from cinemri_tpu_torch.models.denoisers.norm_unet import NormUnet, NormUnet3D
from cinemri_tpu_torch.models.remat import call_remat, check_remat_policy
from cinemri_tpu_torch.ops.coil import rss_complex
from cinemri_tpu_torch.ops.cplx import Complex, cmean
from cinemri_tpu_torch.ops.fft import fft1c, ifft1c, ifft2c
from cinemri_tpu_torch.parallel.autograd import split_rows
from cinemri_tpu_torch.parallel.mesh import mesh_axis, partial_by_prefix
from cinemri_tpu_torch.physics.lowfreq import low_frequency_kspace
from cinemri_tpu_torch.physics.operators import (
    coil_copy,
    coil_weight,
    is_line_mask,
    masked_normal_kernel,
    sens_expand,
    sens_reduce,
    soft_dc,
    soft_dc_image_kernel,
)

__all__ = ["VarNet", "VarNetCascade", "SensitivityModel", "LAMBDA_INIT", "DYNAMIC_TYPES"]

# softplus(LAMBDA_INIT) == 1
LAMBDA_INIT = math.log(math.e - 1.0)

DYNAMIC_TYPES = ("2D", "3D", "XT", "XF")


class SensitivityModel(nn.Module):
    """Learned coil sensitivities: IFFT of the center-band-masked,
    time-averaged k-space, a per-coil NormUnet (coils folded into the
    batch), then RSS normalization. Output ``(b, 1, c, h, w)``; on a
    ``coil_axis``, of this rank's coils, normalized by the RSS of all."""

    def __init__(self, chans: int, num_pools: int, packed: bool = False, coil_axis: str = "",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.coil_axis = coil_axis
        self.norm_unet = NormUnet(chans, num_pools, packed=packed, dtype=dtype)

    def forward(self, masked_kspace: Complex, mask: torch.Tensor) -> Complex:
        with span("cinemri.sens_net"):
            x = ifft2c(low_frequency_kspace(masked_kspace, mask))  # (b, c, h, w), a band per sample
            b, c, h, w = x.shape
            x = self.norm_unet(x.reshape(b * c, h, w)).reshape(b, c, h, w)
            rss = coil_copy(rss_complex(x, axis=1, coil_axis=self.coil_axis), self.coil_axis)
            x = x / rss[:, None]
            return x[:, None]


class VarNetCascade(nn.Module):
    """One unrolled block; a single instance serves every cascade."""

    def __init__(self, chans: int, pools: int, dynamic_type: str = "XF",
                 weight_sharing: bool = False, packed: bool = False, plane_axis: str = "",
                 coil_axis: str = "", dtype: torch.dtype = torch.float32):
        super().__init__()
        if dynamic_type not in DYNAMIC_TYPES:
            raise ValueError(f"unknown dynamic_type {dynamic_type!r}")
        self.dynamic_type = dynamic_type
        self.weight_sharing = weight_sharing
        self.plane_axis = plane_axis
        self.coil_axis = coil_axis
        if dynamic_type in ("2D", "3D"):
            self.net = (NormUnet if dynamic_type == "2D" else NormUnet3D)(chans, pools, packed=packed,
                                                                         dtype=dtype)
        elif weight_sharing:
            self.plane_net = NormUnet(chans, pools, packed=packed, dtype=dtype)
        else:
            self.net_xf = NormUnet(chans, pools, packed=packed, dtype=dtype)
            self.net_yf = NormUnet(chans, pools, packed=packed, dtype=dtype)

    def _xfyf(self, x: Complex) -> Complex:
        """Rotated-plane regularization: temporal-mean subtraction, temporal
        FFT (XF only), NormUnets over the (w, t) and (h, t) plane batches
        (split over ``plane_axis``), average, inverse FFT, mean restored."""
        b, t, h, w = x.shape
        mean = cmean(x, axis=1, keepdims=True)
        x = x - mean
        if self.dynamic_type == "XF":
            x = fft1c(x, axis=1)
        xf = x.transpose(0, 2, 3, 1).reshape(b * h, w, t)
        yf = x.transpose(0, 3, 2, 1).reshape(b * w, h, t)
        net_xf = self.plane_net if self.weight_sharing else self.net_xf
        net_yf = self.plane_net if self.weight_sharing else self.net_yf
        ax = mesh_axis(self.plane_axis)
        xf = split_rows(net_xf, ax, xf).reshape(b, h, w, t).transpose(0, 3, 1, 2)
        yf = split_rows(net_yf, ax, yf).reshape(b, w, h, t).transpose(0, 3, 2, 1)
        out = 0.5 * (xf + yf)
        if self.dynamic_type == "XF":
            out = ifft1c(out, axis=1)
        return out + mean

    def forward(self, carry: Complex, lam: torch.Tensor, ref: Complex,
                mask: torch.Tensor, sens_maps: Complex, dc_kernel, rss0=None) -> Complex:
        # direct form: carry/ref are k-space; kernel form: the combined image
        coil = self.coil_axis
        if dc_kernel is None:
            image = sens_reduce(carry, sens_maps, coil_axis=coil)[:, :, 0]  # (b, t, h, w)
        else:
            image = carry[:, :, 0]
        b, t, h, w = image.shape
        with span("cinemri.regularizer"):
            if self.dynamic_type == "2D":  # per-frame static reconstruction
                model_out = self.net(image.reshape(b * t, h, w)).reshape(b, t, h, w)
            elif self.dynamic_type == "3D":
                model_out = self.net(image)
            else:
                model_out = self._xfyf(image)
        model_out = model_out[:, :, None]
        with span("cinemri.dc"):
            v = F.softplus(lam)
            if dc_kernel is None:
                return soft_dc(sens_expand(model_out, sens_maps, coil), ref, mask, v)
            return soft_dc_image_kernel(model_out, ref, dc_kernel, sens_maps, v, rss_sq=rss0,
                                        coil_axis=coil)


class VarNet(nn.Module):
    """Full dynamic VarNet (2D / 3D / XT / XF). ``remat_prevent_cse`` is
    accepted for the JAX package's signature and does nothing
    (``models/remat.py``)."""

    def __init__(
        self,
        num_cascades: int = 12,
        sens_chans: int = 8,
        sens_pools: int = 4,
        chans: int = 18,
        pools: int = 4,
        dynamic_type: str = "XF",
        weight_sharing: bool = False,
        packed: bool = False,
        kernel_dc: bool = True,
        remat: bool = True,
        remat_policy: str = "",
        remat_prevent_cse: bool = True,
        bf16: bool = False,
        plane_axis: str = "",
        coil_axis: str = "",
    ):
        super().__init__()
        if dynamic_type not in DYNAMIC_TYPES:
            raise ValueError(
                f"dynamic_type must be one of {DYNAMIC_TYPES} (CRNN is a separate model)"
            )
        check_remat_policy(remat_policy)
        self.num_cascades = num_cascades
        self.kernel_dc = kernel_dc
        self.remat = remat
        self.remat_policy = remat_policy
        self.bf16 = bf16
        self.packed = packed
        self.plane_axis = plane_axis
        self.coil_axis = coil_axis
        dtype = resolve_dtype(bf16)
        self.sens_net = SensitivityModel(sens_chans, sens_pools, packed=packed, coil_axis=coil_axis,
                                         dtype=dtype)
        self.cascades = VarNetCascade(chans, pools, dynamic_type, weight_sharing, packed,
                                      plane_axis, coil_axis, dtype)
        self.lambda_reg = nn.Parameter(torch.full((num_cascades,), LAMBDA_INIT))

    def partial_parameters(self) -> Dict[str, Tuple[str, ...]]:
        """Each weight's mesh axes whose ranks each compute a part of its
        gradient: the sens net's on the coil axis (each rank runs it on its
        coils), the plane nets' on the plane axis; every rank computes λ's
        whole."""
        return partial_by_prefix(self, {"sens_net.": self.coil_axis,
                                        "cascades.": self.plane_axis})

    def forward(self, masked_kspace: Complex, mask: torch.Tensor) -> torch.Tensor:
        coil = self.coil_axis
        sens_maps = self.sens_net(masked_kspace, mask)
        if self.kernel_dc and is_line_mask(mask):
            dc_kernel = masked_normal_kernel(mask)
            rss0 = coil_weight(sens_maps, coil)
            x_ref = sens_reduce(masked_kspace, sens_maps, coil_axis=coil)  # (b, t, 1, h, w)
            carry, ref = x_ref, x_ref
        else:
            dc_kernel, rss0, carry, ref = None, None, masked_kspace, masked_kspace
        for i in range(self.num_cascades):
            carry = call_remat(self.cascades, self.remat, self.remat_policy, carry,
                               self.lambda_reg[i], ref, mask, sens_maps, dc_kernel, rss0)
        if dc_kernel is not None:
            return carry[:, :, 0].abs()  # carry is sens_reduce(k_pred)
        return sens_reduce(carry, sens_maps, keepdims=False, coil_axis=coil).abs()
