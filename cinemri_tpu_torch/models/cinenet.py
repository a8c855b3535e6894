"""CineNet: alternating U-Net denoising and conjugate-gradient data
consistency in image space.

Counterpart of ``cinemri_tpu/models/cinenet.py`` for the 2D, 3D, XT and XF
dynamic types (CRNN is a separate model, ``models/recurrent.py``). CineNet takes precomputed sensitivity maps as an input, its
denoisers are plain U-Nets on raw ``[re, im]`` channels (no normalizing
wrapper: XT / XF over the rotated planes, 2D per frame, 3D a 3-D U-Net
over ``(t, h, w)`` without padding), and each cascade ends with a CG solve of
``(AᴴMA + v·I) x = x_ref + v·x_den`` with ``v = softplus(λᵢ)`` a learned
weight per cascade (:func:`~cinemri_tpu_torch.physics.cg.conj_grad`), whose
step sizes and ``v`` stay on the device. A forward binds its request's
``x_ref``, operator and maps once (:func:`bind_dc`,
``physics.CGDataConsistency``); served on the card with grad mode off and
no coil axis, each cascade's solve then replays CUDA graphs of the kernels
between its normal applies, captured at the first call of its shapes, with
the eager loop's bits.

One :class:`CineNetCascade` module serves every cascade (the flax
``nn.scan`` broadcasts its params); the cascade loop is a Python loop. With
``kernel_dc`` and a line mask, every CG apply runs through the precomputed
h-axis normal kernel (``physics.normal_plus_lambda_kernel``, the CUDA
kernel on the card); otherwise through the direct operator
(``physics.normal_plus_lambda``). With ``remat`` (the default, as in the
JAX package) each cascade is checkpointed when autograd records, under
``remat_policy`` (``models/remat.py``). ``bf16`` stores the U-Nets'
activations in bf16 (``models/denoisers/activations.py``); the CG solve, the
normal-apply kernel and the output stay f32, as in the JAX package.
Each cascade's denoiser and its right-hand side and CG solve open the
program spans ``cinemri.regularizer`` and ``cinemri.dc``
(``instrument.span``).
``packed`` runs the U-Nets on the space-to-depth layout
(``models/denoisers/packed_unet.py``; the same parameters and function).
``plane_axis`` and ``coil_axis`` split the plane batches and the coils over
dims of the ambient mesh, as in ``models/varnet.py``: on a coil axis the maps
and k-space hold this rank's coils, and each CG apply runs the kernel on them
with λ = 0, all-reduces, and adds ``v·x`` once.

I/O: ``masked_kspace (b, t, c, h, w)`` Complex, ``mask (b, t|1, 1, h, 1)``,
``sens_maps (b, 1, c, h, w)`` Complex -> magnitude ``(b, t, h, w)`` float32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from cinemri_tpu_torch.instrument import span
from cinemri_tpu_torch.models.denoisers.activations import resolve_dtype
from cinemri_tpu_torch.models.denoisers.unet import Unet
from cinemri_tpu_torch.models.remat import call_remat, check_remat_policy
from cinemri_tpu_torch.models.varnet import DYNAMIC_TYPES, LAMBDA_INIT
from cinemri_tpu_torch.ops.cplx import Complex, cmean, from_channels, to_channels
from cinemri_tpu_torch.ops.fft import fft1c, ifft1c
from cinemri_tpu_torch.parallel.autograd import split_rows
from cinemri_tpu_torch.parallel.mesh import mesh_axis, partial_by_prefix
from cinemri_tpu_torch.physics.operators import (
    CGDataConsistency,
    is_line_mask,
    masked_normal_kernel,
    sens_reduce,
)

__all__ = ["CineNet", "CineNetCascade", "batched_kernel_and_maps", "bind_dc"]


def batched_kernel_and_maps(mask: torch.Tensor, sens_maps: Complex, b: int):
    """The masked normal kernel and the maps at batch ``b``, made once, so no
    CG apply copies a batch-1 K or S (``normal_plus_lambda_kernel``)."""
    batched = lambda a: a.expand(b, *a.shape[1:]).contiguous()
    k = masked_normal_kernel(mask)
    return (Complex(batched(k.re), batched(k.im)),
            Complex(batched(sens_maps.re), batched(sens_maps.im)))


def bind_dc(masked_kspace: Complex, mask: torch.Tensor, sens_maps: Complex, kernel_dc: bool,
            cg_iters: int, coil_axis: str = "") -> CGDataConsistency:
    """The request's CG data consistency: ``x_ref = sens_reduce(k, S)``,
    through the h-axis normal kernel when ``kernel_dc`` and the mask is a
    line mask (:func:`batched_kernel_and_maps`), else the direct form. Where
    the solve is graphed, the bound copy of ``x_ref`` replaces the one made
    here."""
    image_ref = sens_reduce(masked_kspace, sens_maps, coil_axis=coil_axis)
    kernel = None
    if kernel_dc and is_line_mask(mask):
        kernel, sens_maps = batched_kernel_and_maps(mask, sens_maps, masked_kspace.shape[0])
    return CGDataConsistency(image_ref, mask, sens_maps, kernel, cg_iters, coil_axis)


class CineNetCascade(nn.Module):
    """Denoise, then the request's CG solve (:func:`bind_dc`); a single
    instance serves every cascade."""

    def __init__(self, chans: int, pools: int, dynamic_type: str = "XF",
                 weight_sharing: bool = False, plane_axis: str = "",
                 dtype: torch.dtype = torch.float32, packed: bool = False):
        super().__init__()
        if dynamic_type not in DYNAMIC_TYPES:
            raise ValueError(f"unknown dynamic_type {dynamic_type!r}")
        self.plane_axis = plane_axis
        self.dynamic_type = dynamic_type
        self.weight_sharing = weight_sharing
        if dynamic_type in ("2D", "3D"):
            self.net = Unet(chans, pools, dims=3 if dynamic_type == "3D" else 2, packed=packed,
                            dtype=dtype)
        elif weight_sharing:
            self.plane_net = Unet(chans, pools, packed=packed, dtype=dtype)
        else:
            self.net_xf = Unet(chans, pools, packed=packed, dtype=dtype)
            self.net_yf = Unet(chans, pools, packed=packed, dtype=dtype)

    def _xfyf(self, x: Complex) -> Complex:
        """Rotated-plane regularization on raw channels: temporal-mean
        subtraction, temporal FFT (XF only), U-Nets over the (w, t) and
        (h, t) plane batches (h, resp. w, folded into the batch; split over
        ``plane_axis``), average, inverse FFT, mean restored."""
        b, t, h, w = x.shape
        mean = cmean(x, axis=1, keepdims=True)
        x = x - mean
        if self.dynamic_type == "XF":
            x = fft1c(x, axis=1)
        xf = to_channels(x.transpose(0, 2, 3, 1).reshape(b * h, w, t), axis=1)  # (b·h, 2, w, t)
        yf = to_channels(x.transpose(0, 3, 2, 1).reshape(b * w, h, t), axis=1)  # (b·w, 2, h, t)
        net_xf = self.plane_net if self.weight_sharing else self.net_xf
        net_yf = self.plane_net if self.weight_sharing else self.net_yf
        ax = mesh_axis(self.plane_axis)
        xf = from_channels(split_rows(net_xf, ax, xf), axis=1)
        yf = from_channels(split_rows(net_yf, ax, yf), axis=1)
        xf = xf.reshape(b, h, w, t).transpose(0, 3, 1, 2)
        yf = yf.reshape(b, w, h, t).transpose(0, 3, 2, 1)
        out = 0.5 * (xf + yf)
        if self.dynamic_type == "XF":
            out = ifft1c(out, axis=1)
        return out + mean

    def forward(self, image_pred: Complex, lam: torch.Tensor, dc: CGDataConsistency) -> Complex:
        x = image_pred[:, :, 0]  # (b, t, h, w)
        b, t, h, w = x.shape
        with span("cinemri.regularizer"):
            if self.dynamic_type == "2D":
                out = self.net(to_channels(x.reshape(b * t, h, w), axis=1))  # (b·t, 2, h, w)
                model_out = from_channels(out, axis=1).reshape(b, t, h, w)
            elif self.dynamic_type == "3D":
                # (b, 2, t, h, w)
                model_out = from_channels(self.net(to_channels(x, axis=1)), axis=1)
            else:
                model_out = self._xfyf(x)
        model_out = model_out[:, :, None]  # (b, t, 1, h, w)
        with span("cinemri.dc"):
            return dc(model_out, lam)


class CineNet(nn.Module):
    """Full dynamic CineNet (2D / 3D / XT / XF). ``remat_prevent_cse`` is
    accepted and does nothing (``models/remat.py``)."""

    def __init__(
        self,
        num_cascades: int = 12,
        cg_iters: int = 4,
        chans: int = 18,
        pools: int = 4,
        dynamic_type: str = "XF",
        weight_sharing: bool = False,
        kernel_dc: bool = True,
        remat: bool = True,
        remat_policy: str = "",
        remat_prevent_cse: bool = True,
        packed: bool = False,
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
        self.cg_iters = cg_iters
        self.kernel_dc = kernel_dc
        self.remat = remat
        self.remat_policy = remat_policy
        self.bf16 = bf16
        self.packed = packed
        self.plane_axis = plane_axis
        self.coil_axis = coil_axis
        self.cascades = CineNetCascade(chans, pools, dynamic_type, weight_sharing, plane_axis,
                                       resolve_dtype(bf16), packed)
        self.lambda_reg = nn.Parameter(torch.full((num_cascades,), LAMBDA_INIT))

    def partial_parameters(self) -> Dict[str, Tuple[str, ...]]:
        """The plane nets' gradients are partial on the plane axis; every
        rank computes λ's whole (CineNet has no weight on its coils)."""
        return partial_by_prefix(self, {"cascades.": self.plane_axis})

    def forward(self, masked_kspace: Complex, mask: torch.Tensor,
                sens_maps: Complex) -> torch.Tensor:
        dc = bind_dc(masked_kspace, mask, sens_maps, self.kernel_dc, self.cg_iters, self.coil_axis)
        x = dc.image_ref  # (b, t, 1, h, w)
        for i in range(self.num_cascades):
            x = call_remat(self.cascades, self.remat, self.remat_policy, x, self.lambda_reg[i], dc)
        return x[:, :, 0].abs()
