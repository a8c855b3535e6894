"""XPDNet: learned cross-domain primal-dual reconstruction.

Counterpart of ``cinemri_tpu/models/xpdnet.py`` for the 2D, XT and XF
dynamic types (3D is excluded by the reference; CRNN is a separate model,
``models/recurrent.py``). Each cascade pairs a k-space step (the measurement
residual; a :class:`KSpaceCNN` when ``primal_only=False``) with an
image-space MWCNN over a buffer of ``n_primal`` complex channels.

Buffers keep the JAX package's layouts: the image buffer ``(b, t, h, w,
n_primal)`` Complex, the k-space buffer ``(b, t, c, h, w, n_dual)``
Complex. An MWCNN sees them as NCHW planes of ``2n`` real channels,
``[re_0..re_n, im_0..im_n]``.

Reference behaviours kept, as in the JAX package:

  * the XF temporal transform is ``fft1c_alt`` forward and the *standard*
    ``ifft1c`` back, not a true inverse for odd t (the flagship t is 15);
  * the nets are per cascade (a ``ModuleList`` of blocks; flax scans with
    ``variable_axes={'params': 0}``), unlike VarNet's and CineNet's shared
    denoiser; with ``weight_sharing`` one net per cascade serves both the
    (w, t) and the (h, t) planes;
  * the residual adds back the temporal mean of the first ``n_primal``
    buffer channels only;
  * the 2D path pads to ``2**n_scales`` as the XF path does (the JAX
    package's deliberate fix of the reference's unpadded 2D path).

With ``kernel_dc``, ``primal_only`` and a line mask, the k-step and the
backward operator collapse to ``N(head) − x_ref``: one normal apply per
cascade with λ = 0 (``physics.normal_plus_lambda_kernel``, the CUDA kernel
on the card), and the k-space buffer is never built. Otherwise the direct
form runs ``sens_expand`` / ``sens_reduce`` (four DFTs per cascade). With
``remat`` each cascade is checkpointed when autograd records.

``norm_buffers`` normalizes the MWCNN's input planes per channel and
de-normalizes its output (``None`` resolves to the ``bf16`` setting in the
JAX package; bf16 is not ported, so here ``None`` means off).

``plane_axis`` and ``coil_axis`` split the plane batches and the coils over
dims of the ambient mesh, as in ``models/varnet.py``; on a coil axis the
k-space buffer and a :class:`KSpaceCNN` (per coil) run on this rank's coils.

I/O: ``masked_kspace (b, t, c, h, w)`` Complex, ``mask (b, t|1, 1, h, 1)``
-> magnitude ``(b, t, h, w)`` float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from cinemri_tpu_torch.models.denoisers.kspace_cnn import KSpaceCNN
from cinemri_tpu_torch.models.denoisers.mwcnn import MWCNN
from cinemri_tpu_torch.models.denoisers.norm_unet import _norm_groups
from cinemri_tpu_torch.models.denoisers.unet import Unet
from cinemri_tpu_torch.models.remat import call_remat, check_remat_policy
from cinemri_tpu_torch.ops.coil import rss_complex
from cinemri_tpu_torch.ops.cplx import (
    Complex,
    cmean,
    concat,
    crepeat,
    from_channels,
    from_multi_channels,
    to_channels,
    to_multi_channels,
)
from cinemri_tpu_torch.ops.fft import fft1c_alt, ifft1c, ifft2c
from cinemri_tpu_torch.ops.pad import pad_for_mwcnn, unpad_from_mwcnn
from cinemri_tpu_torch.parallel.autograd import split_rows
from cinemri_tpu_torch.parallel.mesh import mesh_axis, partial_by_prefix
from cinemri_tpu_torch.physics.lowfreq import low_frequency_kspace
from cinemri_tpu_torch.physics.operators import (
    apply_mask,
    coil_copy,
    is_line_mask,
    masked_normal_kernel,
    normal_plus_lambda_kernel,
    sens_expand,
    sens_reduce,
)

__all__ = ["XPDNet", "XPDNetBlock", "XPDNetSensitivityModel", "DYNAMIC_TYPES"]

DYNAMIC_TYPES = ("2D", "XT", "XF")


class XPDNetSensitivityModel(nn.Module):
    """XPDNet's sensitivity net: the IFFT of the center-band-masked,
    time-averaged k-space, a plain U-Net per coil (no normalizing wrapper,
    with a residual), then RSS normalization. Output ``(b, 1, c, h, w)``;
    on a ``coil_axis``, of this rank's coils, normalized by the RSS of all."""

    def __init__(self, chans: int, num_pools: int, res_connection: bool = True,
                 coil_axis: str = ""):
        super().__init__()
        self.res_connection = res_connection
        self.coil_axis = coil_axis
        self.unet = Unet(chans=chans, num_pool_layers=num_pools)

    def forward(self, masked_kspace: Complex, mask: torch.Tensor) -> Complex:
        x = ifft2c(low_frequency_kspace(masked_kspace, mask))  # (b, c, h, w)
        b, c, h, w = x.shape
        r = to_channels(x.reshape(b * c, h, w), axis=1)  # (b·c, 2, h, w)
        out = self.unet(r)
        if self.res_connection:
            out = out + r
        x = from_channels(out, axis=1).reshape(b, c, h, w)
        x = x / coil_copy(rss_complex(x, axis=1, coil_axis=self.coil_axis), self.coil_axis)[:, None]
        return x[:, None]


class XPDNetBlock(nn.Module):
    """One k-step + image-step pair, with its own nets."""

    def __init__(
        self,
        n_scales: int = 3,
        n_filters_per_scale: Sequence[int] = (16, 32, 64),
        n_convs_per_scale: Sequence[int] = (2, 2, 2),
        n_first_convs: int = 1,
        first_conv_n_filters: int = 16,
        res: bool = False,
        primal_only: bool = True,
        n_primal: int = 5,
        n_dual: int = 1,
        dynamic_type: str = "XF",
        weight_sharing: bool = False,
        packed: bool = False,
        norm_buffers: bool = False,
        plane_axis: str = "",
        coil_axis: str = "",
    ):
        super().__init__()
        if dynamic_type not in DYNAMIC_TYPES:
            raise ValueError(f"dynamic_type {dynamic_type!r} unsupported for XPDNet "
                             f"(one of {DYNAMIC_TYPES}; 3D is excluded by the reference)")
        self.plane_axis = plane_axis
        self.coil_axis = coil_axis
        self.n_scales = n_scales
        self.primal_only = primal_only
        self.n_primal = n_primal
        self.dynamic_type = dynamic_type
        self.norm_buffers = norm_buffers

        def mwcnn():
            return MWCNN(2 * (n_primal + 1), 2 * n_primal, n_scales, n_filters_per_scale,
                         n_convs_per_scale, n_first_convs, first_conv_n_filters, res, packed)

        if dynamic_type == "2D" or weight_sharing:
            self.image_net = mwcnn()
        else:
            self.image_net_xf, self.image_net_yf = mwcnn(), mwcnn()
        if not primal_only:
            self.kspace_net = KSpaceCNN(2 * (n_dual + 2), 2 * n_dual)

    def _apply_net(self, planes: torch.Tensor, net: MWCNN) -> torch.Tensor:
        """pad -> MWCNN -> unpad on ``(n, 2ch, a, b)`` planes, normalized per
        channel around the net with ``norm_buffers``."""
        if self.norm_buffers:
            ch = planes.shape[1] // 2  # [re x (n_primal+1), im x (n_primal+1)]
            planes, mean, std = _norm_groups(planes, guard_zero_std=True)
        padded, pad = pad_for_mwcnn(planes, self.n_scales, axes=(2, 3))
        out = unpad_from_mwcnn(net(padded), pad, axes=(2, 3))
        if self.norm_buffers:
            # output channels [re(buf_0..n_primal-1), im(...)]: the input slots' stats
            idx = list(range(self.n_primal)) + list(range(ch, ch + self.n_primal))
            out = out * std[:, idx] + mean[:, idx]
        return out

    def _k_step(self, image_buffer, kspace_buffer, ref_kspace, mask, sens_maps):
        """The k-space correction in its direct form: ``(b, t, c, h, w, n)``."""
        head = image_buffer[..., 0][:, :, None]  # (b, t, 1, h, w)
        fwd = apply_mask(sens_expand(head, sens_maps, self.coil_axis), mask)  # (b, t, c, h, w)
        if not self.primal_only:
            cat = concat([kspace_buffer, fwd[..., None], ref_kspace[..., None]], axis=-1)
            return from_multi_channels(self.kspace_net(to_multi_channels(cat)))
        return (fwd - ref_kspace)[..., None]  # the measurement residual

    def _xfyf(self, buf: Complex) -> Complex:
        """``(b, t, h, w, n_primal+1)`` -> ``(b, t, h, w, n_primal)`` over the
        rotated (w, t) and (h, t) planes."""
        b, t, h, w, ch = buf.shape
        n = self.n_primal
        mean = cmean(buf, axis=1, keepdims=True)
        x = buf - mean
        if self.dynamic_type == "XF":
            x = fft1c_alt(x, axis=1)  # the reference's opposite shift order
        # NCHW planes (b·h, 2ch, w, t) and (b·w, 2ch, h, t)
        xf = to_multi_channels(x.transpose(0, 2, 4, 3, 1), axis=2).reshape(b * h, 2 * ch, w, t)
        yf = to_multi_channels(x.transpose(0, 3, 4, 2, 1), axis=2).reshape(b * w, 2 * ch, h, t)
        net_xf, net_yf = ((self.image_net, self.image_net) if hasattr(self, "image_net")
                          else (self.image_net_xf, self.image_net_yf))
        ax = mesh_axis(self.plane_axis)
        xf = split_rows(lambda p: self._apply_net(p, net_xf), ax, xf)
        yf = split_rows(lambda p: self._apply_net(p, net_yf), ax, yf)
        xf = from_multi_channels(xf.reshape(b, h, 2 * n, w, t), axis=2)
        yf = from_multi_channels(yf.reshape(b, w, 2 * n, h, t), axis=2)
        out = 0.5 * (xf.transpose(0, 4, 1, 3, 2) + yf.transpose(0, 4, 3, 1, 2))
        if self.dynamic_type == "XF":
            out = ifft1c(out, axis=1)  # the standard inverse, as the reference
        return out + mean[..., :n]

    def _i_step(self, image_buffer: Complex, bwd: Complex) -> Complex:
        """The image-space correction; ``bwd`` is the backward-operator image
        ``(b, t, h, w)``."""
        buf = concat([image_buffer, bwd[..., None]], axis=-1)
        if self.dynamic_type != "2D":
            return self._xfyf(buf)
        b, t, h, w, ch = buf.shape
        planes = to_multi_channels(buf.transpose(0, 1, 4, 2, 3), axis=2).reshape(b * t, 2 * ch, h, w)
        out = self._apply_net(planes, self.image_net).reshape(b, t, 2 * self.n_primal, h, w)
        return from_multi_channels(out, axis=2).transpose(0, 1, 3, 4, 2)

    def forward(self, image_buffer: Complex, kspace_buffer: Optional[Complex], ref_kspace: Complex,
                mask: torch.Tensor, sens_maps: Complex, x_ref: Complex, dc_kernel):
        if dc_kernel is not None and self.primal_only:
            # measurement-residual k-step and backward operator collapsed:
            # Sᴴ F⁻¹ M (F S head − k_ref) = N(head) − x_ref
            head = image_buffer[..., 0][:, :, None]
            bwd = normal_plus_lambda_kernel(head, dc_kernel, sens_maps, 0.0, self.coil_axis)
            bwd = (bwd - x_ref)[:, :, 0]
        else:
            kspace_buffer = self._k_step(image_buffer, kspace_buffer, ref_kspace, mask, sens_maps)
            bwd = sens_reduce(apply_mask(kspace_buffer[..., 0], mask), sens_maps,
                              coil_axis=self.coil_axis)[:, :, 0]
        return self._i_step(image_buffer, bwd), kspace_buffer


class XPDNet(nn.Module):
    """Full dynamic XPDNet (2D / XT / XF)."""

    def __init__(
        self,
        num_cascades: int = 12,
        sens_chans: int = 8,
        sens_pools: int = 4,
        n_scales: int = 3,
        n_filters_per_scale: Sequence[int] = (16, 32, 64),
        n_convs_per_scale: Sequence[int] = (2, 2, 2),
        n_first_convs: int = 1,
        first_conv_n_filters: int = 16,
        res: bool = False,
        primal_only: bool = True,
        n_primal: int = 5,
        n_dual: int = 1,
        dynamic_type: str = "XF",
        weight_sharing: bool = False,
        kernel_dc: bool = True,
        packed: bool = False,
        norm_buffers: Optional[bool] = None,
        remat: bool = True,
        remat_policy: str = "",
        plane_axis: str = "",
        coil_axis: str = "",
    ):
        super().__init__()
        if dynamic_type not in DYNAMIC_TYPES:
            raise ValueError("XPDNet dynamic_type must be 2D/XT/XF (CRNN is a separate model; "
                             "3D is excluded by the reference)")
        check_remat_policy(remat_policy)
        self.n_primal = n_primal
        self.k_buf_size = 1 if primal_only else n_dual
        self.primal_only = primal_only
        self.kernel_dc = kernel_dc
        self.remat = remat
        self.plane_axis = plane_axis
        self.coil_axis = coil_axis
        self.sens_net = XPDNetSensitivityModel(sens_chans, sens_pools, coil_axis=coil_axis)
        self.cascades = nn.ModuleList(
            XPDNetBlock(n_scales, n_filters_per_scale, n_convs_per_scale, n_first_convs,
                        first_conv_n_filters, res, primal_only, n_primal, n_dual, dynamic_type,
                        weight_sharing, packed, bool(norm_buffers), plane_axis, coil_axis)
            for _ in range(num_cascades))

    def partial_parameters(self) -> Dict[str, Tuple[str, ...]]:
        """Partial on the coil axis: the sens net and the k-space nets (each
        rank runs them on its coils); on the plane axis: the image nets."""
        rules = {"sens_net.": self.coil_axis}
        for i in range(len(self.cascades)):
            rules.update({f"cascades.{i}.image_net": self.plane_axis,
                          f"cascades.{i}.kspace_net.": self.coil_axis})
        return partial_by_prefix(self, rules)

    def forward(self, masked_kspace: Complex, mask: torch.Tensor) -> torch.Tensor:
        sens_maps = self.sens_net(masked_kspace, mask)
        x_ref = sens_reduce(masked_kspace, sens_maps, coil_axis=self.coil_axis)  # (b, t, 1, h, w)
        image_buffer = crepeat(x_ref[:, :, 0][..., None], self.n_primal, axis=-1)
        if self.kernel_dc and self.primal_only and is_line_mask(mask):
            dc_kernel, kspace_buffer = masked_normal_kernel(mask), None  # the k buffer is dead
        else:
            dc_kernel = None
            kspace_buffer = crepeat(masked_kspace[..., None], self.k_buf_size, axis=-1)
        for block in self.cascades:
            image_buffer, kspace_buffer = call_remat(
                block, self.remat, image_buffer, kspace_buffer, masked_kspace, mask, sens_maps,
                x_ref, dc_kernel)
        return image_buffer[..., 0].abs()
