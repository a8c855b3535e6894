"""CRNN dynamic variants: recurrence over time and over unrolled iterations.

Counterpart of ``cinemri_tpu/models/recurrent.py`` (dense layout):
:class:`VarNetRNN`, :class:`CineNetRNN` and :class:`XPDNetRNN`. Each
iteration runs the shared :class:`CRNNTrunk` (a bidirectional CRNN over t,
three iteration-recurrent convolutions and an output convolution, with a
residual onto its input), then the family's data-consistency step: VarNet's
soft DC, CineNet's CG solve, XPDNet's primal-dual buffer update. The trunk
and λ are shared by every iteration: ``lambda_reg`` is one scalar, not one
per cascade. The iteration loop is a Python loop carrying the image (or
XPDNet's buffer) and the trunk's four hidden states; with ``remat`` each
iteration is checkpointed when autograd records (``models/remat.py``), as
the JAX package wraps each scan step. XPDNet's ``primal_only=False`` loop
(a k-space CNN per iteration) runs without remat, as in the JAX package.

Data consistency takes the routes of the non-recurrent models: with
``kernel_dc`` and a line mask, VarNet's soft DC runs in image space
(``soft_dc_image_kernel``: one normal apply per iteration), CineNet's CG
applies ``normal_plus_lambda_kernel``, and XPDNet's measurement-residual
k-step and backward operator collapse to ``N(head) − x_ref`` (one normal
apply with λ = 0); otherwise the direct k-space forms.

Layouts: the trunk is NCHW with t leading, ``(t, b, ch, h, w)``, and
folded ``(t·b, ch, h, w)`` after the BCRNN. XPDNet's image buffer is carried
as the trunk sees it, ``(t, b, 2n, h, w)`` real with the n real channels
then the n imaginary ones (``to_multi_channels``); its head, complex slot 0,
is channels ``0`` and ``n``.

The packed (space-to-depth) trunk, ``trunk_block`` and ``bf16`` are not
ported (ROADMAP Queue 1, item 14). The packed trunk is exact with the same
parameters, so the dense one here computes the JAX package's packed
models too.

``coil_axis`` splits the coils over a dim of the ambient mesh, as in
``models/varnet.py``: the sens net and XPDNet's k-space nets run on this
rank's coils, every coil sum is all-reduced, and the trunk and λ, computed
whole on every rank, are replicated. The CRNN models have no plane batches.

I/O: ``masked_kspace (b, t, c, h, w)`` Complex, ``mask (b, t|1, 1, h, 1)``
(CineNet also ``sens_maps (b, 1, c, h, w)``) -> magnitude ``(b, t, h, w)``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cinemri_tpu_torch.models.cinenet import batched_kernel_and_maps
from cinemri_tpu_torch.models.denoisers.crnn import BCRNN, FusedSumConv2d
from cinemri_tpu_torch.models.denoisers.kspace_cnn import KSpaceCNN
from cinemri_tpu_torch.models.remat import call_remat, check_remat_policy
from cinemri_tpu_torch.models.varnet import LAMBDA_INIT, SensitivityModel
from cinemri_tpu_torch.models.xpdnet import XPDNetSensitivityModel
from cinemri_tpu_torch.ops.cplx import (
    Complex,
    concat,
    crepeat,
    from_multi_channels,
    to_multi_channels,
)
from cinemri_tpu_torch.parallel.mesh import partial_by_prefix
from cinemri_tpu_torch.physics.cg import conj_grad
from cinemri_tpu_torch.physics.operators import (
    apply_mask,
    coil_weight,
    is_line_mask,
    masked_normal_kernel,
    normal_plus_lambda,
    normal_plus_lambda_kernel,
    sens_expand,
    sens_reduce,
    soft_dc,
    soft_dc_image_kernel,
)

__all__ = ["CRNNTrunk", "VarNetRNN", "CineNetRNN", "XPDNetRNN"]

Hiddens = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _check_unported(packed: bool, trunk_block) -> None:
    if packed or tuple(trunk_block):
        raise NotImplementedError(
            "the packed CRNN trunk (packed=True, trunk_block) is not ported yet (ROADMAP "
            "Queue 1, item 14: packed_unet.py); the dense trunk computes the same function")


class CRNNTrunk(nn.Module):
    """BCRNN, three ``relu(conv([x, h]))`` layers and an output conv.

    ``x_in (t, b, in_ch, h, w)``; hiddens ``h0 (t, b, chans, h, w)`` and
    ``h1..h3 (t·b, chans, h, w)``. Returns the correction ``(t·b, out_ch, h,
    w)`` and the new hiddens."""

    def __init__(self, chans: int, in_ch: int = 2, out_ch: int = 2):
        super().__init__()
        self.bcrnn = BCRNN(in_ch, chans)
        self.conv1 = FusedSumConv2d((chans, chans), chans)
        self.conv2 = FusedSumConv2d((chans, chans), chans)
        self.conv3 = FusedSumConv2d((chans, chans), chans)
        self.conv4 = nn.Conv2d(chans, out_ch, 3, padding=1)

    def forward(self, x_in: torch.Tensor, hiddens: Hiddens):
        h0, h1, h2, h3 = hiddens
        t, b = x_in.shape[:2]
        x0 = self.bcrnn(x_in, h0)
        x1 = F.relu(self.conv1(x0.reshape(t * b, *x0.shape[2:]), h1))
        x2 = F.relu(self.conv2(x1, h2))
        x3 = F.relu(self.conv3(x2, h3))
        return self.conv4(x3), (x0, x1, x2, x3)


def _zero_hiddens(like: torch.Tensor, t: int, b: int, h: int, w: int, chans: int) -> Hiddens:
    z = lambda *shape: like.new_zeros(shape)
    return (z(t, b, chans, h, w), z(t * b, chans, h, w), z(t * b, chans, h, w),
            z(t * b, chans, h, w))


def _image_to_tb(x: Complex) -> torch.Tensor:
    """``(b, t, h, w)`` Complex -> ``(t, b, 2, h, w)`` real channels [re, im]."""
    return torch.stack([x.re.transpose(0, 1), x.im.transpose(0, 1)], dim=2)


def _tb_to_image(r: torch.Tensor) -> Complex:
    """``(t, b, 2, h, w)`` -> ``(b, t, h, w)`` Complex, contiguous planes."""
    return Complex(r[:, :, 0].transpose(0, 1).contiguous(), r[:, :, 1].transpose(0, 1).contiguous())


def _trunk_image(trunk: CRNNTrunk, x: Complex, hiddens: Hiddens):
    """The trunk's residual correction of the image ``x (b, t, h, w)``."""
    b, t, h, w = x.shape
    x_in = _image_to_tb(x)
    x4, hiddens = trunk(x_in, hiddens)
    out = x_in.reshape(t * b, 2, h, w) + x4
    return _tb_to_image(out.reshape(t, b, 2, h, w)), hiddens


class VarNetRNN(nn.Module):
    """VarNet-CRNN: the learned sens net, then ``num_cascades`` iterations of
    the CRNN trunk and a soft DC step with one shared λ."""

    def __init__(
        self,
        num_cascades: int = 12,
        sens_chans: int = 8,
        sens_pools: int = 4,
        chans: int = 18,
        kernel_dc: bool = True,
        packed: bool = False,
        trunk_block: tuple = (),
        remat: bool = True,
        remat_policy: str = "",
        coil_axis: str = "",
    ):
        super().__init__()
        _check_unported(packed, trunk_block)
        check_remat_policy(remat_policy)
        self.num_cascades = num_cascades
        self.chans = chans
        self.kernel_dc = kernel_dc
        self.remat = remat
        self.coil_axis = coil_axis
        self.sens_net = SensitivityModel(sens_chans, sens_pools, coil_axis=coil_axis)
        self.trunk = CRNNTrunk(chans)
        self.lambda_reg = nn.Parameter(torch.tensor(LAMBDA_INIT))

    def partial_parameters(self) -> Dict[str, Tuple[str, ...]]:
        """The sens net's gradient is partial on the coil axis."""
        return partial_by_prefix(self, {"sens_net.": self.coil_axis})

    def _iteration(self, x: Complex, hiddens: Hiddens, ref: Complex, mask: torch.Tensor,
                   sens_maps: Complex, dc_kernel, rss0):
        out, hiddens = _trunk_image(self.trunk, x, hiddens)
        out = out[:, :, None]  # (b, t, 1, h, w)
        v = F.softplus(self.lambda_reg)
        coil = self.coil_axis
        if dc_kernel is None:  # ref is the k-space reference
            dc = soft_dc(sens_expand(out, sens_maps, coil), ref, mask, v)
            return sens_reduce(dc, sens_maps, coil_axis=coil)[:, :, 0], hiddens
        # ref is the zero-filled image: no DFT per iteration
        out = soft_dc_image_kernel(out, ref, dc_kernel, sens_maps, v, rss_sq=rss0, coil_axis=coil)
        return out[:, :, 0], hiddens

    def forward(self, masked_kspace: Complex, mask: torch.Tensor) -> torch.Tensor:
        coil = self.coil_axis
        sens_maps = self.sens_net(masked_kspace, mask)
        x_ref = sens_reduce(masked_kspace, sens_maps, coil_axis=coil)  # (b, t, 1, h, w)
        x = x_ref[:, :, 0]
        b, t, h, w = x.shape
        hiddens = _zero_hiddens(x.re, t, b, h, w, self.chans)
        if self.kernel_dc and is_line_mask(mask):
            dc_kernel, rss0, ref = masked_normal_kernel(mask), coil_weight(sens_maps, coil), x_ref
        else:
            dc_kernel, rss0, ref = None, None, masked_kspace
        for _ in range(self.num_cascades):
            x, hiddens = call_remat(self._iteration, self.remat, x, hiddens, ref, mask, sens_maps,
                                    dc_kernel, rss0)
        return x.abs()


class CineNetRNN(nn.Module):
    """CineNet-CRNN: iterations of the CRNN trunk and a CG solve of
    ``(AᴴMA + v·I) x = x_ref + v·out`` from ``out``, one shared λ; takes
    precomputed sensitivity maps."""

    def __init__(
        self,
        num_cascades: int = 10,
        cg_iters: int = 4,
        chans: int = 64,
        kernel_dc: bool = True,
        packed: bool = False,
        trunk_block: tuple = (),
        remat: bool = True,
        remat_policy: str = "",
        coil_axis: str = "",
    ):
        super().__init__()
        _check_unported(packed, trunk_block)
        check_remat_policy(remat_policy)
        self.num_cascades = num_cascades
        self.cg_iters = cg_iters
        self.chans = chans
        self.kernel_dc = kernel_dc
        self.remat = remat
        self.coil_axis = coil_axis
        self.trunk = CRNNTrunk(chans)
        self.lambda_reg = nn.Parameter(torch.tensor(LAMBDA_INIT))

    def partial_parameters(self) -> Dict[str, Tuple[str, ...]]:
        """Every rank computes every gradient whole."""
        return partial_by_prefix(self, {})

    def _iteration(self, x: Complex, hiddens: Hiddens, x_ref: Complex, mask: torch.Tensor,
                   sens_maps: Complex, dc_kernel):
        out, hiddens = _trunk_image(self.trunk, x, hiddens)
        out = out[:, :, None]  # (b, t, 1, h, w)
        v = F.softplus(self.lambda_reg)  # a 0-d tensor on the device
        rhs = x_ref + v * out
        if dc_kernel is None:
            def op(z):
                return normal_plus_lambda(z, mask, sens_maps, v, self.coil_axis)
        else:
            def op(z):
                return normal_plus_lambda_kernel(z, dc_kernel, sens_maps, v, self.coil_axis)
        return conj_grad(op, rhs, out, self.cg_iters)[:, :, 0], hiddens

    def forward(self, masked_kspace: Complex, mask: torch.Tensor,
                sens_maps: Complex) -> torch.Tensor:
        x_ref = sens_reduce(masked_kspace, sens_maps, coil_axis=self.coil_axis)  # (b, t, 1, h, w)
        x = x_ref[:, :, 0]
        b, t, h, w = x.shape
        hiddens = _zero_hiddens(x.re, t, b, h, w, self.chans)
        dc_kernel = None
        if self.kernel_dc and is_line_mask(mask):
            dc_kernel, sens_maps = batched_kernel_and_maps(mask, sens_maps, b)
        for _ in range(self.num_cascades):
            x, hiddens = call_remat(self._iteration, self.remat, x, hiddens, x_ref, mask,
                                    sens_maps, dc_kernel)
        return x.abs()


class XPDNetRNN(nn.Module):
    """XPDNet-CRNN: primal-dual buffers with a CRNN image correction over
    the ``n_primal + 1``-slot buffer (the buffer and the backward-operator
    image). With ``primal_only`` (the reference's default) every weight is
    shared by the iterations and the k-step is the measurement residual;
    otherwise a :class:`KSpaceCNN` per iteration (``kspace_nets[i]``)
    updates an ``n_dual``-slot k-space buffer."""

    def __init__(
        self,
        num_cascades: int = 12,
        sens_chans: int = 8,
        sens_pools: int = 4,
        chans: int = 18,
        primal_only: bool = True,
        n_primal: int = 5,
        n_dual: int = 1,
        kernel_dc: bool = True,
        packed: bool = False,
        trunk_block: tuple = (),
        remat: bool = True,
        remat_policy: str = "",
        coil_axis: str = "",
    ):
        super().__init__()
        _check_unported(packed, trunk_block)
        check_remat_policy(remat_policy)
        self.num_cascades = num_cascades
        self.chans = chans
        self.primal_only = primal_only
        self.n_primal = n_primal
        self.n_dual = n_dual
        self.kernel_dc = kernel_dc
        self.remat = remat
        self.coil_axis = coil_axis
        self.sens_net = XPDNetSensitivityModel(sens_chans, sens_pools, coil_axis=coil_axis)
        self.trunk = CRNNTrunk(chans, in_ch=2 * (n_primal + 1), out_ch=2 * n_primal)
        if not primal_only:
            self.kspace_nets = nn.ModuleList(
                KSpaceCNN(2 * (n_dual + 2), 2 * n_dual) for _ in range(num_cascades))

    def partial_parameters(self) -> Dict[str, Tuple[str, ...]]:
        """Partial on the coil axis: the sens net and, without
        ``primal_only``, the k-space nets (each rank runs them on its
        coils); the CRNN trunk's is whole on every rank."""
        return partial_by_prefix(self, {"sens_net.": self.coil_axis,
                                        "kspace_nets.": self.coil_axis})

    def _head(self, buf: torch.Tensor) -> Complex:
        """Complex slot 0 of the buffer ``(t, b, 2n, h, w)``: ``(b, t, 1, h, w)``,
        strided views (``normal_plus_lambda_kernel`` copies them)."""
        n = self.n_primal
        return Complex(buf[:, :, 0].transpose(0, 1)[:, :, None],
                       buf[:, :, n].transpose(0, 1)[:, :, None])

    def _iteration(self, buf: torch.Tensor, kspace_buffer, hiddens: Hiddens, ref_kspace: Complex,
                   mask: torch.Tensor, sens_maps: Complex, x_ref: Complex, dc_kernel,
                   kspace_net=None):
        """One k-step, the backward operator and the CRNN correction of the
        buffer; returns ``(buf, kspace_buffer, hiddens)``."""
        n = self.n_primal
        coil = self.coil_axis
        head = self._head(buf)
        if dc_kernel is not None:
            # measurement-residual k-step and backward operator collapsed:
            # Sᴴ F⁻¹ M (F S head − k_ref) = N(head) − x_ref
            bwd = normal_plus_lambda_kernel(head, dc_kernel, sens_maps, 0.0, coil)
            bwd = (bwd - x_ref)[:, :, 0]
        else:
            fwd = apply_mask(sens_expand(head, sens_maps, coil), mask)  # (b, t, c, h, w)
            if kspace_net is not None:
                cat = concat([kspace_buffer, fwd[..., None], ref_kspace[..., None]], axis=-1)
                kspace_buffer = from_multi_channels(kspace_net(to_multi_channels(cat)))
            else:
                kspace_buffer = (fwd - ref_kspace)[..., None]
            bwd = sens_reduce(apply_mask(kspace_buffer[..., 0], mask), sens_maps,
                              coil_axis=coil)[:, :, 0]
        t, b, _, h, w = buf.shape
        tb = lambda a: a.transpose(0, 1)[:, :, None]  # (b, t, h, w) -> (t, b, 1, h, w)
        x_in = torch.cat([buf[:, :, :n], tb(bwd.re), buf[:, :, n:], tb(bwd.im)], dim=2)
        x4, hiddens = self.trunk(x_in, hiddens)  # (t·b, 2n, h, w)
        return buf + x4.reshape(t, b, 2 * n, h, w), kspace_buffer, hiddens

    def forward(self, masked_kspace: Complex, mask: torch.Tensor) -> torch.Tensor:
        sens_maps = self.sens_net(masked_kspace, mask)
        # (b, t, 1, h, w)
        x_ref = sens_reduce(apply_mask(masked_kspace, mask), sens_maps, coil_axis=self.coil_axis)
        b, t, _, h, w = x_ref.shape
        n = self.n_primal
        # every slot starts at the zero-filled image: n real channels, n imaginary
        image = x_ref[:, :, 0]
        buf = torch.cat([image.re.transpose(0, 1)[:, :, None].expand(t, b, n, h, w),
                         image.im.transpose(0, 1)[:, :, None].expand(t, b, n, h, w)], dim=2)
        hiddens = _zero_hiddens(buf, t, b, h, w, self.chans)
        if self.primal_only:
            dc_kernel = (masked_normal_kernel(mask) if self.kernel_dc and is_line_mask(mask)
                         else None)
            for _ in range(self.num_cascades):
                buf, _, hiddens = call_remat(self._iteration, self.remat, buf, None, hiddens,
                                             masked_kspace, mask, sens_maps, x_ref, dc_kernel)
        else:
            kspace_buffer = crepeat(masked_kspace[..., None], self.n_dual, axis=-1)
            for kspace_net in self.kspace_nets:
                buf, kspace_buffer, hiddens = self._iteration(
                    buf, kspace_buffer, hiddens, masked_kspace, mask, sens_maps, x_ref, None,
                    kspace_net)
        return self._head(buf)[:, :, 0].abs()
