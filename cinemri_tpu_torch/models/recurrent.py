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
applies ``normal_plus_lambda_kernel`` (bound as CineNet's,
``models.cinenet.bind_dc``, so a served solve on the card replays CUDA
graphs between its normal applies), and XPDNet's measurement-residual
k-step and backward operator collapse to ``N(head) − x_ref`` (one normal
apply with λ = 0); otherwise the direct k-space forms.

Layouts: the trunk is NCHW with t leading, ``(t, b, ch, h, w)``, and
folded ``(t·b, ch, h, w)`` after the BCRNN. XPDNet's image buffer is carried
as the trunk sees it, ``(t, b, 2n, h, w)`` real with the n real channels
then the n imaginary ones (``to_multi_channels``); its head, complex slot 0,
is channels ``0`` and ``n``.

The packed trunk (``packed``, or a ``trunk_block`` that overrides the rule):
with an ``(h, w)`` block from :func:`_trunk_block` (the JAX package's
128-lane rule: (2, 2) up to 32 channels, (1, 2) up to 64, none on odd
sizes) the trunk's input, hidden states and output are space-to-depth
packed (``denoisers.crnn.pack2``) and its convolutions run on the packed
grid with the same parameters (``models/denoisers/packed_unet.py``).
VarNet and CineNet pack the image before the trunk and unpack the
corrected one; XPDNet carries its buffer packed across the iterations (the
JAX package's ``_XPDNetRNNPackedStep``): only the head's packed channels,
``[0, B)`` and ``[n·B, (n+1)·B)``, are unpacked for the data-consistency
step, and only the backward-operator image is packed into the trunk's
input, a channel concatenation of packed slices. VarNet-CRNN's sens net
takes ``packed`` too; XPDNet's stays dense, as in the JAX package.

``bf16`` runs the trunk in bf16 (``models/denoisers/activations.py``): its
hidden states are bf16 from the zeros on, the BCRNN casts its inputs, every
fused convolution runs in bf16, and the correction is cast to f32 before the
residual, as in the JAX package; the sens nets stay as the non-recurrent
families have them (VarNet's NormUnet in bf16, XPDNet's U-Net in f32). Each
iteration is checkpointed under ``remat_policy`` (``models/remat.py``);
``remat_prevent_cse`` is accepted and does nothing.

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

from cinemri_tpu_torch.models.cinenet import bind_dc
from cinemri_tpu_torch.models.denoisers.activations import act_dtype, output, resolve_dtype
from cinemri_tpu_torch.models.denoisers.crnn import BCRNN, FusedSumConv2d, pack2, unpack2
from cinemri_tpu_torch.models.denoisers.kspace_cnn import KSpaceCNN
from cinemri_tpu_torch.models.denoisers.packed_unet import PackedConv2d, block_size
from cinemri_tpu_torch.models.remat import call_remat, check_remat_policy, tag_conv_out
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
from cinemri_tpu_torch.physics.operators import (
    apply_mask,
    coil_weight,
    is_line_mask,
    masked_normal_kernel,
    normal_plus_lambda_kernel,
    sens_expand,
    sens_reduce,
    soft_dc,
    soft_dc_image_kernel,
)

__all__ = ["CRNNTrunk", "VarNetRNN", "CineNetRNN", "XPDNetRNN"]

Hiddens = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class CRNNTrunk(nn.Module):
    """BCRNN, three ``relu(conv([x, h]))`` layers and an output conv.

    ``x_in (t, b, in_ch, h, w)``; hiddens ``h0 (t, b, chans, h, w)`` and
    ``h1..h3 (t·b, chans, h, w)``, in ``dtype``. Returns the correction
    ``(t·b, out_ch, h, w)``, f32 from bf16 activations, and the new hiddens.
    With a ``block`` every one of them is packed (``crnn.pack2``)."""

    def __init__(self, chans: int, in_ch: int = 2, out_ch: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.bcrnn = BCRNN(in_ch, chans, dtype=dtype)
        self.conv1 = FusedSumConv2d((chans, chans), chans, dtype=dtype)
        self.conv2 = FusedSumConv2d((chans, chans), chans, dtype=dtype)
        self.conv3 = FusedSumConv2d((chans, chans), chans, dtype=dtype)
        self.conv4 = PackedConv2d(chans, out_ch, 3, padding=1)

    def forward(self, x_in: torch.Tensor, hiddens: Hiddens, block=()):
        h0, h1, h2, h3 = hiddens
        t, b = x_in.shape[:2]
        x0 = self.bcrnn(x_in, h0, block)
        x1 = F.relu(self.conv1(x0.reshape(t * b, *x0.shape[2:]), h1, block=block))
        x2 = F.relu(self.conv2(x1, h2, block=block))
        x3 = F.relu(self.conv3(x2, h3, block=block))
        with tag_conv_out():  # the JAX package's conv4_x is a tagged fused conv
            x4 = self.conv4(x3, block, self.dtype)
        return output(x4, self.dtype), (x0, x1, x2, x3)


def _trunk_block(h: int, w: int, packed: bool, chans: int = 18) -> tuple:
    """The trunk's ``(h, w)`` block, the JAX package's rule: (2, 2) while
    4·chans fits the TPU's 128 lanes, (1, 2) while 2·chans does; ``()``
    when a size is odd or ``packed`` is off."""
    if not packed or h % 2 or w % 2:
        return ()
    if chans * 4 <= 128:
        return (2, 2)
    if chans * 2 <= 128:
        return (1, 2)
    return ()


def _zero_hiddens(like: torch.Tensor, t: int, b: int, h: int, w: int, chans: int,
                  dtype: torch.dtype, block=()) -> Hiddens:
    """Zero hidden states, packed with ``block``."""
    if block:
        h, w, chans = h // block[0], w // block[1], chans * block_size(block)
    z = lambda *shape: like.new_zeros(shape, dtype=act_dtype(dtype, like))
    return (z(t, b, chans, h, w), z(t * b, chans, h, w), z(t * b, chans, h, w),
            z(t * b, chans, h, w))


def _image_to_tb(x: Complex) -> torch.Tensor:
    """``(b, t, h, w)`` Complex -> ``(t, b, 2, h, w)`` real channels [re, im]."""
    return torch.stack([x.re.transpose(0, 1), x.im.transpose(0, 1)], dim=2)


def _tb_to_image(r: torch.Tensor) -> Complex:
    """``(t, b, 2, h, w)`` -> ``(b, t, h, w)`` Complex, contiguous planes."""
    return Complex(r[:, :, 0].transpose(0, 1).contiguous(), r[:, :, 1].transpose(0, 1).contiguous())


def _trunk_image(trunk: CRNNTrunk, x: Complex, hiddens: Hiddens, block=()):
    """The trunk's residual correction of the image ``x (b, t, h, w)``, the
    trunk packed with ``block``."""
    b, t, h, w = x.shape
    x_in = _image_to_tb(x)
    if block:
        x_in = pack2(x_in, block)
    x4, hiddens = trunk(x_in, hiddens, block)
    out = x_in.reshape(t * b, *x_in.shape[2:]) + x4
    if block:
        out = unpack2(out, block)
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
        remat_prevent_cse: bool = True,
        bf16: bool = False,
        coil_axis: str = "",
    ):
        super().__init__()
        check_remat_policy(remat_policy)
        self.packed = packed
        self.trunk_block = tuple(trunk_block)
        self.num_cascades = num_cascades
        self.chans = chans
        self.kernel_dc = kernel_dc
        self.remat = remat
        self.remat_policy = remat_policy
        self.dtype = resolve_dtype(bf16)
        self.coil_axis = coil_axis
        self.sens_net = SensitivityModel(sens_chans, sens_pools, packed=packed,
                                         coil_axis=coil_axis, dtype=self.dtype)
        self.trunk = CRNNTrunk(chans, dtype=self.dtype)
        self.lambda_reg = nn.Parameter(torch.tensor(LAMBDA_INIT))

    def partial_parameters(self) -> Dict[str, Tuple[str, ...]]:
        """The sens net's gradient is partial on the coil axis."""
        return partial_by_prefix(self, {"sens_net.": self.coil_axis})

    def _iteration(self, x: Complex, hiddens: Hiddens, ref: Complex, mask: torch.Tensor,
                   sens_maps: Complex, dc_kernel, rss0, block):
        out, hiddens = _trunk_image(self.trunk, x, hiddens, block)
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
        block = self.trunk_block or _trunk_block(h, w, self.packed, self.chans)
        hiddens = _zero_hiddens(x.re, t, b, h, w, self.chans, self.dtype, block)
        if self.kernel_dc and is_line_mask(mask):
            dc_kernel, rss0, ref = masked_normal_kernel(mask), coil_weight(sens_maps, coil), x_ref
        else:
            dc_kernel, rss0, ref = None, None, masked_kspace
        for _ in range(self.num_cascades):
            x, hiddens = call_remat(self._iteration, self.remat, self.remat_policy, x, hiddens,
                                    ref, mask, sens_maps, dc_kernel, rss0, block)
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
        remat_prevent_cse: bool = True,
        bf16: bool = False,
        coil_axis: str = "",
    ):
        super().__init__()
        check_remat_policy(remat_policy)
        self.packed = packed
        self.trunk_block = tuple(trunk_block)
        self.num_cascades = num_cascades
        self.cg_iters = cg_iters
        self.chans = chans
        self.kernel_dc = kernel_dc
        self.remat = remat
        self.remat_policy = remat_policy
        self.dtype = resolve_dtype(bf16)
        self.coil_axis = coil_axis
        self.trunk = CRNNTrunk(chans, dtype=self.dtype)
        self.lambda_reg = nn.Parameter(torch.tensor(LAMBDA_INIT))

    def partial_parameters(self) -> Dict[str, Tuple[str, ...]]:
        """Every rank computes every gradient whole."""
        return partial_by_prefix(self, {})

    def _iteration(self, x: Complex, hiddens: Hiddens, dc, block):
        out, hiddens = _trunk_image(self.trunk, x, hiddens, block)
        return dc(out[:, :, None], self.lambda_reg)[:, :, 0], hiddens

    def forward(self, masked_kspace: Complex, mask: torch.Tensor,
                sens_maps: Complex) -> torch.Tensor:
        dc = bind_dc(masked_kspace, mask, sens_maps, self.kernel_dc, self.cg_iters, self.coil_axis)
        x = dc.image_ref[:, :, 0]
        b, t, h, w = x.shape
        block = self.trunk_block or _trunk_block(h, w, self.packed, self.chans)
        hiddens = _zero_hiddens(x.re, t, b, h, w, self.chans, self.dtype, block)
        for _ in range(self.num_cascades):
            x, hiddens = call_remat(self._iteration, self.remat, self.remat_policy, x, hiddens, dc,
                                    block)
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
        remat_prevent_cse: bool = True,
        bf16: bool = False,
        coil_axis: str = "",
    ):
        super().__init__()
        check_remat_policy(remat_policy)
        self.packed = packed
        self.trunk_block = tuple(trunk_block)
        self.num_cascades = num_cascades
        self.chans = chans
        self.primal_only = primal_only
        self.n_primal = n_primal
        self.n_dual = n_dual
        self.kernel_dc = kernel_dc
        self.remat = remat
        self.remat_policy = remat_policy
        self.dtype = resolve_dtype(bf16)
        self.coil_axis = coil_axis
        self.sens_net = XPDNetSensitivityModel(sens_chans, sens_pools, coil_axis=coil_axis)
        self.trunk = CRNNTrunk(chans, in_ch=2 * (n_primal + 1), out_ch=2 * n_primal,
                               dtype=self.dtype)
        if not primal_only:
            self.kspace_nets = nn.ModuleList(
                KSpaceCNN(2 * (n_dual + 2), 2 * n_dual) for _ in range(num_cascades))

    def partial_parameters(self) -> Dict[str, Tuple[str, ...]]:
        """Partial on the coil axis: the sens net and, without
        ``primal_only``, the k-space nets (each rank runs them on its
        coils); the CRNN trunk's is whole on every rank."""
        return partial_by_prefix(self, {"sens_net.": self.coil_axis,
                                        "kspace_nets.": self.coil_axis})

    def _head(self, buf: torch.Tensor, block=()) -> Complex:
        """Complex slot 0 of the buffer ``(t, b, 2n, h, w)``: ``(b, t, 1, h, w)``,
        strided views (``normal_plus_lambda_kernel`` copies them); of a buffer
        packed with ``block``, its two packed channel slices unpacked."""
        n = self.n_primal
        if block:
            m = block_size(block)
            return Complex(unpack2(buf[:, :, :m], block).transpose(0, 1),
                           unpack2(buf[:, :, n * m:(n + 1) * m], block).transpose(0, 1))
        return Complex(buf[:, :, 0].transpose(0, 1)[:, :, None],
                       buf[:, :, n].transpose(0, 1)[:, :, None])

    def _iteration(self, buf: torch.Tensor, kspace_buffer, hiddens: Hiddens, ref_kspace: Complex,
                   mask: torch.Tensor, sens_maps: Complex, x_ref: Complex, dc_kernel,
                   kspace_net=None, block=()):
        """One k-step, the backward operator and the CRNN correction of the
        buffer (packed with ``block``); returns ``(buf, kspace_buffer,
        hiddens)``."""
        n = self.n_primal
        coil = self.coil_axis
        head = self._head(buf, block)
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
        # (b, t, h, w) -> (t, b, 1, h, w), packed with the buffer: the trunk's
        # input is a channel concatenation of packed slices
        tb = lambda a: pack2(a.transpose(0, 1)[:, :, None], block) if block else (
            a.transpose(0, 1)[:, :, None])
        m = block_size(block)
        x_in = torch.cat([buf[:, :, :n * m], tb(bwd.re), buf[:, :, n * m:], tb(bwd.im)], dim=2)
        x4, hiddens = self.trunk(x_in, hiddens, block)  # (t·b, 2n·B, h/bh, w/bw)
        return buf + x4.reshape(buf.shape), kspace_buffer, hiddens

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
        block = self.trunk_block or _trunk_block(h, w, self.packed, self.chans)
        if block:  # packed once here, unpacked once at the end (its head only)
            buf = pack2(buf, block)
        hiddens = _zero_hiddens(buf, t, b, h, w, self.chans, self.dtype, block)
        if self.primal_only:
            dc_kernel = (masked_normal_kernel(mask) if self.kernel_dc and is_line_mask(mask)
                         else None)
            for _ in range(self.num_cascades):
                buf, _, hiddens = call_remat(self._iteration, self.remat, self.remat_policy, buf,
                                             None, hiddens, masked_kspace, mask, sens_maps, x_ref,
                                             dc_kernel, None, block)
        else:
            kspace_buffer = crepeat(masked_kspace[..., None], self.n_dual, axis=-1)
            for kspace_net in self.kspace_nets:
                buf, kspace_buffer, hiddens = self._iteration(
                    buf, kspace_buffer, hiddens, masked_kspace, mask, sens_maps, x_ref, None,
                    kspace_net, block)
        return self._head(buf, block)[:, :, 0].abs()
