"""MRI encoding-operator algebra on Complex (re, im) pairs.

Counterpart of ``cinemri_tpu/physics/operators.py`` (the VarNet and CineNet
subset, and the soft-SENSE operators over multi-set ESPIRiT maps).

Shapes: k-space ``(b, t, c, h, w)`` Complex; sensitivity maps
``(b, 1, c, h, w)`` Complex; coil-combined images ``(b, t, 1, h, w)``
Complex; masks real float tensors, canonically ``(b, t|1, 1, h, 1)``.

The masked normal operator of a line mask runs through
:class:`~cinemri_tpu_torch.ops.kernels.normal_cuda.NormalApply`: the
hand-written CUDA kernels (forward and backward) for CUDA tensors, their
plain versions for CPU tensors. :func:`set_normal_backend` ``("torch")``
sends CUDA tensors to the plain versions too, in both directions, as an
explicit choice for comparison.

``coil_axis`` (default ``""``, no axis) names the ``coil`` dim of the
ambient mesh (``parallel.set_mesh``) over which the coils are split: k-space
and maps then hold this rank's coils only, every coil sum
(:func:`sens_reduce`, :func:`coil_weight`, the normal operator's ``Σ_c``)
is all-reduced over the coil group, and a replicated image entering
per-coil work (:func:`sens_expand`, the normal operator's ``x``) sums its
gradient over the group (``parallel/autograd.py``). The JAX package pins the
same layout with ``constrain_coil_axis`` and lets XLA place those
all-reduces; its counterpart here is ``parallel.coil_shard``, which takes
a rank's coils of a whole tensor.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from cinemri_tpu_torch.ops.cplx import Complex, csum
from cinemri_tpu_torch.ops.fft import _dft_tensors, fft2c, get_dft_precision, ifft2c
from cinemri_tpu_torch.ops.kernels import normal_cuda, trace_safe
from cinemri_tpu_torch.parallel.autograd import copy_to_group, reduce_from_group
from cinemri_tpu_torch.parallel.mesh import mesh_axis
from cinemri_tpu_torch.physics import cg
from cinemri_tpu_torch.physics.cg import conj_grad

__all__ = [
    "sens_expand",
    "sens_reduce",
    "apply_mask",
    "soft_dc",
    "normal_plus_lambda",
    "is_line_mask",
    "masked_normal_kernel",
    "normal_plus_lambda_kernel",
    "coil_weight",
    "coil_copy",
    "coil_sum",
    "soft_dc_image_kernel",
    "cg_dc",
    "CGDataConsistency",
    "set_normal_backend",
    "get_normal_backend",
    "soft_sense_expand",
    "soft_sense_reduce",
    "soft_sense_rss",
    "soft_sense_recon",
]

COIL_AXIS = 2

# Copies of x made by normal_plus_lambda_kernel (one per call that copies):
# the kernel takes contiguous planes, and XPDNet's head is a strided slice of
# its channel-last buffer.
COPIES = 0

# "kernel": CUDA tensors take the CUDA kernel, CPU tensors its plain version;
# "torch": every tensor takes the plain version.
_NORMAL_BACKEND = "kernel"


def set_normal_backend(backend: str) -> None:
    """Select the normal-operator apply backend ('kernel' or 'torch')."""
    global _NORMAL_BACKEND
    if backend not in ("kernel", "torch"):
        raise ValueError(f"unknown normal backend {backend!r}")
    _NORMAL_BACKEND = backend


def get_normal_backend() -> str:
    return _NORMAL_BACKEND


def coil_copy(x, coil_axis: str = ""):
    """A replicated ``x`` (Complex or real) entering per-coil work: itself,
    its gradient summed over the coil group."""
    ax = mesh_axis(coil_axis)
    if ax is None:
        return x
    if isinstance(x, Complex):
        return Complex(*copy_to_group(ax, x.re, x.im))
    return copy_to_group(ax, x)[0]


def coil_sum(x, coil_axis: str = ""):
    """A sum over this rank's coils (Complex or real) completed over the
    coil group: one all-reduce."""
    ax = mesh_axis(coil_axis)
    if ax is None:
        return x
    if isinstance(x, Complex):
        return Complex(*reduce_from_group(ax, x.re, x.im))
    return reduce_from_group(ax, x)[0]


def sens_expand(image: Complex, sens_maps: Complex, coil_axis: str = "") -> Complex:
    """Coil-combined image -> multi-coil k-space: ``F (S ⊙ x)``."""
    return fft2c(coil_copy(image, coil_axis) * sens_maps)


def sens_reduce(kspace: Complex, sens_maps: Complex, keepdims: bool = True,
                coil_axis: str = "") -> Complex:
    """Multi-coil k-space -> coil-combined image: ``Σ_c conj(S) ⊙ F⁻¹ k``."""
    image = ifft2c(kspace)
    return coil_sum(csum(image * sens_maps.conj(), axis=COIL_AXIS, keepdims=keepdims), coil_axis)


def apply_mask(kspace: Complex, mask: torch.Tensor) -> Complex:
    """Subsample k-space by elementwise mask multiplication."""
    return kspace * mask


def soft_dc(model_term: Complex, ref_kspace: Complex, mask: torch.Tensor, v) -> Complex:
    """Soft data consistency ``(1-m)·Tx + m·(Tx + v·k_ref)/(1+v)``, ``v = softplus(λ)``."""
    return (1 - mask) * model_term + mask * ((model_term + v * ref_kspace) / (1 + v))


def normal_plus_lambda(x: Complex, mask: torch.Tensor, sens_maps: Complex, lam,
                       coil_axis: str = "") -> Complex:
    """``H(x) = Aᴴ M A x + λ x``, the CG system operator, in its direct form:
    ``sens_expand``, mask, ``sens_reduce`` (four DFTs per apply). CineNet
    runs it when ``kernel_dc`` is off or the mask is not a line mask."""
    k = apply_mask(sens_expand(x, sens_maps, coil_axis), mask)
    return sens_reduce(k, sens_maps, keepdims=True, coil_axis=coil_axis) + lam * x


def is_line_mask(mask: torch.Tensor) -> bool:
    """True for Cartesian phase-encode line masks ``(b, t|1, 1, h, 1)``, the
    shape :func:`masked_normal_kernel` collapses into an h-axis matrix. The
    kernelized DC path also needs the mask values to be binary 0/1."""
    return mask.ndim == 5 and mask.shape[2] == 1 and mask.shape[-1] == 1


def masked_normal_kernel(mask: torch.Tensor, norm: str = "ortho") -> Complex:
    """``T = F_hᴴ · diag(m) · F_h`` per (batch, frame): ``(b, t|1, h, h)``.

    For a line mask the w-axis transform commutes with the mask and cancels
    in ``Aᴴ M A``, leaving one h x h complex matrix per (batch, frame).
    Three h x h products per matrix, with ``torch.matmul`` (the JAX package
    computes them outside any kernel too), in full f32 at every DFT
    precision: PyTorch has no 3xTF32 product, and one TF32 pass would round
    the DFT matrices to 10 bits, so the port's kernel at ``'high'`` is more
    exact than the JAX package's (``operators.py:243-249`` builds it at
    ``HIGH``, three bf16 passes). It is built once per forward, outside the
    cascades, so its cost does not grow with them.
    """
    if not is_line_mask(mask):
        raise ValueError(f"expected a line mask (b, t|1, 1, h, 1), got {tuple(mask.shape)}")
    h = mask.shape[3]
    wfr, wfi = trace_safe(_dft_tensors, h, False, False, norm, mask.device)
    wir, wii = trace_safe(_dft_tensors, h, True, False, norm, mask.device)
    m = mask[:, :, 0, :, 0].to(torch.float32)  # (b, t|1, h)
    # A = diag(m) @ W_f (row scaling), then T = W_i @ A
    ar = m[..., :, None] * wfr
    ai = m[..., :, None] * wfi
    return Complex(wir @ ar - wii @ ai, wir @ ai + wii @ ar)


def coil_weight(sens_maps: Complex, coil_axis: str = "") -> torch.Tensor:
    """``R0 = Σ_c |S_c|²``, a real tensor (b, 1, 1, h, w)."""
    return coil_sum(sens_maps.abs_sq().sum(dim=COIL_AXIS, keepdim=True), coil_axis)


def normal_plus_lambda_kernel(x: Complex, kernel: Complex, sens_maps: Complex, lam,
                              coil_axis: str = "") -> Complex:
    """``H(x) = Aᴴ M A x + λ x`` with a precomputed h-axis kernel.

    ``x (b, t, 1, h, w)``, ``kernel (b, t|1, h, h)`` from
    :func:`masked_normal_kernel`, ``sens_maps (b, 1, c, h, w)``; ``lam`` a
    Python float or a one-element tensor, passed through to the kernel on
    the device as it is (CineNet's ``softplus(λᵢ)``). Differentiable in
    ``x``, ``sens_maps`` and a tensor ``lam``; the kernel matrix is
    detached, as the JAX package stop-gradients it (it derives from the
    never-learned mask).

    A ``kernel`` or ``sens_maps`` of batch 1 is shared by the ``b`` volumes
    of ``x``, as the JAX package broadcasts it: it is copied to batch ``b``
    for the call (the CUDA kernel takes one K and one S per volume), and
    the gradient of shared maps sums over the batch. Callers that apply
    the operator many times (CineNet's CG) expand them once beforehand.
    An ``x`` that is not contiguous (XPDNet's head, a slice of its buffer)
    is copied for the kernel, and counted in :data:`COPIES`.

    On a ``coil_axis``, the kernel runs on this rank's coils with λ = 0, the
    partial sums are all-reduced over the coil group, and ``λ·x`` is added
    once after the reduction: λ's gradient is taken once, ``x``'s is summed
    over the group, and the maps' stays on the rank that holds them.
    """
    ax = mesh_axis(coil_axis)
    if ax is None:
        return _normal_apply(x, kernel, sens_maps, lam)
    out = coil_sum(_normal_apply(coil_copy(x, coil_axis), kernel, sens_maps, 0.0), coil_axis)
    return out if isinstance(lam, float) and lam == 0.0 else out + lam * x


def _normal_apply(x: Complex, kernel: Complex, sens_maps: Complex, lam) -> Complex:
    global COPIES
    b = x.shape[0]
    batched = lambda a: a.expand(b, *a.shape[1:]).contiguous()  # no copy at batch b
    xr, xi = x.re[:, :, 0], x.im[:, :, 0]
    if not (xr.is_contiguous() and xi.is_contiguous()):
        xr, xi = xr.contiguous(), xi.contiguous()
        COPIES += 1
    outr, outi = normal_cuda.NormalApply.apply(
        xr,
        xi,
        batched(kernel.re.detach()),
        batched(kernel.im.detach()),
        batched(sens_maps.re[:, 0]),
        batched(sens_maps.im[:, 0]),
        lam,
        _NORMAL_BACKEND == "torch",
        get_dft_precision(),
    )
    return Complex(outr[:, :, None], outi[:, :, None])


def soft_dc_image_kernel(
    model_out: Complex, x_ref: Complex, kernel: Complex, sens_maps: Complex, v,
    rss_sq: torch.Tensor | None = None, coil_axis: str = "",
) -> Complex:
    """The VarNet cascade's k-space round trip collapsed into image space:
    ``R0 ⊙ z − α·N(z) + α·x_ref`` with ``α = v/(1+v)``.

    Exact to f32 rounding for a binary 0/1 mask and ``x_ref`` from k-space
    already multiplied by that mask.
    """
    if rss_sq is None:
        rss_sq = coil_weight(sens_maps, coil_axis)
    alpha = v / (1 + v)
    n = normal_plus_lambda_kernel(model_out, kernel, sens_maps, 0.0, coil_axis)
    return model_out * rss_sq - alpha * n + alpha * x_ref


def cg_dc(model_out: Complex, lam: torch.Tensor, image_ref: Complex, operator,
          iters: int) -> Complex:
    """CineNet's data consistency: ``iters`` CG steps on ``(AᴴMA + v·I) x =
    x_ref + v·x_den`` from ``x_den`` (``model_out``), ``x_ref`` =
    ``image_ref``, ``v = softplus(λ)`` (a 0-d tensor on the device), with
    ``operator(z, v)`` applying ``AᴴMA + v·I`` (:func:`normal_plus_lambda_kernel`
    or :func:`normal_plus_lambda`)."""
    v = F.softplus(lam)
    rhs = image_ref + v * model_out
    return conj_grad(lambda z: operator(z, v), rhs, model_out, iters)


def _graphed_dc(iters: int, apply, xr, xi, lam, rr, ri) -> Complex:
    """:func:`cg_dc` as a graphed solve's body, on its buffers ``(x_den, λ,
    x_ref)``; the result is left in ``x_den``'s, where the next cascade
    reads it as its input and then refills them."""
    out = cg_dc(Complex(xr, xi), lam, Complex(rr, ri), apply, iters)
    xr.copy_(out.re)
    xi.copy_(out.im)
    return Complex(xr, xi)


def _switches() -> tuple:
    """The settings that pick a normal apply's kernels (the backend, the
    precision, the FP32 tile, the float32 matmul precision of the plain
    version): a graph replays the kernels it captured, so a change of any
    of them takes a new capture."""
    return (_NORMAL_BACKEND, get_dft_precision(), normal_cuda.get_fp32_tile(),
            torch.get_float32_matmul_precision())


class _Bound:
    """A thread's graphed CG data consistency for one layout of ``x_ref``,
    ``K`` and the maps: their buffers, which a request's binding fills, the
    operator over them, and the solve (:func:`_graphed_dc`) of the layouts
    of the last ``x_den`` and λ and of the :func:`_switches` it was made
    under."""

    def __init__(self, like):
        with torch.inference_mode(False):
            self.buffers = [torch.empty_like(t) for t in like]
        self.ref = self.buffers[:2]
        kernel, sens_maps = Complex(*self.buffers[2:4]), Complex(*self.buffers[4:])
        self.operator = lambda z, v: normal_plus_lambda_kernel(z, kernel, sens_maps, v)
        self.solve, self.switches = None, None


class CGDataConsistency:
    """A request's CG data consistency: its coil-combined image
    ``image_ref`` and operator (through ``kernel`` of
    :func:`masked_normal_kernel`, or the direct form on ``mask`` when
    ``kernel`` is None) bound once; ``dc(model_out, lam)`` is :func:`cg_dc`
    for one cascade.

    In the kernel form, where
    :func:`~cinemri_tpu_torch.physics.cg.graph_blocker` finds nothing in the
    way (dense CUDA tensors, grad mode off, no ``coil_axis``), ``image_ref``,
    ``kernel`` and ``sens_maps`` are copied into this thread's buffers for
    their layouts (:func:`~cinemri_tpu_torch.physics.cg.kept`), which
    :attr:`image_ref` and :attr:`operator` then read, so the caller's copies
    can go. A call whose ``model_out`` has ``image_ref``'s shape and passes
    the same check runs as the
    :class:`~cinemri_tpu_torch.physics.cg.GraphedSolve` over those buffers
    of its layouts and kernel settings (:func:`_switches`), captured at its
    first call: the eager loop's bits, left in the solve's ``x_den`` buffers
    until the next call on this thread. Every other call, and the direct
    form, whose k-space round trip the solve does not hold, run
    :func:`cg_dc` eagerly.
    """

    def __init__(self, image_ref: Complex, mask: torch.Tensor, sens_maps: Complex, kernel,
                 iters: int, coil_axis: str = ""):
        self.image_ref, self.iters = image_ref, iters
        if kernel is None:
            self.operator = lambda z, v: normal_plus_lambda(z, mask, sens_maps, v, coil_axis)
        else:
            self.operator = lambda z, v: normal_plus_lambda_kernel(z, kernel, sens_maps, v,
                                                                   coil_axis)
        self._bound = None
        if kernel is None or iters < 1:
            return
        bound = [image_ref.re, image_ref.im, kernel.re, kernel.im, sens_maps.re, sens_maps.im]
        if cg.graph_blocker(bound, coil_axis) is not None:
            return
        self._bound = cg.kept(("cg_dc", iters, cg.layout(bound)), lambda: _Bound(bound))
        for buf, t in zip(self._bound.buffers, bound):
            buf.copy_(t)
        self.image_ref, self.operator = Complex(*self._bound.ref), self._bound.operator

    def __call__(self, model_out: Complex, lam: torch.Tensor) -> Complex:
        bound = self._bound
        if bound is not None and torch.is_tensor(lam) and model_out.shape == self.image_ref.shape:
            args = [model_out.re, model_out.im, lam]
            if cg.graph_blocker(args) is None:
                switches = _switches()
                if (bound.solve is None or not bound.solve.fits(args + bound.ref)
                        or bound.switches != switches):
                    with torch.inference_mode(False):
                        made = [torch.empty_like(t) for t in args]
                    bound.solve = cg.GraphedSolve(functools.partial(_graphed_dc, self.iters),
                                                  made + bound.ref)
                    bound.switches = switches
                return bound.solve(self.operator, *args, *bound.ref)
        return cg_dc(model_out, lam, self.image_ref, self.operator, self.iters)


def soft_sense_expand(components: Complex, sens_maps_multi: Complex) -> Complex:
    """Soft-SENSE forward: component images -> multi-coil k-space.

    ``components``: (b, t, m, h, w) Complex — one image per ESPIRiT
    eigenvector set (data/espirit.py::espirit_maps_multi);
    ``sens_maps_multi``: (b, m, c, h, w). Returns ``F Σ_m S_m ⊙ x_m``
    of shape (b, t, c, h, w). With m=1 this is exactly :func:`sens_expand`.
    Soft-SENSE (Uecker et al. 2014) models aliased-FOV acquisitions the
    reference's hard single-map model cannot represent; out of reference
    scope, adjoint-tested against :func:`soft_sense_reduce`.
    """
    coil = csum(components[:, :, :, None] * sens_maps_multi[:, None], axis=2)  # (b, t, c, h, w)
    return fft2c(coil)


def soft_sense_reduce(kspace: Complex, sens_maps_multi: Complex) -> Complex:
    """Soft-SENSE adjoint: multi-coil k-space -> per-set component images.

    ``kspace``: (b, t, c, h, w); ``sens_maps_multi``: (b, m, c, h, w).
    Returns (b, t, m, h, w): ``x_m = Σ_c conj(S_m) ⊙ F⁻¹ k``. With m=1
    this is exactly :func:`sens_reduce`.
    """
    img = ifft2c(kspace)  # (b, t, c, h, w)
    return csum(img[:, :, None] * sens_maps_multi[:, None].conj(), axis=3)


def soft_sense_rss(components: Complex) -> torch.Tensor:
    """Magnitude recon from soft-SENSE components: sqrt(Σ_m |x_m|²)."""
    return torch.sqrt(components.abs_sq().sum(dim=2))


def soft_sense_recon(
    masked_kspace: Complex, mask: torch.Tensor, sens_maps_multi: Complex, lam: float = 1e-2,
    iters: int = 10, return_components: bool = False,
):
    """CG-SENSE reconstruction over multiple ESPIRiT map sets.

    Solves ``(Aᴴ M A + λ) x = Aᴴ y`` for the component images
    ``x: (b, t, m, h, w)`` with ``A = soft_sense_expand`` by
    :func:`~cinemri_tpu_torch.physics.cg.conj_grad` from ``x0 = Aᴴ y``, and
    returns the RSS-combined magnitude (b, t, h, w). Every DFT goes through
    ``fft2c``/``ifft2c``: 2 for the right-hand side and 4 per operator
    apply, ``iters + 1`` applies. With m=1 this is plain CG-SENSE.
    """
    y = apply_mask(masked_kspace, mask)
    rhs = soft_sense_reduce(y, sens_maps_multi)

    def normal(x):
        k = apply_mask(soft_sense_expand(x, sens_maps_multi), mask)
        return soft_sense_reduce(k, sens_maps_multi) + lam * x

    x = conj_grad(normal, rhs, rhs, iters=iters)
    if return_components:
        return x
    return soft_sense_rss(x)
