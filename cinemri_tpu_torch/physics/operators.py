"""MRI encoding-operator algebra on Complex (re, im) pairs.

Counterpart of ``cinemri_tpu/physics/operators.py`` (the VarNet and CineNet
subset).

Shapes: k-space ``(b, t, c, h, w)`` Complex; sensitivity maps
``(b, 1, c, h, w)`` Complex; coil-combined images ``(b, t, 1, h, w)``
Complex; masks real float tensors, canonically ``(b, t|1, 1, h, 1)``.

The masked normal operator of a line mask runs through
:class:`~cinemri_tpu_torch.ops.kernels.normal_cuda.NormalApply`: the
hand-written CUDA kernels (forward and backward) for CUDA tensors, their
plain versions for CPU tensors. :func:`set_normal_backend` ``("torch")``
sends CUDA tensors to the plain versions too, in both directions, as an
explicit choice for comparison.
"""

from __future__ import annotations

import torch

from cinemri_tpu_torch.ops.cplx import Complex, csum
from cinemri_tpu_torch.ops.fft import _dft_tensors, fft2c, ifft2c
from cinemri_tpu_torch.ops.kernels import normal_cuda

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
    "soft_dc_image_kernel",
    "set_normal_backend",
    "get_normal_backend",
]

COIL_AXIS = 2

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


def sens_expand(image: Complex, sens_maps: Complex) -> Complex:
    """Coil-combined image -> multi-coil k-space: ``F (S ⊙ x)``."""
    return fft2c(image * sens_maps)


def sens_reduce(kspace: Complex, sens_maps: Complex, keepdims: bool = True) -> Complex:
    """Multi-coil k-space -> coil-combined image: ``Σ_c conj(S) ⊙ F⁻¹ k``."""
    image = ifft2c(kspace)
    return csum(image * sens_maps.conj(), axis=COIL_AXIS, keepdims=keepdims)


def apply_mask(kspace: Complex, mask: torch.Tensor) -> Complex:
    """Subsample k-space by elementwise mask multiplication."""
    return kspace * mask


def soft_dc(model_term: Complex, ref_kspace: Complex, mask: torch.Tensor, v) -> Complex:
    """Soft data consistency ``(1-m)·Tx + m·(Tx + v·k_ref)/(1+v)``, ``v = softplus(λ)``."""
    return (1 - mask) * model_term + mask * ((model_term + v * ref_kspace) / (1 + v))


def normal_plus_lambda(x: Complex, mask: torch.Tensor, sens_maps: Complex, lam) -> Complex:
    """``H(x) = Aᴴ M A x + λ x``, the CG system operator, in its direct form:
    ``sens_expand``, mask, ``sens_reduce`` (four DFTs per apply). CineNet
    runs it when ``kernel_dc`` is off or the mask is not a line mask."""
    k = apply_mask(sens_expand(x, sens_maps), mask)
    return sens_reduce(k, sens_maps, keepdims=True) + lam * x


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
    computes them outside any kernel too).
    """
    if not is_line_mask(mask):
        raise ValueError(f"expected a line mask (b, t|1, 1, h, 1), got {tuple(mask.shape)}")
    h = mask.shape[3]
    wfr, wfi = _dft_tensors(h, False, False, norm, mask.device)
    wir, wii = _dft_tensors(h, True, False, norm, mask.device)
    m = mask[:, :, 0, :, 0].to(torch.float32)  # (b, t|1, h)
    # A = diag(m) @ W_f (row scaling), then T = W_i @ A
    ar = m[..., :, None] * wfr
    ai = m[..., :, None] * wfi
    return Complex(wir @ ar - wii @ ai, wir @ ai + wii @ ar)


def coil_weight(sens_maps: Complex) -> torch.Tensor:
    """``R0 = Σ_c |S_c|²``, a real tensor (b, 1, 1, h, w)."""
    return sens_maps.abs_sq().sum(dim=COIL_AXIS, keepdim=True)


def normal_plus_lambda_kernel(x: Complex, kernel: Complex, sens_maps: Complex, lam) -> Complex:
    """``H(x) = Aᴴ M A x + λ x`` with a precomputed h-axis kernel.

    ``x (b, t, 1, h, w)``, ``kernel (b, t|1, h, h)`` from
    :func:`masked_normal_kernel`, ``sens_maps (b, 1, c, h, w)``; ``lam`` a
    Python float or a one-element tensor, passed through to the kernel on
    the device as it is (CineNet's ``softplus(λᵢ)``). Differentiable in
    ``x``, ``sens_maps`` and a tensor ``lam``; the kernel matrix is
    detached, as the JAX package stop-gradients it (it derives from the
    never-learned mask).
    """
    outr, outi = normal_cuda.NormalApply.apply(
        x.re[:, :, 0].contiguous(),
        x.im[:, :, 0].contiguous(),
        kernel.re.detach().contiguous(),
        kernel.im.detach().contiguous(),
        sens_maps.re[:, 0].contiguous(),
        sens_maps.im[:, 0].contiguous(),
        lam,
        _NORMAL_BACKEND == "torch",
    )
    return Complex(outr[:, :, None], outi[:, :, None])


def soft_dc_image_kernel(
    model_out: Complex, x_ref: Complex, kernel: Complex, sens_maps: Complex, v,
    rss_sq: torch.Tensor | None = None,
) -> Complex:
    """The VarNet cascade's k-space round trip collapsed into image space:
    ``R0 ⊙ z − α·N(z) + α·x_ref`` with ``α = v/(1+v)``.

    Exact to f32 rounding for a binary 0/1 mask and ``x_ref`` from k-space
    already multiplied by that mask.
    """
    if rss_sq is None:
        rss_sq = coil_weight(sens_maps)
    alpha = v / (1 + v)
    n = normal_plus_lambda_kernel(model_out, kernel, sens_maps, 0.0)
    return model_out * rss_sq - alpha * n + alpha * x_ref
