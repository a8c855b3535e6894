"""Centered Fourier transforms.

Counterpart of ``cinemri_tpu/ops/fft.py``. Two dispatch paths behind one API:

  * :class:`~cinemri_tpu_torch.ops.cplx.Complex` inputs (the compute path)
    run the centered transform along one axis as a dense DFT matrix product
    ``y = W_c x`` with ``W_c = shift ∘ F ∘ shift⁻¹`` folded into one N x N
    complex matrix, built once per (length, direction, convention, norm,
    device). The product goes through
    :class:`~cinemri_tpu_torch.ops.kernels.dft_cuda.ComplexDFTMatmul`, which
    launches the hand-written CUDA kernel for a CUDA tensor and its plain
    PyTorch version for a CPU tensor, in the forward and, on ``Wᴴ``, in the
    backward. It runs along the middle axis of an ``(O, N, I)`` view, so the
    transform along any axis of a contiguous tensor copies nothing
    (:func:`_apply_dft`; :data:`COPIES` counts the copies it does make). The
    arithmetic is full f32 (the JAX package's ``Precision.HIGHEST``); there
    is no reduced-precision mode yet.
  * ``complex64`` tensors or numpy arrays use ``torch.fft`` (host-side
    preprocessing and test oracles only).

Conventions: ``fft2c``/``ifft2c`` shift over the last two axes with ortho
norm; ``fft1c``/``ifft1c`` are the centered 1-D transforms along ``axis``.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from cinemri_tpu_torch.ops.cplx import Complex
from cinemri_tpu_torch.ops.kernels import dft_cuda

__all__ = [
    "set_dft_backend",
    "fft1c",
    "ifft1c",
    "fft2c",
    "ifft2c",
]

# Backend of the Complex-pair DFT product, forward and backward: "kernel"
# sends CUDA tensors to the hand-written CUDA kernel (CPU tensors to its
# plain version); "torch" sends every tensor to the plain PyTorch version.
# "torch" on the card is an explicit choice, made to compare the two.
_DFT_BACKEND = "kernel"

# Copies of the input made by _apply_dft (one per call that copies): only an
# input that is neither contiguous nor innermost along the axis is copied.
COPIES = 0


def set_dft_backend(backend: str) -> None:
    global _DFT_BACKEND
    if backend not in ("kernel", "torch"):
        raise ValueError(f"unknown DFT backend {backend!r}")
    _DFT_BACKEND = backend


@lru_cache(maxsize=None)
def _dft_matrix(n: int, inverse: bool, alt: bool, norm: str):
    """Centered DFT matrix columns: transform of the unit basis vectors."""
    eye = np.eye(n, dtype=np.complex128)
    f = np.fft.ifft if inverse else np.fft.fft
    if not alt:
        # standard centered: fftshift ∘ F ∘ ifftshift
        m = np.fft.fftshift(f(np.fft.ifftshift(eye, axes=0), axis=0, norm=norm), axes=0)
    elif not inverse:
        # alt forward (XPDNet's opposite shift order): ifftshift ∘ F ∘ fftshift
        m = np.fft.ifftshift(f(np.fft.fftshift(eye, axes=0), axis=0, norm=norm), axes=0)
    else:
        # true inverse of the alt forward transform
        fwd = np.fft.ifftshift(
            np.fft.fft(np.fft.fftshift(eye, axes=0), axis=0, norm=norm), axes=0
        )
        m = np.linalg.inv(fwd)
    return (
        np.ascontiguousarray(m.real, dtype=np.float32),
        np.ascontiguousarray(m.imag, dtype=np.float32),
    )


@lru_cache(maxsize=64)
def _dft_tensors(n: int, inverse: bool, alt: bool, norm: str, device: torch.device):
    """:func:`_dft_matrix` as f32 tensors on ``device`` (one copy per device).

    Built outside inference mode whatever the caller's mode: a first call
    from a served request would otherwise cache inference tensors, which a
    later training step cannot save for backward."""
    wr, wi = _dft_matrix(n, inverse, alt, norm)
    with torch.inference_mode(False):
        return torch.from_numpy(wr).to(device), torch.from_numpy(wi).to(device)


@lru_cache(maxsize=64)
def _dft_adjoint_tensors(n: int, inverse: bool, alt: bool, norm: str, device: torch.device):
    """``Wᴴ = conj(W)ᵀ`` of :func:`_dft_tensors`, from the same f32 matrix
    (the exact adjoint of the forward product, not the inverse-direction
    matrix), contiguous on ``device``."""
    wr, wi = _dft_matrix(n, inverse, alt, norm)
    with torch.inference_mode(False):
        return (torch.from_numpy(np.ascontiguousarray(wr.T)).to(device),
                torch.from_numpy(np.ascontiguousarray(-wi.T)).to(device))


def _apply_dft(x: Complex, axis: int, inverse: bool, alt: bool, norm: str) -> Complex:
    """Centered DFT along ``axis`` as the ``(O, N, I)`` product of
    :class:`~cinemri_tpu_torch.ops.kernels.dft_cuda.ComplexDFTMatmul`, the
    route picked from the memory layout of ``x``:

    1. the axis is innermost in memory (its moved-last view is contiguous):
       ``I = 1`` on that view;
    2. else ``x`` is contiguous: ``I > 1`` on ``x.view(O, n, I)``;
    3. else one copy of ``x`` (counted in :data:`COPIES`), then route 2.

    The result keeps the layout of the route's input."""
    global COPIES
    axis = axis % x.ndim
    n = x.shape[axis]
    dev = x.re.device
    wr, wi = _dft_tensors(n, inverse, alt, norm, dev)
    whr, whi = _dft_adjoint_tensors(n, inverse, alt, norm, dev)
    plain = _DFT_BACKEND == "torch"
    mr, mi = torch.movedim(x.re, axis, -1), torch.movedim(x.im, axis, -1)
    if mr.is_contiguous() and mi.is_contiguous():
        yr, yi = dft_cuda.ComplexDFTMatmul.apply(mr.view(-1, n, 1), mi.view(-1, n, 1),
                                                 wr, wi, whr, whi, plain)
        return Complex(torch.movedim(yr.view(mr.shape), -1, axis),
                       torch.movedim(yi.view(mi.shape), -1, axis))
    xr, xi = x.re, x.im
    if not (xr.is_contiguous() and xi.is_contiguous()):
        xr, xi = xr.contiguous(), xi.contiguous()
        COPIES += 1
    slab = (math.prod(x.shape[:axis]), n, math.prod(x.shape[axis + 1:]))
    yr, yi = dft_cuda.ComplexDFTMatmul.apply(xr.view(slab), xi.view(slab), wr, wi, whr, whi, plain)
    return Complex(yr.view(x.shape), yi.view(x.shape))


def _native(x, axis: int, inverse: bool, norm: str):
    """Centered 1-D transform of a complex tensor / numpy array with torch.fft."""
    as_numpy = isinstance(x, np.ndarray)
    t = torch.from_numpy(x) if as_numpy else x
    f = torch.fft.ifft if inverse else torch.fft.fft
    y = torch.fft.fftshift(f(torch.fft.ifftshift(t, dim=axis), dim=axis, norm=norm), dim=axis)
    return y.numpy() if as_numpy else y


def _centered(x, axis: int, inverse: bool, norm: str):
    if isinstance(x, Complex):
        return _apply_dft(x, axis, inverse, alt=False, norm=norm)
    return _native(x, axis, inverse, norm)


def fft1c(x, axis: int = -1, norm: str = "ortho"):
    """Centered 1-D FFT along ``axis``."""
    return _centered(x, axis, inverse=False, norm=norm)


def ifft1c(x, axis: int = -1, norm: str = "ortho"):
    """Centered 1-D inverse FFT along ``axis``."""
    return _centered(x, axis, inverse=True, norm=norm)


def fft2c(x, norm: str = "ortho"):
    """Centered 2-D FFT over the last two axes."""
    return fft1c(fft1c(x, axis=-2, norm=norm), axis=-1, norm=norm)


def ifft2c(x, norm: str = "ortho"):
    """Centered 2-D inverse FFT over the last two axes."""
    return ifft1c(ifft1c(x, axis=-2, norm=norm), axis=-1, norm=norm)
