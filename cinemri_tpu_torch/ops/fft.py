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
    arithmetic follows :func:`set_dft_precision`: ``'highest'`` (the
    default) is full f32 (the JAX package's ``Precision.HIGHEST``),
    ``'high'`` 3xTF32 and ``'default'`` 1xTF32 on the tensor cores
    (``ops/kernels/precision.py``), transforms of length ≤ 16 excepted:
    those stay full f32 in every mode (``ops/kernels/dft_cuda.py``); the
    normal-apply kernels of
    ``physics/operators.py`` read the same setting, as the JAX package's
    ``normal_pallas.py`` does. The JAX package's Pallas DFT is fixed at
    ``HIGHEST``, but its default backend, XLA, follows the setting; the
    port's kernel is its only DFT on the card, so it follows the default.
  * ``complex64`` tensors or numpy arrays use ``torch.fft`` (host-side
    preprocessing and test oracles only).

Conventions: ``fft2c``/``ifft2c`` shift over the last two axes with ortho
norm; ``fft1c``/``ifft1c`` are the centered 1-D transforms along ``axis``;
``fft1c_alt`` shifts in the opposite order (XPDNet's temporal transform) and
``ifft1c_alt`` is its exact inverse, a dense matrix (for odd lengths the
standard ``ifft1c`` is not its inverse).
"""

from __future__ import annotations

import math
import os
from functools import lru_cache

import numpy as np
import torch

from cinemri_tpu_torch.ops.cplx import Complex
from cinemri_tpu_torch.ops.kernels import dft_cuda, trace_safe
from cinemri_tpu_torch.ops.kernels.precision import check_precision

__all__ = [
    "set_dft_precision",
    "get_dft_precision",
    "set_dft_backend",
    "fft1c",
    "ifft1c",
    "fft1c_alt",
    "ifft1c_alt",
    "fft2c",
    "ifft2c",
    "fftshift",
    "ifftshift",
]


def fftshift(x, axes=None) -> torch.Tensor:
    """``torch.fft.fftshift`` with numpy's ``axes`` keyword (all axes by default)."""
    return torch.fft.fftshift(torch.as_tensor(x), dim=axes)


def ifftshift(x, axes=None) -> torch.Tensor:
    """``torch.fft.ifftshift`` with numpy's ``axes`` keyword (all axes by default)."""
    return torch.fft.ifftshift(torch.as_tensor(x), dim=axes)

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


# Precision of the Complex-pair DFT products and of the normal-apply
# contractions, forward and backward: 'highest' = f32-exact (FP32 FMA on the
# CUDA cores); 'high' = 3xTF32 and 'default' = 1xTF32 on the tensor cores.
# The JAX package's note applies: 'default' (10 mantissa bits a product) is
# coarse for k-space data consistency.
_DFT_PRECISION = "highest"


def set_dft_precision(precision) -> None:
    """Set the precision of the Complex-pair DFT path (and of the normal
    apply): ``'highest'``, ``'high'`` or ``'default'``, case-insensitive, the
    JAX package's strings. It applies from the next call (eager PyTorch has
    no trace to redo). Also settable with the ``CINEMRI_DFT_PRECISION``
    environment variable, read at import."""
    global _DFT_PRECISION
    _DFT_PRECISION = check_precision(precision)


def get_dft_precision() -> str:
    """The current precision: ``'highest'``, ``'high'`` or ``'default'``."""
    return _DFT_PRECISION


if os.environ.get("CINEMRI_DFT_PRECISION"):
    set_dft_precision(os.environ["CINEMRI_DFT_PRECISION"])


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
    wr, wi = trace_safe(_dft_tensors, n, inverse, alt, norm, dev)
    whr, whi = trace_safe(_dft_adjoint_tensors, n, inverse, alt, norm, dev)
    plain = _DFT_BACKEND == "torch"
    mr, mi = torch.movedim(x.re, axis, -1), torch.movedim(x.im, axis, -1)
    if mr.is_contiguous() and mi.is_contiguous():
        yr, yi = dft_cuda.ComplexDFTMatmul.apply(mr.view(-1, n, 1), mi.view(-1, n, 1),
                                                 wr, wi, whr, whi, plain, _DFT_PRECISION)
        return Complex(torch.movedim(yr.view(mr.shape), -1, axis),
                       torch.movedim(yi.view(mi.shape), -1, axis))
    xr, xi = x.re, x.im
    if not (xr.is_contiguous() and xi.is_contiguous()):
        xr, xi = xr.contiguous(), xi.contiguous()
        COPIES += 1
    slab = (math.prod(x.shape[:axis]), n, math.prod(x.shape[axis + 1:]))
    yr, yi = dft_cuda.ComplexDFTMatmul.apply(xr.view(slab), xi.view(slab), wr, wi, whr, whi, plain,
                                             _DFT_PRECISION)
    return Complex(yr.view(x.shape), yi.view(x.shape))


def _native(x, axis: int, inverse: bool, alt: bool, norm: str):
    """Centered 1-D transform of a complex tensor / numpy array with torch.fft
    (``ifft1c_alt``, ``inverse`` and ``alt``, by its dense matrix)."""
    as_numpy = isinstance(x, np.ndarray)
    t = torch.from_numpy(x) if as_numpy else x
    if inverse and alt:
        wr, wi = _dft_matrix(t.shape[axis], True, True, norm)
        w = torch.complex(torch.from_numpy(wr), torch.from_numpy(wi)).to(t.device, t.dtype)
        y = torch.movedim(torch.tensordot(t, w, dims=([axis], [1])), -1, axis)
    else:
        f = torch.fft.ifft if inverse else torch.fft.fft
        first, last = ((torch.fft.fftshift, torch.fft.ifftshift) if alt
                       else (torch.fft.ifftshift, torch.fft.fftshift))
        y = last(f(first(t, dim=axis), dim=axis, norm=norm), dim=axis)
    return y.numpy() if as_numpy else y


def _centered(x, axis: int, inverse: bool, norm: str, alt: bool = False):
    if isinstance(x, Complex):
        return _apply_dft(x, axis, inverse, alt, norm)
    return _native(x, axis, inverse, alt, norm)


def fft1c(x, axis: int = -1, norm: str = "ortho"):
    """Centered 1-D FFT along ``axis``."""
    return _centered(x, axis, inverse=False, norm=norm)


def ifft1c(x, axis: int = -1, norm: str = "ortho"):
    """Centered 1-D inverse FFT along ``axis``."""
    return _centered(x, axis, inverse=True, norm=norm)


def fft1c_alt(x, axis: int = -1, norm: str = "ortho"):
    """Centered 1-D FFT along ``axis`` with the opposite shift order
    (``ifftshift ∘ F ∘ fftshift``), as XPDNet's reference applies it."""
    return _centered(x, axis, inverse=False, norm=norm, alt=True)


def ifft1c_alt(x, axis: int = -1, norm: str = "ortho"):
    """Exact inverse of :func:`fft1c_alt`."""
    return _centered(x, axis, inverse=True, norm=norm, alt=True)


def fft2c(x, norm: str = "ortho"):
    """Centered 2-D FFT over the last two axes."""
    return fft1c(fft1c(x, axis=-2, norm=norm), axis=-1, norm=norm)


def ifft2c(x, norm: str = "ortho"):
    """Centered 2-D inverse FFT over the last two axes."""
    return ifft1c(ifft1c(x, axis=-2, norm=norm), axis=-1, norm=norm)
