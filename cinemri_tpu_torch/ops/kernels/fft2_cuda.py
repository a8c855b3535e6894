"""Fused 2-D complex DFT of planes: CUDA kernel and its plain PyTorch version.

Replaces ``fft2_plane_pallas`` (``cinemri_tpu/ops/kernels/fft2_pallas.py``,
body ``_kernel``): ``Y[b] = W_h · X[b] · W_wᵀ`` on (re, im) pairs with the
4-multiplication complex product in f32, for ``X (B, h, w)``,
``W_h (h, h)`` and ``W_w (w, w)``. As in the JAX wrapper, ``W_w`` is passed
as it is and the product right-multiplies by its transpose, so with the
centered DFT matrices of ``ops/fft.py`` it computes the centered 2-D DFT of
each plane.

Kernel (``csrc/fft2_plane.cu``, on the block tile of ``csrc/cgemm_tile.cuh``):
bound by the FP32 rate (8·B·(h²w + hw²) FLOP against 16 bytes per plane
element). A block owns a strip of 40 output rows of one plane (5 strips at
h = 200), computes its strip of ``W_h·X`` into shared memory and multiplies
it by ``W_wᵀ`` there, so the intermediate never reaches device memory, as in
the Pallas kernel; a whole 200 x 200 plane (320 KB) does not fit a block's
shared memory, hence the strips. The operand chunks stream through a
``cp.async`` ring. ``w`` is limited to :data:`MAX_W` by the strip's size.

Like the Pallas kernel, it is wired into no model path: the JAX package
calls it only from its tests, and the port's ``fft2c``/``ifft2c`` keep the
two 1-D DFT products of ``ops/fft.py``. It has no backward (the Pallas
kernel has no VJP either).

Dispatch: a CPU tensor takes :func:`fft2_plane_torch`; a CUDA tensor
launches the kernel or raises. ``LAUNCHES`` counts kernel launches. The
product is also registered as the custom op ``torch.ops.cinemri.fft2_plane``
(:func:`fft2_plane_op`), with a fake implementation and no gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from cinemri_tpu_torch.ops.kernels import _build

__all__ = ["fft2_plane", "fft2_plane_torch", "fft2_plane_op", "LAUNCHES", "MAX_W"]

LAUNCHES = 0

# The kernel keeps a 40 x w complex strip in shared memory (2·40·w·4 bytes,
# w rounded up to 16) beside a 64 KB ring of operand chunks, within a
# block's 227 KB.
MAX_W = 512


def fft2_plane_torch(xr, xi, whr, whi, wwr, wwi) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the two complex products of the Pallas kernel in the
    4-multiplication form and the same association, ``(W_h · X) · W_wᵀ``."""
    ar = whr @ xr - whi @ xi
    ai = whr @ xi + whi @ xr
    wtr, wti = wwr.T, wwi.T
    return ar @ wtr - ai @ wti, ar @ wti + ai @ wtr


def _check(xr, xi, whr, whi, wwr, wwi) -> Tuple[int, int, int]:
    if xr.ndim != 3 or xi.shape != xr.shape:
        raise ValueError(f"x must be two (B, h, w) tensors, got {tuple(xr.shape)}, {tuple(xi.shape)}")
    b, h, w = xr.shape
    if whr.shape != (h, h) or whi.shape != (h, h):
        raise ValueError(f"W_h must be ({h}, {h}), got {tuple(whr.shape)}, {tuple(whi.shape)}")
    if wwr.shape != (w, w) or wwi.shape != (w, w):
        raise ValueError(f"W_w must be ({w}, {w}), got {tuple(wwr.shape)}, {tuple(wwi.shape)}")
    for name, a in (("xr", xr), ("xi", xi), ("whr", whr), ("whi", whi), ("wwr", wwr), ("wwi", wwi)):
        if a.device != xr.device:
            raise ValueError(f"{name} is on {a.device}, x on {xr.device}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if w > MAX_W:
        raise ValueError(f"w = {w} exceeds the kernel's shared-memory strip (w <= {MAX_W})")
    if xr.numel() >= 2**31:
        raise ValueError(f"shape {(b, h, w)} exceeds the kernel's index range")
    return b, h, w


def fft2_plane(xr, xi, whr, whi, wwr, wwi) -> Tuple[torch.Tensor, torch.Tensor]:
    """``Y[b] = W_h · X[b] · W_wᵀ`` on raw (re, im) f32 tensors.

    Shapes: ``x (B, h, w)``, ``W_h (h, h)``, ``W_w (w, w)``. CPU tensors go
    to :func:`fft2_plane_torch`, CUDA tensors to the kernel in
    ``csrc/fft2_plane.cu``. Returns ``(y_re, y_im)``, each ``(B, h, w)``.
    """
    if xr.device.type == "cpu":
        return fft2_plane_torch(xr, xi, whr, whi, wwr, wwi)
    if xr.device.type != "cuda":
        raise ValueError(f"fft2_plane runs on cpu or cuda, got {xr.device}")
    b, h, w = _check(xr, xi, whr, whi, wwr, wwi)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    if xr.numel() == 0:
        return yr, yi
    lib = _build.load("fft2_plane")
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cinemri_fft2_plane(
            xr.data_ptr(), xi.data_ptr(), whr.data_ptr(), whi.data_ptr(),
            wwr.data_ptr(), wwi.data_ptr(), yr.data_ptr(), yi.data_ptr(), b, h, w, stream,
        )
    _build.check(lib, code, "cinemri_fft2_plane launch")
    global LAUNCHES
    LAUNCHES += 1
    return yr, yi


@torch.library.custom_op("cinemri::fft2_plane", mutates_args=())
def fft2_plane_op(xr: Tensor, xi: Tensor, whr: Tensor, whi: Tensor, wwr: Tensor,
                  wwi: Tensor) -> Tuple[Tensor, Tensor]:
    """:func:`fft2_plane` as an op: the kernel on a CUDA tensor, the plain
    version on a CPU one."""
    return fft2_plane(xr, xi, whr, whi, wwr, wwi)


@fft2_plane_op.register_fake
def _(xr, xi, whr, whi, wwr, wwi):
    return torch.empty_like(xr), torch.empty_like(xi)
