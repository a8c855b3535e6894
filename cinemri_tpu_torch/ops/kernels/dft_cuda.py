"""Complex DFT matrix product: CUDA kernel and its plain PyTorch version.

Replaces ``complex_dft_matmul_pallas`` (``cinemri_tpu/ops/kernels/
dft_pallas.py``, body ``_kernel``), which carries every centered 1-D DFT of
the JAX package when its DFT backend is ``pallas``. Here it carries every
centered DFT of :mod:`cinemri_tpu_torch.ops.fft` on a CUDA tensor.

Computes ``y[b, j] = Σ_k w[j, k] x[b, k]`` on (re, im) pairs, ``x (B, N)``,
``w (N, N)``, with the 4-multiplication complex product in f32.

Kernel (``csrc/dft_matmul.cu``): a tiled SGEMM on CUDA cores, FMA without
TF32. What bounds it on the H100: at N = 200 the FP32 rate (8·N FLOP per
output against 16 bytes), at N = 15 memory. The Pallas design keeps the
N x N matrices resident on chip; they do not fit a block's shared memory at
N = 200, so the kernel tiles output rows x output columns x contraction and
stages the W tiles in shared memory, with a narrow-tile instance for
N <= 16. Input rows must be contiguous: the caller moves the transform axis
last and copies (``ops/fft.py::_apply_dft``).

Dispatch: a CPU tensor takes :func:`complex_dft_matmul_torch`; a CUDA tensor
launches the kernel or raises. ``LAUNCHES`` counts kernel launches.

Gradient: :class:`ComplexDFTMatmul` wraps the product for autograd. Its
backward is ``x̄ = ȳ · conj(W)``, which is the same product with ``Wᴴ`` in
``W``'s place, so it launches the same kernel (or, with ``plain``, the
plain version); ``W`` gets no gradient. The JAX package has no Pallas
backward for the DFT: its train step differentiates the XLA tensordot
chain, whose transpose is this product with ``Wᴴ``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cinemri_tpu_torch.ops.kernels import _build

__all__ = ["complex_dft_matmul", "complex_dft_matmul_torch", "ComplexDFTMatmul", "LAUNCHES"]

LAUNCHES = 0


def complex_dft_matmul_torch(
    xr: torch.Tensor, xi: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the same 4-multiplication product with ``torch.matmul``."""
    yr = xr @ wr.T - xi @ wi.T
    yi = xr @ wi.T + xi @ wr.T
    return yr, yi


def _check(xr, xi, wr, wi) -> Tuple[int, int]:
    if xr.ndim != 2 or xr.shape != xi.shape:
        raise ValueError(f"x must be two (B, N) tensors, got {tuple(xr.shape)}, {tuple(xi.shape)}")
    b, n = xr.shape
    if wr.shape != (n, n) or wi.shape != (n, n):
        raise ValueError(f"w must be ({n}, {n}), got {tuple(wr.shape)}, {tuple(wi.shape)}")
    for name, a in (("xr", xr), ("xi", xi), ("wr", wr), ("wi", wi)):
        if a.device != xr.device:
            raise ValueError(f"{name} is on {a.device}, x on {xr.device}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b >= 2**31 or n >= 2**31:
        raise ValueError(f"shape {(b, n)} exceeds the kernel's int32 sizes")
    return b, n


def complex_dft_matmul(
    xr: torch.Tensor, xi: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(B, N) x (N, N)`` complex product ``y[b, j] = Σ_k w[j, k] x[b, k]``.

    CPU tensors go to :func:`complex_dft_matmul_torch`; CUDA tensors to the
    kernel in ``csrc/dft_matmul.cu``. Returns ``(y_re, y_im)``, each (B, N).
    """
    if xr.device.type == "cpu":
        return complex_dft_matmul_torch(xr, xi, wr, wi)
    if xr.device.type != "cuda":
        raise ValueError(f"complex_dft_matmul runs on cpu or cuda, got {xr.device}")
    b, n = _check(xr, xi, wr, wi)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    if b == 0:
        return yr, yi
    lib = _build.load("dft_matmul")
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cinemri_dft_matmul(
            xr.data_ptr(), xi.data_ptr(), wr.data_ptr(), wi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), b, n, stream,
        )
    _build.check(lib, code, "cinemri_dft_matmul launch")
    global LAUNCHES
    LAUNCHES += 1
    return yr, yi


class ComplexDFTMatmul(torch.autograd.Function):
    """Differentiable ``(B, N) x (N, N)`` product: ``y = x Wᵀ`` forward,
    ``x̄ = ȳ (Wᴴ)ᵀ = ȳ conj(W)`` backward.

    ``apply(xr, xi, wr, wi, whr, whi, plain)``: ``(whr, whi)`` is ``Wᴴ``,
    contiguous; ``plain`` picks :func:`complex_dft_matmul_torch` over
    :func:`complex_dft_matmul` in both directions. Neither matrix gets a
    gradient.
    """

    @staticmethod
    def forward(ctx, xr, xi, wr, wi, whr, whi, plain: bool):
        ctx.save_for_backward(whr, whi)
        ctx.plain = plain
        product = complex_dft_matmul_torch if plain else complex_dft_matmul
        return product(xr, xi, wr, wi)

    @staticmethod
    def backward(ctx, gr, gi):
        whr, whi = ctx.saved_tensors
        product = complex_dft_matmul_torch if ctx.plain else complex_dft_matmul
        xbr, xbi = product(gr.contiguous(), gi.contiguous(), whr, whi)
        return xbr, xbi, None, None, None, None, None
