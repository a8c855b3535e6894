"""Complex DFT matrix product: CUDA kernel and its plain PyTorch version.

Replaces ``complex_dft_matmul_pallas`` (``cinemri_tpu/ops/kernels/
dft_pallas.py``, body ``_kernel``), which carries every centered 1-D DFT of
the JAX package when its DFT backend is ``pallas``. Here it carries every
centered DFT of :mod:`cinemri_tpu_torch.ops.fft` on a CUDA tensor.

Computes ``y[o, j, i] = Σ_k w[j, k] x[o, k, i]`` on (re, im) pairs,
``x (O, N, I)``, ``w (N, N)``: the transform runs along the middle axis, so
a transform along any axis of a contiguous tensor is a view of it
(``ops/fft.py::_apply_dft``). The product is the 4-multiplication complex
product in f32.

Kernel (``csrc/dft_matmul.cu`` on the block tile of ``csrc/cgemm_tile.cuh``):
FMA on CUDA cores without TF32, operands staged by ``cp.async`` in a ring.
What bounds it on the H100: at N = 200 the FP32 rate (8·N FLOP per output
against 16 bytes), at N ≤ 16 memory. Instances: ``I == 1`` (rows, ``x·Wᵀ``),
``I > 1`` (``W`` from the left on each ``(N, I)`` slab, computed as
``Xᵀ·Wᵀ`` over the slabs' columns, read coalesced along ``I``), both with
8 x 5 complex outputs a thread, and ``N ≤ 16`` (``W`` in shared memory, x
read once, y written once).

Dispatch: a CPU tensor takes :func:`complex_dft_matmul_torch`; a CUDA tensor
launches the kernel or raises. ``LAUNCHES`` counts kernel launches.

Gradient: :class:`ComplexDFTMatmul` wraps the product for autograd. Its
backward is ``x̄[o, :, i] = Wᴴ ȳ[o, :, i]``, the same product in the same
layout with ``Wᴴ`` in ``W``'s place, so it launches the same kernel (or,
with ``plain``, the plain version); ``W`` gets no gradient. The JAX package
has no Pallas backward for the DFT: its train step differentiates the XLA
tensordot chain, whose transpose is this product with ``Wᴴ``.
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
    """Plain version: the same 4-multiplication product with ``torch.matmul``,
    ``einsum("jk,oki->oji")`` over the middle axis of ``(O, N, I)`` (rows
    times ``Wᵀ`` when ``I == 1``). The result is contiguous, as the kernel's
    is."""
    if xr.shape[2] == 1:
        xr, xi = xr[..., 0], xi[..., 0]
        return (xr @ wr.T - xi @ wi.T)[..., None], (xr @ wi.T + xi @ wr.T)[..., None]
    return wr @ xr - wi @ xi, wr @ xi + wi @ xr


def _check(xr, xi, wr, wi) -> Tuple[int, int, int]:
    if xr.ndim != 3 or xr.shape != xi.shape:
        raise ValueError(f"x must be two (O, N, I) tensors, got {tuple(xr.shape)}, {tuple(xi.shape)}")
    o, n, i = xr.shape
    if wr.shape != (n, n) or wi.shape != (n, n):
        raise ValueError(f"w must be ({n}, {n}), got {tuple(wr.shape)}, {tuple(wi.shape)}")
    for name, a in (("xr", xr), ("xi", xi), ("wr", wr), ("wi", wi)):
        if a.device != xr.device:
            raise ValueError(f"{name} is on {a.device}, x on {xr.device}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(o, n, i) >= 2**31 or o * i >= 2**31:
        raise ValueError(f"shape {(o, n, i)} exceeds the kernel's int32 sizes")
    return o, n, i


def complex_dft_matmul(
    xr: torch.Tensor, xi: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``y[o, j, i] = Σ_k w[j, k] x[o, k, i]`` for ``x (O, N, I)``.

    CPU tensors go to :func:`complex_dft_matmul_torch`; CUDA tensors to the
    kernel in ``csrc/dft_matmul.cu``. Returns ``(y_re, y_im)`` shaped as x.
    """
    if xr.device.type == "cpu":
        return complex_dft_matmul_torch(xr, xi, wr, wi)
    if xr.device.type != "cuda":
        raise ValueError(f"complex_dft_matmul runs on cpu or cuda, got {xr.device}")
    o, n, i = _check(xr, xi, wr, wi)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    if xr.numel() == 0:
        return yr, yi
    lib = _build.load("dft_matmul")
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cinemri_dft_matmul(
            xr.data_ptr(), xi.data_ptr(), wr.data_ptr(), wi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), o, n, i, stream,
        )
    _build.check(lib, code, "cinemri_dft_matmul launch")
    global LAUNCHES
    LAUNCHES += 1
    return yr, yi


class ComplexDFTMatmul(torch.autograd.Function):
    """Differentiable product along the middle axis of ``(O, N, I)``:
    ``y = W x`` forward, ``x̄ = Wᴴ ȳ`` backward, both in the layout of x.

    ``apply(xr, xi, wr, wi, whr, whi, plain)``: ``(whr, whi)`` is ``Wᴴ``,
    contiguous; ``plain`` picks :func:`complex_dft_matmul_torch` over
    :func:`complex_dft_matmul` in both directions. Neither matrix gets a
    gradient. The incoming gradient is copied only when it is not
    contiguous.
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
