"""Precision modes of the DFT and normal-apply kernels, and their plain versions.

The JAX package's matrix-unit precision of the DFT (``ops/fft.py::
set_dft_precision``: ``HIGHEST``, ``HIGH``, ``DEFAULT``) maps onto the H100
as follows (``csrc/wgmma_tf32.cuh`` and ``csrc/cgemm_tf32.cuh``):

  * ``'highest'`` — full f32 FMA on the CUDA cores (the default, mode 0);
  * ``'high'``    — 3xTF32 on the tensor cores (mode 1): each operand split
    as ``hi = tf32(a)``, ``lo = tf32(a − hi)``, and ``a·b ≈ lo·hi' + hi·lo'
    + hi·hi'`` accumulated in f32;
  * ``'default'`` — 1xTF32 (mode 2): ``a·b ≈ tf32(a)·tf32(b)``.

``tf32(v)`` is ``cvt.rna.tf32.f32``: round half away from zero to 10
mantissa bits. :func:`tf32_round` does the same with integer operations on
the bit pattern, and :func:`matmul` takes the kernels' partial products in
f32 with ``torch.matmul``. Products of tf32 values are exact in f32, so on
the card a kernel and its plain version differ only by summation order; on
the CPU the plain versions are the wrappers' arithmetic. Nothing here
changes at ``'highest'``: :func:`matmul` is ``a @ b``.
"""

from __future__ import annotations

import torch

__all__ = ["PRECISIONS", "MODES", "check_precision", "tf32_round", "split", "matmul"]

PRECISIONS = ("highest", "high", "default")
# the C entries' mode argument
MODES = {p: i for i, p in enumerate(PRECISIONS)}


def check_precision(precision: str) -> str:
    """``precision`` lower-cased, or a ``ValueError`` naming the choices."""
    p = str(precision).lower()
    if p not in MODES:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return p


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on an f32 tensor: the low 13 mantissa bits rounded
    half away from zero (add half of their range to the sign-magnitude bit
    pattern, then clear them)."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32).view(x.shape)


def split(a: torch.Tensor, precision: str):
    """``(hi, lo)`` of the kernels' operands: ``lo`` is None at ``'default'``."""
    hi = tf32_round(a)
    return hi, (tf32_round(a - hi) if precision == "high" else None)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """``a @ b`` with the kernels' arithmetic at ``precision``: the small
    terms of 3xTF32 first, as the tensor-core tile accumulates them."""
    if precision == "highest":
        return a @ b
    ah, al = split(a, precision)
    bh, bl = split(b, precision)
    if al is None:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh
