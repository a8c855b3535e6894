"""Masked normal operator apply: CUDA kernel and its plain PyTorch version.

Replaces the forward of ``normal_apply_pallas`` (``cinemri_tpu/ops/kernels/
normal_pallas.py``, ``fwd_pallas_call`` / body ``_fwd_kernel``), which
computes ``N(z)`` in every VarNet cascade's data-consistency step.

Computes ``out = Σ_c conj(S_c) ⊙ (K ·_h (S_c ⊙ x)) + λ·x`` on (re, im)
pairs, with ``x (b, t, h, w)``, ``K (b, 1|t, h, h)`` applied along h,
``S (b, c, h, w)`` and a scalar ``λ``, in f32 with the 4-multiplication
complex product.

Kernel (``csrc/normal_apply.cu``): what bounds it on the H100 is the FP32
rate (9.6 GFLOP against ~18 MB per apply at t=15, c=10, h=w=200). The
Pallas program holds a whole plane, K and the coil stack on chip and
relies on the TPU's sequential grid; neither carries to Hopper. The kernel
runs a grid over (w-tile, h-tile, b·t), loops over coils and over chunks
of K's columns with K and ``S_c ⊙ x`` tiles staged in shared memory, and
keeps ``z`` and the coil sum in registers, so only x, K, S and out move
through device memory.

Dispatch: a CPU tensor takes :func:`normal_apply_torch`; a CUDA tensor
launches the kernel or raises. There is no backward kernel yet, so the CUDA
path raises on inputs that require grad. ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cinemri_tpu_torch.ops.kernels import _build

__all__ = ["normal_apply", "normal_apply_torch", "LAUNCHES"]

LAUNCHES = 0


def normal_apply_torch(xr, xi, kr, ki, sr, si, lam) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: coil-expand, K along h by ``torch.matmul``, conj-reduce."""
    yr = sr[:, None] * xr[:, :, None] - si[:, None] * xi[:, :, None]  # (b, t, c, h, w)
    yi = sr[:, None] * xi[:, :, None] + si[:, None] * xr[:, :, None]
    k_r = kr[:, :, None]  # (b, 1|t, 1, h, h) broadcasts over coils (and frames)
    k_i = ki[:, :, None]
    zr = k_r @ yr - k_i @ yi
    zi = k_r @ yi + k_i @ yr
    outr = (sr[:, None] * zr + si[:, None] * zi).sum(dim=2)
    outi = (sr[:, None] * zi - si[:, None] * zr).sum(dim=2)
    return outr + lam * xr, outi + lam * xi


def _check(xr, xi, kr, ki, sr, si):
    if xr.ndim != 4 or xi.shape != xr.shape:
        raise ValueError(f"x must be two (b, t, h, w) tensors, got {tuple(xr.shape)}")
    b, t, h, w = xr.shape
    if sr.ndim != 4 or sr.shape[0] != b or sr.shape[2:] != (h, w) or si.shape != sr.shape:
        raise ValueError(f"S must be (b, c, h, w) = ({b}, c, {h}, {w}), got {tuple(sr.shape)}")
    c = sr.shape[1]
    kt = kr.shape[1] if kr.ndim == 4 else -1
    if kr.shape != (b, kt, h, h) or ki.shape != kr.shape or kt not in (1, t):
        raise ValueError(f"K must be ({b}, 1|{t}, {h}, {h}), got {tuple(kr.shape)}")
    for name, a in (("xr", xr), ("xi", xi), ("kr", kr), ("ki", ki), ("sr", sr), ("si", si)):
        if a.device != xr.device:
            raise ValueError(f"{name} is on {a.device}, x on {xr.device}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if a.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "the CUDA normal-apply kernel has no backward yet (ROADMAP "
                "Queue 2, normal_apply backward); run the forward under "
                "torch.inference_mode()"
            )
    if b * t > 65535:
        raise ValueError(f"b*t = {b * t} exceeds the kernel grid's 65535 limit")
    if max(b * c, b * t) * h * w >= 2**31:
        raise ValueError("tensor sizes exceed the kernel's index range")
    return b, t, c, h, w, kt


def normal_apply(xr, xi, kr, ki, sr, si, lam) -> Tuple[torch.Tensor, torch.Tensor]:
    """``out = Σ_c conj(S_c)⊙(K(S_c⊙x)) + λx`` on raw (re, im) f32 tensors.

    Shapes: ``x (b,t,h,w)``, ``K (b,{1|t},h,h)``, ``S (b,c,h,w)``, ``lam`` a
    scalar (a tensor ``lam`` is read to the host on the CUDA path). CPU
    tensors go to :func:`normal_apply_torch`, CUDA tensors to the kernel in
    ``csrc/normal_apply.cu``. Returns ``(out_re, out_im)``.
    """
    if xr.device.type == "cpu":
        return normal_apply_torch(xr, xi, kr, ki, sr, si, lam)
    if xr.device.type != "cuda":
        raise ValueError(f"normal_apply runs on cpu or cuda, got {xr.device}")
    b, t, c, h, w, kt = _check(xr, xi, kr, ki, sr, si)
    outr = torch.empty_like(xr)
    outi = torch.empty_like(xi)
    if xr.numel() == 0:
        return outr, outi
    lib = _build.load("normal_apply")
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cinemri_normal_apply(
            xr.data_ptr(), xi.data_ptr(), kr.data_ptr(), ki.data_ptr(),
            sr.data_ptr(), si.data_ptr(), float(lam),
            outr.data_ptr(), outi.data_ptr(), b, t, c, h, w, kt, stream,
        )
    _build.check(lib, code, "cinemri_normal_apply launch")
    global LAUNCHES
    LAUNCHES += 1
    return outr, outi
