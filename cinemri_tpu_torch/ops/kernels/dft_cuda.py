"""Complex DFT matrix product: CUDA kernel and its plain PyTorch version.

Replaces ``complex_dft_matmul_pallas`` (``cinemri_tpu/ops/kernels/
dft_pallas.py``, body ``_kernel``), which carries every centered 1-D DFT of
the JAX package when its DFT backend is ``pallas``. Here it carries every
centered DFT of :mod:`cinemri_tpu_torch.ops.fft` on a CUDA tensor.

Computes ``y[o, j, i] = Σ_k w[j, k] x[o, k, i]`` on (re, im) pairs,
``x (O, N, I)``, ``w (N, N)``: the transform runs along the middle axis, so
a transform along any axis of a contiguous tensor is a view of it
(``ops/fft.py::_apply_dft``). The product is the 4-multiplication complex
product in f32 at ``precision`` ``'highest'`` (the default), in 3xTF32 at
``'high'`` and in 1xTF32 at ``'default'`` (:mod:`.precision`). The JAX
package's Pallas DFT is fixed at ``HIGHEST`` (``dft_pallas.py:53``), but its
default DFT backend, XLA, takes the precision (``ops/fft.py:113-122``); this
kernel is the port's only DFT on the card, so it follows the default backend.

Kernel (``csrc/dft_matmul.cu`` on the block tile of ``csrc/cgemm_tile.cuh``):
FMA on CUDA cores without TF32, operands staged by ``cp.async`` in a ring.
What bounds it on the H100: at N = 200 the FP32 rate (8·N FLOP per output
against 16 bytes), at N ≤ 16 memory. Instances: ``I == 1`` (rows, ``x·Wᵀ``),
``I > 1`` (``W`` from the left on each ``(N, I)`` slab, computed as
``Xᵀ·Wᵀ`` over the slabs' columns, read coalesced along ``I``), both with
8 x 5 complex outputs a thread, and ``N ≤ 16`` (``W`` in shared memory, x
read once, y written once). At ``'high'`` and ``'default'`` an ``N > 16`` runs
on the TF32 tensor-core tile of ``csrc/cgemm_tf32.cuh`` (``mma.sync`` m16n8k8,
the same ``cp.async`` ring and operand layouts). ``N ≤ 16`` (the temporal
transforms) takes the FP32 ``N ≤ 16`` kernel in every mode: it is bound by
memory, so the tensor cores would buy no time there, and it is more exact
than the mode asks, as ``physics/operators.py::masked_normal_kernel`` is.
The plain versions do the same.

Dispatch: a CPU tensor takes :func:`complex_dft_matmul_torch`; a CUDA tensor
launches the kernel or raises. ``LAUNCHES`` counts kernel launches, and
``LAUNCHES_BY_PRECISION`` the same launches by precision.

Custom op: the product is registered as ``torch.ops.cinemri.dft_matmul``
(:func:`dft_matmul_op`), so ``torch.export`` and the profiler see one op
where a ctypes call would be opaque. Its implementation is
:func:`complex_dft_matmul` (or, with ``plain``, the plain version), looked
up at each call; its fake implementation gives the result's shape. The
precision is its trailing argument, ``'highest'`` by default, so an artifact
exported before the argument existed loads unchanged. Its gradient is
``x̄[o, :, i] = Wᴴ ȳ[o, :, i]``, the same op in the same layout with ``Wᴴ`` in
``W``'s place and the same precision, so the backward launches the same
kernel (or, with ``plain``, the plain version); neither matrix gets a
gradient. The JAX
package has no Pallas backward for the DFT: its train step differentiates
the XLA tensordot chain, whose transpose is this product with ``Wᴴ``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from cinemri_tpu_torch.ops.kernels import _build
from cinemri_tpu_torch.ops.kernels.precision import MODES, check_precision, matmul

__all__ = ["complex_dft_matmul", "complex_dft_matmul_torch", "dft_matmul_op", "ComplexDFTMatmul",
           "LAUNCHES", "LAUNCHES_BY_PRECISION"]

LAUNCHES = 0
LAUNCHES_BY_PRECISION = dict.fromkeys(MODES, 0)
# the kernel's N <= 16 instance, full f32 in every mode (csrc/dft_matmul.cu)
SMALL_N = 16


def complex_dft_matmul_torch(
    xr: torch.Tensor, xi: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the same 4-multiplication product with ``torch.matmul``,
    ``einsum("jk,oki->oji")`` over the middle axis of ``(O, N, I)`` (rows
    times ``Wᵀ`` when ``I == 1``), each real product taken as the kernel
    takes it at ``precision`` (:func:`.precision.matmul`): in full f32 at
    ``N ≤ 16`` whatever the mode. The result is contiguous, as the kernel's
    is."""
    p = "highest" if xr.shape[1] <= SMALL_N else check_precision(precision)
    mm = lambda a, b: matmul(a, b, p)
    if xr.shape[2] == 1:
        xr, xi = xr[..., 0], xi[..., 0]
        return ((mm(xr, wr.T) - mm(xi, wi.T))[..., None],
                (mm(xr, wi.T) + mm(xi, wr.T))[..., None])
    return mm(wr, xr) - mm(wi, xi), mm(wr, xi) + mm(wi, xr)


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
    xr: torch.Tensor, xi: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``y[o, j, i] = Σ_k w[j, k] x[o, k, i]`` for ``x (O, N, I)`` at
    ``precision`` (``'highest'``, ``'high'`` or ``'default'``).

    CPU tensors go to :func:`complex_dft_matmul_torch`; CUDA tensors to the
    kernel in ``csrc/dft_matmul.cu``. Returns ``(y_re, y_im)`` shaped as x.
    """
    p = check_precision(precision)
    if xr.device.type == "cpu":
        return complex_dft_matmul_torch(xr, xi, wr, wi, p)
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
            yr.data_ptr(), yi.data_ptr(), o, n, i, MODES[p], stream,
        )
    _build.check(lib, code, "cinemri_dft_matmul launch")
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_PRECISION[p] += 1
    return yr, yi


@torch.library.custom_op("cinemri::dft_matmul", mutates_args=())
def dft_matmul_op(xr: Tensor, xi: Tensor, wr: Tensor, wi: Tensor, whr: Tensor, whi: Tensor,
                  plain: bool, precision: str = "highest") -> Tuple[Tensor, Tensor]:
    """``y = W x`` along the middle axis of ``x (O, N, I)`` at ``precision``:
    the kernel on a CUDA tensor (the plain version with ``plain``), the plain
    version on a CPU one. ``(whr, whi)`` is ``Wᴴ``, contiguous, read by the
    backward."""
    return (complex_dft_matmul_torch if plain else complex_dft_matmul)(xr, xi, wr, wi, precision)


@dft_matmul_op.register_fake
def _(xr, xi, wr, wi, whr, whi, plain, precision="highest"):
    return torch.empty_like(xr), torch.empty_like(xi)


def _dft_setup(ctx, inputs, output):
    _, _, wr, wi, whr, whi, plain, precision = inputs
    ctx.save_for_backward(wr, wi, whr, whi)
    ctx.plain, ctx.precision = plain, precision


def _dft_backward(ctx, gr, gi):
    # x̄ = Wᴴ ȳ; the incoming gradient is copied only when it is not contiguous
    wr, wi, whr, whi = ctx.saved_tensors
    xbr, xbi = dft_matmul_op(gr.contiguous(), gi.contiguous(), whr, whi, wr, wi, ctx.plain,
                             ctx.precision)
    return xbr, xbi, None, None, None, None, None, None


dft_matmul_op.register_autograd(_dft_backward, setup_context=_dft_setup)


class ComplexDFTMatmul:
    """Differentiable product along the middle axis of ``(O, N, I)``:
    ``y = W x`` forward, ``x̄ = Wᴴ ȳ`` backward, both in the layout of x.

    ``apply(xr, xi, wr, wi, whr, whi, plain, precision="highest")`` calls
    ``torch.ops.cinemri.dft_matmul`` (:func:`dft_matmul_op`): ``(whr, whi)``
    is ``Wᴴ``, contiguous; ``plain`` picks :func:`complex_dft_matmul_torch`
    over :func:`complex_dft_matmul` in both directions, both at
    ``precision``. Neither matrix gets a gradient.
    """

    apply = staticmethod(dft_matmul_op)
