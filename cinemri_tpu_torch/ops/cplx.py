"""Complex arithmetic as a (re, im) pair of float32 tensors.

Counterpart of ``cinemri_tpu/ops/cplx.py``. The compute path carries complex
data as :class:`Complex`, two f32 tensors of equal shape, rather than
``complex64``: the CUDA kernels take planar re/im operands, and every
elementwise op stays a plain f32 op. Axis arguments keep the JAX package's
names (``axis``, ``keepdims``) so call sites read the same in both packages.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = [
    "Complex",
    "from_complex",
    "to_numpy",
    "csum",
    "cmean",
    "to_channels",
    "from_channels",
    "to_multi_channels",
    "from_multi_channels",
    "concat",
    "crepeat",
    "real_dot",
]


class Complex:
    """A complex tensor stored as real/imag float tensors of equal shape."""

    __slots__ = ("re", "im")

    def __init__(self, re: torch.Tensor, im: torch.Tensor):
        self.re = re
        self.im = im

    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self) -> int:
        return self.re.ndim

    @property
    def dtype(self):
        return self.re.dtype

    @property
    def device(self) -> torch.device:
        return self.re.device

    def __repr__(self):
        return f"Complex(shape={tuple(self.re.shape)}, dtype={self.re.dtype}, device={self.re.device})"

    # -- arithmetic --------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, Complex):
            return Complex(self.re + other.re, self.im + other.im)
        return Complex(self.re + other, self.im)

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, Complex):
            return Complex(self.re - other.re, self.im - other.im)
        return Complex(self.re - other, self.im)

    def __rsub__(self, other):
        return Complex(other - self.re, -self.im)

    def __neg__(self):
        return Complex(-self.re, -self.im)

    def __mul__(self, other):
        if isinstance(other, Complex):
            return Complex(
                self.re * other.re - self.im * other.im,
                self.re * other.im + self.im * other.re,
            )
        return Complex(self.re * other, self.im * other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Complex):
            d = other.re * other.re + other.im * other.im
            return self * Complex(other.re / d, -other.im / d)
        return Complex(self.re / other, self.im / other)

    def conj(self) -> "Complex":
        return Complex(self.re, -self.im)

    def abs(self) -> torch.Tensor:
        return torch.sqrt(self.re * self.re + self.im * self.im)

    def abs_sq(self) -> torch.Tensor:
        return self.re * self.re + self.im * self.im

    # -- shape ops ---------------------------------------------------------
    def reshape(self, *shape) -> "Complex":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return Complex(self.re.reshape(shape), self.im.reshape(shape))

    def transpose(self, *axes) -> "Complex":
        """Permute the axes (numpy/JAX ``transpose`` semantics)."""
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return Complex(self.re.permute(axes), self.im.permute(axes))

    def __getitem__(self, idx) -> "Complex":
        return Complex(self.re[idx], self.im[idx])


# -- constructors / converters ---------------------------------------------


def from_complex(x) -> Complex:
    """numpy complex array or complex torch tensor -> Complex pair (float32),
    on the tensor's device (the CPU for numpy)."""
    if isinstance(x, Complex):
        return x
    if isinstance(x, np.ndarray):
        return Complex(
            torch.from_numpy(np.ascontiguousarray(x.real, dtype=np.float32)),
            torch.from_numpy(np.ascontiguousarray(x.imag, dtype=np.float32)),
        )
    return Complex(x.real.to(torch.float32).contiguous(), x.imag.to(torch.float32).contiguous())


def to_numpy(x: Complex) -> np.ndarray:
    return x.re.detach().cpu().numpy() + 1j * x.im.detach().cpu().numpy()


# -- reductions / packing ----------------------------------------------------


def csum(x: Complex, axis=None, keepdims: bool = False) -> Complex:
    if axis is None:
        return Complex(x.re.sum(), x.im.sum())
    return Complex(x.re.sum(dim=axis, keepdim=keepdims), x.im.sum(dim=axis, keepdim=keepdims))


def cmean(x: Complex, axis=None, keepdims: bool = False) -> Complex:
    if axis is None:
        return Complex(x.re.mean(), x.im.mean())
    return Complex(x.re.mean(dim=axis, keepdim=keepdims), x.im.mean(dim=axis, keepdim=keepdims))


def to_channels(x: Complex, axis: int = -1) -> torch.Tensor:
    """Complex (...,) -> real tensor with a [re, im] channel axis at ``axis``.

    ``axis=-1`` is the JAX package's channels-last packing; the port's
    NCHW denoisers use ``axis=1``.
    """
    return torch.stack([x.re, x.im], dim=axis)


def from_channels(r: torch.Tensor, axis: int = -1) -> Complex:
    re, im = r.unbind(dim=axis)
    return Complex(re, im)


def to_multi_channels(x: Complex, axis: int = -1) -> torch.Tensor:
    """Complex ``(..., n, ...)`` -> real ``(..., 2n, ...)`` along ``axis``:
    the first n re, the last n im (the reference's complex_to_real_multi_ch
    packing). ``axis=-1`` is the JAX package's channels-last layout."""
    return torch.cat([x.re, x.im], dim=axis)


def from_multi_channels(r: torch.Tensor, axis: int = -1) -> Complex:
    """Inverse of :func:`to_multi_channels`: views of the two halves of ``axis``."""
    re, im = r.chunk(2, dim=axis)
    return Complex(re, im)


def concat(xs: Sequence[Complex], axis: int = -1) -> Complex:
    return Complex(torch.cat([x.re for x in xs], dim=axis), torch.cat([x.im for x in xs], dim=axis))


def crepeat(x: Complex, n: int, axis: int) -> Complex:
    """Each element repeated ``n`` times along ``axis`` (``jnp.repeat``)."""
    return Complex(x.re.repeat_interleave(n, dim=axis), x.im.repeat_interleave(n, dim=axis))


def real_dot(u: Complex, v: Complex) -> torch.Tensor:
    """``Re⟨u, v⟩`` summed over every axis, the batch axis included: the
    reference CG's real-flattened ``torch.dot``. A 0-d tensor on the
    operands' device (never read to the host)."""
    return (u.re * v.re + u.im * v.im).sum()
