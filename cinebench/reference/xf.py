"""Pieces both XF models share: the XF regularizer, the masked normal
operator along h, and conjugate gradients with real inner products.

Shapes: image ``(b, t, h, w)`` complex, per-frame kernel ``(b, t, h, h)``,
maps ``(b, c, h, w)``.
"""

from __future__ import annotations

from typing import Callable

import torch

from cinebench.reference.fourier import fft1c, ifft1c

__all__ = ["xf_regularizer", "normal_op", "cg"]


def normal_op(z: torch.Tensor, kernel: torch.Tensor, maps: torch.Tensor) -> torch.Tensor:
    """``Σ_c conj(S_c) T_t (S_c z_t)``."""
    coil = maps[:, None] * z[:, :, None]  # (b, t, c, h, w)
    coil = torch.einsum("btij,btcjw->btciw", kernel, coil)
    return (maps.conj()[:, None] * coil).sum(dim=2)


def xf_regularizer(x: torch.Tensor, net: Callable[[torch.Tensor, str], torch.Tensor],
                   prefix: str) -> torch.Tensor:
    """Temporal mean off, centered DFT over t, ``net`` over the (w, t) planes
    (``<prefix>.net_xf``) and over the (h, t) planes (``<prefix>.net_yf``),
    their mean, the inverse DFT, the mean back; ``net(planes, name)`` maps
    complex planes ``(n, a, t)`` to complex planes."""
    b, t, h, w = x.shape
    mean = x.mean(dim=1, keepdim=True)
    y = fft1c(x - mean, 1)
    xf = net(y.permute(0, 2, 3, 1).reshape(b * h, w, t), f"{prefix}.net_xf")
    yf = net(y.permute(0, 3, 2, 1).reshape(b * w, h, t), f"{prefix}.net_yf")
    xf = xf.reshape(b, h, w, t).permute(0, 3, 1, 2)
    yf = yf.reshape(b, w, h, t).permute(0, 3, 2, 1)
    return ifft1c(0.5 * (xf + yf), 1) + mean


def _real_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (u.real * v.real + u.imag * v.imag).sum()


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ok = b != 0
    return torch.where(ok, a / torch.where(ok, b, torch.ones_like(b)), torch.zeros_like(a))


def cg(op, rhs: torch.Tensor, x: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` steps on ``op(x) = rhs`` from ``x``; a zero denominator
    gives a zero step; the last step ends after its ``x`` update."""
    r = rhs - op(x)
    d = r
    rs = _real_dot(r, r)
    for i in range(iters):
        q = op(d)
        step = _safe_div(rs, _real_dot(d, q))
        x = x + step * d
        if i == iters - 1:
            break
        r = r - step * q
        rs_new = _real_dot(r, r)
        d = r + _safe_div(rs_new, rs) * d
        rs = rs_new
    return x
