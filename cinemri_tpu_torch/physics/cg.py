"""Conjugate-gradient solver with on-device scalars.

Counterpart of ``cinemri_tpu/physics/cg.py``: a fixed number of CG steps on
``H x = b`` with the inner products taken over the real view of the complex
tensors (:func:`~cinemri_tpu_torch.ops.cplx.real_dot`, summed over every
axis, the batch axis included, so the step sizes are shared across a
batch, as in the reference's flattened ``torch.dot``).

The JAX package runs the loop as a ``lax.fori_loop`` whose step sizes stay
on the device. Here it is a Python loop over ``iters`` steps whose step
sizes α, β and residual norms are 0-d device tensors: nothing is read to
the host, so a CineNet forward makes no host sync in its CG solves.
Autograd differentiates through the loop, as ``jax.grad`` does through the
``fori_loop``.

The last step stops after its ``x`` update: its residual and direction
updates do not reach the result (XLA drops them from the JAX loop as dead
code), and leaving them out also keeps them out of a checkpoint's replay.
"""

from __future__ import annotations

from typing import Callable

import torch

from cinemri_tpu_torch.instrument import span
from cinemri_tpu_torch.ops.cplx import Complex, real_dot

__all__ = ["conj_grad"]


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b``, and 0 where ``b == 0``: an exhausted residual gives a zero
    step. The inner ``where`` keeps the division (and its gradient) finite
    on the branch that is not taken."""
    ok = b != 0
    return torch.where(ok, a / torch.where(ok, b, torch.ones_like(b)), torch.zeros_like(a))


def conj_grad(operator: Callable[[Complex], Complex], rhs: Complex, x0: Complex,
              iters: int) -> Complex:
    """Run ``iters`` CG steps on ``operator(x) = rhs`` starting from ``x0``."""
    x = x0
    r = rhs - operator(x0)
    p = r
    rs_old = real_dot(r, r)
    for i in range(iters):
        with span("cinemri.dc.cg_step"):
            d = operator(p)
            alpha = _safe_div(rs_old, real_dot(p, d))
            x = x + alpha * p
            if i == iters - 1:
                break
            r = r - alpha * d
            rs_new = real_dot(r, r)
            beta = _safe_div(rs_new, rs_old)
            p = r + beta * p
            rs_old = rs_new
    return x
