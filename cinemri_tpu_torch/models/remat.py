"""Rematerialization of the VarNet, CineNet and XPDNet cascades.

Counterpart of ``cinemri_tpu/models/remat.py``. With ``remat`` on, each
cascade call runs under ``torch.utils.checkpoint`` (non-reentrant): the
forward keeps only the cascade's inputs, and the backward replays the
cascade's forward to rebuild what it needs. That is the JAX package's
default policy ``""`` (save nothing, full replay), the winner of its
policy sweep. Outside autograd (``torch.no_grad`` or inference mode) the
cascade runs directly, so the serving forward is unchanged.

The saving policies ``"dots"``, ``"dots_batch"`` and ``"convs"`` are not
ported yet (ROADMAP Queue 1, item 14).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["REMAT_POLICIES", "check_remat_policy", "call_remat"]

REMAT_POLICIES = ("", "dots", "dots_batch", "convs")


def check_remat_policy(name: str) -> None:
    """Raise unless ``name`` is the ported full-replay policy ``""``."""
    if name not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, got {name!r}")
    if name:
        raise NotImplementedError(
            f"remat_policy {name!r} is not ported yet (ROADMAP Queue 1, item 14: "
            "models/remat.py policies); the port replays the whole cascade (policy '')"
        )


def call_remat(block, remat: bool, *args):
    """``block(*args)``, checkpointed when ``remat`` is on and autograd records."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False)
    return block(*args)
