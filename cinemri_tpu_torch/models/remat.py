"""Rematerialization of the VarNet, CineNet and XPDNet cascades.

Counterpart of ``cinemri_tpu/models/remat.py``. With ``remat`` on, each
cascade (or CRNN iteration) call runs under ``torch.utils.checkpoint``
(non-reentrant): the forward keeps the cascade's inputs, and the backward
replays the cascade's forward to rebuild what it needs. Outside autograd
(``torch.no_grad`` or inference mode) the cascade runs directly, so the
serving forward is unchanged.

Policies (``remat_policy`` on the model classes): what the forward keeps
besides the inputs, through selective checkpointing
(``create_selective_checkpoint_contexts``): a kept output is not recomputed
by the replay. The counterparts of the JAX package's policies:

* ``""``         — keep nothing (full replay); the default, the winner of
  the JAX package's policy sweep;
* ``"dots"``     — ``dots_with_no_batch_dims_saveable``: the outputs of
  ``cinemri::dft_matmul`` (the DFT, JAX's XLA ``tensordot``) and of any
  ``aten.mm`` / ``aten.addmm``;
* ``"dots_batch"`` — ``dots_saveable``: those, plus ``cinemri::normal_apply``
  (JAX's batched einsum of ``physics/operators.py:345``) and any
  ``aten.bmm`` / ``aten.baddbmm``;
* ``"convs"``    — ``save_only_these_names('conv_out')``: the convolutions run
  inside :func:`tag_conv_out`, which the U-Nets' blocks and the CRNN's
  convolutions enter as the JAX package tags them (not the MWCNN's, not the
  k-space net's).

Every policy gives the same losses and gradients: it changes only what the
backward recomputes. ``prevent_cse`` (``remat_prevent_cse`` on the models) is
accepted and does nothing: it keeps XLA from merging the replay with the
forward, and eager PyTorch merges nothing. :data:`SAVED` counts, per policy,
the op outputs that checkpointed forwards kept.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

__all__ = ["REMAT_POLICIES", "SAVED", "check_remat_policy", "call_remat", "tag_conv_out"]

REMAT_POLICIES = ("", "dots", "dots_batch", "convs")
SAVED = dict.fromkeys(REMAT_POLICIES, 0)

_aten = torch.ops.aten
_CONV_OUT = 0  # depth of the tag_conv_out regions being run


def check_remat_policy(name: str) -> None:
    """Raise unless ``name`` is one of :data:`REMAT_POLICIES`."""
    if name not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, got {name!r}")


@contextlib.contextmanager
def tag_conv_out():
    """The convolutions run inside are the ``"convs"`` policy's to keep (the
    JAX package's ``tag_conv_out``); costs nothing under another policy."""
    global _CONV_OUT
    _CONV_OUT += 1
    try:
        yield
    finally:
        _CONV_OUT -= 1


@functools.lru_cache(maxsize=None)
def _saved_ops(policy: str) -> frozenset:
    import cinemri_tpu_torch.ops.kernels  # noqa: F401  (registers the cinemri ops)

    ops = set()
    if policy in ("dots", "dots_batch"):
        ops |= {torch.ops.cinemri.dft_matmul.default, _aten.mm.default, _aten.addmm.default}
    if policy == "dots_batch":
        ops |= {torch.ops.cinemri.normal_apply.default, _aten.bmm.default, _aten.baddbmm.default}
    return frozenset(ops)


def _policy_fn(policy: str, ctx, op, *args, **kwargs):
    keep = op in _saved_ops(policy) or (
        policy == "convs" and _CONV_OUT > 0 and op is _aten.convolution.default)
    if keep and not ctx.is_recompute:
        SAVED[policy] += 1
    return CheckpointPolicy.MUST_SAVE if keep else CheckpointPolicy.PREFER_RECOMPUTE


def call_remat(block, remat: bool, policy: str, *args):
    """``block(*args)``, checkpointed under ``policy`` when ``remat`` is on
    and autograd records."""
    if not (remat and torch.is_grad_enabled()):
        return block(*args)
    if not policy:
        return checkpoint(block, *args, use_reentrant=False)
    context_fn = functools.partial(create_selective_checkpoint_contexts,
                                   functools.partial(_policy_fn, policy))
    return checkpoint(block, *args, use_reentrant=False, context_fn=context_fn)
