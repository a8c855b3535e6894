"""Instrumentation: profiler traces, step timing, numerical sanitizers.

Counterpart of ``cinemri_tpu/instrument/__init__.py``, on torch:

  * :func:`trace` — ``torch.profiler`` over a block (CUDA activity when a
    card is present), written as a chrome trace that
    :func:`~cinemri_tpu_torch.instrument.opstats.kernel_events` folds.
  * :class:`StepTimer` — device-synchronized per-step wall times with
    percentile summaries.
  * :func:`enable_nan_checks` — a switch that raises ``FloatingPointError``
    at the first module whose output, or the gradient into whose output, is
    not finite (JAX's ``jax_debug_nans``).
  * :func:`assert_finite` — host-side finiteness check of a tree of tensors
    or arrays, naming the leaf.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from cinemri_tpu_torch.ops.cplx import Complex

__all__ = ["trace", "StepTimer", "enable_nan_checks", "assert_finite"]


@contextlib.contextmanager
def trace(log_dir):
    """Profile the enclosed block with ``torch.profiler`` (CPU activity,
    and CUDA activity when a card is present) and write its chrome trace to
    ``log_dir/<host>_<pid>.<ms>.pt.trace.json`` (TensorBoard's profiler
    naming), also when the block raises. The card is synchronized before
    the profiler stops, so the trace holds the block's device work."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    cuda = torch.cuda.is_available()
    prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
    prof.start()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json"
        prof.export_chrome_trace(str(log_dir / name))


class StepTimer:
    """Wall-clock step timer; call around device-synchronized work."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync=None):
        """``sync``: a tensor (or a tree of them) whose devices are
        synchronized before the clock stops."""
        if sync is not None:
            for dev in {t.device for t in _tensors(sync) if t.device.type == "cuda"}:
                torch.cuda.synchronize(dev)
        self.times.append(time.perf_counter() - self._t0)

    @contextlib.contextmanager
    def step(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {
            "count": float(len(t)),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p90_s": float(np.percentile(t, 90)),
            "min_s": float(t.min()),
            "max_s": float(t.max()),
        }


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, object]]:
    """``(path, leaf)`` of a tree of dicts, lists, tuples and ``Complex``
    pairs, the path in ``['key'][0].re`` form."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(tree, Complex):
        yield f"{path}.re", tree.re
        yield f"{path}.im", tree.im
    else:
        yield path, tree


def _tensors(tree) -> Iterator[torch.Tensor]:
    for _, leaf in _leaves(tree):
        if torch.is_tensor(leaf):
            yield leaf


def _finite(leaf) -> bool:
    if torch.is_tensor(leaf):
        return not leaf.is_floating_point() or bool(torch.isfinite(leaf).all())
    return bool(np.isfinite(np.asarray(leaf)).all())


_NAN_HOOK = None


def _check_output(module, args, output):
    name = type(module).__name__
    for path, leaf in _leaves(output):
        if not torch.is_tensor(leaf) or not leaf.is_floating_point():
            continue
        if not _finite(leaf):
            raise FloatingPointError(f"non-finite values in the output{path} of {name}")
        if leaf.requires_grad:
            def check_grad(grad, path=path):
                if not _finite(grad):
                    raise FloatingPointError(
                        f"non-finite gradient into the output{path} of {name}")
            leaf.register_hook(check_grad)


def enable_nan_checks(enabled: bool = True) -> bool:
    """Switch the NaN checks on or off for every module of the process;
    returns whether they were on. While on, each module's floating output is
    checked after its forward (one device sync each) and, when it requires
    grad, the gradient into it during backward; the first non-finite one
    raises ``FloatingPointError`` naming the module and the output."""
    global _NAN_HOOK
    was = _NAN_HOOK is not None
    if enabled and not was:
        _NAN_HOOK = torch.nn.modules.module.register_module_forward_hook(_check_output)
    elif not enabled and was:
        _NAN_HOOK.remove()
        _NAN_HOOK = None
    return was


def assert_finite(tree, name: str = "tree"):
    """Raise ``FloatingPointError`` with the offending leaf's path if any
    value of ``tree`` (tensors, numpy arrays or numbers in dicts, lists,
    tuples and ``Complex`` pairs) is not finite."""
    for path, leaf in _leaves(tree):
        if not _finite(leaf):
            raise FloatingPointError(f"non-finite values in {name}{path}")
