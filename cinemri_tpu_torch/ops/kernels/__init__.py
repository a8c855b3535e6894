"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Nothing here builds or loads a kernel at import; ``_build.load`` does so at
the first launch. Importing this package registers the kernels' custom ops
in the ``cinemri`` namespace (``torch.ops.cinemri.dft_matmul``,
``normal_apply``, ``normal_apply_bwd``, ``fft2_plane``), which a loaded
``torch.export`` artifact of the port calls.

Each wrapper advances its launch counters through one function decorated
with :func:`counter`, so that a CUDA graph that captured its launches can
take their counts again at each replay (:func:`counted`).
"""

import contextlib
import functools
import threading

import torch


def trace_safe(cached, *key):
    """``cached(*key)`` from its ``lru_cache``, safe while ``torch.export``
    traces (``torch.compiler.is_compiling()``): an entry made before the
    trace is a device tensor, which the artifact keeps as a constant, but an
    entry made inside it would be a fake tensor, so a miss there empties the
    cache and the next eager call builds the entry anew."""
    if not torch.compiler.is_compiling():
        return cached(*key)
    misses = cached.cache_info().misses
    out = cached(*key)
    if cached.cache_info().misses != misses:
        cached.cache_clear()
    return out


_COUNTING = threading.local()


def counter(fn):
    """``fn``, a kernel wrapper's function that advances its launch
    counters; while :func:`counted` records on the calling thread (a CUDA
    graph captures the launch, which runs nothing), a call is logged
    instead of counted."""

    @functools.wraps(fn)
    def counting(*args):
        log = getattr(_COUNTING, "log", None)
        if log is None:
            fn(*args)
        else:
            log.append((fn, args))

    return counting


@contextlib.contextmanager
def counted():
    """The ``(fn, args)`` of the :func:`counter` calls made on this thread
    while entered, uncounted: a replay of what was captured meanwhile calls
    each ``fn(*args)``."""
    saved = getattr(_COUNTING, "log", None)
    _COUNTING.log = log = []
    try:
        yield log
    finally:
        _COUNTING.log = saved


from cinemri_tpu_torch.ops.kernels import dft_cuda, fft2_cuda, normal_cuda  # noqa: F401
