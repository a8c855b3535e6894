"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Nothing here builds or loads a kernel at import; ``_build.load`` does so at
the first launch. Importing this package registers the kernels' custom ops
in the ``cinemri`` namespace (``torch.ops.cinemri.dft_matmul``,
``normal_apply``, ``normal_apply_bwd``, ``fft2_plane``), which a loaded
``torch.export`` artifact of the port calls.
"""

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


from cinemri_tpu_torch.ops.kernels import dft_cuda, fft2_cuda, normal_cuda  # noqa: F401
