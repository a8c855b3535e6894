"""Where a forward's or a train step's device time goes, from a
``torch.profiler`` trace.

Counterpart of ``cinemri_tpu/instrument/opstats.py``: parses the kernel
events of an exported chrome trace and folds their durations by kind
(the port's CUDA kernels, convolutions, normalization, elementwise, ...),
and reports the device's busy and idle share over the traced window.
``chip_smoke.py`` folds its profiled forwards and train steps with these.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

__all__ = ["kernel_events", "fold_by_kind", "top_names", "busy_share", "KINDS"]

# (kind, substrings of the lower-cased kernel name), first match wins
KINDS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    # ahead of the convolutions: the tile engine's template names hold "cgemm"
    ("dft_matmul (port kernel)", ("dft_matmul_kernel", "dft_kernel", "dft_small_")),
    ("normal_apply_bwd (port kernels)", ("normal_apply_bwd",)),
    ("normal_apply (port kernels)", ("normal_apply_products", "normal_apply_contract",
                                     "normal_apply_reduce")),
    # before the convolutions, whose keys include cuDNN's fft2d_*
    ("fft2_plane (port kernel)", ("fft2_plane_kernel",)),
    ("instance norm", ("batch_norm", "instance_norm", "welford")),
    # cuDNN's FFT convolutions run fft2d_*, pointwise_mult_and_sum_complex,
    # the DSE engine's vector_fft and the float2 transposes region_transform_*
    ("conv / gemm (cuDNN, cuBLAS)", ("conv", "implicit", "xmma", "cudnn", "sm90", "sm80",
                                     "gemm", "winograd", "cutlass", "dgrad", "wgrad",
                                     "fft2d", "pointwise_mult_and_sum", "vector_fft",
                                     "region_transform")),
    ("pooling", ("pool",)),
    ("copy / cat / pad", ("memcpy", "memset", "copy", "cat", "pad", "flip")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "leaky")),
)

_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_events(trace_path) -> List[Tuple[str, float, float]]:
    """``(name, start_us, duration_us)`` of every device event in a chrome trace."""
    trace = json.loads(Path(trace_path).read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [(e["name"], float(e["ts"]), float(e["dur"]))
            for e in events if e.get("cat") in _CATS and "dur" in e]


def _kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def fold_by_kind(events) -> Dict[str, dict]:
    """Device milliseconds and event counts per kind, largest first."""
    acc = defaultdict(lambda: [0.0, 0])
    for name, _, dur in events:
        a = acc[_kind(name)]
        a[0] += dur / 1e3
        a[1] += 1
    return {k: {"ms": v[0], "count": v[1]}
            for k, v in sorted(acc.items(), key=lambda kv: -kv[1][0])}


def top_names(events, kind: str, n: int = 5) -> List[Tuple[str, float, int]]:
    """The ``n`` kernel names of ``kind`` with the most device time:
    ``(name, ms, count)``, largest first."""
    acc = defaultdict(lambda: [0.0, 0])
    for name, _, dur in events:
        if _kind(name) == kind:
            acc[name][0] += dur / 1e3
            acc[name][1] += 1
    return sorted(((k, v[0], v[1]) for k, v in acc.items()), key=lambda x: -x[1])[:n]


def busy_share(events) -> Tuple[float, float]:
    """(busy ms, window ms): the union of event intervals over first start to last end."""
    spans = sorted((ts, ts + dur) for _, ts, dur in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0] if spans else 0.0
    return busy / 1e3, window / 1e3
