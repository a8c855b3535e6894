"""Device traces of a run's profiled items, folded in memory.

A traced run profiles two spans of items, one after the other, and folds
the profiler's raw events (no chrome trace is written) into a
:class:`Trace`:

* the device span (:func:`device_profiler`, the card's activity alone, so the
  host runs at its untraced pace): the window from the first to the last
  device event (a marker kernel is launched right after the profiler starts
  and right before it stops, both with the queue drained), the device's busy
  seconds in it (the union of every kernel, copy and set), and device
  seconds and counts by kernel name and by kind (:data:`KINDS`, copied from
  the port's ``instrument/opstats.py``);
* the op span (:func:`op_profiler`, CPU ops with their input shapes and the
  card's activity): for each op asked for, its calls, with the device
  seconds of the kernels each call launched, found through the profiler's
  link from a kernel to the CPU op that launched it (the op or an op nested
  in it on the same thread), not through kernel names; and the idle gaps
  inside the harness's item spans (``record_function`` ranges named
  :data:`ITEM`) by what the host was doing, the innermost CPU op open on the
  item thread at the gap's start. Recording every op slows the host, so the
  gaps' sizes there are not the untraced run's; their labels say where the
  host spends its time.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

__all__ = ["ITEM", "KINDS", "kind", "Trace", "device_profiler", "op_profiler", "fold",
           "fold_device", "fold_ops"]

ITEM = "cinebench.item"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "user_annotation")

# (kind, substrings of the lower-cased kernel name), first match wins
KINDS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("dft_matmul", ("dft_matmul_kernel", "dft_kernel", "dft_small_", "dft_wgmma_")),
    ("normal_apply_bwd", ("normal_apply_bwd",)),
    ("normal_apply", ("normal_apply_products", "normal_apply_contract", "normal_apply_reduce",
                      "normal_apply_wgmma_", "normal_apply_fp32")),
    ("fft2_plane", ("fft2_plane_kernel",)),
    ("instance_norm", ("batch_norm", "instance_norm", "welford")),
    ("conv", ("conv", "implicit", "xmma", "cudnn", "sm90", "sm80", "gemm", "winograd", "cutlass",
              "dgrad", "wgrad", "fft2d", "pointwise_mult_and_sum", "vector_fft",
              "region_transform")),
    ("pooling", ("pool",)),
    ("copy", ("memcpy", "memset", "copy", "cat", "pad", "flip")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "leaky")),
)


def kind(name: str) -> str:
    low = name.lower()
    for k, keys in KINDS:
        if any(s in low for s in keys):
            return k
    return "other"


@dataclass
class Trace:
    """What :func:`fold` reads; ``items`` items ran in the device span."""

    items: int
    window_s: float
    busy_s: float
    kernels: Dict[str, List[float]] = field(default_factory=dict)  # name -> [seconds, count]
    ops: Dict[str, List[Tuple[list, float, int]]] = field(default_factory=dict)
    gaps: Dict[str, float] = field(default_factory=dict)  # host activity -> idle seconds

    def seconds_of_kind(self, k: str) -> float:
        return sum(s for name, (s, _) in self.kernels.items() if kind(name) == k)

    def ms_by_kind(self) -> Dict[str, float]:
        """Device ms per item of the device span by kernel kind, largest first."""
        acc: Dict[str, float] = defaultdict(float)
        for name, (seconds, _) in self.kernels.items():
            acc[kind(name)] += 1e3 * seconds / self.items
        return dict(sorted(acc.items(), key=lambda kv: -kv[1]))

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(((name, v[0]) for name, v in self.kernels.items()), key=lambda x: -x[1])
        gaps = sorted(self.gaps.items(), key=lambda x: -x[1])
        return {"device_ops": [list(x) for x in ops[:n]], "idle_gaps": [list(x) for x in gaps[:n]]}


def device_profiler():
    """A profiler of the card's activity alone (of the CPU's, without a card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    return profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])


def op_profiler():
    """A profiler of the CPU ops, with their input shapes, and the card."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True)


def _link(event) -> int:
    """The correlation of the CPU op that launched a device event (0: none)."""
    return event.linked_correlation_id() if hasattr(event, "linked_correlation_id") else 0


_RUNTIME = re.compile(r"^(cu|cuda|nv)[A-Z]")


def _activity(event, name: str) -> str:
    """The event's kineto activity type; where torch does not expose it,
    worked out from the device type and the name: device events other than
    the harness's own span are kernels (copies and sets included), host
    events other than CUDA API calls (``cuda*``, ``cu*``) are ops."""
    if hasattr(event, "activity_type"):
        return event.activity_type()
    from torch.autograd import DeviceType

    if event.device_type() == DeviceType.CUDA:
        return "gpu_user_annotation" if name == ITEM else "kernel"
    return "cuda_runtime" if _RUNTIME.match(name) else "cpu_op"


def _events(prof, ops: set) -> Tuple[List[tuple], List[tuple]]:
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        act = _activity(e, name)
        if act in DEVICE_ACTIVITIES:
            device.append((e.start_ns(), e.end_ns(), name, _link(e)))
        elif act in HOST_ACTIVITIES:
            host.append((e.start_ns(), e.end_ns(), e.start_thread_id(), e.correlation_id(), name,
                         e.shapes() if name in ops else None))
    return host, device


def fold(device_prof, items: int, op_prof, ops: Iterable[str]) -> Trace:
    """Fold the two stopped profilers (see the module docstring)."""
    ops = set(ops)
    trace = fold_device(_events(device_prof, ops)[1], items)
    host, device = _events(op_prof, ops)
    return fold_ops(trace, host, device, ops)


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def fold_device(device: List[tuple], items: int) -> Trace:
    """The device span's window, busy seconds and kernels; ``device``
    ``(start_ns, end_ns, name, linked correlation)``."""
    if not device:
        return Trace(items=items, window_s=0.0, busy_s=0.0)
    w0, w1 = min(d[0] for d in device), max(d[1] for d in device)
    busy = _union([(s, e) for s, e, _, _ in device])
    trace = Trace(items=items, window_s=(w1 - w0) / 1e9, busy_s=sum(e - s for s, e in busy) / 1e9)
    for s, e, name, _ in device:
        acc = trace.kernels.setdefault(name, [0.0, 0])
        acc[0] += (e - s) / 1e9
        acc[1] += 1
    return trace


def fold_ops(trace: Trace, host: List[tuple], device: List[tuple], ops: Iterable[str]) -> Trace:
    """Add the op span's calls and idle gaps to ``trace``; ``host``
    ``(start_ns, end_ns, thread, correlation, name, shapes)``."""
    ops = set(ops)
    by_link: Dict[int, List[float]] = defaultdict(list)
    for s, e, _, link in device:
        if link:
            by_link[link].append((e - s) / 1e9)
    by_thread: Dict[int, List[tuple]] = defaultdict(list)
    for h in host:
        by_thread[h[2]].append(h)
    for events in by_thread.values():
        events.sort()
        starts = [h[0] for h in events]
        outer_end = {}
        for s, e, _, _, name, shapes in events:
            if name not in ops or outer_end.get(name, -1) >= e:
                continue  # not an op asked for, or nested in a call of the same op
            outer_end[name] = e
            lo, hi = bisect.bisect_left(starts, s), bisect.bisect_right(starts, e)
            secs = [d for n in events[lo:hi] if n[1] <= e for d in by_link.get(n[3], ())]
            trace.ops.setdefault(name, []).append((shapes, sum(secs), len(secs)))

    spans = [h for h in host if h[4] == ITEM]
    if not spans:
        return trace
    main = by_thread[spans[0][2]]
    starts = [h[0] for h in main]
    for w0, w1, *_ in spans:
        busy = _union([(max(s, w0), min(e, w1)) for s, e, _, _ in device if e > w0 and s < w1])
        edges = [w0] + [x for span in busy for x in span] + [w1]
        for g0, g1 in zip(edges[::2], edges[1::2]):
            if g1 <= g0:
                continue
            label = ITEM
            i = bisect.bisect_right(starts, g0) - 1
            for i in range(i, max(i - 256, -1), -1):  # the innermost open op lies close
                if main[i][1] > g0 and main[i][4] != ITEM:
                    label = main[i][4]
                    break
            trace.gaps[label] = trace.gaps.get(label, 0.0) + (g1 - g0) / 1e9
    return trace
