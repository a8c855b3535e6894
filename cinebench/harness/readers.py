"""Arithmetic shared by the metric readers under ``metrics/``.

Each reader is ``metrics/<metric>.py`` with ``read(run)`` returning a
number, or None when ``run`` (``harness.bench.Run``) holds nothing for it:
another kind of traffic, an untraced run for a trace metric, or a trace
with no call of the op. A share of a roofline or of a peak is never
reported as 0 in place of nothing.
"""

from __future__ import annotations

import statistics
from typing import Optional

from cinebench.harness import flops

__all__ = ["enqueue_ms", "kind_ms", "roofline_pct", "idle_pct", "mfu_pct"]


def enqueue_ms(run, kind: str) -> Optional[float]:
    """Median host ms from the call until the program returns, over the
    window's items that ran outside the profiler."""
    if run.kind != kind:
        return None
    times = [x["t1"] - x["t0"] for x in run.items if not x["traced"]]
    return 1e3 * statistics.median(times) if times else None


def _traced(run, kind: str) -> bool:
    """A traced run of ``kind`` whose trace holds device work."""
    return run.kind == kind and run.trace is not None and run.trace.busy_s > 0


def kind_ms(run, kind: str, kernels: str) -> Optional[float]:
    """Device ms of the kernels of a kind, per traced item."""
    if not _traced(run, kind):
        return None
    return 1e3 * run.trace.seconds_of_kind(kernels) / run.trace.items


def roofline_pct(run, kind: str, cost: str) -> Optional[float]:
    """Σ bound / Σ device time over the traced calls of ``costs/<cost>.py``'s
    op, the bound of a call max(FLOP / peak FLOP/s, bytes / peak bytes/s)
    from its input shapes, in %."""
    if not _traced(run, kind):
        return None
    module = flops.cost_ops()
    op = next((name for name, stem in module.items() if stem == cost), None)
    calls = [c for c in run.trace.ops.get(op, []) if c[1] > 0]
    if not calls:
        return None
    fn = flops.op_cost(cost)
    bound = 0.0
    for shapes, _, _ in calls:
        f, b = fn(shapes)
        bound += max(f / run.peak_flops, b / run.peak_bw)
    return 100.0 * bound / sum(c[1] for c in calls)


def idle_pct(run, kind: str) -> Optional[float]:
    """The traced window's share with no kernel, copy or set on the device, in %."""
    if not _traced(run, kind):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu_pct(run, kind: str) -> Optional[float]:
    """The model's FLOP (closed form, ``harness/flops.py``) over the traced
    items, over the traced window's seconds at the float32 peak, in %."""
    if not _traced(run, kind):
        return None
    return 100.0 * run.item_flop * run.trace.items / (run.trace.window_s * run.peak_flops)
