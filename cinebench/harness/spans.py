"""Readings of a traced run that need the port's program spans
(``cinemri_tpu_torch.instrument.span``), for the readers under ``metrics/``.

A program span is a host range recorded like an op (``cpu_op``, not a user
annotation), so the profiler draws no device range for it and no fold counts
a span as device work. Naming a span in ``costs/`` (``OP``, the span's name)
makes the op span's fold (:func:`.trace.fold_ops`) list each of its calls,
outermost per thread, with the device seconds and the count of the device
events (kernels, copies, sets) linked to the ops opened inside it on its
thread: each event carries the correlation of the op that launched it. That
count is device work, not host launch calls: a CUDA graph's replay is one
call and as many events as it holds. A trace of a program without the span
holds no call of it, and the readers return None.

The fold matches a device event to every host event of its correlation, and
kineto's own host events (``Activity Buffer Request``, ``Command Buffer
Full``) take the correlation of the op they interrupt, so that op's device
events count twice. The op profiler's first buffer request falls in the
first item's first copy, inside ``cinemri.serve.h2d``; so the span readings
leave the op span's first item out, and read the items after it (one
request in ``traffic/serve_closed.json``). ``Command Buffer Full`` falls
where the card's launch queue is full, which on the H100 was inside the
U-Nets of a card-paced request (``cinemri.regularizer``), not in the spans
read here; one inside a span read here would double that op's device time
and events, and the fold leaves no trace of it that a reader could see.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

__all__ = ["op_items", "later_calls", "span_ms", "span_events"]


def op_items(run) -> int:
    """The items that ran under the op profiler (after the device span's)."""
    return sum(1 for x in run.items if x["traced"]) - run.trace.items


def later_calls(run, kind: str, name: str) -> Optional[Tuple[List[tuple], int]]:
    """``(calls, items)``: the calls ``(shapes, device seconds, device
    events)`` of the span ``name``, opened on the item's thread, in the op
    span's items after its first, and the count of those items; None in
    another kind of run, an untraced run, or without a call of the span."""
    if run.kind != kind or run.trace is None or run.trace.busy_s <= 0:
        return None
    n = op_items(run)
    calls = run.trace.ops.get(name)
    if n < 2 or not calls:
        return None
    return calls[len(calls) // n:], n - 1


def span_ms(run, kind: str, name: str) -> Optional[float]:
    """Device ms per item of the kernels, copies and sets launched inside
    the span ``name``."""
    got = later_calls(run, kind, name)
    return None if got is None else 1e3 * sum(c[1] for c in got[0]) / got[1]


def span_events(run, kind: str, name: str) -> Optional[float]:
    """Device events (kernels, copies, sets) per item launched inside the
    span ``name``."""
    got = later_calls(run, kind, name)
    return None if got is None else sum(c[2] for c in got[0]) / got[1]
