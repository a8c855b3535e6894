"""The port's program spans in a folded trace, and the readers of them,
on synthetic event lists.

A span is a host range like an op: its device events, and the existing
fields of a trace, fold as they did without it; the readers take a span's
device time and device events from the op span's items after its first.
"""

import pytest

from cinebench.harness import flops, trace
from cinebench.harness.bench import Run, read_metric

OPS = set(flops.cost_ops())
NA = [(1, 2, 4, 4), (1, 2, 4, 4), (1, 2, 4, 4), (1, 2, 4, 4), (1, 3, 4, 4), (1, 3, 4, 4), (1,), (),
      ()]


def _item(t0, corr, buffer_request=False):
    """One served request at ``t0``: host ``(start, end, thread, correlation,
    name, shapes)`` and device ``(start, end, name, link)`` events, the
    correlations from ``corr`` on. Its copy (100 ns) lies in
    ``cinemri.serve.h2d``; its two data consistencies each launch a normal
    apply (two kernels) and a product; a denoiser launches a convolution."""
    c = corr
    host = [(t0, t0 + 1000, 1, c, trace.ITEM, None),
            (t0 + 10, t0 + 990, 1, c + 1, "cinemri.serve", None),
            (t0 + 20, t0 + 80, 1, c + 2, "cinemri.serve.h2d", None),
            (t0 + 30, t0 + 70, 1, c + 3, "aten::copy_", None),
            (t0 + 100, t0 + 300, 1, c + 4, "cinemri.regularizer", None),
            (t0 + 110, t0 + 150, 1, c + 5, "aten::cudnn_convolution", None)]
    device = [(t0 + 40, t0 + 140, "Memcpy HtoD (Pageable -> Device)", c + 3),
              (t0 + 150, t0 + 400, "conv_kernel", c + 5)]
    for k, s in enumerate((t0 + 400, t0 + 600)):
        d = c + 6 + 3 * k
        host += [(s, s + 150, 1, d, "cinemri.dc", None),
                 (s + 10, s + 60, 1, d + 1, "cinemri::normal_apply", NA),
                 (s + 70, s + 100, 1, d + 2, "aten::mul", None)]
        device += [(s + 60, s + 100, "normal_apply_products_kernel", d + 1),
                   (s + 100, s + 160, "normal_apply_contract_kernel", d + 1),
                   (s + 160, s + 180, "vectorized_elementwise_kernel", d + 2)]
    if buffer_request:  # kineto's host event, with the correlation of the copy it interrupts
        host.append((t0 + 31, t0 + 32, 1, c + 3, "Activity Buffer Request", None))
    return host, device


def _fold(with_spans=True, buffer_request=True):
    host, device = [], []
    for k in range(3):  # a device-span item's worth of kernels, then two op-span items
        h, d = _item(10_000 * k, 100 * k + 1, buffer_request and k == 1)
        host += h
        device += d
    dev = [x for x in device if x[0] < 10_000]
    op_host = [x for x in host if x[0] >= 10_000]
    op_dev = [x for x in device if x[0] >= 10_000]
    if not with_spans:
        op_host = [x for x in op_host if not x[4].startswith("cinemri.")]
    t = trace.fold_ops(trace.fold_device(dev, items=1), op_host, op_dev, OPS)
    items = [{"t0": 0.0, "t1": 0.0, "t2": 0.0, "traced": True}] * 3
    return Run(kind="serve", setup_s=1.0, window_s=1.0, items=items, peak_window_bytes=0,
               item_flop=1.0, peak_flops=67e12, peak_bw=3.35e12, trace=t)


def test_the_costs_name_the_spans_read_and_give_them_no_cost():
    assert {"cinemri.serve.h2d", "cinemri.dc"} <= OPS
    for op in ("cinemri.serve.h2d", "cinemri.dc"):
        with pytest.raises(TypeError, match="program span"):
            flops.op_cost(flops.cost_ops()[op])([])


def test_spans_fold_with_their_ops_device_time_and_events():
    run = _fold()
    calls = run.trace.ops["cinemri.dc"]
    assert len(calls) == 4 and all(c[2] == 3 for c in calls)  # outermost calls, each 3 device events
    assert [c[1] for c in calls] == pytest.approx([120e-9] * 4)
    # the first op-span item's copy counts twice (the buffer request); the readers leave it out
    assert [c[1] for c in run.trace.ops["cinemri.serve.h2d"]] == pytest.approx([200e-9, 100e-9])
    assert read_metric("h2d_ms.serve", run) == pytest.approx(100e-6)
    assert read_metric("dc_ms.serve", run) == pytest.approx(240e-6)
    assert read_metric("dc_device_events.serve", run) == 6


def test_the_existing_fields_read_the_same_with_program_spans():
    plain, spanned = _fold(with_spans=False), _fold()
    for field in ("items", "window_s", "busy_s", "kernels"):
        assert getattr(spanned.trace, field) == getattr(plain.trace, field)
    assert spanned.trace.ops["cinemri::normal_apply"] == plain.trace.ops["cinemri::normal_apply"]
    for name in ("idle_pct.serve", "mfu.serve", "conv_ms.serve", "normal_apply_roofline.serve"):
        assert read_metric(name, spanned) == read_metric(name, plain)
    # the same idle seconds; where no op is open, the innermost span names the gap
    assert sum(spanned.trace.gaps.values()) == pytest.approx(sum(plain.trace.gaps.values()))
    assert plain.trace.gaps[trace.ITEM] > spanned.trace.gaps.get(trace.ITEM, 0.0)
    assert spanned.trace.gaps["cinemri.serve"] > 0 and spanned.trace.gaps["cinemri.dc"] > 0


def test_a_trace_without_the_spans_reads_nothing():
    run = _fold(with_spans=False)
    for name in ("h2d_ms.serve", "dc_ms.serve", "dc_device_events.serve"):
        assert read_metric(name, run) is None
    assert read_metric("dc_ms.serve", Run(**{**run.__dict__, "kind": "train"})) is None
    assert read_metric("dc_ms.serve", Run(**{**run.__dict__, "trace": None})) is None

