"""Window statistics and the metric readers on synthetic timings."""

import statistics

import pytest

from cinebench.harness import stats
from cinebench.harness.bench import Run, read_metric


def _run(kind, latencies, window_s, enqueue=None, traced=0):
    t, items = 0.0, []
    for i, lat in enumerate(latencies):
        items.append({"t0": t, "t1": t + (enqueue or lat / 2), "t2": t + lat, "traced": i < traced})
        t += lat
    return Run(kind=kind, setup_s=12.5, window_s=window_s, items=items,
               peak_window_bytes=3 * 2 ** 30, item_flop=1e12, peak_flops=67e12, peak_bw=3.35e12)


def test_p90_is_over_all_requests():
    lat = [0.1] * 90 + [0.5] * 10  # 100 requests, the slowest tenth at 500 ms
    assert stats.percentile(lat, 90) == pytest.approx(0.1 + 0.1 * (0.5 - 0.1))
    assert read_metric("volume_ms_p90", _run("serve", lat, 14.0)) == \
        pytest.approx(1e3 * statistics.quantiles(lat, n=100, method="inclusive")[89])


def test_rate_is_work_over_the_whole_window():
    run = _run("serve", [0.25] * 120, 30.5)
    assert read_metric("volumes_per_s", run) == pytest.approx(120 / 30.5)


def test_train_step_ms_is_the_window_over_the_steps():
    run = _run("train", [0.9] * 34, 30.6)
    assert read_metric("train_step_ms", run) == pytest.approx(1e3 * 30.6 / 34)
    assert read_metric("volumes_per_s", run) is None  # another kind's metric


def test_enqueue_is_the_median_of_untraced_items():
    run = _run("serve", [0.2] * 10, 2.0, enqueue=0.05, traced=4)
    run.items[0]["t1"] = 10.0  # a traced item is left out
    assert read_metric("enqueue_ms.serve", run) == pytest.approx(50.0)
    assert read_metric("enqueue_ms.train", run) is None


def test_setup_and_memory():
    run = _run("train", [1.0], 1.0)
    assert read_metric("setup_s", run) == 12.5
    assert read_metric("peak_mem_gib", run) == 3.0


def test_trace_metrics_need_a_trace():
    run = _run("serve", [0.2] * 4, 0.8)
    for name in ("conv_ms.serve", "idle_pct.serve", "mfu.serve", "normal_apply_roofline.serve"):
        assert read_metric(name, run) is None
