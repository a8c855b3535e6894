"""One run of one cell: set-up, the measured window, the comparison with the
reference, and the metrics the manifest asks of the cell.

The cell names a configuration (``configs/<config>.json``, its sizes and
precision) and a traffic mix (``traffic/<mix>.json``, parameters only); the
mix's ``kind`` names its traffic loop, ``loops/<kind>.py``, which holds the
loop's set-up, window and reference. The cell's limits are
``limits/<cell>.json``; each metric is read by ``metrics/<metric>.py``. A
configuration or a mix that holds a key nothing reads, or a precision the
run does not run, is refused when the cell is loaded.

This module holds what every loop shares: the window (:func:`window`), which
runs one item after another until ``seconds`` have passed, with ``trace``
the first ``traced_items`` under the device profiler and the next
``op_traced_items`` under the op profiler (:mod:`.trace`); the set-up's
phases, the first of which builds the program's kernels; and
:func:`run_cell`, which runs the loop, judges its readings, and reads the
metrics. The reference runs once the window has closed, the memory peak is
read and the program's state is freed.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import torch

from cinebench.harness import check, flops, host, program, trace as tracing
from cinebench.harness.weights import draw_weights

__all__ = ["BENCH", "ROOT", "CONFIG_KEYS", "PRECISION", "Cell", "Run", "Phases", "load_cell",
           "loop", "read_metric", "sync", "volume_shape", "build_model", "window_start", "window",
           "free", "to_double", "run_cell"]

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# the keys a configuration may hold: documentation, and what the program
# adapter, the volumes and the reference read
CONFIG_KEYS = {"name", "source", "source_detail", "assumed", "family", "dynamic_type", "model",
               "maps_in_request", "frames", "coils", "height", "width", "dft_precision",
               "activations", "tf32", "param_centers"}
# the precision every run runs (float32 activations, TF32 off): a
# configuration states it and may state no other
PRECISION = {"activations": "float32", "tf32": False}


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclass
class Run:
    """What a metric reader reads: the window's items (host clock), the
    memory peak, the set-up time and, in a traced run, the trace."""

    kind: str
    setup_s: float
    window_s: float
    items: List[dict]
    peak_window_bytes: int
    item_flop: float
    peak_flops: float
    peak_bw: float
    trace: Optional[tracing.Trace] = None


def loop(kind: str):
    """The traffic loop ``loops/<kind>.py``: ``RUN_KIND`` (``serve`` or
    ``train``), ``KEYS`` (the traffic keys it reads), ``setup``,
    ``reference``, ``run`` and ``readings`` (the control's)."""
    if not (BENCH / "loops" / f"{kind}.py").is_file():
        raise SystemExit(f"cinebench: no traffic loop loops/{kind}.py")
    return importlib.import_module(f"cinebench.loops.{kind}")


def _refuse_unread(what: str, data: dict, known) -> None:
    unread = sorted(set(data) - set(known))
    if unread:
        raise SystemExit(f"cinebench: {what} holds keys nothing reads: {unread}")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"cinebench: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    _refuse_unread(entry["file"], config, CONFIG_KEYS)
    for key, value in PRECISION.items():
        if config.get(key) != value:
            raise SystemExit(f"cinebench: {entry['file']} states {key}={config.get(key)!r}; "
                             f"every run runs {key}={value!r}")
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    _refuse_unread(f"traffic/{cell['traffic']}.json", traffic, {"kind", *loop(traffic["kind"]).KEYS})
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())["limits"]
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, config, traffic, limits, e2e, per_layer)


def read_metric(name: str, run: Run) -> Optional[float]:
    """``metrics/<name>.py``'s ``read(run)``: a number, or None when the run
    holds nothing for it to read."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"cinebench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def volume_shape(cfg: dict) -> Dict[str, int]:
    return {"t": cfg["frames"], "c": cfg["coils"], "h": cfg["height"], "w": cfg["width"]}


def _profile_warmup(device: torch.device) -> None:
    """Start and stop each profiler once, so their own start-up is set-up."""
    for make in (tracing.device_profiler, tracing.op_profiler):
        prof = make()
        prof.start()
        torch.ones(1, device=device).add_(1)
        sync(device)
        prof.stop()


class Phases:
    """Host seconds of each set-up phase, in order (printed with the result)."""

    def __init__(self, t_start: float):
        self.last = t_start
        self.seconds: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now


def build_model(cell: Cell, seed: int, device: torch.device):
    """The program's model with the benchmark's weights, and those weights."""
    cfg = cell.config
    model = program.build(cfg, device)
    weights = draw_weights({n: tuple(p.shape) for n, p in model.named_parameters()}, seed,
                           cfg.get("param_centers", {}), device)
    model.load_state_dict(weights)
    return model, weights


def window_start(device: torch.device, trace: bool, phases: Phases) -> int:
    """Finish set-up (the profiler's own start-up included); returns the set-up's memory peak."""
    if trace:
        _profile_warmup(device)
    sync(device)
    phases.mark("profiler" if trace else "sync")
    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return peak


def window(item, seconds: float, trace: bool, traffic: dict, device: torch.device) -> dict:
    """Run ``item(i) -> {"t0", "t1", "t2"}`` for ``i = 0, 1, ...`` until
    ``seconds`` have passed; with ``trace``, the first ``traced_items`` under
    the device profiler and the next ``op_traced_items`` under the op
    profiler, each span opened and closed with the queue drained."""
    n_dev = traffic["traced_items"] if trace else 0
    n_op = traffic["op_traced_items"] if trace else 0
    marker = torch.zeros(1, device=device)
    items, profs = [], {}
    before = host.snapshot()
    w0 = time.perf_counter()
    deadline = w0 + seconds
    i = 0
    while time.perf_counter() < deadline or i < n_dev + n_op:
        if i == 0 and n_dev:
            sync(device)
            profs["device"] = tracing.device_profiler()
            profs["device"].start()
            marker.add_(1)
        if i == n_dev and n_op:
            if n_dev:
                sync(device)
                marker.add_(1)
                sync(device)
                profs["device"].stop()
            profs["op"] = tracing.op_profiler()
            profs["op"].start()
        traced = i < n_dev + n_op
        span = torch.profiler.record_function(tracing.ITEM) if n_dev <= i < n_dev + n_op \
            else contextlib.nullcontext()
        with span:
            times = item(i)
        if traced and i == n_dev + n_op - 1:
            sync(device)
            profs["op"].stop()
        items.append({**times, "traced": traced})
        i += 1
    return {"items": items, "w0": w0, "profs": profs, "host": (before, host.snapshot())}


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def to_double(weights: dict, pool: list) -> tuple:
    """The weights and the volumes in float64 / complex128 (the control's witness)."""
    w64 = {n: v.double() for n, v in weights.items()}
    pool64 = [{k: v.to(torch.complex128) if v.is_complex() else v.double() for k, v in vol.items()}
              for vol in pool]
    return w64, pool64


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: torch.device, device_info: dict) -> dict:
    """One run; returns the result line's object (``compared`` last)."""
    from cinebench import reference

    reference.full_f32()
    traffic_loop = loop(cell.traffic["kind"])
    phases = Phases(t_start)
    phases.mark("start")
    built = program.build_kernels() if device.type == "cuda" else []
    phases.mark("build")
    out = traffic_loop.run(cell, seed, seconds, trace, device, phases)
    ok, lines = check.judge(out["values"], cell.limits)
    peak_flops, peak_bw = device_info["peaks"]
    run_kind = traffic_loop.RUN_KIND
    run = Run(kind=run_kind, setup_s=out["w0"] - t_start,
              window_s=out["window_s"], items=out["items"], peak_window_bytes=out["peak_window"],
              item_flop=flops.item_flop(cell.config, run_kind), peak_flops=peak_flops,
              peak_bw=peak_bw)
    device_out = {"platform": device_info["platform"], "kind": device_info["kind"],
                  "count": device_info["count"], "memory_peak_bytes": out["peak"],
                  "power_limit": device_info["power_limit"]}
    result = {"correct": ok, "attempted": len(out["items"]), "failed": 0}
    if trace:
        profs = out["profs"]
        run.trace = tracing.fold(profs["device"], cell.traffic["traced_items"], profs["op"],
                                 flops.cost_ops())
        device_out.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result.update(metrics=metrics, device=device_out)
    if trace:
        result["breakdown"] = run.trace.breakdown()
        result["item_ms"] = _item_ms(out["items"], cell.traffic)
        result["device_ms_by_kind"] = run.trace.ms_by_kind()
    # a run that built a kernel library is a checkout's first: its set-up
    # holds the nvcc build ("build"), which later runs find in the cache
    result["setup_phases_s"] = {**phases.seconds, "built": built}
    result["host"] = host.window_summary(out["host"])
    result["compared"] = {x["name"]: {"value": x["value"], "limit": x["limit"]} for x in lines}
    return result


def _item_ms(items: List[dict], traffic: dict) -> dict:
    """Mean ms an item of each span of a traced run: what the tracing costs."""
    n_dev, n_op = traffic["traced_items"], traffic["op_traced_items"]
    spans = {"device_trace": items[:n_dev], "op_trace": items[n_dev:n_op + n_dev],
             "untraced": items[n_dev + n_op:]}
    return {k: 1e3 * sum(x["t2"] - x["t0"] for x in v) / len(v) for k, v in spans.items() if v}
