"""Training, batch 1, steps back to back.

Set-up makes a pool of ``pool`` volumes from the seed as device batches of
``make_train_step``'s format, builds the train state (``create_train_state``
with ``lr``, ``lr_step_size``, ``lr_gamma``, ``steps_per_epoch``) on the
benchmark's weights, and drives it through ``checked_steps`` steps with the
window's own step and feed: the steps the reference follows. The window then
runs steps on the pool's batches back to back and closes at the synchronize
after the last step enqueued before ``seconds``. In a traced run each step
after the traced ones is synchronized, so that its host enqueue time is read
from an empty queue.
"""

from __future__ import annotations

import statistics
import time
from typing import List

import torch

from cinebench import reference as plain
from cinebench.harness import bench, check, program, volumes

RUN_KIND = "train"
KEYS = ("pool", "checked_steps", "traced_items", "op_traced_items", "center_lines",
        "acceleration", "noise", "lr", "lr_step_size", "lr_gamma", "steps_per_epoch")
BETA1 = 0.9  # Adam's first-moment decay: its state after one step is 0.1 x the gradient


def setup(cell, seed: int, device: torch.device, phases):
    """``(pool, batches, weights, state, step, readings)``: the train state
    driven through the traffic's checked steps by the window's own step and
    feed, and the readings the reference is held to: each step's loss, each
    parameter's first gradient as Adam got it (its first moment after one
    step over 1 − β1) and its change over the checked steps."""
    cfg, traffic = cell.config, cell.traffic
    pool = volumes.make_volumes(seed, traffic["pool"], bench.volume_shape(cfg), traffic, device)
    batches = [program.train_batch(v, cfg["maps_in_request"]) for v in pool]
    phases.mark("inputs")
    model, weights = bench.build_model(cell, seed, device)
    state, step = program.train_state(model, traffic, device)
    phases.mark("model")
    losses, grad_norms = [], {}
    for j in range(traffic["checked_steps"]):
        state, aux = step(state, batches[j % len(batches)])
        losses.append(aux["loss"].detach())
        if j == 0:
            grad_norms = {n: (m / (1 - BETA1)).norm() for n, m in program.first_moments(state).items()}
    params = dict(state.model.named_parameters())
    readings = {"losses": [float(x) for x in losses],
                "grad_norms": {n: float(g) for n, g in grad_norms.items()},
                "change_norms": {n: float((params[n].detach() - weights[n]).norm()) for n in weights}}
    phases.mark("warmup")
    return pool, batches, weights, state, step, readings


def reference(cell, weights: dict, pool: List[dict]) -> dict:
    """The reference's readings over the checked steps, on the same volumes."""
    maps = cell.config["maps_in_request"]
    n = cell.traffic["checked_steps"]
    batches = [{"kspace": v["kspace"], "mask": v["mask"], "target": v["target"],
                "maps": v["maps"] if maps else None} for v in (pool[j % len(pool)] for j in range(n))]
    return plain.train_steps(cell.config, weights, batches, cell.traffic)


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, phases) -> dict:
    pool, batches, weights, state, step, prog = setup(cell, seed, device, phases)
    setup_peak = bench.window_start(device, trace, phases)
    checked = cell.traffic["checked_steps"]
    box = {"state": state}
    del state

    def item(i):
        t0 = time.perf_counter()
        box["state"], _ = step(box["state"], batches[(checked + i) % len(batches)])
        t1 = time.perf_counter()
        if trace:
            bench.sync(device)
        return {"t0": t0, "t1": t1, "t2": time.perf_counter()}

    out = bench.window(item, seconds, trace, cell.traffic, device)
    bench.sync(device)
    out["window_s"] = time.perf_counter() - out["w0"]
    out["peak_window"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del box, step, batches
    bench.free(device)
    out["values"] = check.train_gaps(prog, reference(cell, weights, pool))
    out["peak"] = max(setup_peak, out["peak_window"])
    return out


def readings(cell, seed: int, device: torch.device, f64: bool) -> dict:
    """The control's readings of one seed (``control.py``): the program's
    checked steps; the reference with TF32 in the program's place; and the
    fault "state unchanged", planted in the reference (learning rate 0);
    each against the float32 reference, with the three parameters of the
    widest gaps. With ``f64`` the program and the float32 reference against
    the reference in float64 too."""
    pool, batches, weights, state, step, prog = setup(cell, seed, device,
                                                      bench.Phases(time.perf_counter()))
    del state, step, batches
    bench.free(device)
    ref = reference(cell, weights, pool)
    out = {"program": check.train_gaps(prog, ref)}
    plain.tf32()
    try:
        control = reference(cell, weights, pool)
    finally:
        plain.full_f32()
    out["control"] = check.train_gaps(control, ref)
    still = bench.Cell(**{**cell.__dict__, "traffic": {**cell.traffic, "lr": 0.0}})
    out["fault_state_unchanged"] = check.train_gaps(reference(still, weights, pool), ref)
    out["detail"] = {"program": _detail(prog, ref), "control": _detail(control, ref)}
    if f64:
        w64, pool64 = bench.to_double(weights, pool)
        ref64 = reference(cell, w64, pool64)
        out["program_vs_f64"] = check.train_gaps(prog, ref64)
        out["reference_vs_f64"] = check.train_gaps(ref, ref64)
    del pool
    bench.free(device)
    return out


def _detail(got: dict, want: dict) -> dict:
    """Per-step loss gaps and the three parameters with the widest norm gaps."""
    def worst(key):
        floor = statistics.median(want[key].values())
        gaps = {n: abs(got[key].get(n, 0.0) - w) / max(w, floor) for n, w in want[key].items()}
        top = sorted(gaps, key=gaps.get, reverse=True)[:3]
        return [[n, gaps[n], got[key].get(n, 0.0), want[key][n], floor] for n in top]

    median = statistics.median(want["grad_norms"].values())
    still = [n for n, g in want["grad_norms"].items() if g < check.GRAD_FLOOR * median]
    return {"loss_gaps": [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])],
            "grad": worst("grad_norms"), "change": worst("change_norms"), "excluded": still}
