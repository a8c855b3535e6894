"""Serving, one client in a closed loop.

Set-up makes a pool of ``pool`` volumes from the seed, their requests as
float32 host arrays (as a client sends them), the benchmark's weights and
the model bound through ``serve.bind_model``, and serves ``warmup`` requests.
In the window the client sends the pool's requests in turn to
``serve(...)`` and waits for each image as a host tensor; the window closes
when the last request sent before ``seconds`` completes. A share
``checked_share`` of the images, drawn from the seed (the first always), is
kept for the comparison with the reference's image of the same request; the
rest are dropped, as a server drops them.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from cinebench import reference as plain
from cinebench.harness import bench, check, program, volumes

RUN_KIND = "serve"
KEYS = ("pool", "warmup", "traced_items", "op_traced_items", "center_lines", "acceleration",
        "noise", "checked_share")


def _request(vol: dict, with_maps: bool) -> tuple:
    """A served request: float32 host arrays, as a client sends them."""
    parts = [vol["kspace"].real, vol["kspace"].imag, vol["mask"]]
    if with_maps:
        parts += [vol["maps"].real, vol["maps"].imag]
    return tuple(p.contiguous().cpu().numpy() for p in parts)


def setup(cell, seed: int, device: torch.device, phases):
    """``(pool, requests, weights, serve)``: the pool of volumes, their host
    requests, the weights and the bound model, warmed up on the requests."""
    cfg, traffic = cell.config, cell.traffic
    pool = volumes.make_volumes(seed, traffic["pool"], bench.volume_shape(cfg), traffic, device)
    requests = [_request(v, cfg["maps_in_request"]) for v in pool]
    phases.mark("inputs")
    model, weights = bench.build_model(cell, seed, device)
    serve = program.bind(model, device)
    phases.mark("model")
    for i in range(traffic["warmup"]):
        serve(*requests[i % len(requests)]).cpu()
    phases.mark("warmup")
    return pool, requests, weights, serve


def reference(cell, weights: dict, pool: List[dict]) -> List[torch.Tensor]:
    """The reference's image of each pool volume, on the host."""
    maps = cell.config["maps_in_request"]
    with torch.no_grad():
        return [plain.forward(cell.config, weights, v["kspace"], v["mask"],
                              v["maps"] if maps else None).float().cpu() for v in pool]


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, phases) -> dict:
    pool, requests, weights, serve = setup(cell, seed, device, phases)
    setup_peak = bench.window_start(device, trace, phases)
    outputs = []
    sample = np.random.default_rng([seed % 2 ** 64, 2])
    share = cell.traffic["checked_share"]

    def item(i):
        k = i % len(requests)
        t0 = time.perf_counter()
        out = serve(*requests[k])
        t1 = time.perf_counter()
        image = out.cpu()
        t2 = time.perf_counter()
        if i == 0 or sample.random() < share:
            outputs.append((k, image))
        return {"t0": t0, "t1": t1, "t2": t2}

    out = bench.window(item, seconds, trace, cell.traffic, device)
    out["window_s"] = out["items"][-1]["t2"] - out["w0"]
    out["peak_window"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del serve
    bench.free(device)
    out["values"] = check.image_gaps(outputs, reference(cell, weights, pool))
    out["peak"] = max(setup_peak, out["peak_window"])
    return out


def readings(cell, seed: int, device: torch.device, f64: bool) -> dict:
    """The control's readings of one seed (``control.py``): the program's
    image of each pool request after the warm-up, and the reference with
    TF32 in the program's place, each against the float32 reference; with
    ``f64`` both against the reference in float64 too."""
    pool, requests, weights, serve = setup(cell, seed, device, bench.Phases(time.perf_counter()))
    images = [(k, serve(*r).cpu()) for k, r in enumerate(requests)]
    del serve
    bench.free(device)
    ref = reference(cell, weights, pool)
    out = {"program": check.image_gaps(images, ref)}
    plain.tf32()
    try:
        control = reference(cell, weights, pool)
    finally:
        plain.full_f32()
    out["control"] = check.image_gaps(list(enumerate(control)), ref)
    if f64:
        w64, pool64 = bench.to_double(weights, pool)
        ref64 = [r.float() for r in reference(cell, w64, pool64)]
        out["program_vs_f64"] = check.image_gaps(images, ref64)
        out["reference_vs_f64"] = check.image_gaps(list(enumerate(ref)), ref64)
    del pool
    bench.free(device)
    return out
