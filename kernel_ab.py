#!/usr/bin/env python3
"""Times the port's CUDA kernels of two checkouts on one NVIDIA GPU, in turns.

    python3 kernel_ab.py OTHER_ROOT [--out FILE]

``OTHER_ROOT`` is another checkout of the repository (for example the
parent commit unpacked by ``git archive`` into a git-ignored directory).
Both checkouts' ``cinemri_tpu_torch`` packages are imported in one process,
their kernels built from their own ``csrc`` (each into its own ``_build``),
and every kernel is timed on the same inputs at the flagship shapes of
``chip_smoke.py``, device alone (CUDA graphs of 20 calls,
``chip_smoke.graph_ms``), in the order other, this, this, other, and the
host's time to issue one call (wrapper and launches, 20 calls after a
synchronize, the device running behind), in the same turns. Kernels:
the normal apply and its backward at ``chip_smoke.py``'s four cases, the
DFT at its eight ``(O, N, I)`` layouts and ``fft2_plane`` at its four
shapes. Each result is checked against this checkout's plain version at
``chip_smoke.py``'s tolerances, and the two checkouts' results against each
other (max |this - other|, 0 where both compute the same bits). Then the entries the models call,
``dft_cuda.ComplexDFTMatmul.apply`` at (1, 15, 40000) and
``normal_cuda.NormalApply.apply`` at the flagship shape (autograd Functions
or custom ops, with the wrappers and kernels behind them), the host's time
per call in the same turns. Then the full-width CineNet-XF and VarNet-XF
forwards and train steps run through either checkout's entries, in the
same turns (the rest of the path is this checkout's), with the largest
difference between the two checkouts' forward outputs.

Prints one ``[ab]`` line per shape and, last, the card's nvidia-smi line and
one JSON object with every time; ``--out`` also writes that object to a
file. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402  (this checkout's harness)

HOST_CALLS = 20  # calls per turn of the host-time measurement
E2E_FORWARDS, E2E_STEPS = 12, 5  # per turn of the end-to-end runs


def load_port(root: Path):
    """The kernel wrappers of the ``cinemri_tpu_torch`` package under ``root``,
    built; the package is imported afresh from there."""
    for name in [m for m in sys.modules if m == "cinemri_tpu_torch" or m.startswith("cinemri_tpu_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        mods = {m: importlib.import_module(f"cinemri_tpu_torch.ops.kernels.{m}")
                for m in ("_build", "dft_cuda", "fft2_cuda", "normal_cuda")}
    finally:
        sys.path.remove(str(root))
    if not Path(mods["_build"].__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {mods['_build'].__file__}, not the package under {root}")
    mods["_build"].build()
    dft_entry, normal_entry = mods["dft_cuda"].ComplexDFTMatmul, mods["normal_cuda"].NormalApply
    if "precision" not in inspect.signature(normal_entry.apply).parameters:
        # a checkout from before the precision modes: its entries take no
        # precision argument and compute 'highest'
        dft_entry, normal_entry = _AtHighest(dft_entry, 7), _AtHighest(normal_entry, 8)
    return dict(normal_apply=mods["normal_cuda"].normal_apply,
                normal_apply_bwd=mods["normal_cuda"].normal_apply_bwd,
                complex_dft_matmul=mods["dft_cuda"].complex_dft_matmul,
                fft2_plane=mods["fft2_cuda"].fft2_plane,
                ComplexDFTMatmul=dft_entry, NormalApply=normal_entry)


class _AtHighest:
    """An entry (``ComplexDFTMatmul`` or ``NormalApply``) of a checkout that
    predates the precision argument, called as this checkout's ``ops/fft.py``
    and ``physics/operators.py`` call theirs: a trailing ``'highest'`` is
    dropped, another precision refused."""

    def __init__(self, entry, nargs: int):
        self.entry, self.nargs = entry, nargs

    def apply(self, *args):
        if args[self.nargs:] not in ((), ("highest",)):
            raise ValueError(f"this checkout's entries compute 'highest' only, got {args[self.nargs:]}")
        return self.entry.apply(*args[:self.nargs])


def end_to_end(torch, dev, ports, dft_cuda, normal_cuda):
    """The full-width CineNet-XF and VarNet-XF forwards and train steps of
    ``chip_smoke.py`` (this checkout's models, random weights from seed 0)
    through either checkout's DFT and normal-apply entries
    (``ComplexDFTMatmul``, ``NormalApply``) and the kernels behind them, in
    turns other, this, this, other: per turn, after one warm call, the
    median of E2E_FORWARDS forwards or E2E_STEPS steps (device ms and the
    host's ms to issue each) and the cudaMallocs of the caching allocator
    among them."""
    from cinemri_tpu_torch.data.masks import RandomMask
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops.cplx import Complex
    from cinemri_tpu_torch.train import create_train_state, make_train_step

    def forward_of(family, config, *inputs):
        model = build_model(family, "XF", device=dev, generator=torch.Generator().manual_seed(0),
                            **config).eval()

        def forward():
            with torch.inference_mode():
                return model(*inputs)
        return forward

    kre, kim, mask = CS.flagship_inputs(torch, RandomMask([10], [4]), 0, dev)
    runs = {"cinenet forward": forward_of("cinenet", CS.CINENET, Complex(kre, kim), mask,
                                          Complex(*CS.rss_maps(torch, 0, dev))),
            "varnet forward": forward_of("varnet", CS.FLAGSHIP, Complex(kre, kim), mask)}
    step = make_train_step()

    def train_step_of(family, config):
        state = create_train_state(build_model(family, "XF", device=dev,
                                               generator=torch.Generator().manual_seed(0),
                                               **config), device=dev)
        batch = CS.train_batch(torch, dev, sens_maps=family == "cinenet")

        def train_step():
            nonlocal state
            state, _ = step(state, batch)
        return train_step

    runs["cinenet train step"] = train_step_of("cinenet", CS.CINENET)
    runs["varnet train step"] = train_step_of("varnet", CS.FLAGSHIP)

    def timed(fn):
        """(device ms between CUDA events, host ms to issue the work) of one
        call started on an idle device: host ms near device ms means the
        host sets the pace."""
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        host = (time.perf_counter() - t0) * 1e3
        e1.synchronize()
        return e0.elapsed_time(e1), host

    saved = dft_cuda.ComplexDFTMatmul, normal_cuda.NormalApply
    out = {}
    try:
        for label, fn in runs.items():
            n = E2E_STEPS if "train" in label else E2E_FORWARDS
            rec = {key: {"other": [], "this": []} for key in ("ms", "host_ms", "cuda_mallocs")}
            first = {}
            for side in ("other", "this", "this", "other"):
                dft_cuda.ComplexDFTMatmul = ports[side]["ComplexDFTMatmul"]
                normal_cuda.NormalApply = ports[side]["NormalApply"]
                result = fn()  # warm
                if result is not None:
                    first.setdefault(side, result)
                segments = torch.cuda.memory_stats()["segment.all.allocated"]
                ms, host = zip(*(timed(fn) for _ in range(n)))
                rec["ms"][side].append(statistics.median(ms))
                rec["host_ms"][side].append(statistics.median(host))
                rec["cuda_mallocs"][side].append(torch.cuda.memory_stats()["segment.all.allocated"] - segments)
            if first:
                rec["max_abs_diff_vs_other"] = (first["this"] - first["other"]).abs().max().item()
            del first
            out[label] = rec
            print(f"[ab] {label} (median of {n}): ms other {rec['ms']['other']} this {rec['ms']['this']}; "
                  f"host ms to issue it other {rec['host_ms']['other']} this {rec['host_ms']['this']}; "
                  f"cudaMallocs other {rec['cuda_mallocs']['other']} this {rec['cuda_mallocs']['this']}"
                  + (f"; output max |this - other| {rec['max_abs_diff_vs_other']:.3e}"
                     if "max_abs_diff_vs_other" in rec else ""))
    finally:
        dft_cuda.ComplexDFTMatmul, normal_cuda.NormalApply = saved
    return out


def entries(torch, dev, ports, randn):
    """The host's time per call (µs, HOST_CALLS calls after a synchronize,
    the device running behind) of each checkout's entries as the models call
    them, in turns other, this, this, other: the DFT at (1, 15, 40000) with
    and without autograd recording, and the normal apply at the flagship
    shape with λ = 0.0."""
    from cinemri_tpu_torch.data.masks import RandomMask
    from cinemri_tpu_torch.ops import fft as FFT
    from cinemri_tpu_torch.physics import operators as OPS

    T, C, H, W = CS.T, CS.C, CS.H, CS.W
    mats = FFT._dft_tensors(T, False, False, "ortho", dev) + FFT._dft_adjoint_tensors(
        T, False, False, "ortho", dev)
    xr, xi = randn(1, T, H * W), randn(1, T, H * W)
    xg = xr.clone().requires_grad_()
    kern = OPS.masked_normal_kernel(torch.from_numpy(RandomMask([10], [4])(T, H, seed=1)[None]).to(dev))
    n_args = (randn(1, T, H, W), randn(1, T, H, W), kern.re.contiguous(), kern.im.contiguous(),
              randn(1, C, H, W), randn(1, C, H, W), 0.0, False)
    calls = {"ComplexDFTMatmul.apply (1, 15, 40000)":
             lambda p: p["ComplexDFTMatmul"].apply(xr, xi, *mats, False),
             "ComplexDFTMatmul.apply (1, 15, 40000), autograd recording":
             lambda p: p["ComplexDFTMatmul"].apply(xg, xi, *mats, False),
             "NormalApply.apply b=1 kt=15 lam=0.0": lambda p: p["NormalApply"].apply(*n_args)}
    out = {}
    for label, call in calls.items():
        host = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            call(ports[side])  # untimed: allocations cached
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                call(ports[side])
            host[side].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()
        mean = {k: statistics.mean(v) for k, v in host.items()}
        out[label] = dict(host_us=host, mean_host_us=mean)
        print(f"[ab] entry {label}: host per call µs other {mean['other']:.1f} ({host['other']}) "
              f"this {mean['this']:.1f} ({host['this']})")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 everywhere, as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = CS.nvidia_smi_line()
    print(f"[ab] {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    ports = {"other": load_port(args.other), "this": load_port(ROOT)}
    # plain versions, masks and DFT matrices from this checkout
    from cinemri_tpu_torch.data.masks import EquispacedMask, RandomMask
    from cinemri_tpu_torch.ops import fft as FFT
    from cinemri_tpu_torch.ops.kernels import dft_cuda, fft2_cuda, normal_cuda
    from cinemri_tpu_torch.physics import operators as OPS

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    T, C, H, W = CS.T, CS.C, CS.H, CS.W
    cases = []  # (label, kernel name, args, plain, tolerance)
    lam_dev = torch.tensor(0.37, device=dev)
    for b, kt, seed, lam in ((1, T, 1, 0.0), (1, 1, 2, 0.37), (2, T, 3, 0.0), (1, T, 4, lam_dev)):
        mask_func = RandomMask([10], [4]) if kt > 1 else EquispacedMask([0.08], [4])
        masks = np.stack([mask_func(T, H, seed=seed + i) for i in range(b)])
        kern = OPS.masked_normal_kernel(torch.from_numpy(masks).to(dev))
        sr, si = randn(b, C, H, W), randn(b, C, H, W)
        rss = torch.sqrt((sr * sr + si * si).sum(1, keepdim=True))
        xr, xi = randn(b, T, H, W), randn(b, T, H, W)
        ops = (kern.re.contiguous(), kern.im.contiguous(), sr / rss, si / rss)
        label = f"b={b} kt={kt} lam={'device tensor' if torch.is_tensor(lam) else lam}"
        fwd_lam = lam if torch.is_tensor(lam) else 0.0
        cases.append((f"normal_apply {label}", "normal_apply", (xr, xi) + ops + (fwd_lam,),
                      normal_cuda.normal_apply_torch, CS.NORMAL_TOL))
        cases.append((f"normal_apply_bwd {label}", "normal_apply_bwd",
                      (xr, xi, xr + randn(b, T, H, W), xi + randn(b, T, H, W)) + ops + (lam,),
                      normal_cuda.normal_apply_bwd_torch, CS.NORMAL_TOL))
    for o, n, i in ((C, H, W), (C * H, W, 1), (T * C, H, W), (T * C * H, W, 1),
                    (1, T, H * W), (H * W, T, 1), (37, 64, 1), (3, 24, 7)):
        wr, wi = FFT._dft_tensors(n, False, False, "ortho", dev)
        cases.append((f"complex_dft_matmul {(o, n, i)}", "complex_dft_matmul",
                      (randn(o, n, i), randn(o, n, i), wr, wi), dft_cuda.complex_dft_matmul_torch,
                      CS.DFT_TOL))
    for (b, h, w), inverse in (((T * C, H, W), True), ((C, H, W), True), ((3, 32, 32), False),
                               ((4, 24, 20), None)):
        mats = (tuple(randn(n, n) / math.sqrt(n) for n in (h, h, w, w)) if inverse is None
                else FFT._dft_tensors(h, inverse, False, "ortho", dev)
                + FFT._dft_tensors(w, inverse, False, "ortho", dev))
        cases.append((f"fft2_plane {(b, h, w)}", "fft2_plane", (randn(b, h, w), randn(b, h, w)) + mats,
                      fft2_cuda.fft2_plane_torch, CS.DFT_TOL))

    results = []
    for label, kernel, call_args, plain, tol in cases:
        want = plain(*call_args)
        errs, outs = {}, {}
        for side, port in ports.items():
            outs[side] = got = port[kernel](*call_args)
            torch.cuda.synchronize()
            errs[side] = max((a - b_).abs().max().item() / b_.abs().max().clamp_min(1e-30).item()
                             for a, b_ in zip(got, want))
            if not errs[side] <= tol:
                CS.fail(f"{side} {label}: relative error {errs[side]} > {tol}")
        vs_other = max((a - b_).abs().max().item() for a, b_ in zip(outs["this"], outs["other"]))
        del outs
        times = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            fn = ports[side][kernel]
            times[side].append(CS.graph_ms(torch, lambda: fn(*call_args)))
        mean = {k: statistics.mean(v) for k, v in times.items()}
        # the host's time to issue one call (wrapper, checks, launches):
        # launches are asynchronous, so the host waits on nothing while the
        # launch queue has room
        host = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            fn = ports[side][kernel]
            fn(*call_args)  # untimed: allocations cached
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn(*call_args)
            host[side].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
        host_us = {k: statistics.mean(v) for k, v in host.items()}
        results.append(dict(case=label, device_ms=times, mean_device_ms=mean, host_us=host,
                            mean_host_us=host_us, max_rel_err=errs, max_abs_diff_vs_other=vs_other))
        print(f"[ab] {label}: device alone ms other {mean['other']:.4f} "
              f"({', '.join(f'{x:.4f}' for x in times['other'])}) this {mean['this']:.4f} "
              f"({', '.join(f'{x:.4f}' for x in times['this'])}); this/other "
              f"{mean['this'] / mean['other']:.3f}; host per call µs other {host_us['other']:.1f} "
              f"this {host_us['this']:.1f}; rel err other {errs['other']:.2e} this "
              f"{errs['this']:.2e}; max |this - other| {vs_other:.3e}")
        del want
    del cases
    torch.cuda.empty_cache()
    report = dict(device=smi, other=str(args.other), results=results,
                  entries=entries(torch, dev, ports, randn),
                  end_to_end=end_to_end(torch, dev, ports, dft_cuda, normal_cuda))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print(smi)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
