#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``cinemri_tpu_torch/csrc`` with nvcc,
holds each kernel against its plain PyTorch version at the shapes of the
serving and training paths, runs the full-width VarNet-XF forward (10
cascades, chans 16, pools 3, sens net 8/3) on a 15-frame x 10-coil x
200x200 volume through the kernels and through the plain versions, profiles
one forward, and answers four requests through ``cinemri_tpu_torch.serve``
three times: through the kernels, through the plain versions and through
one library call each. Then it trains: four steps of
``cinemri_tpu_torch.train`` (SSIM loss, Adam 1e-4, cascade remat) on one
such volume, twice through the plain versions (their run-to-run gap), once
through one library call each and once through the kernels, from the same
initial weights; it profiles one train step and times steps without remat.
It checks that each kernel run launched every kernel as many times as the
path calls it and that the runs agree. Any failure ends the run with a
non-zero exit code.

Output, last three lines: one JSON object with a row per kernel and run
(``"serve"`` or ``"train"``), the card's name and power limit as nvidia-smi
reports them, and ``{"ok": true, "device": {...}}``. A row's ``ms``,
``plain_ms`` and ``library_ms`` sum CUDA-event times taken around every
call of that function in its run (the four serve requests, or the four
train steps); ``bound_ms`` sums the bound of each call of the kernel run.
The line before them, ``[details] {...}``, holds the per-shape
microbenchmarks and every other number.

Imports nothing of JAX. Exits non-zero without a CUDA device, or when the
``cinemri_tpu_torch`` package is not beside this file.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Published peaks (NVIDIA data sheets): FP32 outside the tensor cores, TFLOP/s,
# and device memory, TB/s. Matched against torch.cuda.get_device_name(0).
PEAKS = (
    ("H100 NVL", 60.0, 3.9),
    ("H100 PCIe", 51.0, 2.0),
    ("H100", 67.0, 3.35),  # SXM
)

FLAGSHIP = dict(num_cascades=10, sens_chans=8, sens_pools=3, chans=16, pools=3)
T, C, H, W = 15, 10, 200, 200

# Tolerances, relative to the largest magnitude of the plain result. Both
# sides are f32 with FMA and no TF32; they differ only in summation order
# (N = 200 terms for the DFT, c·h = 2000 for the normal apply).
DFT_TOL = 2e-5
NORMAL_TOL = 2e-5
# Whole forward, kernels vs plain versions: rounding differences pass
# through 10 cascades and 21 instance-normalized U-Nets.
MODEL_TOL = 1e-4
# λ̄ of the normal-apply backward, relative: a sum over b·t·h·w terms whose
# inputs are made correlated (g = x + noise) so that it does not cancel.
LAM_TOL = 1e-5
# Train runs over TRAIN_STEPS steps from the same weights, each against the
# plain versions' run: the largest relative difference of the per-step
# losses, and the relative L2 distance of the first step's gradients (all
# leaves). Two plain runs share a bit-identical forward and differ only by
# cuDNN's nondeterministic backward (2.3e-6 on the H100). Any other f32
# summation order in the forward moves the gradients far more, because a
# LeakyReLU input that is 0 up to rounding takes slope 1 or 0.2 by rounding:
# the library calls, an independent exact order, differ by 2.6e-3, the
# kernels by 2.7e-3. The tolerances sit above both gaps, and the script
# fails unless the plain-vs-plain and library-vs-plain gaps are inside them.
TRAIN_STEPS = 4
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def peaks(name: str):
    for key, tflops, tbs in PEAKS:
        if key in name:
            return tflops * 1e12, tbs * 1e12
    fail(f"no published FP32/memory peak known for {name!r}")


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` per call, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# (FLOP, bytes) of one call, from its inputs: the 4-multiplication complex
# product (8 FLOP per complex multiply-add); each input read once, each
# output written once.
def dft_cost(xr, xi, wr, wi):
    b, n = xr.shape
    return 8.0 * b * n * n, 4.0 * (4 * b * n + 2 * n * n)


def normal_cost(xr, xi, kr, ki, sr, si, lam):
    b, t, h, w = xr.shape
    c, kt = sr.shape[1], kr.shape[1]
    flops = 8.0 * b * t * c * h * h * w + 14.0 * b * t * c * h * w + (4.0 * b * t * h * w if lam else 0.0)
    return flops, 8.0 * (2 * b * t * h * w + b * kt * h * h + b * c * h * w)


def normal_bwd_cost(xr, xi, gr, gi, kr, ki, sr, si, lam):
    """Two h-contractions per coil (ȳ = Kᴴ(S⊙g) and the recomputed
    z = K(S⊙x)), the elementwise products around them (36 FLOP per
    (b,t,c,h,w) element), x̄ + λg and λ̄; reads x, g, K, S, writes x̄, s̄, λ̄."""
    b, t, h, w = xr.shape
    c, kt = sr.shape[1], kr.shape[1]
    flops = 16.0 * b * t * c * h * h * w + 36.0 * b * t * c * h * w + 8.0 * b * t * h * w
    return flops, 4.0 * (6 * b * t * h * w + 2 * b * kt * h * h + 4 * b * c * h * w + b * t)


def bound(cost, peak_flops: float, peak_bw: float):
    t_ops, t_bytes = cost[0] / peak_flops * 1e3, cost[1] / peak_bw * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# Library yardsticks: one PyTorch call on complex64 that computes the same
# function. Timed only; the port never calls them.
def dft_library(torch):
    def prep(xr, xi, wr, wi):
        return torch.complex(xr, xi), torch.complex(wr, wi).T

    return prep, torch.matmul


def normal_library(torch):
    def prep(xr, xi, kr, ki, sr, si, lam):
        b, t, h, _ = xr.shape
        s = torch.complex(sr, si)
        return torch.complex(xr, xi), torch.complex(kr, ki).expand(b, t, h, h), s, s.conj(), lam

    def call(x, k, s, sc, lam):
        out = torch.einsum("bckw,btkw,btik,bciw->btiw", s, x, k, sc)
        return out + lam * x if lam else out

    return prep, call


def normal_bwd_library(torch):
    """``torch.autograd.grad`` through the one-einsum complex64 forward of
    :func:`normal_library` (the forward included): no single PyTorch call
    computes this backward."""
    def prep(xr, xi, gr, gi, kr, ki, sr, si, lam):
        b, t, h, _ = xr.shape
        return (torch.complex(xr, xi), torch.complex(gr, gi),
                torch.complex(kr, ki).expand(b, t, h, h), torch.complex(sr, si),
                torch.tensor(float(lam), device=xr.device))

    def call(x, g, k, s, lam):
        with torch.enable_grad():
            x, s, lam = (a.detach().requires_grad_(True) for a in (x, s, lam))
            out = torch.einsum("bckw,btkw,btik,bciw->btiw", s, x, k, s.conj()) + lam * x
            xb, sb, lb = torch.autograd.grad(out, (x, s, lam), g)
        return xb.real, xb.imag, sb.real, sb.imag, lb

    return prep, call


class Timed:
    """Stands in for ``module.<attr>`` while entered: each call runs ``fn``
    between two CUDA events on the current stream and keeps the events and
    the call's (FLOP, bytes). ``prep`` (untimed, before) turns the pair
    arguments into ``fn``'s; a complex result is split back into a pair."""

    def __init__(self, torch, module, attr, cost, fn=None, prep=None):
        self.torch, self.module, self.attr, self.cost = torch, module, attr, cost
        self.fn, self.prep = fn or getattr(module, attr), prep
        self.calls = []

    def __enter__(self):
        self.saved = getattr(self.module, self.attr)
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.saved)

    def __call__(self, *args):
        work = self.cost(*args)
        inputs = self.prep(*args) if self.prep else args
        e0 = self.torch.cuda.Event(enable_timing=True)
        e1 = self.torch.cuda.Event(enable_timing=True)
        e0.record()
        out = self.fn(*inputs)
        e1.record()
        self.calls.append((e0, e1, work))
        if self.torch.is_tensor(out) and out.is_complex():
            out = (out.real.contiguous(), out.imag.contiguous())
        return out

    def ms(self) -> float:
        return sum(e0.elapsed_time(e1) for e0, e1, _ in self.calls)

    def bound(self, peak_flops: float, peak_bw: float):
        per_call = [bound(work, peak_flops, peak_bw) for _, _, work in self.calls]
        ops = sum(b for b, by in per_call if by == "operations")
        total = sum(b for b, _ in per_call)
        return total, "operations" if ops >= 0.5 * total else "bytes"


def flagship_inputs(torch, mask_func, seed: int, device):
    """One volume (1, 15, 10, 200, 200) from ``default_rng(seed)`` k-space
    under ``mask_func(15, 200, seed=seed)``, as the JAX package's entry
    point makes its flagship input."""
    rng = np.random.default_rng(seed)
    shape = (1, T, C, H, W)
    k = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    mask = mask_func(T, H, seed=seed)[None].astype(np.float32)  # (1, t|1, 1, h, 1)
    k = k * mask
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
    return as_t(k.real), as_t(k.imag), as_t(mask)


def train_batch(torch, device):
    """The JAX package's train-step batch (``bench/train_step.py``): k-space
    from ``default_rng(0)`` under ``RandomMask([10], [4])(15, 200, seed=0)``,
    target = |k| averaged over coils."""
    from cinemri_tpu_torch.data.masks import RandomMask
    from cinemri_tpu_torch.ops.cplx import Complex

    rng = np.random.default_rng(0)
    shape = (1, T, C, H, W)
    k = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    mask = RandomMask([10], [4])(T, H, seed=0)[None].astype(np.float32)
    km = k * mask
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
    return {"masked_kspace": Complex(as_t(km.real), as_t(km.imag)), "mask": as_t(mask),
            "target": as_t(np.abs(k).mean(axis=2))}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "cinemri_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: cinemri_tpu_torch/ not found beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    from torch.profiler import ProfilerActivity, profile

    from cinemri_tpu_torch.data.masks import EquispacedMask, RandomMask
    from cinemri_tpu_torch.instrument import opstats
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops import fft as FFT
    from cinemri_tpu_torch.ops.cplx import Complex
    from cinemri_tpu_torch.ops.kernels import _build, dft_cuda, normal_cuda
    from cinemri_tpu_torch.physics import operators as OPS
    from cinemri_tpu_torch.serve import bind_model
    from cinemri_tpu_torch.train import create_train_state, make_train_step

    dev = torch.device("cuda", 0)
    cases = []

    # -- 0. device --------------------------------------------------------------
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = peaks(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"[device] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}; peaks {peak_flops / 1e12} TFLOP/s FP32, "
          f"{peak_bw / 1e12} TB/s; opt_einsum {torch.backends.opt_einsum.is_available()}")

    # -- 1. build -----------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build(verbose=True)
    print(f"[build] {time.perf_counter() - t0:.2f} s for {sorted(built)} (one nvcc each, in parallel)")
    for kname, info in built.items():
        print(f"[build] {kname}: {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    def check_case(kernel, shape, args, fn, plain, library, cost, tol):
        """One kernel against its plain version and its library call on the
        same inputs; times each (mean of warm launches, L2-warm)."""
        got, want = fn(*args), plain(*args)
        prep, lib = library
        lib_in = prep(*args)
        lib_out = lib(*lib_in)
        torch.cuda.synchronize()
        err = max((got[0] - want[0]).abs().max().item(), (got[1] - want[1]).abs().max().item())
        lib_err = max((lib_out.real - want[0]).abs().max().item(),
                      (lib_out.imag - want[1]).abs().max().item())
        scale = max(want[0].abs().max().item(), want[1].abs().max().item())
        ms = cuda_ms(torch, lambda: fn(*args))
        plain_ms = cuda_ms(torch, lambda: plain(*args), iters=10)
        library_ms = cuda_ms(torch, lambda: lib(*lib_in), iters=10)
        b_ms, b_by = bound(cost(*args), peak_flops, peak_bw)
        case = dict(kernel=kernel, **shape, max_abs_err=err, max_rel_err=err / scale,
                    library_max_abs_err=lib_err, max_abs=scale, tol=tol * scale, ms=ms,
                    plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
        cases.append(case)
        print(f"[kernel] {kernel} {shape}: max_abs_err {err:.3e} rel {err / scale:.3e} "
              f"(tol {tol * scale:.3e}; library {lib_err:.3e}) kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms library {library_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})")
        if not err <= tol * scale:
            fail(f"{kernel} disagrees with its plain version at {shape}: {err} > {tol * scale}")
        if not lib_err <= tol * scale:
            fail(f"the library yardstick of {kernel} disagrees at {shape}: {lib_err} > {tol * scale}")

    def check_bwd_case(shape, args):
        """The normal-apply backward against its plain version and its
        library yardstick: x̄ and s̄ at NORMAL_TOL x max |plain|, λ̄ (summed
        over (b, t)) at LAM_TOL relative."""
        fn, plain = normal_cuda.normal_apply_bwd, normal_cuda.normal_apply_bwd_torch
        got, want = fn(*args), plain(*args)
        prep, lib = normal_bwd_library(torch)
        lib_in = prep(*args)
        lib_out = lib(*lib_in)
        torch.cuda.synchronize()
        lam_want = want[4].sum().item()
        errs = {}
        for label, out in (("kernel", got), ("library", lib_out)):
            for part, sl in (("xbar", slice(0, 2)), ("sbar", slice(2, 4))):
                scale = max(a.abs().max().item() for a in want[sl])
                err = max((a - b_).abs().max().item() for a, b_ in zip(out[sl], want[sl]))
                errs[f"{label}_{part}"] = (err, scale)
                if not err <= NORMAL_TOL * scale:
                    fail(f"normal_apply_bwd ({label}) {part} disagrees with the plain version at "
                         f"{shape}: {err} > {NORMAL_TOL * scale}")
            lam_err = abs(out[4].sum().item() - lam_want) / abs(lam_want)
            errs[f"{label}_lambar_rel"] = lam_err
            if not lam_err <= LAM_TOL:
                fail(f"normal_apply_bwd ({label}) λ̄ disagrees at {shape}: rel {lam_err} > {LAM_TOL}")
        ms = cuda_ms(torch, lambda: fn(*args))
        plain_ms = cuda_ms(torch, lambda: plain(*args), iters=10)
        library_ms = cuda_ms(torch, lambda: lib(*lib_in), iters=10)
        b_ms, b_by = bound(normal_bwd_cost(*args), peak_flops, peak_bw)
        err = max(errs["kernel_xbar"][0], errs["kernel_sbar"][0])
        case = dict(kernel="normal_apply_bwd", **shape, max_abs_err=err,
                    max_rel_err={k: v[0] / v[1] for k, v in errs.items() if isinstance(v, tuple)},
                    lambar_rel_err=errs["kernel_lambar_rel"],
                    library_lambar_rel_err=errs["library_lambar_rel"], ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
        cases.append(case)
        print(f"[kernel] normal_apply_bwd {shape}: rel err x̄ {case['max_rel_err']['kernel_xbar']:.3e} "
              f"s̄ {case['max_rel_err']['kernel_sbar']:.3e} λ̄ {errs['kernel_lambar_rel']:.3e} "
              f"(tol {NORMAL_TOL:.0e} x max, λ̄ {LAM_TOL:.0e}; library x̄ "
              f"{case['max_rel_err']['library_xbar']:.3e} s̄ {case['max_rel_err']['library_sbar']:.3e}) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library {library_ms:.4f} ms "
              f"bound {b_ms:.4f} ms ({b_by})")

    def profiled(fn):
        """One call of ``fn`` under the profiler: device time by kernel kind
        and the device's idle share of the host time."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        with tempfile.TemporaryDirectory() as tmp:
            prof.export_chrome_trace(str(Path(tmp) / "trace.json"))
            events = opstats.kernel_events(Path(tmp) / "trace.json")
        if not events:
            fail("the profiler recorded no device events")
        busy, window = opstats.busy_share(events)
        return dict(host_ms=host_ms, device_window_ms=window, device_busy_ms=busy,
                    idle_share_of_host_time=1 - busy / host_ms, n_events=len(events),
                    by_kind=opstats.fold_by_kind(events),
                    top_other=opstats.top_names(events, "other"))

    # -- 2. kernels against their plain versions ----------------------------------
    # the main path's shapes (sens-net ifft2c, x_ref ifft2c, temporal fft) and a ragged one
    for b, n in ((C * W, H), (T * C * W, H), (H * W, T), (37, 64)):
        wr, wi = FFT._dft_tensors(n, False, False, "ortho", dev)
        check_case("complex_dft_matmul", dict(B=b, N=n), (randn(b, n), randn(b, n), wr, wi),
                   dft_cuda.complex_dft_matmul, dft_cuda.complex_dft_matmul_torch,
                   dft_library(torch), dft_cost, DFT_TOL)

    for b, kt, seed in ((1, T, 1), (1, 1, 2), (2, T, 3)):
        mask_func = RandomMask([10], [4]) if kt > 1 else EquispacedMask([0.08], [4])
        masks = np.stack([mask_func(T, H, seed=seed + i) for i in range(b)])  # (b, t|1, 1, h, 1)
        kern = OPS.masked_normal_kernel(torch.from_numpy(masks).to(dev))
        sr, si = randn(b, C, H, W), randn(b, C, H, W)
        rss = torch.sqrt((sr * sr + si * si).sum(1, keepdim=True))
        args = (randn(b, T, H, W), randn(b, T, H, W), kern.re.contiguous(), kern.im.contiguous(),
                sr / rss, si / rss, 0.0)  # unit-RSS maps, as the sens net's
        check_case("normal_apply", dict(b=b, t=T, c=C, h=H, w=W, kt=kt), args,
                   normal_cuda.normal_apply, normal_cuda.normal_apply_torch,
                   normal_library(torch), normal_cost, NORMAL_TOL)
        # the backward on the same operands; g = x + noise keeps λ̄ = Σ Re⟨g, x⟩
        # from cancelling, so its relative error measures the kernel
        lam = 0.37 if kt == 1 else 0.0
        xr, xi = args[0], args[1]
        check_bwd_case(dict(b=b, t=T, c=C, h=H, w=W, kt=kt, lam=lam),
                       (xr, xi, xr + randn(b, T, H, W), xi + randn(b, T, H, W)) + args[2:6] + (lam,))
    del args, sr, si, rss, kern, xr, xi
    torch.cuda.empty_cache()

    # -- 3. main path: the full-width VarNet-XF forward ---------------------------
    model = build_model("varnet", "XF", device=dev,
                        generator=torch.Generator().manual_seed(0), **FLAGSHIP).eval()
    kre, kim, mask = flagship_inputs(torch, RandomMask([10], [4]), 0, dev)
    k = Complex(kre, kim)

    def forward():
        with torch.inference_mode():
            return model(k, mask)

    # per forward: ifft2c (2 DFTs) in the sens net and for x_ref, then per
    # cascade one fft1c + one ifft1c over t and one normal apply
    nc = FLAGSHIP["num_cascades"]
    expected = {"dft": 4 + 2 * nc, "normal": nc}
    dft_cuda.LAUNCHES = normal_cuda.LAUNCHES = 0
    out_kernel = forward()
    torch.cuda.synchronize()
    per_forward = {"dft": dft_cuda.LAUNCHES, "normal": normal_cuda.LAUNCHES}
    print(f"[forward] launches per forward: {per_forward}")
    if per_forward != expected:
        fail(f"expected {expected} launches per forward, got {per_forward}")
    if out_kernel.shape != (1, T, H, W) or not torch.isfinite(out_kernel).all():
        fail(f"forward output has shape {tuple(out_kernel.shape)} or non-finite values")

    FFT.set_dft_backend("torch")
    OPS.set_normal_backend("torch")
    out_plain = forward()
    FFT.set_dft_backend("kernel")
    OPS.set_normal_backend("kernel")
    model_err = (out_kernel - out_plain).abs().max().item()
    model_scale = out_plain.abs().max().item()
    print(f"[forward] kernels vs plain versions: max_abs_err {model_err:.3e} "
          f"(tol {MODEL_TOL * model_scale:.3e}, max |out| {model_scale:.4f})")
    if not model_err <= MODEL_TOL * model_scale:
        fail(f"forward through the kernels disagrees with the plain forward: {model_err}")

    torch.cuda.reset_peak_memory_stats()
    fwd = [cuda_ms(torch, forward, iters=1, warmup=1 if i == 0 else 0) for i in range(12)]
    peak_mem = torch.cuda.max_memory_allocated()
    ms_vol = statistics.median(fwd)
    print(f"[forward] kernels: {ms_vol:.3f} ms/volume (median of {len(fwd)}, min {min(fwd):.3f}), "
          f"{T / ms_vol * 1e3:.2f} frames/s, peak memory {peak_mem / 2**20:.1f} MiB")

    # one warm forward under the profiler: device time by kernel kind, idle share
    print("[profile] " + json.dumps(profiled(forward)))

    # -- 4. serve: four requests through the serving entry, three times -----------
    serve = bind_model(model, device=dev)
    requests = [(RandomMask([10], [4]), s) for s in (0, 1, 2)] + [(EquispacedMask([0.08], [4]), 3)]
    inputs = [flagship_inputs(torch, mf, s, dev) for mf, s in requests]
    torch.cuda.synchronize()

    def serve_all(*timers):
        latencies, outs = [], []
        with contextlib.ExitStack() as stack:
            for timer in timers:
                stack.enter_context(timer)
            for kr_, ki_, m_ in inputs:
                t0 = time.perf_counter()
                outs.append(serve(kr_, ki_, m_))
                torch.cuda.synchronize()
                latencies.append((time.perf_counter() - t0) * 1e3)
        return latencies, outs

    # (a) through the kernels: the main path's run, whose launches are counted
    kernel_dft = Timed(torch, dft_cuda, "complex_dft_matmul", dft_cost)
    kernel_normal = Timed(torch, normal_cuda, "normal_apply", normal_cost)
    dft_cuda.LAUNCHES = normal_cuda.LAUNCHES = 0
    latencies, outs = serve_all(kernel_dft, kernel_normal)
    served = {"dft": dft_cuda.LAUNCHES, "normal": normal_cuda.LAUNCHES}
    print(f"[serve] kernels: {len(inputs)} requests, latency ms {[round(x, 3) for x in latencies]}, "
          f"launches {served}")
    if served != {k: v * len(inputs) for k, v in expected.items()}:
        fail(f"serving run did not launch every kernel as expected: {served}")
    for o in outs:
        if o.shape != (1, T, H, W) or not torch.isfinite(o).all():
            fail(f"served image has shape {tuple(o.shape)} or non-finite values")
    serve_err = (outs[0] - out_kernel).abs().max().item()
    if not serve_err <= MODEL_TOL * model_scale:
        fail(f"served image differs from the direct forward on the same input: {serve_err}")
    print(f"[serve] request 0 vs direct forward: max_abs_err {serve_err:.3e}")

    # (b) through the plain versions and (c) through the library calls, each
    # in the plain backends' slot; launches here are not counted
    FFT.set_dft_backend("torch")
    OPS.set_normal_backend("torch")
    plain_dft = Timed(torch, dft_cuda, "complex_dft_matmul_torch", dft_cost)
    plain_normal = Timed(torch, normal_cuda, "normal_apply_torch", normal_cost)
    plain_lat, plain_outs = serve_all(plain_dft, plain_normal)
    lib_prep, lib_fn = dft_library(torch)
    lib_dft = Timed(torch, dft_cuda, "complex_dft_matmul_torch", dft_cost, lib_fn, lib_prep)
    lib_prep, lib_fn = normal_library(torch)
    lib_normal = Timed(torch, normal_cuda, "normal_apply_torch", normal_cost, lib_fn, lib_prep)
    lib_lat, lib_outs = serve_all(lib_dft, lib_normal)
    FFT.set_dft_backend("kernel")
    OPS.set_normal_backend("kernel")
    for label, lat, others in (("plain versions", plain_lat, plain_outs),
                               ("library calls", lib_lat, lib_outs)):
        err = max((a - b).abs().max().item() for a, b in zip(outs, others))
        print(f"[serve] {label}: latency ms {[round(x, 3) for x in lat]}; "
              f"max_abs_err vs the kernels {err:.3e}")
        if not err <= MODEL_TOL * model_scale:
            fail(f"serving through the {label} disagrees with the kernels: {err}")

    # -- 5. train: four full-width VarNet-XF train steps, four times ----------------
    del serve, inputs, outs, plain_outs, lib_outs, model, out_kernel, out_plain, k
    torch.cuda.empty_cache()
    tmodel = build_model("varnet", "XF", device=dev, generator=torch.Generator().manual_seed(0),
                         **FLAGSHIP)  # remat on, as the JAX package trains
    init = {n: v.detach().clone() for n, v in tmodel.state_dict().items()}
    batch = train_batch(torch, dev)
    train_step = make_train_step()

    def launches():
        return {"dft": dft_cuda.LAUNCHES, "normal": normal_cuda.LAUNCHES,
                "normal_bwd": normal_cuda.BWD_LAUNCHES}

    def train_run(steps, *timers):
        """``steps`` train steps from the initial weights with a fresh Adam;
        per step the CUDA-event ms, loss, grad norm and kernel launches, and
        the gradients of the first step."""
        tmodel.load_state_dict(init)
        state = create_train_state(tmodel, device=dev)
        rec = dict(ms=[], loss=[], grad_norm=[], launches=[])
        grads = None
        with contextlib.ExitStack() as stack:
            for timer in timers:
                stack.enter_context(timer)
            for i in range(steps):
                before = launches()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                state, aux = train_step(state, batch)
                e1.record()
                e1.synchronize()
                rec["ms"].append(e0.elapsed_time(e1))
                rec["loss"].append(aux["loss"].item())
                rec["grad_norm"].append(aux["grad_norm"].item())
                rec["launches"].append({n: v - before[n] for n, v in launches().items()})
                if not (math.isfinite(rec["loss"][-1]) and math.isfinite(rec["grad_norm"][-1])):
                    fail(f"train step {i + 1} gave loss {rec['loss'][-1]}, grad norm {rec['grad_norm'][-1]}")
                if aux["output"].shape != (1, T, H, W):
                    fail(f"train output has shape {tuple(aux['output'].shape)}")
                if i == 0:
                    grads = {n: q.grad.detach().clone() for n, q in tmodel.named_parameters()}
        return rec, grads

    def gap(rec, grads, ref, ref_grads):
        """(largest relative loss difference over the steps, relative L2
        distance of the first step's gradients, the three leaves with the
        largest max |diff| / max |g|)."""
        loss = max(abs(a - b_) / abs(b_) for a, b_ in zip(rec["loss"], ref["loss"]))
        num = math.sqrt(sum(((grads[n] - g) ** 2).sum().item() for n, g in ref_grads.items()))
        den = math.sqrt(sum((g ** 2).sum().item() for g in ref_grads.values()))
        leaves = sorted(((((grads[n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item(), n)
                         for n, g in ref_grads.items()), reverse=True)[:3]
        return loss, num / den, leaves

    def set_backends(backend):
        FFT.set_dft_backend(backend)
        OPS.set_normal_backend(backend)

    # (a) through the plain versions, twice: the run-to-run gap
    set_backends("torch")
    tplain = (Timed(torch, dft_cuda, "complex_dft_matmul_torch", dft_cost),
              Timed(torch, normal_cuda, "normal_apply_torch", normal_cost),
              Timed(torch, normal_cuda, "normal_apply_bwd_torch", normal_bwd_cost))
    plain_rec, plain_grads = train_run(TRAIN_STEPS, *tplain)
    plain2_rec, plain2_grads = train_run(TRAIN_STEPS)
    # (b) through one library call each, in the plain versions' slots
    tlib = tuple(Timed(torch, mod, attr, cost, lib[1], lib[0]) for mod, attr, cost, lib in (
        (dft_cuda, "complex_dft_matmul_torch", dft_cost, dft_library(torch)),
        (normal_cuda, "normal_apply_torch", normal_cost, normal_library(torch)),
        (normal_cuda, "normal_apply_bwd_torch", normal_bwd_cost, normal_bwd_library(torch))))
    lib_rec, lib_grads = train_run(TRAIN_STEPS, *tlib)
    set_backends("kernel")

    # (c) through the kernels: the train path's run, whose launches are counted
    tkern = (Timed(torch, dft_cuda, "complex_dft_matmul", dft_cost),
             Timed(torch, normal_cuda, "normal_apply", normal_cost),
             Timed(torch, normal_cuda, "normal_apply_bwd", normal_bwd_cost))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dft_cuda.LAUNCHES = normal_cuda.LAUNCHES = normal_cuda.BWD_LAUNCHES = 0
    kern_rec, kern_grads = train_run(TRAIN_STEPS, *tkern)
    trained = launches()
    train_peak = torch.cuda.max_memory_allocated()
    # per step, with remat: the forward's 24 DFTs and 10 normal applies, the
    # replay of each cascade in the backward (2 DFTs and 1 normal apply per
    # cascade), and the backward of the cascades' DFTs (2 per cascade, on Wᴴ)
    # and normal applies (1 per cascade); the sens net's and x_ref's 4 DFTs
    # act on data and have no backward
    per_step = {"dft": 4 + 2 * nc + 2 * nc + 2 * nc, "normal": nc + nc, "normal_bwd": nc}
    print(f"[train] launches per step: {kern_rec['launches']} (expected {per_step}); "
          f"run total {trained}")
    if any(step_launches != per_step for step_launches in kern_rec["launches"]):
        fail(f"train steps did not launch the kernels as expected: {kern_rec['launches']}")
    if trained != {n: v * TRAIN_STEPS for n, v in per_step.items()}:
        fail(f"train run counted {trained} launches")

    plain_gap = gap(plain2_rec, plain2_grads, plain_rec, plain_grads)
    kern_gap = gap(kern_rec, kern_grads, plain_rec, plain_grads)
    lib_gap = gap(lib_rec, lib_grads, plain_rec, plain_grads)
    gaps = (("plain vs plain", plain_gap), ("kernels vs plain", kern_gap),
            ("library vs plain", lib_gap))
    for label, (loss_gap, grad_gap, leaves) in gaps:
        print(f"[train] {label}: loss rel {loss_gap:.3e} (tol {TRAIN_LOSS_TOL:.0e}), step-1 grads "
              f"rel L2 {grad_gap:.3e} (tol {TRAIN_GRAD_TOL:.0e}), worst leaves "
              f"{[(n, f'{v:.3e}') for v, n in leaves]}")
    for label, (loss_gap, grad_gap, _) in gaps:
        if not (loss_gap <= TRAIN_LOSS_TOL and grad_gap <= TRAIN_GRAD_TOL):
            fail(f"train run, {label}, is outside the tolerances: {loss_gap}, {grad_gap}")

    ms_step = statistics.median(kern_rec["ms"][1:])
    for label, rec in (("kernels", kern_rec), ("plain versions", plain_rec),
                       ("plain versions, again", plain2_rec), ("library calls", lib_rec)):
        print(f"[train] {label}: ms/step {[round(x, 3) for x in rec['ms']]}, "
              f"loss {rec['loss']}, grad_norm {rec['grad_norm']}")
    print(f"[train] kernels, remat on: {ms_step:.3f} ms/step (median of steps 2-{TRAIN_STEPS}), "
          f"{1e3 / ms_step:.3f} volumes/s, peak memory {train_peak / 2**20:.1f} MiB")

    # one warm step under the profiler
    tmodel.load_state_dict(init)
    pstate = create_train_state(tmodel, device=dev)
    pstate, _ = train_step(pstate, batch)
    train_profile = profiled(lambda: train_step(pstate, batch))
    print("[train-profile] " + json.dumps(train_profile))

    # without remat: every cascade's activations kept for the backward
    tmodel.remat = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    noremat_rec, _ = train_run(3)
    noremat_peak = torch.cuda.max_memory_allocated()
    tmodel.remat = True
    noremat_ms = statistics.median(noremat_rec["ms"][1:])
    print(f"[train] kernels, remat off: {noremat_ms:.3f} ms/step (median of steps 2-3, "
          f"{[round(x, 3) for x in noremat_rec['ms']]}), peak memory {noremat_peak / 2**20:.1f} MiB")

    # -- 6. report -------------------------------------------------------------------
    def row(kernel, source, replaces, run, launches, timed, plain, library):
        b_ms, b_by = timed.bound(peak_flops, peak_bw)
        return dict(name=kernel, route="cuda", source=source, replaces=replaces, run=run,
                    launches=launches,
                    max_abs_err=max(c["max_abs_err"] for c in cases if c["kernel"] == kernel),
                    ms=timed.ms(), plain_ms=plain.ms(), bound_ms=b_ms, bound_by=b_by,
                    library_ms=library.ms())

    dft_src = ("complex_dft_matmul", "cinemri_tpu_torch/csrc/dft_matmul.cu",
               "cinemri_tpu/ops/kernels/dft_pallas.py:65")
    fwd_src = ("normal_apply", "cinemri_tpu_torch/csrc/normal_apply.cu",
               "cinemri_tpu/ops/kernels/normal_pallas.py:182")
    bwd_src = ("normal_apply_bwd", "cinemri_tpu_torch/csrc/normal_apply_bwd.cu",
               "cinemri_tpu/ops/kernels/normal_pallas.py:203")
    rows = [
        row(*dft_src, "serve", served["dft"], kernel_dft, plain_dft, lib_dft),
        row(*fwd_src, "serve", served["normal"], kernel_normal, plain_normal, lib_normal),
        row(*dft_src, "train", trained["dft"], tkern[0], tplain[0], tlib[0]),
        row(*fwd_src, "train", trained["normal"], tkern[1], tplain[1], tlib[1]),
        row(*bwd_src, "train", trained["normal_bwd"], tkern[2], tplain[2], tlib[2]),
    ]
    print("[details] " + json.dumps(dict(
        cases=cases, forward_ms=fwd, ms_per_volume=ms_vol, frames_per_s=T / ms_vol * 1e3,
        peak_memory_bytes=peak_mem, model_max_abs_err=model_err, launches_per_forward=per_forward,
        serve_latency_ms=latencies, plain_serve_latency_ms=plain_lat,
        library_serve_latency_ms=lib_lat, serve_launches=served,
        train=dict(kernels=kern_rec, plain=plain_rec, plain_again=plain2_rec, library=lib_rec,
                   ms_per_step=ms_step, volumes_per_s=1e3 / ms_step, peak_memory_bytes=train_peak,
                   launches=trained, launches_per_step=per_step, plain_gap=plain_gap,
                   kernel_gap=kern_gap, library_gap=lib_gap, profile=train_profile,
                   no_remat=dict(steps=noremat_rec, ms_per_step=noremat_ms,
                                 peak_memory_bytes=noremat_peak)))))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
