#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``cinemri_tpu_torch/csrc`` with nvcc
(one nvcc per source, in parallel) and holds each kernel against its plain
PyTorch version and one library call at the shapes of the serving and
training paths: the DFT at the six ``(O, N, I)`` layouts of the path and two
ragged ones; the fused 2-D DFT ``fft2_plane``, which no path runs (as in
the JAX package), at the 2-D DFT shapes of the ported paths, beside the two
1-D DFT launches that ``ifft2c`` makes today and cuFFT. For these two
kernels it also times the device alone (CUDA graphs, no host launch
overhead), and it times the cascades' temporal DFT on both layouts it could
take (``[layout]``).

Then it drives two models at full width through the port's entry points.
VarNet-XF (10 cascades, chans 16, pools 3, sens net 8/3): the forward on a
15-frame x 10-coil x 200x200 volume through the kernels and through the
plain versions, one profiled forward, four requests through
``cinemri_tpu_torch.serve`` three times (through the kernels, the plain
versions and one library call each), then four train steps of
``cinemri_tpu_torch.train`` (SSIM loss, Adam 1e-4, cascade remat) twice
through the plain versions (their run-to-run gap), once through the library
calls and once through the kernels, from the same initial weights, one
profiled step and steps without remat; one more forward prints the
``(O, N, I)`` of its DFT launches and the copies ``_apply_dft`` made (fewer
than PR 3's). CineNet-XF (10 cascades, 6 CG
iterations, chans 16, pools 3, with RSS-normalized sensitivity maps as
input): the same forward, profile and serving runs, one warm forward under
``torch.cuda.set_sync_debug_mode("error")`` (λ stays on the device), the same
four train runs, one profiled step and the host syncs of one step.

It checks that each kernel run launched every kernel as many times as the
path calls it and that the runs agree. Any failure ends the run with a
non-zero exit code.

Output, last three lines: one JSON object with a row per kernel and run
(``"serve"``, ``"train"``, ``"cinenet-serve"``, ``"cinenet-train"`` and, for
``fft2_plane``, ``"check"``), the card's name and power limit as nvidia-smi
reports them, and ``{"ok": true, "device": {...}}``. A row's ``ms``,
``plain_ms`` and ``library_ms`` sum CUDA-event times taken around every
call of that function in its run (the four serve requests, the four train
steps, or one call at each of the four check shapes); ``bound_ms`` sums the
bound of each call of the kernel run. The line before them, ``[details]
{...}``, holds the per-shape microbenchmarks and every other number.

Imports nothing of JAX. Exits non-zero without a CUDA device, or when the
``cinemri_tpu_torch`` package is not beside this file.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
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
# the JAX package's protocol CineNet (bench/_protocol.py CONFIGS["cinenet"])
CINENET = dict(num_cascades=10, cg_iters=6, chans=16, pools=3)
T, C, H, W = 15, 10, 200, 200

# Tolerances, relative to the largest magnitude of the plain result. Both
# sides are f32 with FMA and no TF32; they differ only in summation order
# (N = 200 terms for the DFT, c·h = 2000 for the normal apply).
DFT_TOL = 2e-5
NORMAL_TOL = 2e-5
# Whole forward, kernels vs plain versions: rounding differences pass
# through 10 cascades and their instance-normalized U-Nets (and CineNet's
# 6-step CG solves).
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
# CineNet's first-step gradient at full width is ill-conditioned in f32: every
# f32 summation order, the plain versions' own included, lands about 2%
# (relative L2) from the gradient evaluated in f64 (the loss within 1e-7), so
# any two f32 orders are about 2.2% apart (1.9-2.1% and 2.2% on the H100);
# Adam's first step, ±lr by the sign of each gradient element, carries that
# into the later steps' losses (up to 6e-4 apart). So the CineNet train runs
# are held to wider gaps against the plain run, which the plain-vs-plain and
# library-vs-plain gaps must meet too, and the kernels' first-step gradient
# must be no farther from the f64 gradient than F64_RATIO times the plain
# versions'.
CINENET_TRAIN_LOSS_TOL = 2e-3
CINENET_TRAIN_GRAD_TOL = 5e-2
F64_RATIO = 1.5


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


def graph_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` per call: ``iters`` calls captured in one
    CUDA graph and replayed between two CUDA events, so the host's launch
    overhead, which a small kernel cannot hide, is left out."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


# (FLOP, bytes) of one call, from its inputs: the 4-multiplication complex
# product (8 FLOP per complex multiply-add); each input read once, each
# output written once.
def dft_cost(xr, xi, wr, wi):
    o, n, i = xr.shape
    return 8.0 * o * n * n * i, 4.0 * (4 * o * n * i + 2 * n * n)


def normal_cost(xr, xi, kr, ki, sr, si, lam):
    """The h-contraction per coil, the products around it and ``+ λx``
    (which the kernel computes whatever λ is); λ's four bytes are left out."""
    b, t, h, w = xr.shape
    c, kt = sr.shape[1], kr.shape[1]
    flops = 8.0 * b * t * c * h * h * w + 14.0 * b * t * c * h * w + 4.0 * b * t * h * w
    return flops, 8.0 * (2 * b * t * h * w + b * kt * h * h + b * c * h * w)


def fft2_cost(xr, xi, whr, whi, wwr, wwi):
    """Two complex products per plane, ``W_h·X`` and ``(W_h·X)·W_wᵀ``; reads
    the planes and both matrices, writes the planes."""
    b, h, w = xr.shape
    return 8.0 * b * (h * h * w + h * w * w), 4.0 * (4 * b * h * w + 2 * h * h + 2 * w * w)


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
    """One complex64 ``matmul`` in the layout of the input: rows times ``Wᵀ``
    for ``I == 1``, ``W`` from the left on each ``(N, I)`` slab otherwise."""
    def prep(xr, xi, wr, wi):
        x, w = torch.complex(xr, xi), torch.complex(wr, wi)
        return x, w, xr.shape[2] > 1

    def call(x, w, slabs):
        if slabs:
            return torch.matmul(w, x)
        return torch.matmul(x.reshape(x.shape[0], -1), w.T).view(x.shape)

    return prep, call


def normal_library(torch):
    def prep(xr, xi, kr, ki, sr, si, lam):
        b, t, h, _ = xr.shape
        s = torch.complex(sr, si)
        return torch.complex(xr, xi), torch.complex(kr, ki).expand(b, t, h, h), s, s.conj(), lam

    def call(x, k, s, sc, lam):
        return torch.einsum("bckw,btkw,btik,bciw->btiw", s, x, k, sc) + lam * x

    return prep, call


def fft2_library(torch):
    """One complex64 ``einsum`` for ``W_h · X[b] · W_wᵀ``."""
    def prep(xr, xi, whr, whi, wwr, wwi):
        return torch.complex(whr, whi), torch.complex(xr, xi), torch.complex(wwr, wwi)

    def call(wh, x, ww):
        return torch.einsum("ij,bjk,lk->bil", wh, x, ww)

    return prep, call


def normal_bwd_library(torch):
    """``torch.autograd.grad`` through the one-einsum complex64 forward of
    :func:`normal_library` (the forward included): no single PyTorch call
    computes this backward."""
    def prep(xr, xi, gr, gi, kr, ki, sr, si, lam):
        b, t, h, _ = xr.shape
        lam = (lam.detach().reshape(()) if torch.is_tensor(lam)
               else torch.tensor(lam, dtype=torch.float32, device=xr.device))
        return (torch.complex(xr, xi), torch.complex(gr, gi),
                torch.complex(kr, ki).expand(b, t, h, h), torch.complex(sr, si), lam)

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


def rss_maps(torch, seed: int, device):
    """Random RSS-normalized sensitivity maps (1, 1, 10, 200, 200) from
    ``default_rng(seed + 1)``, as the JAX package's
    ``bench/_protocol.py::rss_normalized_maps`` makes CineNet's input."""
    rng = np.random.default_rng(seed + 1)
    shape = (1, 1, C, H, W)
    s = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    s /= np.sqrt((np.abs(s) ** 2).sum(2, keepdims=True))
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
    return as_t(s.real), as_t(s.imag)


def train_batch(torch, device, sens_maps: bool = False):
    """The JAX package's train-step batch (``bench/train_step.py``): k-space
    from ``default_rng(0)`` under ``RandomMask([10], [4])(15, 200, seed=0)``,
    target = |k| averaged over coils; with ``sens_maps``, RSS-normalized maps
    drawn next from the same generator, as that script gives CineNet."""
    from cinemri_tpu_torch.data.masks import RandomMask
    from cinemri_tpu_torch.ops.cplx import Complex

    rng = np.random.default_rng(0)
    shape = (1, T, C, H, W)
    k = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    mask = RandomMask([10], [4])(T, H, seed=0)[None].astype(np.float32)
    km = k * mask
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
    batch = {"masked_kspace": Complex(as_t(km.real), as_t(km.imag)), "mask": as_t(mask),
             "target": as_t(np.abs(k).mean(axis=2))}
    if sens_maps:
        s = (rng.standard_normal((1, 1, C, H, W))
             + 1j * rng.standard_normal((1, 1, C, H, W))).astype(np.complex64)
        s /= np.sqrt((np.abs(s) ** 2).sum(2, keepdims=True))
        batch["sens_maps"] = Complex(as_t(s.real), as_t(s.imag))
    return batch


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
    from cinemri_tpu_torch.ops.cplx import Complex, to_channels
    from cinemri_tpu_torch.ops.kernels import _build, dft_cuda, fft2_cuda, normal_cuda
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

    def check_case(kernel, shape, args, fn, plain, library, cost, tol, graph=False):
        """One kernel against its plain version and its library call on the
        same inputs; times each (mean of warm launches, L2-warm) and, with
        ``graph``, also their device time alone (graph_ms)."""
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
        device = ""
        if graph:
            case.update(device_ms=graph_ms(torch, lambda: fn(*args)),
                        plain_device_ms=graph_ms(torch, lambda: plain(*args), iters=10),
                        library_device_ms=graph_ms(torch, lambda: lib(*lib_in), iters=10))
            device = (f"; device alone (CUDA graph): kernel {case['device_ms']:.4f} ms plain "
                      f"{case['plain_device_ms']:.4f} ms library {case['library_device_ms']:.4f} ms")
        cases.append(case)
        print(f"[kernel] {kernel} {shape}: max_abs_err {err:.3e} rel {err / scale:.3e} "
              f"(tol {tol * scale:.3e}; library {lib_err:.3e}) kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms library {library_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})"
              + device)
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
    # the main path's (O, N, I) layouts: the sens net's and x_ref's ifft2c
    # (axis -2 on the contiguous k-space, then axis -1 on its contiguous
    # result), the cascades' temporal transforms (fft1c on a contiguous
    # image, ifft1c on one with t innermost); and two ragged ones
    for o, n, i in ((C, H, W), (C * H, W, 1), (T * C, H, W), (T * C * H, W, 1),
                    (1, T, H * W), (H * W, T, 1), (37, 64, 1), (3, 24, 7)):
        wr, wi = FFT._dft_tensors(n, False, False, "ortho", dev)
        check_case("complex_dft_matmul", dict(O=o, N=n, I=i),
                   (randn(o, n, i), randn(o, n, i), wr, wi),
                   dft_cuda.complex_dft_matmul, dft_cuda.complex_dft_matmul_torch,
                   dft_library(torch), dft_cost, DFT_TOL, graph=True)

    # the cascades' temporal DFT and the two plane batches they feed
    # (models/varnet.py _xfyf), from a contiguous image: the route ops/fft.py
    # takes (I > 1 on the image, no copy; the plane batches copy) against a
    # copy to t innermost first (I = 1; the (w, t) batch is then a view)
    def cascade_planes(x):
        y = FFT.fft1c(x, axis=1)
        b, t, h, w = y.shape
        return (to_channels(y.transpose(0, 2, 3, 1).reshape(b * h, w, t), axis=1),
                to_channels(y.transpose(0, 3, 2, 1).reshape(b * w, h, t), axis=1))

    def t_last(x):
        return Complex(*(a.movedim(1, -1).contiguous().movedim(-1, 1) for a in (x.re, x.im)))

    ximg = Complex(randn(1, T, H, W), randn(1, T, H, W))
    with torch.no_grad():
        planes = [cascade_planes(ximg), cascade_planes(t_last(ximg))]
        torch.cuda.synchronize()
        layout_err = max((a - b_).abs().max().item() for a, b_ in zip(*planes))
        layout_scale = max(a.abs().max().item() for a in planes[0])
        layout_ms = [cuda_ms(torch, lambda: cascade_planes(ximg)),
                     cuda_ms(torch, lambda: cascade_planes(t_last(ximg))),
                     cuda_ms(torch, lambda: cascade_planes(ximg)),
                     cuda_ms(torch, lambda: cascade_planes(t_last(ximg)))]
    layout = dict(contiguous_ms=layout_ms[0::2], t_last_copy_ms=layout_ms[1::2], max_abs_diff=layout_err)
    print(f"[layout] cascade fft1c + plane batches at (1, {T}, {H}, {W}): contiguous route (I > 1, "
          f"no DFT copy) {layout_ms[0]:.4f} / {layout_ms[2]:.4f} ms; copy to t innermost first "
          f"(I = 1) {layout_ms[1]:.4f} / {layout_ms[3]:.4f} ms; max_abs_diff {layout_err:.3e}")
    if not layout_err <= DFT_TOL * layout_scale:
        fail(f"the two temporal DFT layouts disagree: {layout_err}")
    del ximg, planes

    # λ: VarNet's 0.0 in the forward; 0.37 in a backward; a device tensor
    # (CineNet's softplus(λᵢ), read by the kernels through a pointer)
    lam_dev = torch.tensor(0.37, device=dev)
    for b, kt, seed, lam in ((1, T, 1, 0.0), (1, 1, 2, 0.37), (2, T, 3, 0.0), (1, T, 4, lam_dev)):
        mask_func = RandomMask([10], [4]) if kt > 1 else EquispacedMask([0.08], [4])
        masks = np.stack([mask_func(T, H, seed=seed + i) for i in range(b)])  # (b, t|1, 1, h, 1)
        kern = OPS.masked_normal_kernel(torch.from_numpy(masks).to(dev))
        sr, si = randn(b, C, H, W), randn(b, C, H, W)
        rss = torch.sqrt((sr * sr + si * si).sum(1, keepdim=True))
        args = (randn(b, T, H, W), randn(b, T, H, W), kern.re.contiguous(), kern.im.contiguous(),
                sr / rss, si / rss)  # unit-RSS maps, as the sens net's
        lam_label = "device tensor 0.37" if torch.is_tensor(lam) else lam
        fwd_lam = lam if torch.is_tensor(lam) else 0.0  # the forward cases: VarNet's 0.0
        check_case("normal_apply", dict(b=b, t=T, c=C, h=H, w=W, kt=kt,
                                        lam=lam_label if torch.is_tensor(lam) else 0.0),
                   args + (fwd_lam,), normal_cuda.normal_apply, normal_cuda.normal_apply_torch,
                   normal_library(torch), normal_cost, NORMAL_TOL)
        # the backward on the same operands; g = x + noise keeps λ̄ = Σ Re⟨g, x⟩
        # from cancelling, so its relative error measures the kernel
        xr, xi = args[0], args[1]
        check_bwd_case(dict(b=b, t=T, c=C, h=H, w=W, kt=kt, lam=lam_label),
                       (xr, xi, xr + randn(b, T, H, W), xi + randn(b, T, H, W)) + args[2:6] + (lam,))
    del args, sr, si, rss, kern, xr, xi

    # fft2_plane, wired into no path (as in the JAX package), at the 2-D DFT
    # shapes of the ported paths: CineNet's image_ref and VarNet's x_ref
    # ifft2c (150 planes), the sens net's ifft2c (10), a small forward DFT, and
    # random non-symmetric W_h ≠ W_w, h ≠ w (a transposed W_w would show). For
    # the DFTs also the route the port takes today (ops/fft.py: two DFT
    # kernel launches, (B, h, w) and then (B·h, w, 1), no copy) and cuFFT
    # between the shifts, for information.
    fft2_args = []
    for (b, h, w), inverse in (((T * C, H, W), True), ((C, H, W), True), ((3, 32, 32), False),
                               ((4, 24, 20), None)):
        if inverse is None:
            mats = tuple(randn(n, n) / math.sqrt(n) for n in (h, h, w, w))
        else:
            mats = (FFT._dft_tensors(h, inverse, False, "ortho", dev)
                    + FFT._dft_tensors(w, inverse, False, "ortho", dev))
        args = (randn(b, h, w), randn(b, h, w)) + mats
        fft2_args.append(args)
        label = "random" if inverse is None else ("centered inverse DFT" if inverse else "centered DFT")
        check_case("fft2_plane", dict(B=b, h=h, w=w, matrices=label), args, fft2_cuda.fft2_plane,
                   fft2_cuda.fft2_plane_torch, fft2_library(torch), fft2_cost, DFT_TOL, graph=True)
        if inverse is None:
            continue
        x = Complex(args[0], args[1])
        route = FFT.ifft2c if inverse else FFT.fft2c
        with torch.no_grad():
            via_1d = route(x)
            two_ms = cuda_ms(torch, lambda: route(x))
            two_device_ms = graph_ms(torch, lambda: route(x))
        xc = torch.complex(args[0], args[1])
        fft = torch.fft.ifft2 if inverse else torch.fft.fft2
        cufft = lambda: torch.fft.fftshift(fft(torch.fft.ifftshift(xc, dim=(-2, -1)), norm="ortho"),
                                           dim=(-2, -1))
        cufft_ms = cuda_ms(torch, cufft)
        cufft_device_ms = graph_ms(torch, cufft)
        want = cufft()
        got = fft2_cuda.fft2_plane(*args)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        errs = [max((a - want.real).abs().max().item(), (b_ - want.imag).abs().max().item())
                for a, b_ in (got, (via_1d.re, via_1d.im))]
        cases[-1].update(two_dft_launches_ms=two_ms, cufft_ms=cufft_ms,
                         two_dft_launches_device_ms=two_device_ms, cufft_device_ms=cufft_device_ms,
                         max_abs_err_vs_cufft=errs[0], two_dft_launches_max_abs_err_vs_cufft=errs[1])
        print(f"[kernel] fft2_plane {(b, h, w)} vs today's route: two DFT launches "
              f"{two_ms:.4f} ms (device alone {two_device_ms:.4f}), cuFFT {cufft_ms:.4f} ms (device "
              f"alone {cufft_device_ms:.4f}); max_abs_err vs cuFFT: kernel {errs[0]:.3e}, "
              f"two launches {errs[1]:.3e} (tol {DFT_TOL * scale:.3e})")
        if not max(errs) <= DFT_TOL * scale:
            fail(f"fft2_plane or the two-launch route disagrees with cuFFT at {(b, h, w)}: {errs}")
    # the check run of the kernel row: one call at each shape, CUDA events around each
    fft2_runs = (Timed(torch, fft2_cuda, "fft2_plane", fft2_cost),
                 Timed(torch, fft2_cuda, "fft2_plane_torch", fft2_cost),
                 Timed(torch, fft2_cuda, "fft2_plane_torch", fft2_cost, fft2_library(torch)[1],
                       fft2_library(torch)[0]))
    fft2_cuda.LAUNCHES = 0
    for args in fft2_args:
        for timer in fft2_runs:
            timer(*args)
    torch.cuda.synchronize()
    fft2_launches = fft2_cuda.LAUNCHES
    if fft2_launches != len(fft2_args):
        fail(f"the fft2_plane check run launched {fft2_launches} kernels, not {len(fft2_args)}")
    del args, fft2_args, mats, x, xc, via_1d, want, got
    torch.cuda.empty_cache()

    def set_backends(backend):
        FFT.set_dft_backend(backend)
        OPS.set_normal_backend(backend)

    def dft_layouts(fn):
        """The distinct (O, N, I) of the DFT launches in one call of ``fn``,
        with their counts, and the copies ``_apply_dft`` made."""
        seen = collections.Counter()
        saved = dft_cuda.complex_dft_matmul

        def record(xr, xi, wr, wi):
            seen[tuple(xr.shape)] += 1
            return saved(xr, xi, wr, wi)

        dft_cuda.complex_dft_matmul = record
        FFT.COPIES = 0
        try:
            fn()
        finally:
            dft_cuda.complex_dft_matmul = saved
        return {str(k): v for k, v in seen.items()}, FFT.COPIES

    def forward_phase(tag, forward, expected, max_copies):
        """The forward through the kernels (launches counted) and through the
        plain versions, checked against each other; the DFT layouts and
        copies of one more forward (fewer than ``max_copies``); then 12 timed
        warm forwards."""
        dft_cuda.LAUNCHES = normal_cuda.LAUNCHES = 0
        out_kernel = forward()
        torch.cuda.synchronize()
        per_forward = {"dft": dft_cuda.LAUNCHES, "normal": normal_cuda.LAUNCHES}
        print(f"[{tag}] launches per forward: {per_forward}")
        if per_forward != expected:
            fail(f"{tag}: expected {expected} launches per forward, got {per_forward}")
        if out_kernel.shape != (1, T, H, W) or not torch.isfinite(out_kernel).all():
            fail(f"{tag}: output has shape {tuple(out_kernel.shape)} or non-finite values")
        set_backends("torch")
        out_plain = forward()
        set_backends("kernel")
        err = (out_kernel - out_plain).abs().max().item()
        scale = out_plain.abs().max().item()
        print(f"[{tag}] kernels vs plain versions: max_abs_err {err:.3e} "
              f"(tol {MODEL_TOL * scale:.3e}, max |out| {scale:.4f})")
        if not err <= MODEL_TOL * scale:
            fail(f"{tag}: the forward through the kernels disagrees with the plain forward: {err}")
        layouts, copies = dft_layouts(forward)
        print(f"[{tag}] DFT launches by (O, N, I): {layouts}; _apply_dft copies per forward: "
              f"{copies} (PR 3: {max_copies})")
        if not copies < max_copies:
            fail(f"{tag}: _apply_dft made {copies} copies in a forward, not fewer than {max_copies}")
        torch.cuda.reset_peak_memory_stats()
        times = [cuda_ms(torch, forward, iters=1, warmup=1 if i == 0 else 0) for i in range(12)]
        peak = torch.cuda.max_memory_allocated()
        ms_vol = statistics.median(times)
        print(f"[{tag}] kernels: {ms_vol:.3f} ms/volume (median of {len(times)}, min {min(times):.3f}), "
              f"{T / ms_vol * 1e3:.2f} frames/s, peak memory {peak / 2**20:.1f} MiB")
        return dict(out=out_kernel, scale=scale, max_abs_err=err, launches_per_forward=per_forward,
                    dft_layouts=layouts, dft_copies=copies, forward_ms=times, ms_per_volume=ms_vol, frames_per_s=T / ms_vol * 1e3,
                    peak_memory_bytes=peak)

    def serve_phase(tag, serve, inputs, expected, direct_out, scale):
        """The requests through ``serve`` three times: (a) through the kernels,
        whose launches are counted, (b) through the plain versions and (c)
        through one library call each, both in the plain versions' slots,
        uncounted. CUDA events around every call of each (Timed)."""
        def serve_all(*timers):
            latencies, outs = [], []
            with contextlib.ExitStack() as stack:
                for timer in timers:
                    stack.enter_context(timer)
                for request in inputs:
                    t0 = time.perf_counter()
                    outs.append(serve(*request))
                    torch.cuda.synchronize()
                    latencies.append((time.perf_counter() - t0) * 1e3)
            return latencies, outs

        kern = (Timed(torch, dft_cuda, "complex_dft_matmul", dft_cost),
                Timed(torch, normal_cuda, "normal_apply", normal_cost))
        dft_cuda.LAUNCHES = normal_cuda.LAUNCHES = 0
        latencies, outs = serve_all(*kern)
        served = {"dft": dft_cuda.LAUNCHES, "normal": normal_cuda.LAUNCHES}
        print(f"[{tag}] kernels: {len(inputs)} requests, latency ms "
              f"{[round(x, 3) for x in latencies]}, launches {served}")
        if served != {k_: v * len(inputs) for k_, v in expected.items()}:
            fail(f"{tag}: the serving run did not launch every kernel as expected: {served}")
        for o in outs:
            if o.shape != (1, T, H, W) or not torch.isfinite(o).all():
                fail(f"{tag}: served image has shape {tuple(o.shape)} or non-finite values")
        serve_err = (outs[0] - direct_out).abs().max().item()
        if not serve_err <= MODEL_TOL * scale:
            fail(f"{tag}: served image differs from the direct forward on the same input: {serve_err}")
        print(f"[{tag}] request 0 vs direct forward: max_abs_err {serve_err:.3e}")

        set_backends("torch")
        plain = (Timed(torch, dft_cuda, "complex_dft_matmul_torch", dft_cost),
                 Timed(torch, normal_cuda, "normal_apply_torch", normal_cost))
        plain_lat, plain_outs = serve_all(*plain)
        lib = tuple(Timed(torch, mod, attr, cost, fn_[1], fn_[0]) for mod, attr, cost, fn_ in (
            (dft_cuda, "complex_dft_matmul_torch", dft_cost, dft_library(torch)),
            (normal_cuda, "normal_apply_torch", normal_cost, normal_library(torch))))
        lib_lat, lib_outs = serve_all(*lib)
        set_backends("kernel")
        for label, lat, others in (("plain versions", plain_lat, plain_outs),
                                   ("library calls", lib_lat, lib_outs)):
            err = max((a - b_).abs().max().item() for a, b_ in zip(outs, others))
            print(f"[{tag}] {label}: latency ms {[round(x, 3) for x in lat]}; "
                  f"max_abs_err vs the kernels {err:.3e}")
            if not err <= MODEL_TOL * scale:
                fail(f"{tag}: serving through the {label} disagrees with the kernels: {err}")
        return dict(launches=served, kern=kern, plain=plain, lib=lib, latency_ms=latencies,
                    plain_latency_ms=plain_lat, library_latency_ms=lib_lat)

    train_step = make_train_step()

    def launches():
        return {"dft": dft_cuda.LAUNCHES, "normal": normal_cuda.LAUNCHES,
                "normal_bwd": normal_cuda.BWD_LAUNCHES}

    def train_run(model, init, batch, steps, *timers):
        """``steps`` train steps from the initial weights with a fresh Adam;
        per step the CUDA-event ms, loss, grad norm and kernel launches, and
        the gradients of the first step."""
        model.load_state_dict(init)
        state = create_train_state(model, device=dev)
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
                    grads = {n: q.grad.detach().clone() for n, q in model.named_parameters()}
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

    @contextlib.contextmanager
    def float64_plain():
        """While entered, the plain versions compute in float64: the DFT
        matrices come from the complex128 matrices the f32 ones are rounded
        from, and λ keeps its dtype. Stands in for the module attributes, as
        Timed does."""
        saved = (FFT._dft_tensors, FFT._dft_adjoint_tensors, OPS._dft_tensors,
                 normal_cuda.lambda_tensor)

        @functools.lru_cache(maxsize=None)
        def mats(n, inverse, device):
            f = np.fft.ifft if inverse else np.fft.fft
            eye = np.eye(n, dtype=np.complex128)
            m = np.fft.fftshift(f(np.fft.ifftshift(eye, axes=0), axis=0, norm="ortho"), axes=0)
            return (torch.from_numpy(m.real.copy()).to(device),
                    torch.from_numpy(m.imag.copy()).to(device),
                    torch.from_numpy(m.real.T.copy()).to(device),
                    torch.from_numpy(-m.imag.T.copy()).to(device))

        def lam64(lam, device):
            if torch.is_tensor(lam):
                return lam.detach().reshape(1)
            return torch.full((1,), lam, dtype=torch.float64, device=device)

        FFT._dft_tensors = OPS._dft_tensors = lambda n, inv, alt, norm, d: mats(n, inv, d)[:2]
        FFT._dft_adjoint_tensors = lambda n, inv, alt, norm, d: mats(n, inv, d)[2:]
        normal_cuda.lambda_tensor = lam64
        set_backends("torch")
        try:
            yield
        finally:
            set_backends("kernel")
            (FFT._dft_tensors, FFT._dft_adjoint_tensors, OPS._dft_tensors,
             normal_cuda.lambda_tensor) = saved

    def train_phase(tag, model, batch, per_step, loss_tol=TRAIN_LOSS_TOL, grad_tol=TRAIN_GRAD_TOL,
                    f64_reference=False):
        """TRAIN_STEPS steps from the same weights four times: (a) through the
        plain versions twice (their run-to-run gap), (b) through one library
        call each in the plain versions' slots, (c) through the kernels, whose
        launches are counted per step; the gaps against the plain run, and
        one profiled warm step. With ``f64_reference``, also one step of the
        plain versions in float64, and each run's first-step gradient
        against it."""
        init = {n: v.detach().clone() for n, v in model.state_dict().items()}
        set_backends("torch")
        tplain = (Timed(torch, dft_cuda, "complex_dft_matmul_torch", dft_cost),
                  Timed(torch, normal_cuda, "normal_apply_torch", normal_cost),
                  Timed(torch, normal_cuda, "normal_apply_bwd_torch", normal_bwd_cost))
        plain_rec, plain_grads = train_run(model, init, batch, TRAIN_STEPS, *tplain)
        plain2_rec, plain2_grads = train_run(model, init, batch, TRAIN_STEPS)
        tlib = tuple(Timed(torch, mod, attr, cost, fn_[1], fn_[0]) for mod, attr, cost, fn_ in (
            (dft_cuda, "complex_dft_matmul_torch", dft_cost, dft_library(torch)),
            (normal_cuda, "normal_apply_torch", normal_cost, normal_library(torch)),
            (normal_cuda, "normal_apply_bwd_torch", normal_bwd_cost, normal_bwd_library(torch))))
        lib_rec, lib_grads = train_run(model, init, batch, TRAIN_STEPS, *tlib)
        set_backends("kernel")

        tkern = (Timed(torch, dft_cuda, "complex_dft_matmul", dft_cost),
                 Timed(torch, normal_cuda, "normal_apply", normal_cost),
                 Timed(torch, normal_cuda, "normal_apply_bwd", normal_bwd_cost))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dft_cuda.LAUNCHES = normal_cuda.LAUNCHES = normal_cuda.BWD_LAUNCHES = 0
        kern_rec, kern_grads = train_run(model, init, batch, TRAIN_STEPS, *tkern)
        trained = launches()
        peak = torch.cuda.max_memory_allocated()
        print(f"[{tag}] launches per step: {kern_rec['launches']} (expected {per_step}); "
              f"run total {trained}")
        if any(step_launches != per_step for step_launches in kern_rec["launches"]):
            fail(f"{tag}: train steps did not launch the kernels as expected: {kern_rec['launches']}")
        if trained != {n: v * TRAIN_STEPS for n, v in per_step.items()}:
            fail(f"{tag}: the train run counted {trained} launches")

        gaps = dict(plain_gap=gap(plain2_rec, plain2_grads, plain_rec, plain_grads),
                    kernel_gap=gap(kern_rec, kern_grads, plain_rec, plain_grads),
                    library_gap=gap(lib_rec, lib_grads, plain_rec, plain_grads))
        labels = ("plain vs plain", "kernels vs plain", "library vs plain")
        for label, (loss_gap, grad_gap, leaves) in zip(labels, gaps.values()):
            print(f"[{tag}] {label}: loss rel {loss_gap:.3e} (tol {loss_tol:.0e}), step-1 grads "
                  f"rel L2 {grad_gap:.3e} (tol {grad_tol:.0e}), worst leaves "
                  f"{[(n, f'{v:.3e}') for v, n in leaves]}")
        if f64_reference:
            model64 = model.to(torch.float64)
            batch64 = {k_: (Complex(v.re.double(), v.im.double()) if isinstance(v, Complex)
                            else v.double()) for k_, v in batch.items()}
            with float64_plain():
                rec64, grads64 = train_run(model64, init, batch64, 1)
            model.to(torch.float32)
            del model64, batch64
            gaps["f64_gaps"] = {label: gap(rec, grads, rec64, grads64) for label, rec, grads in (
                ("plain", plain_rec, plain_grads), ("kernels", kern_rec, kern_grads),
                ("library", lib_rec, lib_grads))}
            print(f"[{tag}] first step against the plain versions in float64: " + "; ".join(
                f"{label} loss rel {g[0]:.3e}, grads rel L2 {g[1]:.3e}"
                for label, g in gaps["f64_gaps"].items()))
            ratio = gaps["f64_gaps"]["kernels"][1] / gaps["f64_gaps"]["plain"][1]
            if not ratio <= F64_RATIO:
                fail(f"{tag}: the kernels' first-step gradient is {ratio:.2f}x as far from the f64 "
                     f"gradient as the plain versions' (limit {F64_RATIO})")
        for label, (loss_gap, grad_gap, _) in zip(labels, gaps.values()):
            if not (loss_gap <= loss_tol and grad_gap <= grad_tol):
                fail(f"{tag}: train run, {label}, is outside the tolerances: {loss_gap}, {grad_gap}")

        ms_step = statistics.median(kern_rec["ms"][1:])
        for label, rec in (("kernels", kern_rec), ("plain versions", plain_rec),
                           ("plain versions, again", plain2_rec), ("library calls", lib_rec)):
            print(f"[{tag}] {label}: ms/step {[round(x, 3) for x in rec['ms']]}, "
                  f"loss {rec['loss']}, grad_norm {rec['grad_norm']}")
        print(f"[{tag}] kernels, remat on: {ms_step:.3f} ms/step (median of steps 2-{TRAIN_STEPS}), "
              f"{1e3 / ms_step:.3f} volumes/s, peak memory {peak / 2**20:.1f} MiB")

        model.load_state_dict(init)
        pstate = create_train_state(model, device=dev)
        pstate, _ = train_step(pstate, batch)
        profile_ = profiled(lambda: train_step(pstate, batch))
        print(f"[{tag}-profile] " + json.dumps(profile_))
        return dict(init=init, batch=batch, kernels=kern_rec, plain=plain_rec,
                    plain_again=plain2_rec, library=lib_rec, ms_per_step=ms_step,
                    volumes_per_s=1e3 / ms_step, peak_memory_bytes=peak, launches=trained,
                    launches_per_step=per_step, profile=profile_, timers=(tkern, tplain, tlib),
                    **gaps)

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
    # an ifft2c of the contiguous flagship k-space copies nothing
    FFT.COPIES = 0
    with torch.inference_mode():
        FFT.ifft2c(k)
    print(f"[forward] _apply_dft copies in an ifft2c of the (1, {T}, {C}, {H}, {W}) k-space: {FFT.COPIES}")
    if FFT.COPIES:
        fail(f"an ifft2c of the contiguous k-space made {FFT.COPIES} copies")
    # PR 3 copied 5 times per VarNet forward, 3 per CineNet forward
    vfwd = forward_phase("forward", forward, expected, 5)
    # one warm forward under the profiler: device time by kernel kind, idle share
    print("[profile] " + json.dumps(profiled(forward)))

    # -- 4. serve: four requests through the serving entry, three times -----------
    requests = [(RandomMask([10], [4]), s) for s in (0, 1, 2)] + [(EquispacedMask([0.08], [4]), 3)]
    vserve = serve_phase("serve", bind_model(model, device=dev),
                         [flagship_inputs(torch, mf, s, dev) for mf, s in requests],
                         expected, vfwd.pop("out"), vfwd["scale"])

    # -- 5. train: four full-width VarNet-XF train steps, four times ----------------
    del model, k
    torch.cuda.empty_cache()
    tmodel = build_model("varnet", "XF", device=dev, generator=torch.Generator().manual_seed(0),
                         **FLAGSHIP)  # remat on, as the JAX package trains
    # per step, with remat: the forward's 24 DFTs and 10 normal applies, the
    # replay of each cascade in the backward (2 DFTs and 1 normal apply per
    # cascade), and the backward of the cascades' DFTs (2 per cascade, on Wᴴ)
    # and normal applies (1 per cascade); the sens net's and x_ref's 4 DFTs
    # act on data and have no backward
    vtrain = train_phase("train", tmodel, train_batch(torch, dev),
                         {"dft": 4 + 2 * nc + 2 * nc + 2 * nc, "normal": nc + nc, "normal_bwd": nc})

    # without remat: every cascade's activations kept for the backward
    tmodel.remat = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    noremat_rec, _ = train_run(tmodel, vtrain.pop("init"), vtrain.pop("batch"), 3)
    noremat_peak = torch.cuda.max_memory_allocated()
    noremat_ms = statistics.median(noremat_rec["ms"][1:])
    print(f"[train] kernels, remat off: {noremat_ms:.3f} ms/step (median of steps 2-3, "
          f"{[round(x, 3) for x in noremat_rec['ms']]}), peak memory {noremat_peak / 2**20:.1f} MiB")
    vtrain["no_remat"] = dict(steps=noremat_rec, ms_per_step=noremat_ms, peak_memory_bytes=noremat_peak)
    del tmodel
    torch.cuda.empty_cache()

    # -- 6. CineNet-XF at full width: forward, λ on the device, serving ---------------
    cmodel = build_model("cinenet", "XF", device=dev,
                         generator=torch.Generator().manual_seed(0), **CINENET).eval()
    kre, kim, mask = flagship_inputs(torch, RandomMask([10], [4]), 0, dev)
    ck, cs = Complex(kre, kim), Complex(*rss_maps(torch, 0, dev))

    def cforward():
        with torch.inference_mode():
            return cmodel(ck, mask, cs)

    # per forward: image_ref's ifft2c (2 DFTs), then per cascade one fft1c and
    # one ifft1c over t, and a CG solve: one normal apply for the initial
    # residual and one per iteration
    cnc, cgi = CINENET["num_cascades"], CINENET["cg_iters"]
    c_expected = {"dft": 2 + 2 * cnc, "normal": cnc * (1 + cgi)}
    cfwd = forward_phase("cinenet-forward", cforward, c_expected, 3)
    print("[cinenet-profile] " + json.dumps(profiled(cforward)))

    # a warm forward (DFT-matrix and λ caches built) makes no host sync: λ
    # = softplus(λᵢ) reaches the kernels on the device
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sync_out = cforward()
    except RuntimeError as e:
        fail(f"a warm CineNet forward synchronized with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    sync_err = (sync_out - cfwd["out"]).abs().max().item()
    print(f"[cinenet-forward] one warm forward under set_sync_debug_mode('error'): no sync; "
          f"max_abs_err vs the first forward {sync_err:.3e}")
    if not sync_err <= MODEL_TOL * cfwd["scale"]:
        fail(f"the forward under sync debug mode differs from the first: {sync_err}")
    del sync_out

    cserve = serve_phase("cinenet-serve", bind_model(cmodel, device=dev),
                         [flagship_inputs(torch, mf, s, dev) + rss_maps(torch, s, dev)
                          for mf, s in requests],
                         c_expected, cfwd.pop("out"), cfwd["scale"])

    # -- 7. CineNet-XF train: four full-width steps, four times ------------------------
    del cmodel, ck, cs
    torch.cuda.empty_cache()
    ctmodel = build_model("cinenet", "XF", device=dev, generator=torch.Generator().manual_seed(0),
                          **CINENET)  # remat on
    cbatch = train_batch(torch, dev, sens_maps=True)
    # per step, with remat: the forward's 22 DFTs and 70 normal applies; the
    # replay of each cascade (2 DFTs and 7 normal applies: torch's
    # non-reentrant checkpoint replays up to the last saved tensor, the
    # last CG step's x update, which follows its normal apply); the backward
    # of the normal applies (7 per cascade) and of the cascades' DFTs but
    # one: image_ref's 2 DFTs and cascade 0's fft1c act on data (the maps
    # are an input, not learned as VarNet's) and have no backward
    ctrain = train_phase("cinenet-train", ctmodel, cbatch,
                         {"dft": (2 + 2 * cnc) + 2 * cnc + (2 * cnc - 1),
                          "normal": 2 * cnc * (1 + cgi), "normal_bwd": cnc * (1 + cgi)},
                         CINENET_TRAIN_LOSS_TOL, CINENET_TRAIN_GRAD_TOL, f64_reference=True)

    # the host syncs of one warm step, each named by the port's frame that made it
    ctmodel.load_state_dict(ctrain.pop("init"))
    sstate = create_train_state(ctmodel, device=dev)
    sstate, _ = train_step(sstate, cbatch)
    torch.cuda.synchronize()
    syncs = []

    def record_sync(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "warnings" not in f.filename]
        ours = [f for f in frames if "cinemri_tpu_torch" in f.filename]
        at = ours[-1] if ours else frames[-1]
        syncs.append(f"{Path(at.filename).name}:{at.lineno} {at.name}: {str(message)[:120]}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record_sync
        torch.cuda.set_sync_debug_mode("warn")
        try:
            train_step(sstate, cbatch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    sync_names = sorted(set(syncs))
    print(f"[cinenet-train] host syncs in one warm step (sync debug mode 'warn'): {len(syncs)}; "
          f"{[(n, syncs.count(n)) for n in sync_names]}")
    ctrain.update(host_syncs_per_step=len(syncs), host_syncs=sync_names)
    del ctmodel, sstate, cbatch, ctrain["batch"]
    torch.cuda.empty_cache()

    # -- 8. report -------------------------------------------------------------------
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
    fft2_src = ("fft2_plane", "cinemri_tpu_torch/csrc/fft2_plane.cu",
                "cinemri_tpu/ops/kernels/fft2_pallas.py:45")
    rows = []
    for run, srv in (("serve", vserve), ("cinenet-serve", cserve)):
        rows += [row(*dft_src, run, srv["launches"]["dft"], srv["kern"][0], srv["plain"][0], srv["lib"][0]),
                 row(*fwd_src, run, srv["launches"]["normal"], srv["kern"][1], srv["plain"][1],
                     srv["lib"][1])]
    for run, tr in (("train", vtrain), ("cinenet-train", ctrain)):
        tkern, tplain, tlib = tr.pop("timers")
        rows += [row(*src, run, tr["launches"][key], tkern[i], tplain[i], tlib[i])
                 for i, (src, key) in enumerate(((dft_src, "dft"), (fwd_src, "normal"),
                                                 (bwd_src, "normal_bwd")))]
    rows.append(row(*fft2_src, "check", fft2_launches, *fft2_runs))
    for srv in (vserve, cserve):
        for key in ("kern", "plain", "lib"):
            srv.pop(key)
    print("[details] " + json.dumps(dict(
        cases=cases, forward=vfwd, serve=vserve, train=vtrain,
        cinenet=dict(config=CINENET, forward=cfwd, serve=cserve, train=ctrain))))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
