#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``cinemri_tpu_torch/csrc`` with nvcc
(one nvcc per source, in parallel) and holds each kernel against its plain
PyTorch version and one library call at the shapes of the serving and
training paths: the DFT at the six ``(O, N, I)`` layouts of the path and two
ragged ones; the normal apply and its backward at four flagship cases, the
forward also beside its contraction alone as one complex64 ``matmul``, the
backward beside its two contractions alone as two; the
fused 2-D DFT ``fft2_plane``, which no path runs (as in the JAX package),
at the 2-D DFT shapes of the ported paths, beside the two 1-D DFT launches
that ``ifft2c`` makes today and cuFFT. Each is also timed on the device
alone (CUDA graphs, no host launch overhead), and it times the cascades'
temporal DFT on both layouts it could take (``[layout]``).

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
four train runs, one profiled step and the host syncs of one step, and the
same four steps with the normal apply on the fused FP32 tile
(``normal_cuda.set_fp32_tile('fused')``, ``[cinenet-train-fused]``: every
call on it, the losses against the engine route's).
XPDNet-XF (9 cascades, MWCNN 16/32/64, n_primal 5, kernel DC): the kernels
first on its new operands (the DFT on the alt matrices at (1, 15, 240000)
and its backward, the inverse at (1, 15, 200000), the normal apply with
λ = 0.0 on the strided head of its channel-last buffer, and its backward),
then the same forward (its input copies counted), profile, serving and four
train runs, with the host syncs of one step; its forwards and its
gradients are held against float64, as it amplifies f32 rounding (the
sensitivity to a 1e-7 perturbation is printed). XPDNet-2D, XT and the
``primal_only=False`` XF: one request each three ways (``[xpdnet-variants]``).
VarNet and CineNet 2D and 3D: one request each three ways and five timed
forwards (``[cascades-2d3d]``), and two train steps of each 3D model
through the plain versions, library calls and kernels. The CRNN variants at
the JAX package's protocol widths (VarNet-CRNN 10 iterations, chans 16, sens
net 8/3; CineNet-CRNN 10 iterations, 6 CG iterations, chans 16, with maps;
XPDNet-CRNN 9 iterations, chans 18, n_primal 5, kernel DC): for each, how
far a 1e-7 perturbation of the k-space moves the output, the forward
(launches, copies, ms per volume, peak memory, one warm forward under
``set_sync_debug_mode("error")``), one profiled forward, four requests
three ways, and train runs (4 steps for VarNet-CRNN, 3 for the others) four
times with one profiled step and the host syncs of a step
(``[varnet-crnn-*]``, ``[cinenet-crnn-*]``, ``[xpdnet-crnn-*]``);
XPDNet-CRNN with ``primal_only=False`` one request three ways
(``[xpdnet-crnn-dual]``).

Then the host data path feeds the card. ``[data]``: two raw volumes in the
on-disk layout (18 frames x 10 coils x 224x224) through ``preprocess_volume``
with both ESPIRiT engines (numpy, and the C++ library built by g++), the two
held against each other, and VarNet and CineNet samples built from them
(CineNet's maps by ESPIRiT at r=15; one sample compressed to 6 virtual
coils), all timed on the host. ``[data-serve]``: those samples answered as
requests by the same VarNet-XF and CineNet-XF, through the kernels, the
plain versions and library calls, and one CineNet request at 10 and one at
6 coils profiled. ``[soft-sense]``: the soft-SENSE CG
reconstruction over two ESPIRiT map sets of volume 0 (46 DFT launches),
timed and profiled.
``[queue3]``: two volumes sharing a batch-1 K and batch-1 maps. The script
prints whether h5py is importable; nothing here needs it.

Then the training system, ``[loop]``: the flagship VarNet-XF fitted by
``cinemri_tpu_torch.train.Trainer`` on ``[data]``'s two decoded volumes
(held by an in-memory dataset, ``MemoryDataset``): 2 epochs of batch 1
with validation on volume 1 and a checkpoint per epoch, through the
kernels with the device cache, the plain versions, library calls and the
kernels without the cache, from the same initial weights; ms per step inside
the loop beside the bare step of ``[train]``, the host's share around it,
validation ms per volume, host -> device bytes per step, checkpoint size
and save time; then the latest checkpoint restored bit-identically into a
fresh Trainer, ``test()`` (SSIMs.csv) and one ``InferenceRunner`` request
(the three .npy files). The phase must take under 60 s of wall time.

Then data parallelism, ``[ddp]``: the flagship VarNet-XF trained 3 steps by
the data-parallel step on a one-rank NCCL group started in this process
(one gradient all-reduce of 4,330,176 bytes and 2 scalar ones per step,
counted; the kernel launches of the plain step) and 3 by the plain step,
from the same weights, in turns; the same data-parallel run through the
plain versions and library calls; one gradient-sized NCCL all-reduce
alone; ``Trainer.fit`` on that one-rank mesh against the fit without a mesh,
wall ms per step. Then two gloo ranks in two processes sharing the card (NCCL refuses
two ranks on one card; gloo carries the CUDA tensors through the host), one
volume each of a global batch of 2, held against this process training both
volumes in one batch, and their ``Trainer.fit`` (2 epochs of ``[loop]``'s
volumes) with a checkpoint restored on both ranks. Every process group has a
timeout, and a rank that fails or hangs fails the run.

Then the plane and coil mesh axes, ``[mesh]``: two gloo ranks in two
processes sharing the card run the flagship VarNet-XF on ``{plane: 2}`` (100
of the 200 planes of each plane batch per rank) and on ``{coil: 2}`` (5 of
the 10 coils per rank, the normal apply and its backward on 5-coil shards),
a forward and 2 train steps each, CineNet-XF's forward on ``{coil: 2}`` (λ
added once after the coil all-reduce, through the CG), and ``Trainer.fit``
(1 epoch) on ``{coil: 2}`` with a checkpoint restored on both ranks; each
held against this process's one-process run from the same weights, each
forward and step launching the kernels as the one-process path does and
making the collectives counted in ``MESH_*_COLLECTIVES``. The phase must
take under 120 s of wall time. Its times are of a host-carried (gloo)
collective on one shared card, not of NVLink scaling.

The kernels are reached through the custom ops ``torch.ops.cinemri.*``:
``[custom-op]`` times each kernel's call through its op against its wrapper
alone, and ``[cinenet-profile-dft]`` counts a CineNet forward's DFT launches,
the op's host events and the DFT kernel records in one ``instrument.trace``
window (one and two forwards). After ``[mesh]``, ``[profile]``:
``Trainer.fit`` of the flagship with ``profile_steps=2``, whose trace must
hold each port kernel as often as the counters' launches over the traced
steps (times its kernels per launch) and each op's host events once per
launch; then ``[interop-export]``: reference-layout Lightning checkpoints of
the flagship VarNet-XF and of CineNet-XF (with maps), written from a seed by
``interop.reference_layout``, imported by ``interop.import_torch_checkpoint``
and served, 4 requests each, through ``serve.bind_model`` and through a
``torch.export`` artifact (``serve.export_model`` -> file ->
``serve.load_exported``) with equal launches and images, then timed in
turns; it must take under 120 s.

Then the precision modes, bf16 activations and remat policies.
``[precision]``: the DFT at (150, 200, 200), (30000, 200, 1), (1, 15, 40000)
and (40000, 15, 1) and the normal apply and its backward at the flagship
shape in the TF32 modes 'high' (3xTF32) and 'default' (1xTF32) of the
tensor-core tile (the N = 15 DFTs run the FP32 kernel in every mode), each
against its emulating plain version (TF32_TOL), against 'highest', timed
beside its TF32 bound and the complex64 library call (TF32 for 'default');
then each call's kernels by name under the profiler at every mode, 'highest'
with every contraction on the FP32 tile and ȳ on the copy Kᴴ; last the
fused FP32 tile at 'highest' at the flagship cases, against the plain
version, its bits against the engine route's, both timed, and its kernels
by name.
``[bf16]``: the flagship VarNet-XF served (4 requests) and fitted (3 steps)
in f32 at 'highest' and in bf16 at 'highest', 'high' and 'default' (ms per
volume, ms per step, peak memory, the bf16 images against f32 at the JAX
package's bound, the launches at each mode); the 'high' and 'default' runs
timed call by call and repeated through the plain versions (held against
the kernels' run) and the library calls; and one bf16 forward each of
CineNet-XF and XPDNet-XF.
``[remat]``: under each remat policy, one flagship train step with cuDNN's
deterministic algorithms (its gradients against full replay's), then three
timed steps with cuDNN's defaults. The ``[build]`` line names the
compile cache's directory, and a second build of the run must be a hit.

Last, the space-to-depth (packed) conv stacks, ``[packed]``: VarNet-3D (the
flagship's widths) and XPDNet-CRNN (the packed-carry iterations) with the
same weights dense and packed: four requests through ``serve`` each way in
f32 and bf16, the packed f32 ones also through the plain versions and the
library calls, two train steps each way (the packed ones three ways) and
two in bf16; then one request packed against dense for VarNet-2D,
CineNet-2D and 3D, VarNet- and CineNet-CRNN and XPDNet-2D. Packed is held
to the dense run: 1e-4 x max where the model is not order-sensitive,
against float64 where it is, the bf16 bound against f32 in bf16, VarNet's
train tolerances.

It checks that each kernel run launched every kernel as many times as the
path calls it and that the runs agree. Any failure ends the run with a
non-zero exit code.

Output, last three lines: one JSON object with a row per kernel and run
(``"serve"``, ``"train"``, ``"cinenet-serve"``, ``"cinenet-train"``,
``"xpdnet-serve"``, ``"xpdnet-train"``, ``"xpdnet-variants"``,
``"cascades-2d3d"``, ``"varnet-3d-train"``, ``"cinenet-3d-train"``,
``"varnet-crnn-serve"``, ``"varnet-crnn-train"``, the same two for
``cinenet-crnn`` and ``xpdnet-crnn``, ``"xpdnet-crnn-dual"`` (its DFT only),
``"data-serve"``, ``"soft-sense"``, ``"loop"``, ``"ddp"``, ``"mesh"`` (rank 0's 2
steps on ``{coil: 2}``), ``"packed-serve"`` and ``"packed-train"`` (``[packed]``'s
eight f32 requests and four steps) and, for ``fft2_plane``,
``"check"``; the TF32 modes as their own rows, ``complex_dft_matmul[high]``
... ``normal_apply_bwd[default]``, from ``[bf16]``'s run at that mode and
its repeats through the plain versions and the library calls, with the
largest error of ``[precision]``'s checks); the fused FP32 tile's rows
``normal_apply[highest fused]`` and ``normal_apply_bwd[highest fused]``
from ``"cinenet-train-fused"`` (the plain versions' and library calls' times
over the engine route's run of the same steps), the card's
name and power limit as nvidia-smi
reports them, and ``{"ok": true, "device": {...}}``. A row's ``ms``,
``plain_ms`` and ``library_ms`` sum CUDA-event times taken around every
call of that function in its run (the four serve requests, the four train
steps, the whole ``[loop]`` fit, the 3 data-parallel steps of ``[ddp]``, rank
0's 2 coil-axis steps of ``[mesh]``, ``[bf16]``'s serving and fit at a TF32
mode, or one call at each of the four check shapes); ``bound_ms`` sums the
bound of each call of the kernel run (at the TF32 rate for the TF32 rows). The line before them, ``[details]
{...}``, holds the per-shape microbenchmarks and every other number.

Imports nothing of JAX. Exits non-zero without a CUDA device, or when the
``cinemri_tpu_torch`` package is not beside this file.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
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
from typing import Dict

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
# the JAX package's protocol XPDNet (bench/_protocol.py CONFIGS["xpdnet"]),
# with its defaults: one first conv of 16, (2, 2, 2) convs, primal only,
# kernel DC
XPDNET = dict(num_cascades=9, sens_chans=8, sens_pools=3, n_scales=3,
              n_filters_per_scale=(16, 32, 64), n_convs_per_scale=(2, 2, 2), n_first_convs=1,
              first_conv_n_filters=16, n_primal=5, primal_only=True, kernel_dc=True)
# the JAX package's protocol CRNN models (bench/_protocol.py CRNN_CONFIGS, the
# CLI defaults), kernel DC on
VARNET_CRNN = dict(num_cascades=10, sens_chans=8, sens_pools=3, chans=16)
CINENET_CRNN = dict(num_cascades=10, cg_iters=6, chans=16)
XPDNET_CRNN = dict(num_cascades=9, sens_chans=8, sens_pools=3, chans=18, n_primal=5)
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
# output written once. The wrappers take a trailing precision, which the
# costs, the library preps and the stand-ins below accept and ignore.
def dft_cost(xr, xi, wr, wi, precision="highest"):
    o, n, i = xr.shape
    return 8.0 * o * n * n * i, 4.0 * (4 * o * n * i + 2 * n * n)


def normal_cost(xr, xi, kr, ki, sr, si, lam, precision="highest"):
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


def normal_bwd_cost(xr, xi, gr, gi, kr, ki, sr, si, lam, precision="highest"):
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
    def prep(xr, xi, wr, wi, precision="highest"):
        x, w = torch.complex(xr, xi), torch.complex(wr, wi)
        return x, w, xr.shape[2] > 1

    def call(x, w, slabs):
        if slabs:
            return torch.matmul(w, x)
        return torch.matmul(x.reshape(x.shape[0], -1), w.T).view(x.shape)

    return prep, call


def normal_library(torch):
    def prep(xr, xi, kr, ki, sr, si, lam, precision="highest"):
        b, t, h, _ = xr.shape
        s = torch.complex(sr, si)
        return torch.complex(xr, xi), torch.complex(kr, ki).expand(b, t, h, h), s, s.conj(), lam

    def call(x, k, s, sc, lam):
        return torch.einsum("bckw,btkw,btik,bciw->btiw", s, x, k, sc) + lam * x

    return prep, call


def contraction_matmul(torch, normal_cuda, xr, xi, kr, ki, sr, si):
    """The normal apply's contraction alone, the same 8·b·t·c·h²·w FLOP as
    one complex64 ``matmul``: each K on its coil-stacked ``S⊙x`` (h x G·w,
    G the slabs sharing that K), stacked outside the timed call. Returns
    the call."""
    b, t, h, w = xr.shape
    kt = kr.shape[1]
    y = torch.complex(*normal_cuda.coil_products(sr, si, xr, xi))  # (b·t·c, h, w)
    g = y.shape[0] // (b * kt)
    stacked = y.reshape(b * kt, g, h, w).transpose(1, 2).reshape(b * kt, h, g * w).contiguous()
    k = torch.complex(kr, ki).reshape(b * kt, h, h)
    return lambda: torch.matmul(k, stacked)


def fft2_library(torch):
    """One complex64 ``einsum`` for ``W_h · X[b] · W_wᵀ``."""
    def prep(xr, xi, whr, whi, wwr, wwi):
        return torch.complex(whr, whi), torch.complex(xr, xi), torch.complex(wwr, wwi)

    def call(wh, x, ww):
        return torch.einsum("ij,bjk,lk->bil", wh, x, ww)

    return prep, call


def bwd_contractions_matmul(torch, normal_cuda, xr, xi, gr, gi, kr, ki, sr, si):
    """The backward's two contractions alone, ȳ = Kᴴ·(S⊙g) and z = K·(S⊙x),
    the same 16·b·t·c·h²·w FLOP as two complex64 ``matmul`` calls on the
    coil-stacked operands (Kᴴ and the stacks made outside the timed call).
    Returns the call."""
    b, t, h, w = xr.shape
    kt = kr.shape[1]

    def stacked(ur, ui):
        y = torch.complex(*normal_cuda.coil_products(sr, si, ur, ui))  # (b·t·c, h, w)
        g = y.shape[0] // (b * kt)
        return y.reshape(b * kt, g, h, w).transpose(1, 2).reshape(b * kt, h, g * w).contiguous()

    k = torch.complex(kr, ki).reshape(b * kt, h, h)
    kh = k.conj().transpose(1, 2).contiguous()
    v, y = stacked(gr, gi), stacked(xr, xi)
    return lambda: (torch.matmul(kh, v), torch.matmul(k, y))


def normal_bwd_library(torch):
    """``torch.autograd.grad`` through the one-einsum complex64 forward of
    :func:`normal_library` (the forward included): no single PyTorch call
    computes this backward."""
    def prep(xr, xi, gr, gi, kr, ki, sr, si, lam, precision="highest"):
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


def normal_bwd_op_library(torch):
    """:func:`normal_bwd_library` in the slot of the op
    ``normal_cuda.normal_apply_bwd_op`` (its last two arguments are the
    ``plain`` flag and the precision), which the normal apply's gradient
    calls with autograd on: inside the op's own implementation autograd's
    dispatch keys are excluded, and the yardstick's ``autograd.grad`` could
    not record there."""
    prep, call = normal_bwd_library(torch)
    return (lambda *args: prep(*args[:-2])), call


def normal_bwd_op_cost(*args):
    """:func:`normal_bwd_cost` of the op's arguments (the ``plain`` flag and
    the precision last)."""
    return normal_bwd_cost(*args[:-2])


class Timed:
    """Stands in for ``module.<attr>`` while entered: each call runs ``fn``
    between two CUDA events on the current stream and keeps the events and
    the call's (FLOP, bytes). ``prep`` (untimed, before) turns the pair
    arguments into ``fn``'s; a complex result is split back into a pair.
    While entered, every CG solve runs its eager loop (``physics/cg.py``):
    a CUDA graph's replay would launch the kernels without calling ``fn``."""

    def __init__(self, torch, module, attr, cost, fn=None, prep=None):
        self.torch, self.module, self.attr, self.cost = torch, module, attr, cost
        self.fn, self.prep = fn or getattr(module, attr), prep
        self.calls = []

    def __enter__(self):
        from cinemri_tpu_torch.physics import cg

        self.saved = getattr(self.module, self.attr)
        self.blocker = cg.graph_blocker
        setattr(self.module, self.attr, self)
        cg.graph_blocker = lambda tensors, coil_axis="": "timed"
        return self

    def __exit__(self, *exc):
        from cinemri_tpu_torch.physics import cg

        setattr(self.module, self.attr, self.saved)
        cg.graph_blocker = self.blocker

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


class GCTimer:
    """Milliseconds the garbage collector ran while entered (``gc.callbacks``):
    a full collection holds the host, and with it the kernel launches, for
    hundreds of ms."""

    def __init__(self):
        self.ms, self._t0 = 0.0, 0.0

    def __call__(self, stage, info):
        if stage == "start":
            self._t0 = time.perf_counter()
        else:
            self.ms += (time.perf_counter() - self._t0) * 1e3

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


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


def train_batch(torch, device, sens_maps: bool = False, seed: int = 0):
    """The JAX package's train-step batch (``bench/train_step.py``): k-space
    from ``default_rng(seed)`` under ``RandomMask([10], [4])(15, 200,
    seed=seed)`` (seed 0 there), target = |k| averaged over coils; with
    ``sens_maps``, RSS-normalized maps drawn next from the same generator, as
    that script gives CineNet."""
    from cinemri_tpu_torch.data.masks import RandomMask
    from cinemri_tpu_torch.ops.cplx import Complex

    rng = np.random.default_rng(seed)
    shape = (1, T, C, H, W)
    k = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    mask = RandomMask([10], [4])(T, H, seed=seed)[None].astype(np.float32)
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


def host_data_phase():
    """``[data]``: two raw volumes in the on-disk layout (``hf["y"]`` of
    ``write_hdf5_volume``, made in memory: 18 frames x 10 coils x 224x224,
    noise 2e-3, seeds 0 and 1), ``preprocess_volume`` with the default
    ``PreprocessConfig`` (crop 200x200, 15 frames, target 180x180,
    calibration 200) by the numpy ESPIRiT (both volumes) and the C++ one
    (volume 0; it takes several times as long), the two engines held
    against each other with tests/test_native.py's measures (the targets
    where the leading eigenvector is well defined, see below); then VarNet
    and CineNet samples (``RandomMask([10], [4])``, CineNet's maps by ESPIRiT
    at r=15) and one CineNet sample compressed to 6 virtual coils. Host
    numbers only; returns the samples and the numbers."""
    import dataclasses
    import importlib.util
    import os
    import platform

    from cinemri_tpu_torch import native
    from cinemri_tpu_torch.data import (CineNetDataTransform, PreprocessConfig, RandomMask,
                                        VarNetDataTransform, center_crop, preprocess_volume,
                                        synthetic)
    from cinemri_tpu_torch.data.espirit import espirit_maps_multi

    # the first processor's identification in /proc/cpuinfo (x86 names a
    # "model name"; Arm gives implementer and part numbers)
    with open("/proc/cpuinfo") as f:
        first = f.read().split("\n\n")[0]
    fields = dict((k.strip(), v.strip()) for k, _, v in
                  (line.partition(":") for line in first.splitlines()) if v.strip())
    cpu = "; ".join(f"{k}: {fields[k]}" for k in ("model name", "vendor_id", "cpu family", "model",
                                                 "CPU implementer", "CPU part", "CPU variant")
                    if k in fields) + f" ({platform.machine()})"
    has_h5py = importlib.util.find_spec("h5py") is not None
    print(f"[data] host CPU: {cpu}, {os.cpu_count()} logical CPUs; h5py importable: {has_h5py} "
          f"(no phase needs it)")
    # each engine is picked by its config below, not by the environment
    os.environ.pop("CINEMRI_ESPIRIT_ENGINE", None)
    t0 = time.perf_counter()
    lib = native.build_library()
    build_s = time.perf_counter() - t0
    print(f"[data] native ESPIRiT: g++ {' '.join(native.GXX_FLAGS)} -> "
          f"{lib.relative_to(ROOT)} in {build_s:.2f} s")

    raws, gen_s = [], []
    for seed in (0, 1):
        t0 = time.perf_counter()
        vol = synthetic.synthetic_volume(num_frames=18, num_coils=C, h=224, w=224, noise=2e-3,
                                         seed=seed)
        raws.append((vol["kspace"].transpose(0, 2, 3, 1) / 1e6).astype(np.complex64))
        gen_s.append(time.perf_counter() - t0)
    cfg = PreprocessConfig()
    decoded, seconds = [], {"numpy": [], "native": []}
    for raw in raws:
        t0 = time.perf_counter()
        decoded.append(preprocess_volume(raw, cfg))
        seconds["numpy"].append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    nat = preprocess_volume(raws[0], dataclasses.replace(cfg, espirit_engine="native"))
    seconds["native"].append(time.perf_counter() - t0)
    print(f"[data] raw volume {raws[0].shape} {raws[0].dtype}, made in "
          f"{[round(s, 3) for s in gen_s]} s; preprocess_volume host s per volume: numpy ESPIRiT "
          f"{[round(s, 3) for s in seconds['numpy']]}, native ESPIRiT (volume 0) "
          f"{[round(s, 3) for s in seconds['native']]}")
    want = {"kspace": (T, C, H, W), "sens": (C, H, W), "target": (T,) + cfg.crop_target}
    for out in decoded + [nat]:
        got = {k: out[k].shape for k in want}
        if got != want or not all(np.isfinite(out[k]).all() for k in want):
            fail(f"data: preprocess_volume gave shapes {got} (want {want}) or non-finite values")
    print(f"[data] shapes: k-space {want['kspace']}, maps {want['sens']}, target {want['target']}")

    # The engines agree where the pointwise operator's leading eigenvector is
    # well defined. Where its top two eigenvalues are within 1e-2 (background
    # pixels at calibration 200), the C++ power iteration (400 steps,
    # converging as (λ2/λ1)^n) stops short of the numpy eigh's vector, so a
    # few target pixels there differ by more: they are counted, not held.
    a, b = decoded[0]["target"], nat["target"]
    err = np.abs(a - b) / a.max()
    _, eig = espirit_maps_multi(decoded[0]["kspace"].mean(axis=0), num_maps=2,
                                calib_size=cfg.calib_size, return_eigenvalues=True)
    sup = eig[0] > 0.9
    map_err = float(np.median(np.abs(np.abs(nat["sens"]) - np.abs(decoded[0]["sens"]))[:, sup]))
    separated = center_crop(eig[0] - eig[1], cfg.crop_target) >= 1e-2
    target_err = float(err[:, separated].max())
    print(f"[data] engines, volume 0: targets max |numpy - native| / max {target_err:.3e} (tol 5e-3) "
          f"where the top two eigenvalues are >= 1e-2 apart ({separated.mean():.4f} of the pixels); "
          f"over all pixels {float(err.max()):.3e}, {int((err > 5e-3).sum())} of {err.size} values "
          f"above 5e-3, 99.9th percentile {float(np.quantile(err, 0.999)):.3e}; median "
          f"map-magnitude error where the eigenvalue > 0.9 ({int(sup.sum())} pixels) {map_err:.3e} "
          f"(tol 1e-4)")
    if not (sup.any() and separated.mean() > 0.9 and target_err <= 5e-3 and map_err < 1e-4):
        fail(f"data: the two ESPIRiT engines disagree: targets {target_err}, maps {map_err}")

    names = ("vol00.h5", "vol01.h5")

    def samples(transform, volumes):
        out, ms = [], []
        for i in volumes:
            t0 = time.perf_counter()
            out.append(transform(decoded[i]["kspace"], None, decoded[i]["target"], {}, names[i], 0))
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, ms

    vs, vms = samples(VarNetDataTransform(RandomMask([10], [4])), (0, 1))
    cs, cms = samples(CineNetDataTransform(RandomMask([10], [4])), (0, 1))
    c6, c6ms = samples(CineNetDataTransform(RandomMask([10], [4]), compress_coils=6), (0,))
    for s, c, maps in [(s, C, False) for s in vs] + [(s, C, True) for s in cs] + [(c6[0], 6, True)]:
        shapes = (s["masked_kspace"].shape, s["mask"].shape, s["sens_maps"].shape if maps else None)
        if shapes != ((T, c, H, W), (T, 1, H, 1), (1, c, H, W) if maps else None):
            fail(f"data: a sample has shapes {shapes}")
    print(f"[data] host ms per sample: VarNetDataTransform {[round(x, 3) for x in vms]}, "
          f"CineNetDataTransform (ESPIRiT r=15) {[round(x, 3) for x in cms]}, "
          f"CineNetDataTransform(compress_coils=6) {[round(x, 3) for x in c6ms]}")
    return dict(decoded=decoded, names=names, varnet_samples=vs, cinenet_samples=cs,
                cinenet6_sample=c6[0],
                host_cpu=cpu, h5py_importable=has_h5py, native_build_s=build_s,
                volume_s=gen_s, preprocess_s=seconds, engines_target_rel_err=target_err,
                engines_target_rel_err_all=float(err.max()),
                engines_target_values_above_tol=int((err > 5e-3).sum()),
                engines_separated_share=float(separated.mean()),
                engines_map_median_err=map_err, varnet_sample_ms=vms, cinenet_sample_ms=cms,
                cinenet6_sample_ms=c6ms)


def queue3_phase(torch, dev, set_backends):
    """``[queue3]``: b = 2 volumes sharing a batch-1 K and batch-1 maps (the
    case of ROADMAP Queue 3), through the kernels against the plain
    versions: the operator at full width, and the small CineNet-XF of the
    CPU test (2 cascades, 2 CG iterations, chans 4, pools 2, t = 4, c = 3,
    16x16) on one mask ``(1, 1, 1, h, 1)``."""
    from cinemri_tpu_torch.data.masks import RandomMask
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops.cplx import Complex
    from cinemri_tpu_torch.ops.kernels import normal_cuda
    from cinemri_tpu_torch.physics import operators as OPS

    rng = np.random.default_rng(1)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    cplx = lambda *shape: (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))

    def unit_rss(s):
        return s / np.sqrt((np.abs(s) ** 2).sum(2, keepdims=True))

    def both(fn, launches):
        """``fn`` through the kernels (its normal-apply launches counted),
        then through the plain versions."""
        before = normal_cuda.LAUNCHES
        got = fn()
        torch.cuda.synchronize()
        launched = normal_cuda.LAUNCHES - before
        if launched != launches:
            fail(f"queue3: {launched} normal-apply launches, not {launches}")
        set_backends("torch")
        try:
            want = fn()
        finally:
            set_backends("kernel")
        return got, want

    result = {}
    mask = as_t(RandomMask([10], [4])(1, H, seed=1)[None])  # (1, 1, 1, h, 1)
    x, s = cplx(2, T, 1, H, W), unit_rss(cplx(1, 1, C, H, W))
    xs, ss = Complex(as_t(x.real), as_t(x.imag)), Complex(as_t(s.real), as_t(s.imag))
    kern = OPS.masked_normal_kernel(mask)  # (1, 1, h, h)
    with torch.inference_mode():
        got, want = both(lambda: OPS.normal_plus_lambda_kernel(xs, kern, ss, 0.37), 1)
    scale = max(want.re.abs().max().item(), want.im.abs().max().item())
    err = max((got.re - want.re).abs().max().item(), (got.im - want.im).abs().max().item())
    result["operator"] = dict(max_abs_err=err, max_abs_out=scale, tol=NORMAL_TOL * scale)
    print(f"[queue3] normal_plus_lambda_kernel, x (2, {T}, 1, {H}, {W}), K {tuple(kern.re.shape)}, "
          f"S (1, 1, {C}, {H}, {W}): kernels vs plain versions max_abs_err {err:.3e} "
          f"(tol {NORMAL_TOL * scale:.3e})")
    if not err <= NORMAL_TOL * scale:
        fail(f"queue3: the operator with a shared K and S disagrees: {err}")

    b, t, c, h, w = 2, 4, 3, 16, 16
    m = RandomMask([4], [2])(1, h, seed=1)[None].astype(np.float32)
    k, maps = cplx(b, t, c, h, w) * m, unit_rss(cplx(b, 1, c, h, w))
    model = build_model("cinenet", "XF", device=dev, generator=torch.Generator().manual_seed(1),
                        num_cascades=2, cg_iters=2, chans=4, pools=2).eval()
    args = (Complex(as_t(k.real), as_t(k.imag)), as_t(m), Complex(as_t(maps.real), as_t(maps.imag)))
    with torch.inference_mode():
        got, want = both(lambda: model(*args), 2 * (1 + 2))
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    result["cinenet"] = dict(max_abs_err=err, max_abs_out=scale, tol=MODEL_TOL * scale)
    print(f"[queue3] CineNet-XF (2 cascades, 2 CG iterations, chans 4, pools 2), b = 2 on one mask "
          f"(1, 1, 1, {h}, 1): kernels vs plain versions max_abs_err {err:.3e} "
          f"(tol {MODEL_TOL * scale:.3e})")
    if got.shape != (b, t, h, w) or not err <= MODEL_TOL * scale:
        fail(f"queue3: the small CineNet with a shared mask disagrees: {tuple(got.shape)}, {err}")
    return result


class MemoryDataset:
    """``[loop]``'s dataset: decoded volumes held in memory (the card's host
    has no h5py, so nothing reads a file), with the interface the Trainer and
    the Loader use (``examples``, ``transform``, ``load``, ``_load_decoded``).
    A stand-in for ``SliceDataset`` in this script, not a package feature."""

    Example = collections.namedtuple("Example", "fname slice_num metadata")

    def __init__(self, decoded, names, transform):
        self.transform = transform
        self._decoded = {Path(n): d for n, d in zip(names, decoded)}
        self.examples = [self.Example(Path(n), 0, {"num_frames": T, "encoding_size": (H, W),
                                                   "num_coils": C}) for n in names]

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, i):
        return self.load(i)

    def _load_decoded(self, fname):
        return self._decoded[fname]

    def load(self, i, mask_seed=None):
        ex = self.examples[i]
        d = self._load_decoded(ex.fname)
        kwargs = {} if mask_seed is None else {"mask_seed": mask_seed}
        return self.transform(d["kspace"], None, d["target"], {}, ex.fname.name, ex.slice_num,
                              **kwargs)


def loop_phase(torch, dev, data, set_backends, bare_ms, per_step, per_forward, launches):
    """``[loop]``: the training system at full width. The flagship VarNet-XF
    (remat on) fitted by ``Trainer.fit`` on ``[data]``'s two decoded volumes
    (``RandomMask([10], [4])``, batch 1, 2 epochs: 4 train steps, validation
    on volume 1 after each epoch, a checkpoint per epoch), with the CLI's
    loader defaults (4 decode threads, prefetch 2). Four fits from the same
    initial weights: (a) the kernels with the device cache (launches counted,
    CUDA events around every kernel call, every step and every eval step),
    (b) the plain versions and (c) one library call each in their slots
    (timed the same way), (d) the kernels without the cache. Then the
    latest checkpoint restored into a fresh Trainer (bit-identical weights
    and Adam state), ``test()`` on volume 0 (SSIMs.csv) and one timed
    ``InferenceRunner`` request (the three .npy files)."""
    from cinemri_tpu_torch.cli.inference import InferenceRunner
    from cinemri_tpu_torch.data import RandomMask, VarNetDataTransform
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops.kernels import dft_cuda, normal_cuda
    from cinemri_tpu_torch.train import Loader, Trainer, TrainerConfig, metrics_agg

    t_phase = time.perf_counter()
    decoded, names = data["decoded"], data["names"]
    transform = VarNetDataTransform(RandomMask([10], [4]), use_seed=False)
    datasets = {split: MemoryDataset([decoded[i] for i in vols], [names[i] for i in vols], transform)
                for split, vols in (("train", (0, 1)), ("val", (1,)), ("test", (0,)))}

    def loader(split):
        # the CLI's defaults: 4 decode threads, prefetch 2; eval volume-aware
        return Loader(datasets[split], batch_size=1, shuffle=split == "train", seed=42,
                      prefetch_size=2, num_workers=4, volume_aware=split != "train")

    metric_ms = {"train": [], "val": [], "test": []}
    phase = ["train"]
    update = metrics_agg.MetricsAggregator.update

    def timed_update(self, *args, **kwargs):
        t0 = time.perf_counter()
        update(self, *args, **kwargs)
        metric_ms[phase[0]].append((time.perf_counter() - t0) * 1e3)

    gc_timer = GCTimer()

    def instrument(trainer):
        """Wrap the trainer's step, eval step, placement, evaluation and
        saves: per step the CUDA-event ms, the host ms until the step's
        work is enqueued (``dispatch_ms``) and until it is done, the ms the
        garbage collector ran during it, the device allocator's new
        segments (cudaMalloc calls), loss, launches and the host ms since
        the previous step of the epoch; per eval step the CUDA-event ms;
        per placement the host -> device bytes."""
        rec = dict(ms=[], host_ms=[], dispatch_ms=[], gc_ms=[], new_segments=[], loss=[],
                   launches=[], gap_ms=[], eval_ms=[], eval_launches=[], val_wall_ms=[],
                   h2d_bytes=[], place_ms=[], save_s=[])
        step, evals, place, run_eval = (trainer._train_step, trainer._eval_step,
                                        trainer._place_batch, trainer._run_eval)
        last_end = [None]

        def segments():
            return torch.cuda.memory_stats().get("segment.all.allocated", 0)

        def train_step(state, batch):
            t0 = time.perf_counter()
            if last_end[0] is not None:
                rec["gap_ms"].append((t0 - last_end[0]) * 1e3)
            before, seg, gc0 = launches(), segments(), gc_timer.ms
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            state, aux = step(state, batch)
            e1.record()
            rec["dispatch_ms"].append((time.perf_counter() - t0) * 1e3)
            e1.synchronize()  # the loop waits for the loss right after anyway
            last_end[0] = time.perf_counter()
            rec["host_ms"].append((last_end[0] - t0) * 1e3)
            rec["gc_ms"].append(gc_timer.ms - gc0)
            rec["new_segments"].append(segments() - seg)
            rec["ms"].append(e0.elapsed_time(e1))
            rec["loss"].append(aux["loss"].item())
            rec["launches"].append({n: v - before[n] for n, v in launches().items()})
            return state, aux

        def eval_step(state, batch):
            before = launches()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            aux = evals(state, batch)
            e1.record()
            rec["eval_ms"].append((e0, e1))
            rec["eval_launches"].append({n: v - before[n] for n, v in launches().items()})
            return aux

        def place_batch(batch, loader_, cache=None):
            sent, t0 = trainer.h2d_bytes, time.perf_counter()
            out = place(batch, loader_, cache)
            rec["place_ms"].append((time.perf_counter() - t0) * 1e3)
            if loader_ is trainer.train_loader:
                rec["h2d_bytes"].append(trainer.h2d_bytes - sent)
            return out

        def eval_run(loader_, epoch, split, ssim_csv=None):
            phase[0] = split
            t0 = time.perf_counter()
            try:
                return run_eval(loader_, epoch, split, ssim_csv)
            finally:
                rec["val_wall_ms"].append((time.perf_counter() - t0) * 1e3)
                last_end[0] = None  # the next epoch's first step has no gap
                phase[0] = "train"

        trainer._train_step, trainer._eval_step = train_step, eval_step
        trainer._place_batch, trainer._run_eval = place_batch, eval_run
        if trainer.ckpt is not None:
            save = trainer.ckpt.save

            def timed_save(*args, **kwargs):
                t0 = time.perf_counter()
                save(*args, **kwargs)
                rec["save_s"].append(time.perf_counter() - t0)

            trainer.ckpt.save = timed_save
        return rec

    def fit(tag, tmp, cache=True, timers=()):
        cfg = TrainerConfig(epochs=2, log_dir=None, device_data_cache=cache,
                            ckpt_dir=tmp / "ckpt" if tag == "kernels" else None,
                            save_path=tmp / "results")
        trainer = Trainer(build_model("varnet", "XF", device=dev, **FLAGSHIP), cfg,
                          train_loader=loader("train"), val_loader=loader("val"),
                          test_loader=loader("test"), device=dev)
        rec = instrument(trainer)
        with contextlib.ExitStack() as stack:
            for timer in timers:
                stack.enter_context(timer)
            t0 = time.perf_counter()
            history = trainer.fit()
            torch.cuda.synchronize()
            rec["fit_s"] = time.perf_counter() - t0
        rec["eval_ms"] = [e0.elapsed_time(e1) for e0, e1 in rec["eval_ms"]]
        rec["history"] = history
        if len(rec["loss"]) != 4 or not all(math.isfinite(x) for x in rec["loss"]):
            fail(f"loop ({tag}): the fit took {len(rec['loss'])} steps with losses {rec['loss']}")
        return trainer, rec

    def gaps(rec, ref):
        loss = max(abs(a - b) / abs(b) for a, b in zip(rec["loss"], ref["loss"]))
        val = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(rec["history"], ref["history"]))
               for k in ("val_ssim", "val_loss", "val_nmse", "val_psnr", "train_ssim")}
        return loss, val

    metrics_agg.MetricsAggregator.update = timed_update
    try:
        with gc_timer, tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            tkern = (Timed(torch, dft_cuda, "complex_dft_matmul", dft_cost),
                     Timed(torch, normal_cuda, "normal_apply", normal_cost),
                     Timed(torch, normal_cuda, "normal_apply_bwd", normal_bwd_cost))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dft_cuda.LAUNCHES = normal_cuda.LAUNCHES = normal_cuda.BWD_LAUNCHES = 0
            trainer, kern = fit("kernels", tmp, timers=tkern)
            fit_launches = launches()
            peak = torch.cuda.max_memory_allocated()
            eval_metric_ms = list(metric_ms["val"])
            train_metric_ms = list(metric_ms["train"])
            want_fit = {n: 4 * per_step[n] + 2 * per_forward.get(n, 0) for n in per_step}
            print(f"[loop] kernels: launches per step {kern['launches']} (the [train] phase's "
                  f"{per_step}), per eval step {kern['eval_launches']}; fit total {fit_launches} "
                  f"(expected {want_fit})")
            if (any(s != per_step for s in kern["launches"]) or fit_launches != want_fit
                    or not all(fit_launches.values())):
                fail(f"loop: Trainer.fit did not launch the kernels as the train phase does: "
                     f"{kern['launches']}, {fit_launches}")

            set_backends("torch")
            tplain = (Timed(torch, dft_cuda, "complex_dft_matmul_torch", dft_cost),
                      Timed(torch, normal_cuda, "normal_apply_torch", normal_cost),
                      Timed(torch, normal_cuda, "normal_apply_bwd_torch", normal_bwd_cost))
            _, plain = fit("plain", tmp, timers=tplain)
            tlib = tuple(Timed(torch, mod, attr, cost, fn_[1], fn_[0]) for mod, attr, cost, fn_ in (
                (dft_cuda, "complex_dft_matmul_torch", dft_cost, dft_library(torch)),
                (normal_cuda, "normal_apply_torch", normal_cost, normal_library(torch)),
                (normal_cuda, "normal_apply_bwd_op", normal_bwd_op_cost, normal_bwd_op_library(torch))))
            _, lib = fit("library", tmp, timers=tlib)
            set_backends("kernel")
            _, nocache = fit("no cache", tmp, cache=False)
            results = {}
            for label, rec in (("plain versions", plain), ("library calls", lib),
                               ("kernels, cache off", nocache)):
                loss_gap, val_gap = gaps(rec, kern)
                results[label] = dict(loss_rel=loss_gap, val_rel=val_gap)
                print(f"[loop] {label} vs kernels: per-step loss rel {loss_gap:.3e} (tol "
                      f"{TRAIN_LOSS_TOL:.0e}); epoch metrics rel " + ", ".join(
                          f"{k} {v:.3e}" for k, v in val_gap.items()) + " (val_ssim tol 1e-4)")
                if label != "library calls" and not (loss_gap <= TRAIN_LOSS_TOL
                                                     and val_gap["val_ssim"] <= 1e-4):
                    fail(f"loop: the fit through the {label} differs from the kernel fit: "
                         f"{loss_gap}, {val_gap}")

            # the latest checkpoint into a fresh Trainer: bit-identical
            fresh = Trainer(build_model("varnet", "XF", device=dev,
                                        generator=torch.Generator().manual_seed(1), **FLAGSHIP),
                            TrainerConfig(log_dir=None, ckpt_dir=tmp / "ckpt", save_path=tmp / "results"),
                            test_loader=loader("test"), device=dev)
            t0 = time.perf_counter()
            next_epoch = fresh.restore_latest()
            restore_s = time.perf_counter() - t0
            same = [torch.equal(a, b) for a, b in zip(trainer.state.model.state_dict().values(),
                                                      fresh.state.model.state_dict().values())]
            for p, q in zip(trainer.state.model.parameters(), fresh.state.model.parameters()):
                sa, sb = (t.state.optimizer.adam.state[x] for t, x in ((trainer, p), (fresh, q)))
                same += [torch.equal(sa[k], sb[k]) for k in ("exp_avg", "exp_avg_sq", "step")]
            same.append(fresh.state.step == trainer.state.step == 4 and next_epoch == 2)
            ckpt_files = sorted((tmp / "ckpt").glob("*.pt"))
            ckpt_mib = [f.stat().st_size / 2**20 for f in ckpt_files]
            print(f"[loop] restore_latest into a fresh Trainer: {restore_s:.3f} s; {sum(same)} of "
                  f"{len(same)} tensors and counters bit-identical; checkpoints "
                  f"{[f.name for f in ckpt_files]}, {[round(x, 3) for x in ckpt_mib]} MiB, save s "
                  f"{[round(x, 3) for x in kern['save_s']]}")
            if not all(same):
                fail("loop: the restored weights or optimizer state differ from the trained ones")

            phase[0] = "test"
            dft_cuda.LAUNCHES = normal_cuda.LAUNCHES = normal_cuda.BWD_LAUNCHES = 0
            t0 = time.perf_counter()
            test_metrics = fresh.test()
            torch.cuda.synchronize()
            test_ms = (time.perf_counter() - t0) * 1e3
            test_launches = launches()
            rows = (tmp / "results" / "SSIMs.csv").read_text().splitlines()
            runner = InferenceRunner(fresh.model, None, "varnet", tmp / "results", device=dev)
            batch = loader("test").first_batch()
            dft_cuda.LAUNCHES = normal_cuda.LAUNCHES = normal_cuda.BWD_LAUNCHES = 0
            runner(batch)  # warm: the serving path's first call
            request_s = runner(batch)
            infer_launches = launches()
            npys = sorted(f.name for f in (tmp / "results").glob("*.npy"))
            print(f"[loop] test(): {test_ms:.1f} ms for 1 volume, metrics {test_metrics}, launches "
                  f"{test_launches}; SSIMs.csv rows {len(rows)}; InferenceRunner request "
                  f"{request_s * 1e3:.3f} ms (host clock up to a synchronize), launches for two "
                  f"requests {infer_launches}, wrote {npys}")
            want_npys = sorted(f"{k}_{names[0]}.npy" for k in ("target", "output_varnet", "zero_filled"))
            if (len(rows) != 1 or npys != want_npys or not 0 < test_metrics["ssim"] <= 1
                    or test_launches != {n: per_forward.get(n, 0) for n in per_step}):
                fail(f"loop: test/inference artifacts or launches are wrong: {rows}, {npys}, "
                     f"{test_metrics}, {test_launches}")
            del trainer, fresh, runner
            torch.cuda.empty_cache()
    finally:
        metrics_agg.MetricsAggregator.update = update

    ms_step = statistics.median(kern["ms"][1:])
    # what a user of fit pays per train step: the fit's wall time less its
    # validation passes, over its 4 steps (loader, placement, metrics and
    # checkpoint saves included)
    wall_step = (kern["fit_s"] - sum(kern["val_wall_ms"]) / 1e3) * 1e3 / 4
    steady = kern["h2d_bytes"][2:]  # epoch 1: every sample already on the device
    wall = time.perf_counter() - t_phase
    out = dict(
        kernels=kern, plain=plain, library=lib, no_cache=nocache, gaps=results,
        ms_per_step=ms_step, bare_ms_per_step=bare_ms, overhead_ms=ms_step - bare_ms,
        wall_ms_per_step=wall_step, wall_overhead_ms=wall_step - bare_ms,
        host_gap_ms=kern["gap_ms"], place_ms=kern["place_ms"],
        val_wall_ms_per_volume=kern["val_wall_ms"], val_device_ms=kern["eval_ms"],
        val_metrics_host_ms=eval_metric_ms, train_metrics_host_ms=train_metric_ms,
        h2d_bytes_per_step_cache=kern["h2d_bytes"], h2d_bytes_per_step_no_cache=nocache["h2d_bytes"],
        checkpoint_save_s=kern["save_s"], checkpoint_mib=ckpt_mib, restore_s=restore_s,
        peak_memory_bytes=peak, launches=fit_launches, test_ms=test_ms,
        test_metrics=test_metrics, inference_request_ms=request_s * 1e3, wall_s=wall,
        timers=(tkern, tplain, tlib))
    print(f"[loop] kernels, cache on: {wall_step:.3f} wall ms per train step of Trainer.fit "
          f"((fit {kern['fit_s']:.3f} s - validation {sum(kern['val_wall_ms']) / 1e3:.3f} s) / 4) vs "
          f"the [train] phase's bare step {bare_ms:.3f} ms: {wall_step - bare_ms:+.3f} ms of loop "
          f"overhead; the train step alone {ms_step:.3f} ms (CUDA events, median of steps 2-4; "
          f"{[round(x, 3) for x in kern['ms']]}, {ms_step - bare_ms:+.3f} ms); host ms per step outside the step "
          f"(metrics, loader, placement) {[round(x, 3) for x in kern['gap_ms']]}, of which placement "
          f"{[round(x, 3) for x in kern['place_ms']]}; peak memory {peak / 2**20:.1f} MiB")
    for label, rec in (("kernels", kern), ("plain versions", plain), ("library calls", lib),
                       ("kernels, cache off", nocache)):
        print(f"[loop] {label}: per step CUDA-event ms {[round(x, 3) for x in rec['ms']]}, host ms "
              f"to enqueue {[round(x, 3) for x in rec['dispatch_ms']]} and to finish "
              f"{[round(x, 3) for x in rec['host_ms']]}, garbage collector ms "
              f"{[round(x, 3) for x in rec['gc_ms']]}, new allocator segments {rec['new_segments']}")
    print(f"[loop] validation: {[round(x, 3) for x in kern['val_wall_ms']]} ms per volume (host "
          f"clock), eval step {[round(x, 3) for x in kern['eval_ms']]} device ms; ops/metrics host "
          f"ms per volume: validation {[round(x, 3) for x in eval_metric_ms]}, train "
          f"{[round(x, 3) for x in train_metric_ms]}")
    print(f"[loop] host -> device bytes per step: cache on {kern['h2d_bytes']} (epoch 1: "
          f"{steady}), cache off {nocache['h2d_bytes']}; fits s: kernels {kern['fit_s']:.2f}, plain "
          f"{plain['fit_s']:.2f}, library {lib['fit_s']:.2f}, cache off {nocache['fit_s']:.2f}")
    print(f"[loop] phase wall time {wall:.1f} s (limit 60 s)")
    if not wall < 60:
        fail(f"loop: the phase took {wall:.1f} s of wall time, not under 60 s")
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ddp_batches(torch):
    """``[ddp]``'s global batch on the host: ``train_batch``'s volume from
    seed 0 and one from seed 1, with ``sample_weight``."""
    parts = [train_batch(torch, "cpu", seed=s) for s in (0, 1)]
    batch = {k: torch.cat([p[k] for p in parts]) for k in ("mask", "target")}
    batch["k_re"] = torch.cat([p["masked_kspace"].re for p in parts])
    batch["k_im"] = torch.cat([p["masked_kspace"].im for p in parts])
    batch["sample_weight"] = torch.ones(2)
    return batch


def ddp_rows(torch, batch, rows, device):
    """Rows ``rows`` of a ``ddp_batches`` batch as a train-step batch on ``device``."""
    from cinemri_tpu_torch.ops.cplx import Complex

    out = {k: batch[k][rows].to(device) for k in ("mask", "target", "sample_weight")}
    out["masked_kspace"] = Complex(batch["k_re"][rows].to(device), batch["k_im"][rows].to(device))
    return out


def ddp_rank(rank: int, tmp: str) -> None:
    """One of ``[ddp]``'s two gloo ranks, both on ``cuda:0``: two data-parallel
    steps of the flagship on its volume of the global batch (ms per step,
    collectives, loss, final weights), the metric sum of ``rank + 1``, 5
    gradient-sized all-reduces timed alone, then ``Trainer.fit`` (2 epochs
    of ``[loop]``'s volumes, one per rank and epoch; validation on volume
    1, which only rank 0 holds) with a checkpoint, and a restore into a
    fresh Trainer. Writes ``rank<r>.pt`` under ``tmp``."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from cinemri_tpu_torch.data import RandomMask, VarNetDataTransform
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.parallel import distributed as D
    from cinemri_tpu_torch.parallel import make_mesh, make_process_sum
    from cinemri_tpu_torch.train import Loader, Trainer, TrainerConfig, create_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # gloo on purpose: NCCL refuses two ranks on one card; gloo carries the
    # CUDA tensors through the host
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        job = torch.load(f"{tmp}/job.pt", weights_only=False)
        mesh = make_mesh({"data": 2})
        model = build_model("varnet", "XF", device=dev, **FLAGSHIP)
        model.load_state_dict(job["init"])
        state = create_train_state(model, device=dev)
        step = make_train_step(mesh=mesh)
        batch = ddp_rows(torch, job["batch"], slice(rank, rank + 1), dev)
        out = dict(ms=[], loss=[], collectives=[], bytes=[])
        for _ in range(2):
            D.COLLECTIVES.clear()
            D.COLLECTIVE_BYTES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, aux = step(state, batch)
            out["loss"].append(aux["loss"].item())
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["collectives"].append(dict(D.COLLECTIVES))
            out["bytes"].append(dict(D.COLLECTIVE_BYTES))
        out["params"] = {n: p.detach().cpu() for n, p in model.named_parameters()}
        out["sum"] = make_process_sum()(rank + 1.0)
        buf = torch.zeros(sum(p.numel() for p in model.parameters()), device=dev)
        D.all_reduce_sum(buf, "grad")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            D.all_reduce_sum(buf, "grad")
        torch.cuda.synchronize()
        out["allreduce_ms"] = (time.perf_counter() - t0) * 1e3 / 5
        del state, aux, batch, buf, model
        torch.cuda.empty_cache()

        vols = np.load(f"{tmp}/volumes.npz")
        decoded = [{"kspace": vols[f"kspace{i}"], "target": vols[f"target{i}"]} for i in (0, 1)]
        transform = VarNetDataTransform(RandomMask([10], [4]), use_seed=False)

        def loader(vols_, train):
            ds = MemoryDataset([decoded[i] for i in vols_], [job["names"][i] for i in vols_], transform)
            return Loader(ds, batch_size=1, shuffle=train, seed=42, prefetch_size=2, num_workers=4,
                          num_replicas=2, rank=rank, volume_aware=not train)

        cfg = TrainerConfig(epochs=2, log_dir=None, ckpt_dir=f"{tmp}/ckpt", save_path=f"{tmp}/results")
        trainer = Trainer(build_model("varnet", "XF", device=dev, generator=torch.Generator().manual_seed(0),
                                      **FLAGSHIP), cfg, train_loader=loader((0, 1), True),
                          val_loader=loader((1,), False), mesh=mesh, reduce_fn=make_process_sum(),
                          device=dev)
        fit_step, step_ms = trainer._train_step, []

        def timed_step(state_, batch_, **kw):
            t0 = time.perf_counter()
            result = fit_step(state_, batch_, **kw)
            result[1]["loss"].item()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return result

        trainer._train_step = timed_step
        t0 = time.perf_counter()
        history = trainer.fit()
        out["fit_s"] = time.perf_counter() - t0
        out["fit_step_ms"], out["history"] = step_ms, history
        fresh = Trainer(build_model("varnet", "XF", device=dev, generator=torch.Generator().manual_seed(1),
                                    **FLAGSHIP), TrainerConfig(log_dir=None, ckpt_dir=f"{tmp}/ckpt"),
                        mesh=mesh, device=dev)
        out["next_epoch"] = fresh.restore_latest()
        out["restored_same"] = all(torch.equal(a, b) for a, b in zip(
            trainer.state.model.parameters(), fresh.state.model.parameters()))
        out["fit_params"] = [p.detach().cpu() for p in trainer.state.model.parameters()]
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def ddp_fit_timing(torch, dev, data, mesh):
    """``Trainer.fit`` of the flagship on ``[loop]``'s two volumes, each
    twice (2 epochs of 4 steps, batch 1, no device cache, max-throughput
    mode: no train metrics, no per-step logging, so the loss waits for the
    epoch's end; a full garbage collection before each fit) on the
    one-rank NCCL ``mesh`` against the same fit without a mesh and against
    the mesh fit with each step's stop flag read right after its step
    (``sync``), in turns (plain, mesh, sync, sync, mesh, plain): wall ms per
    step (fit / steps, the host clock around a synchronized fit), the
    mesh's collectives, and the epochs' train losses held to
    ``TRAIN_LOSS_TOL``. The mesh fit agrees on a SIGTERM each step through
    the step's scalar all-reduce and reads that flag a step late, so the
    host can queue a step ahead as the plain fit does; ``sync`` shows what
    reading it at once would cost."""
    from cinemri_tpu_torch.data import RandomMask, VarNetDataTransform
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.parallel import distributed as D
    from cinemri_tpu_torch.train import Loader, Trainer, TrainerConfig

    transform = VarNetDataTransform(RandomMask([10], [4]), use_seed=False)
    vols = (0, 1, 0, 1)
    ds = MemoryDataset([data["decoded"][i] for i in vols], [data["names"][i] for i in vols],
                       transform)
    cfg = TrainerConfig(epochs=2, log_dir=None, compute_train_metrics=False, log_every_steps=0,
                        device_data_cache=False)
    out = {k: [] for k in ("plain", "mesh", "sync", "plain_loss", "mesh_loss", "sync_loss")}
    for name in ("plain", "mesh", "sync", "sync", "mesh", "plain"):
        trainer = Trainer(build_model("varnet", "XF", device=dev, **FLAGSHIP), cfg,
                          train_loader=Loader(ds, batch_size=1, shuffle=True, seed=42,
                                              prefetch_size=2, num_workers=4),
                          mesh=None if name == "plain" else mesh, device=dev)
        trainer.init_state()
        if name == "sync":
            step = trainer._train_step

            def synced(state, batch, step=step, **kw):
                state, aux = step(state, batch, **kw)
                bool(aux["stop"])  # the host waits for this step before queuing the next
                return state, aux

            trainer._train_step = synced
        D.COLLECTIVES.clear()
        gc.collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history = trainer.fit()
        torch.cuda.synchronize()
        out[name].append((time.perf_counter() - t0) * 1e3 / trainer.state.step)
        out[f"{name}_loss"].append([h["train_loss"] for h in history])
        if name == "mesh":
            out["collectives"] = dict(D.COLLECTIVES)
        del trainer
        torch.cuda.empty_cache()
    gap = max(abs(a - b) / abs(b) for m, p_ in zip(out["mesh_loss"] + out["sync_loss"],
                                                    out["plain_loss"] * 2) for a, b in zip(m, p_))
    out["loss_rel"] = gap
    print(f"[ddp] Trainer.fit, 2 epochs x 4 steps, no train metrics (the loss waits for the "
          f"epoch's end), no device cache: wall ms per step on the one-rank NCCL mesh "
          f"{[round(x, 3) for x in out['mesh']]}, the same with the stop flag read at once "
          f"{[round(x, 3) for x in out['sync']]}, without a mesh "
          f"{[round(x, 3) for x in out['plain']]} (in turns plain, mesh, sync, sync, mesh, plain); "
          f"mesh collectives {out['collectives']}; train losses rel {gap:.3e} "
          f"(tol {TRAIN_LOSS_TOL:.0e})")
    if gap > TRAIN_LOSS_TOL or out["collectives"] != {"grad": 8, "scalar": 18}:
        fail(f"ddp: the one-rank NCCL Trainer.fit disagrees with the plain fit: {gap}, "
             f"{out['collectives']}")
    return out


def ddp_phase(torch, dev, data, set_backends, per_step, launches):
    """``[ddp]``: data parallelism at full width. (1) The flagship VarNet-XF
    trained 3 steps by the data-parallel step on a one-rank NCCL group in
    this process and 3 by the plain ``make_train_step()``, from the same
    weights and batch, in turns (plain, kernels, kernels, plain), then the
    data-parallel step through the plain versions and through library calls
    (the ``ddp`` kernel rows); per step the collectives (1 gradient
    all-reduce of Σ numel x 4 bytes, 2 scalar ones), the kernel launches
    (the plain step's), ms and peak memory; one gradient-sized NCCL
    all-reduce timed alone; ``Trainer.fit`` on that mesh against the fit
    without one (``ddp_fit_timing``). (2) Two gloo ranks in two processes sharing
    the card, one volume each of a global batch of 2 (``ddp_rank``), held
    against this process training both volumes in one batch; then their
    ``Trainer.fit`` with a checkpoint and a restore."""
    import datetime
    import multiprocessing

    import torch.distributed as dist

    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops.kernels import dft_cuda, normal_cuda
    from cinemri_tpu_torch.parallel import distributed as D
    from cinemri_tpu_torch.parallel import make_mesh
    from cinemri_tpu_torch.train import create_train_state, make_train_step

    t_phase = time.perf_counter()
    host = ddp_batches(torch)
    model = build_model("varnet", "XF", device=dev, generator=torch.Generator().manual_seed(0), **FLAGSHIP)
    init = {n: v.detach().clone() for n, v in model.state_dict().items()}
    nbytes = 4 * sum(p.numel() for p in model.parameters())

    def run(step, batch, steps, timers=()):
        """``steps`` steps from ``init`` with a fresh Adam: per step ms
        (CUDA events), loss, launches and collectives; the first step's
        gradients and the final weights."""
        model.load_state_dict(init)
        state = create_train_state(model, device=dev)
        rec = dict(ms=[], loss=[], launches=[], collectives=[], bytes=[])
        grads = None
        with contextlib.ExitStack() as stack:
            for timer in timers:
                stack.enter_context(timer)
            for i in range(steps):
                before = launches()
                D.COLLECTIVES.clear()
                D.COLLECTIVE_BYTES.clear()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                state, aux = step(state, batch)
                e1.record()
                e1.synchronize()
                rec["ms"].append(e0.elapsed_time(e1))
                rec["loss"].append(aux["loss"].item())
                rec["launches"].append({n: v - before[n] for n, v in launches().items()})
                rec["collectives"].append(dict(D.COLLECTIVES))
                rec["bytes"].append(dict(D.COLLECTIVE_BYTES))
                if not math.isfinite(rec["loss"][-1]):
                    fail(f"ddp: step {i + 1} gave loss {rec['loss'][-1]}")
                if i == 0:
                    grads = {n: q.grad.detach().clone() for n, q in model.named_parameters()}
        return rec, grads, {n: p.detach().clone() for n, p in model.named_parameters()}

    def rel_l2(a, b):
        num = math.sqrt(sum(((a[n] - v) ** 2).sum().item() for n, v in b.items()))
        return num / math.sqrt(sum((v ** 2).sum().item() for v in b.values()))

    def held(label, rec, grads, params, ref, ref_grads, ref_params):
        loss = max(abs(a - b) / abs(b) for a, b in zip(rec["loss"], ref["loss"]))
        grad = rel_l2(grads, ref_grads) if grads is not None else 0.0
        param = rel_l2(params, ref_params)
        print(f"[ddp] {label}: loss rel {loss:.3e} (tol {TRAIN_LOSS_TOL:.0e}), step-1 grads rel L2 "
              f"{grad:.3e}, final weights rel L2 {param:.3e} (tol {TRAIN_GRAD_TOL:.0e})")
        if not (loss <= TRAIN_LOSS_TOL and grad <= TRAIN_GRAD_TOL and param <= TRAIN_GRAD_TOL):
            fail(f"ddp: {label} is outside the train tolerances: {loss}, {grad}, {param}")
        return dict(loss_rel=loss, grads_rel_l2=grad, params_rel_l2=param)

    # -- (1) a one-rank NCCL group in this process -------------------------------
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120), device_id=dev)
    try:
        mesh = make_mesh({"data": 1})
        batch = ddp_rows(torch, host, slice(0, 1), dev)
        plain_step, dp_step = make_train_step(), make_train_step(mesh=mesh)
        tkern = (Timed(torch, dft_cuda, "complex_dft_matmul", dft_cost),
                 Timed(torch, normal_cuda, "normal_apply", normal_cost),
                 Timed(torch, normal_cuda, "normal_apply_bwd", normal_bwd_cost))
        plain_a, pg, pp = run(plain_step, batch, 3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dft_cuda.LAUNCHES = normal_cuda.LAUNCHES = normal_cuda.BWD_LAUNCHES = 0
        kern, kg, kp = run(dp_step, batch, 3, tkern)
        dp_launches = launches()
        peak = torch.cuda.max_memory_allocated()
        kern_b, _, _ = run(dp_step, batch, 3)
        plain_b, _, _ = run(plain_step, batch, 3)
        set_backends("torch")
        tplain = (Timed(torch, dft_cuda, "complex_dft_matmul_torch", dft_cost),
                  Timed(torch, normal_cuda, "normal_apply_torch", normal_cost),
                  Timed(torch, normal_cuda, "normal_apply_bwd_torch", normal_bwd_cost))
        pv, pvg, pvp = run(dp_step, batch, 3, tplain)
        tlib = tuple(Timed(torch, mod, attr, cost, fn_[1], fn_[0]) for mod, attr, cost, fn_ in (
            (dft_cuda, "complex_dft_matmul_torch", dft_cost, dft_library(torch)),
            (normal_cuda, "normal_apply_torch", normal_cost, normal_library(torch)),
            (normal_cuda, "normal_apply_bwd_op", normal_bwd_op_cost, normal_bwd_op_library(torch))))
        lib, lg, lp = run(dp_step, batch, 3, tlib)
        set_backends("kernel")
        buf = torch.zeros(nbytes // 4, device=dev)
        nccl_ms = cuda_ms(torch, lambda: dist.all_reduce(buf), iters=20)
        del buf
        fits = ddp_fit_timing(torch, dev, data, mesh)
    finally:
        dist.destroy_process_group()

    want = {"grad": 1, "scalar": 2}
    print(f"[ddp] one-rank NCCL group: collectives per step {kern['collectives']}, bytes "
          f"{kern['bytes']} (gradient {nbytes} = 4 x {nbytes // 4} floats); the plain step's "
          f"{plain_a['collectives']}")
    if any(c != want for c in kern["collectives"]) or any(
            b["grad"] != nbytes for b in kern["bytes"]) or any(plain_a["collectives"]):
        fail(f"ddp: the data-parallel step did not make one gradient all-reduce of {nbytes} bytes "
             f"and 2 scalar ones per step: {kern['collectives']}, {kern['bytes']}")
    print(f"[ddp] launches per step: data-parallel {kern['launches']}, plain step "
          f"{plain_a['launches']} (the [train] phase's {per_step}); run total {dp_launches}")
    if (any(s != per_step for s in kern["launches"] + plain_a["launches"])
            or dp_launches != {n: 3 * v for n, v in per_step.items()}):
        fail(f"ddp: the data-parallel step launched the kernels otherwise than the plain step: "
             f"{kern['launches']}, {plain_a['launches']}")
    gaps = dict(kernels=held("data-parallel vs plain step, kernels", kern, kg, kp, plain_a, pg, pp),
                plain_versions=held("data-parallel through the plain versions vs plain step", pv, pvg,
                                    pvp, plain_a, pg, pp),
                library=held("data-parallel through library calls vs plain step", lib, lg, lp,
                             plain_a, pg, pp))
    dp_ms = statistics.median(kern["ms"][1:] + kern_b["ms"][1:])
    plain_ms = statistics.median(plain_a["ms"][1:] + plain_b["ms"][1:])
    print(f"[ddp] ms/step (CUDA events, median of steps 2-3 of two runs each, in turns plain, DP, DP, "
          f"plain): data-parallel {dp_ms:.3f} ({[round(x, 3) for x in kern['ms'] + kern_b['ms']]}), "
          f"plain step {plain_ms:.3f} ({[round(x, 3) for x in plain_a['ms'] + plain_b['ms']]}): "
          f"{100 * (dp_ms / plain_ms - 1):+.2f}%; one {nbytes}-byte NCCL all-reduce alone "
          f"{nccl_ms:.4f} ms (20 in a row, CUDA events); peak memory {peak / 2**20:.1f} MiB")
    nccl = dict(kernels=kern, kernels_again=kern_b, plain_step=plain_a, plain_step_again=plain_b,
                plain_versions=pv, library=lib, gaps=gaps, dp_ms_per_step=dp_ms,
                plain_ms_per_step=plain_ms, allreduce_ms=nccl_ms, peak_memory_bytes=peak,
                fits=fits)
    del model, batch, pg, pp, kg, kp, pvg, pvp, lg, lp
    torch.cuda.empty_cache()

    # -- (2) two gloo ranks in two processes on the one card ------------------------
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"init": {n: v.cpu() for n, v in init.items()}, "batch": host,
                    "names": data["names"]}, f"{tmp}/job.pt")
        np.savez(f"{tmp}/volumes.npz", **{f"{k}{i}": data["decoded"][i][k] for i in (0, 1)
                                          for k in ("kspace", "target")})
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=ddp_rank, args=(r, tmp)) for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=max(1.0, 300 - (time.perf_counter() - t0)))
        finally:
            hung = [p.pid for p in procs if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        ranks_s = time.perf_counter() - t0
        if hung or any(p.exitcode != 0 for p in procs):
            fail(f"ddp: the gloo ranks ended with exit codes {[p.exitcode for p in procs]} "
                 f"(killed after 300 s: {hung})")
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(2)]

    # this process, both volumes in one batch, the plain step
    model = build_model("varnet", "XF", device=dev, **FLAGSHIP)
    model.load_state_dict(init)
    state = create_train_state(model, device=dev)
    step = make_train_step()
    both = ddp_rows(torch, host, slice(0, 2), dev)
    one = dict(ms=[], loss=[])
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = step(state, both)
        one["loss"].append(aux["loss"].item())
        torch.cuda.synchronize()
        one["ms"].append((time.perf_counter() - t0) * 1e3)
    one_params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    del model, state, aux, both
    torch.cuda.empty_cache()
    same = [torch.equal(ranks[0]["params"][n], ranks[1]["params"][n]) for n in one_params]
    same_fit = [torch.equal(a, b) for a, b in zip(ranks[0]["fit_params"], ranks[1]["fit_params"])]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["loss"], one["loss"]))
    param_gap = rel_l2(ranks[0]["params"], one_params)
    print(f"[ddp] two gloo ranks on cuda:0, one volume each: ms per step (host clock) rank 0 "
          f"{[round(x, 3) for x in ranks[0]['ms']]}, rank 1 {[round(x, 3) for x in ranks[1]['ms']]}; one "
          f"process with both volumes {[round(x, 3) for x in one['ms']]}; a {nbytes}-byte gloo "
          f"all-reduce of CUDA tensors {ranks[0]['allreduce_ms']:.3f} / {ranks[1]['allreduce_ms']:.3f} "
          f"ms; collectives per step {ranks[0]['collectives']}")
    print(f"[ddp] two gloo ranks vs one process: loss {ranks[0]['loss']} vs {one['loss']} (rel "
          f"{loss_gap:.3e}, tol {TRAIN_LOSS_TOL:.0e}), weights rel L2 {param_gap:.3e} (tol "
          f"{TRAIN_GRAD_TOL:.0e}); ranks' weights bit-identical: {sum(same)} of {len(same)}; metric "
          f"sum of rank + 1: {[r_['sum'] for r_ in ranks]} (want 3.0)")
    if not (all(same) and ranks[0]["loss"] == ranks[1]["loss"] and loss_gap <= TRAIN_LOSS_TOL
            and param_gap <= TRAIN_GRAD_TOL and all(r_["sum"] == 3.0 for r_ in ranks)
            and all(c == want for r_ in ranks for c in r_["collectives"])):
        fail("ddp: the two gloo ranks disagree with each other or with the one-process batch")
    fit_ms = [r_["fit_s"] * 1e3 / len(r_["fit_step_ms"]) for r_ in ranks]
    print(f"[ddp] Trainer.fit on the two ranks (2 epochs, one volume per rank and epoch, validation "
          f"on volume 1 held by rank 0 only): {[round(r_['fit_s'], 3) for r_ in ranks]} s, wall ms per "
          f"step (fit / steps) {[round(x, 3) for x in fit_ms]}, each step "
          f"{[[round(x, 3) for x in r_['fit_step_ms']] for r_ in ranks]}; histories equal "
          f"{ranks[0]['history'] == ranks[1]['history']}; weights bit-identical {all(same_fit)}; "
          f"restore_latest into a fresh Trainer on each rank: next epoch "
          f"{[r_['next_epoch'] for r_ in ranks]}, bit-identical {[r_['restored_same'] for r_ in ranks]}")
    if not (all(same_fit) and ranks[0]["history"] == ranks[1]["history"]
            and all(r_["restored_same"] and r_["next_epoch"] == 2 for r_ in ranks)
            and all(len(r_["fit_step_ms"]) == 2 for r_ in ranks)):
        fail("ddp: Trainer.fit on the two ranks diverged, or its checkpoint did not restore")
    wall = time.perf_counter() - t_phase
    print(f"[ddp] phase wall time {wall:.1f} s, of which the two ranks' processes {ranks_s:.1f} s")
    for r_ in ranks:
        r_.pop("params")
        r_.pop("fit_params")
    return dict(nccl_world1=nccl, gloo_ranks=ranks, one_process=one, loss_rel=loss_gap,
                params_rel_l2=param_gap, fit_wall_ms_per_step=fit_ms, wall_s=wall,
                launches=dp_launches, launches_per_step=per_step, timers=(tkern, tplain, tlib))


class Measured:
    """A ``Timed`` run's numbers carried back from a rank process: the
    summed CUDA-event ms of its calls and the summed bound of those calls."""

    def __init__(self, ms, bound_ms=0.0, bound_by="bytes"):
        self._ms, self._bound = ms, (bound_ms, bound_by)

    def ms(self) -> float:
        return self._ms

    def bound(self, peak_flops: float, peak_bw: float):
        return self._bound


# Collectives of one flagship VarNet-XF step (10 cascades, remat, kernel DC)
# on a mesh axis of 2. Coil: the forward all-reduces the sens net's RSS,
# R0 = Σ|S|², x_ref and each cascade's normal apply (13); the backward
# replays each cascade's normal apply and all-reduces the cotangent of its
# input (20) and that of the sens net's RSS (1). Plane: each cascade gathers
# its two plane batches (20); the backward replays those gathers and
# all-gathers the two slices' cotangents (40). A forward alone makes the
# forward's 13 (coil) or 20 (plane).
MESH_STEP_COLLECTIVES = {"coil": {"coil": 34, "grad": 1, "scalar": 2},
                         "plane": {"plane": 60, "grad": 1, "scalar": 2}}
MESH_FORWARD_COLLECTIVES = {"coil": {"coil": 13}, "plane": {"plane": 20}}


def mesh_host_batch(torch):
    """``train_batch``'s volume (seed 0) as numpy, the Loader's layout."""
    b = train_batch(torch, "cpu", seed=0)
    k = b["masked_kspace"]
    return {"masked_kspace": (k.re.numpy() + 1j * k.im.numpy()).astype(np.complex64),
            "mask": b["mask"].numpy(), "target": b["target"].numpy()}


def mesh_rank(rank: int, tmp: str) -> None:
    """One of ``[mesh]``'s two gloo ranks, both on ``cuda:0``. On ``{plane:
    2}`` and then ``{coil: 2}``: the flagship VarNet-XF's forward (one warm,
    one timed) and 2 train steps (ms, launches, collectives and bytes by
    kind, peak memory, the first step's gradients); on ``{coil: 2}`` also
    the 2 steps again with every call of the three kernels timed, through
    the kernels, the plain versions and library calls (the ``mesh`` kernel
    rows). Then CineNet-XF's forward on ``{coil: 2}``, and ``Trainer.fit``
    (1 epoch of ``[loop]``'s two volumes, both on every rank) with a
    checkpoint restored into a fresh Trainer. Writes ``rank<r>.pt``."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from cinemri_tpu_torch.data import RandomMask, VarNetDataTransform
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops import fft as FFT
    from cinemri_tpu_torch.ops.cplx import Complex
    from cinemri_tpu_torch.ops.kernels import dft_cuda, normal_cuda
    from cinemri_tpu_torch.parallel import coil_shard, make_mesh, set_mesh, shard_batch
    from cinemri_tpu_torch.parallel import distributed as D
    from cinemri_tpu_torch.parallel import make_process_sum
    from cinemri_tpu_torch.physics import operators as OPS
    from cinemri_tpu_torch.train import Loader, Trainer, TrainerConfig, create_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # gloo: NCCL refuses two ranks on one card
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        job = torch.load(f"{tmp}/job.pt", weights_only=False)
        peak_flops, peak_bw = peaks(torch.cuda.get_device_name(0))
        host = job["batch"]

        def launches():
            return {"dft": dft_cuda.LAUNCHES, "normal": normal_cuda.LAUNCHES,
                    "normal_bwd": normal_cuda.BWD_LAUNCHES}

        def delta(before):
            return {n: v - before[n] for n, v in launches().items()}

        def cplx(a):
            return Complex(torch.from_numpy(np.ascontiguousarray(a.real)).to(dev),
                           torch.from_numpy(np.ascontiguousarray(a.imag)).to(dev))

        def timed_forward(model, mesh, *args):
            with set_mesh(mesh), torch.inference_mode():
                model(*args)  # warm
                torch.cuda.synchronize()
                before = launches()
                D.COLLECTIVES.clear()
                t0 = time.perf_counter()
                y = model(*args)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            return dict(out=y.cpu(), ms=ms, launches=delta(before), collectives=dict(D.COLLECTIVES))

        def steps(model, mesh, n, timers=()):
            model.load_state_dict(job["varnet"])
            state = create_train_state(model, device=dev)
            step = make_train_step(mesh=mesh)
            batch = shard_batch(host, mesh, device=dev)
            rec = dict(ms=[], loss=[], launches=[], collectives=[], bytes=[])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with contextlib.ExitStack() as stack:
                for timer in timers:
                    stack.enter_context(timer)
                for i in range(n):
                    before = launches()
                    D.COLLECTIVES.clear()
                    D.COLLECTIVE_BYTES.clear()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, aux = step(state, batch)
                    rec["loss"].append(aux["loss"].item())
                    torch.cuda.synchronize()
                    rec["ms"].append((time.perf_counter() - t0) * 1e3)
                    rec["launches"].append(delta(before))
                    rec["collectives"].append(dict(D.COLLECTIVES))
                    rec["bytes"].append(dict(D.COLLECTIVE_BYTES))
                    if i == 0:
                        rec["grads"] = {n_: p.grad.detach().cpu() for n_, p in model.named_parameters()}
            rec["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
            return rec

        out = {}
        t_rank = time.perf_counter()
        for axis in ("plane", "coil"):
            mesh = make_mesh({axis: 2})
            model = build_model("varnet", "XF", device=dev, **FLAGSHIP, **{f"{axis}_axis": axis})
            model.load_state_dict(job["varnet"])
            with set_mesh(mesh):
                k = coil_shard(cplx(host["masked_kspace"]), model.coil_axis)
            rec = dict(forward=timed_forward(model, mesh, k, torch.from_numpy(host["mask"]).to(dev)),
                       train=steps(model, mesh, 2))
            if axis == "coil":
                def kernels(fns):
                    return [Timed(torch, mod, attr, cost, *fn) for (mod, attr, cost), fn in zip(
                        ((dft_cuda, "complex_dft_matmul", dft_cost),
                         (normal_cuda, "normal_apply", normal_cost),
                         (normal_cuda, "normal_apply_bwd", normal_bwd_cost)), fns)]

                tk = kernels([()] * 3)
                dft_cuda.LAUNCHES = normal_cuda.LAUNCHES = normal_cuda.BWD_LAUNCHES = 0
                kern_run = steps(model, mesh, 2, tk)
                kern_run["counts"] = launches()
                FFT.set_dft_backend("torch")
                OPS.set_normal_backend("torch")
                tp = [Timed(torch, mod, attr, cost) for mod, attr, cost in (
                    (dft_cuda, "complex_dft_matmul_torch", dft_cost),
                    (normal_cuda, "normal_apply_torch", normal_cost),
                    (normal_cuda, "normal_apply_bwd_torch", normal_bwd_cost))]
                plain_run = steps(model, mesh, 2, tp)
                tl = [Timed(torch, mod, attr, cost, fn_[1], fn_[0]) for mod, attr, cost, fn_ in (
                    (dft_cuda, "complex_dft_matmul_torch", dft_cost, dft_library(torch)),
                    (normal_cuda, "normal_apply_torch", normal_cost, normal_library(torch)),
                    (normal_cuda, "normal_apply_bwd_op", normal_bwd_op_cost,
                     normal_bwd_op_library(torch)))]
                steps(model, mesh, 2, tl)
                FFT.set_dft_backend("kernel")
                OPS.set_normal_backend("kernel")
                rec["timers"] = [[(t.ms(), *t.bound(peak_flops, peak_bw), len(t.calls)) for t in ts]
                                 for ts in (tk, tp, tl)]
                # the timed kernel run against the plain versions' run on the
                # same shards: the kernels on 5-coil operands, held by the path
                rec["kernel_run"] = {k_: kern_run[k_] for k_ in ("loss", "grads", "counts")}
                rec["plain_run"] = {k_: plain_run[k_] for k_ in ("loss", "grads")}
            out[axis] = rec
            del model, k
            torch.cuda.empty_cache()

        # CineNet-XF on {coil: 2}: λ after the coil all-reduce, through the CG
        mesh = make_mesh({"coil": 2})
        cmodel = build_model("cinenet", "XF", device=dev, **CINENET, coil_axis="coil")
        cmodel.load_state_dict(job["cinenet"])
        with set_mesh(mesh):
            ck = coil_shard(cplx(job["cinenet_k"]), "coil")
            cs = coil_shard(cplx(job["cinenet_maps"]), "coil")
        out["cinenet"] = timed_forward(cmodel, mesh, ck, torch.from_numpy(job["cinenet_mask"]).to(dev),
                                       cs)
        del cmodel, ck, cs
        torch.cuda.empty_cache()

        # Trainer.fit on {coil: 2}: both volumes on both ranks (one data group)
        vols = np.load(f"{tmp}/volumes.npz")
        decoded = [{"kspace": vols[f"kspace{i}"], "target": vols[f"target{i}"]} for i in (0, 1)]
        ds = MemoryDataset(decoded, job["names"], VarNetDataTransform(RandomMask([10], [4]),
                                                                      use_seed=False))
        cfg = TrainerConfig(epochs=1, log_dir=None, ckpt_dir=f"{tmp}/ckpt")
        trainer = Trainer(build_model("varnet", "XF", device=dev, coil_axis="coil", **FLAGSHIP), cfg,
                          train_loader=Loader(ds, batch_size=1, shuffle=True, seed=42,
                                              prefetch_size=2, num_workers=4),
                          mesh=mesh, reduce_fn=make_process_sum(mesh), device=dev)
        before = launches()
        D.COLLECTIVES.clear()
        t0 = time.perf_counter()
        history = trainer.fit()
        torch.cuda.synchronize()
        fit = dict(s=time.perf_counter() - t0, launches=delta(before), history=history,
                   steps=trainer.state.step, collectives=dict(D.COLLECTIVES))
        fresh = Trainer(build_model("varnet", "XF", device=dev, coil_axis="coil",
                                    generator=torch.Generator().manual_seed(1), **FLAGSHIP),
                        TrainerConfig(log_dir=None, ckpt_dir=f"{tmp}/ckpt"), mesh=mesh, device=dev)
        fit["next_epoch"] = fresh.restore_latest()
        fit["restored_same"] = all(torch.equal(a, b) for a, b in zip(
            trainer.state.model.parameters(), fresh.state.model.parameters()))
        fit["params"] = [p.detach().cpu() for p in trainer.state.model.parameters()]
        out["fit"] = fit
        out["wall_s"] = time.perf_counter() - t_rank
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def mesh_phase(torch, dev, data, per_step, expected):
    """``[mesh]``: the plane and coil axes at full width, two gloo ranks in
    two processes sharing the card (``mesh_rank``), held against this
    process's one-process runs from the same weights: the flagship
    VarNet-XF's forward to ``MODEL_TOL`` x max |out|, its 2 train steps'
    losses to ``TRAIN_LOSS_TOL`` and first-step gradients to
    ``TRAIN_GRAD_TOL`` (relative L2), CineNet-XF's forward to ``MODEL_TOL``;
    every forward and step launching the kernels as the one-process path
    does (``expected``, ``per_step``) and making ``MESH_*_COLLECTIVES``. The
    times are of two ranks sharing one card over a host-carried (gloo)
    collective, not of NVLink scaling. Fails over 120 s of wall time."""
    import multiprocessing

    from cinemri_tpu_torch.data.masks import RandomMask
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops.cplx import Complex
    from cinemri_tpu_torch.train import create_train_state, make_train_step

    t_phase = time.perf_counter()
    host = mesh_host_batch(torch)
    vmodel = build_model("varnet", "XF", device=dev, generator=torch.Generator().manual_seed(0),
                         **FLAGSHIP)
    cmodel = build_model("cinenet", "XF", device=dev, generator=torch.Generator().manual_seed(0),
                         **CINENET)
    ck = flagship_inputs(torch, RandomMask([10], [4]), 0, "cpu")
    cs = rss_maps(torch, 0, "cpu")
    job = dict(varnet={n: v.cpu() for n, v in vmodel.state_dict().items()},
               cinenet={n: v.cpu() for n, v in cmodel.state_dict().items()}, batch=host,
               cinenet_k=(ck[0].numpy() + 1j * ck[1].numpy()).astype(np.complex64),
               cinenet_mask=ck[2].numpy(),
               cinenet_maps=(cs[0].numpy() + 1j * cs[1].numpy()).astype(np.complex64),
               names=data["names"])
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(job, f"{tmp}/job.pt")
        np.savez(f"{tmp}/volumes.npz", **{f"{k}{i}": data["decoded"][i][k] for i in (0, 1)
                                          for k in ("kspace", "target")})
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=mesh_rank, args=(r, tmp)) for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=max(1.0, 240 - (time.perf_counter() - t0)))
        finally:
            hung = [p.pid for p in procs if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        ranks_s = time.perf_counter() - t0
        if hung or any(p.exitcode != 0 for p in procs):
            fail(f"mesh: the gloo ranks ended with exit codes {[p.exitcode for p in procs]} "
                 f"(killed after 240 s: {hung})")
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(2)]

    # this process: the same weights and inputs, no mesh
    def cplx(a):
        return Complex(torch.from_numpy(np.ascontiguousarray(a.real)).to(dev),
                       torch.from_numpy(np.ascontiguousarray(a.imag)).to(dev))

    with torch.inference_mode():
        v_out = vmodel(cplx(host["masked_kspace"]), torch.from_numpy(host["mask"]).to(dev)).cpu()
        c_out = cmodel(cplx(job["cinenet_k"]), torch.from_numpy(job["cinenet_mask"]).to(dev),
                       cplx(job["cinenet_maps"])).cpu()
    state = create_train_state(vmodel, device=dev)
    step = make_train_step()
    batch = {"masked_kspace": cplx(host["masked_kspace"]),
             "mask": torch.from_numpy(host["mask"]).to(dev),
             "target": torch.from_numpy(host["target"]).to(dev)}
    one = dict(loss=[])
    for i in range(2):
        state, aux = step(state, batch)
        one["loss"].append(aux["loss"].item())
        if i == 0:
            one_grads = {n: p.grad.detach().cpu() for n, p in vmodel.named_parameters()}
    del vmodel, cmodel, state, aux, batch
    torch.cuda.empty_cache()

    def rel_l2(a, b):
        num = math.sqrt(sum(((a[n] - v) ** 2).sum().item() for n, v in b.items()))
        return num / math.sqrt(sum((v ** 2).sum().item() for v in b.values()))

    expected = dict(expected, normal_bwd=0)
    report, ok = {}, True
    v_scale, c_scale = v_out.abs().max().item(), c_out.abs().max().item()
    for axis in ("plane", "coil"):
        recs = [r_[axis] for r_ in ranks]
        fwd_err = max((r_["forward"]["out"] - v_out).abs().max().item() for r_ in recs) / v_scale
        loss_rel = max(abs(a - b) / abs(b) for r_ in recs for a, b in zip(r_["train"]["loss"],
                                                                           one["loss"]))
        grad_rel = max(rel_l2(r_["train"]["grads"], one_grads) for r_ in recs)
        launches_ok = all(r_["forward"]["launches"] == expected
                          and all(l_ == per_step for l_ in r_["train"]["launches"]) for r_ in recs)
        coll_ok = all(r_["forward"]["collectives"] == MESH_FORWARD_COLLECTIVES[axis]
                      and all(c_ == MESH_STEP_COLLECTIVES[axis] for c_ in r_["train"]["collectives"])
                      for r_ in recs)
        print(f"[mesh] VarNet-XF on {{{axis}: 2}}, two gloo ranks on cuda:0 (host-carried "
              f"collectives on one shared card, not NVLink scaling): forward ms per rank "
              f"{[round(r_['forward']['ms'], 3) for r_ in recs]}, train ms per step "
              f"{[[round(x, 3) for x in r_['train']['ms']] for r_ in recs]}, peak MiB "
              f"{[round(r_['train']['peak_mib'], 1) for r_ in recs]}; collectives per step "
              f"{recs[0]['train']['collectives'][0]}, bytes {recs[0]['train']['bytes'][0]} "
              f"(forward {recs[0]['forward']['collectives']}); launches per forward "
              f"{recs[0]['forward']['launches']} (want {expected}), per step "
              f"{recs[0]['train']['launches']} (want {per_step})")
        print(f"[mesh] VarNet-XF on {{{axis}: 2}} vs one process: forward max|diff| / max|out| "
              f"{fwd_err:.3e} (tol {MODEL_TOL:.0e}), losses rel {loss_rel:.3e} (tol "
              f"{TRAIN_LOSS_TOL:.0e}), step-1 grads rel L2 {grad_rel:.3e} (tol {TRAIN_GRAD_TOL:.0e})")
        ok &= (fwd_err <= MODEL_TOL and loss_rel <= TRAIN_LOSS_TOL and grad_rel <= TRAIN_GRAD_TOL
               and launches_ok and coll_ok and recs[0]["train"]["loss"] == recs[1]["train"]["loss"])
        report[axis] = dict(forward_rel=fwd_err, loss_rel=loss_rel, grads_rel_l2=grad_rel,
                            forward_ms=[r_["forward"]["ms"] for r_ in recs],
                            train_ms=[r_["train"]["ms"] for r_ in recs],
                            peak_mib=[r_["train"]["peak_mib"] for r_ in recs],
                            collectives=recs[0]["train"]["collectives"],
                            bytes=recs[0]["train"]["bytes"],
                            launches=[r_["train"]["launches"] for r_ in recs])
    c_expected = {"dft": 2 + 2 * CINENET["num_cascades"],
                  "normal": CINENET["num_cascades"] * (1 + CINENET["cg_iters"]), "normal_bwd": 0}
    c_err = max((r_["cinenet"]["out"] - c_out).abs().max().item() for r_ in ranks) / c_scale
    c_launches_ok = all(r_["cinenet"]["launches"] == c_expected for r_ in ranks)
    print(f"[mesh] CineNet-XF forward on {{coil: 2}} (5 coils per rank, RSS-normalized random "
          f"maps): ms per rank {[round(r_['cinenet']['ms'], 3) for r_ in ranks]}, launches "
          f"{ranks[0]['cinenet']['launches']} (want {c_expected}), collectives "
          f"{ranks[0]['cinenet']['collectives']}; vs one process max|diff| / max|out| {c_err:.3e} "
          f"(tol {MODEL_TOL:.0e})")
    ok &= c_err <= MODEL_TOL and c_launches_ok
    fits = [r_["fit"] for r_ in ranks]
    same_fit = all(torch.equal(a, b) for a, b in zip(fits[0]["params"], fits[1]["params"]))
    fit_ok = (same_fit and fits[0]["history"] == fits[1]["history"]
              and all(f["restored_same"] and f["next_epoch"] == 1 and f["steps"] == 2
                      and f["launches"] == {n: 2 * v for n, v in per_step.items()} for f in fits))
    print(f"[mesh] Trainer.fit on {{coil: 2}} (1 epoch, [loop]'s two volumes on both ranks): "
          f"{[round(f['s'], 3) for f in fits]} s, launches {fits[0]['launches']}, collectives "
          f"{fits[0]['collectives']}; history {fits[0]['history']}; ranks' weights bit-identical "
          f"{same_fit}; restore_latest into a fresh Trainer: next epoch "
          f"{[f['next_epoch'] for f in fits]}, bit-identical {[f['restored_same'] for f in fits]}")
    ok &= fit_ok
    # the timed coil-axis run through the kernels against the same run through
    # the plain versions, on each rank's 5-coil shards; its launch counts
    # (the counters set to 0 just before it) against 2 steps of the path
    for r, r_ in enumerate(ranks):
        kr, pr = r_["coil"]["kernel_run"], r_["coil"]["plain_run"]
        kp_loss = max(abs(a - b) / abs(b) for a, b in zip(kr["loss"], pr["loss"]))
        kp_grad = rel_l2(kr["grads"], pr["grads"])
        counts_ok = kr["counts"] == {n: 2 * v for n, v in per_step.items()}
        print(f"[mesh] rank {r} VarNet-XF on {{coil: 2}}, timed run through the kernels vs the "
              f"plain versions on the same 5-coil shards: losses rel {kp_loss:.3e} (tol "
              f"{TRAIN_LOSS_TOL:.0e}), step-1 grads rel L2 {kp_grad:.3e} (tol {TRAIN_GRAD_TOL:.0e}); "
              f"launches {kr['counts']} (want {dict((n, 2 * v) for n, v in per_step.items())})")
        ok &= kp_loss <= TRAIN_LOSS_TOL and kp_grad <= TRAIN_GRAD_TOL and counts_ok
        report.setdefault("kernel_vs_plain", []).append(
            dict(loss_rel=kp_loss, grads_rel_l2=kp_grad, launches=kr["counts"]))
    wall = time.perf_counter() - t_phase
    print(f"[mesh] phase wall time {wall:.1f} s (limit 120 s), of which the ranks' processes "
          f"{ranks_s:.1f} s")
    if not ok:
        fail("mesh: a mesh run disagrees with one process or with the plain versions, or "
             "launched the kernels or made the collectives otherwise than the path does")
    if wall > 120:
        fail(f"mesh: the phase took {wall:.1f} s of wall time, not under 120 s")
    coil = ranks[0]["coil"]
    timers = tuple(tuple(Measured(ms, b_ms, b_by) for ms, b_ms, b_by, _ in ts)
                   for ts in coil["timers"])
    launches = coil["kernel_run"]["counts"]
    for r_ in ranks:
        for axis in ("plane", "coil"):
            r_[axis]["train"].pop("grads")
            r_[axis]["forward"].pop("out")
        r_["coil"].pop("kernel_run")
        r_["coil"].pop("plain_run")
        r_["cinenet"].pop("out")
        r_["fit"].pop("params")
    return dict(report, cinenet_rel=c_err, fits=fits, wall_s=wall, ranks_s=ranks_s,
                rank_wall_s=[r_["wall_s"] for r_ in ranks], timers=timers, launches=launches,
                timed_calls=[[c for *_, c in ts] for ts in coil["timers"]])


# the flagship and the protocol CineNet as a reference checkpoint stores them
# (its Lightning module's hyper_parameters: the reference's names)
FLAGSHIP_HPARAMS = dict(FLAGSHIP, dynamic_type="XF", weight_sharing=False)
CINENET_HPARAMS = dict(num_cascades=CINENET["num_cascades"], CG_iters=CINENET["cg_iters"],
                       chans=CINENET["chans"], pools=CINENET["pools"], dynamic_type="XF",
                       weight_sharing=False)
# the kernels a launch of each C entry runs at each precision on the
# flagship's rows (one launch counted per call): at 'default' the normal
# apply's products are formed in the resident TF32 tile's staging, in the
# forward and in both contractions of the backward; the backward adds one
# kernel, the conjugate-transposed copy of K its adjoint contracts with (at
# 'highest' on the FP32 tile)
KERNELS_PER_LAUNCH = {"highest": {"dft": 1, "normal": 3, "normal_bwd": 8},
                      "high": {"dft": 1, "normal": 3, "normal_bwd": 8},
                      "default": {"dft": 1, "normal": 2, "normal_bwd": 6}}
# the 'highest' contractions' tile on 16-byte rows (csrc/normal_passes.cuh
# Fp32Tile), as the profiler names its kernels' template argument
FP32_TILE = "cgemm::Tile<96, 40, 16, 8, 5, 3, 4, 1>"
# the kernels a launch runs at 'highest' on the fused FP32 tile
# (normal_cuda.set_fp32_tile('fused'), csrc/fp32_hopper.cuh): the tile with
# the products formed in its staging, then the coil reduction; the backward's
# copy Kᴴ, its two contractions on the tile and its three passes
FUSED_KERNELS_PER_LAUNCH = {"normal": 2, "normal_bwd": 6}
FOLD_KINDS = {"dft": "dft_matmul (port kernel)", "normal": "normal_apply (port kernels)",
              "normal_bwd": "normal_apply_bwd (port kernels)"}
OP_NAMES = {"dft": "cinemri::dft_matmul", "normal": "cinemri::normal_apply",
            "normal_bwd": "cinemri::normal_apply_bwd"}


def op_events(trace_path) -> Dict[str, int]:
    """The host-side events of the port's custom ops in a chrome trace, by
    op name (``torch.ops.cinemri.*``; one per call, whatever the device
    side recorded)."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    return dict(collections.Counter(e["name"] for e in events if e.get("cat") == "cpu_op"
                                    and e.get("name", "").startswith("cinemri::")))


def interop_export_phase(torch, dev, per_forward):
    """``[interop-export]``: a user of the reference serves a trained
    checkpoint from a ``torch.export`` artifact. For the flagship VarNet-XF
    at full width and depth, then CineNet-XF with maps (the protocol
    config, full depth): a reference-layout Lightning checkpoint written from
    seed 0 (``interop.reference_layout``, no reference code), imported by
    ``interop.import_torch_checkpoint`` into ``build_model`` on the card
    (weights checked against the checkpoint's), 4 requests of 15 x 10 x
    200 x 200 served through ``serve.bind_model`` and through
    ``serve.export_model`` -> file -> ``serve.load_exported``, the kernel
    counters at 0 before each run: both must launch the DFT and normal-apply
    kernels as often as ``per_forward`` times 4, and the artifact's images
    agree with the eager ones within MODEL_TOL x max |out|. Then 12 requests
    each, in turns, CUDA events around each. The phase must take under
    120 s."""
    from cinemri_tpu_torch.data.masks import RandomMask
    from cinemri_tpu_torch.interop import import_torch_checkpoint
    from cinemri_tpu_torch.interop.reference_layout import reference_checkpoint
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops.cplx import Complex
    from cinemri_tpu_torch.ops.kernels import dft_cuda, normal_cuda
    from cinemri_tpu_torch.serve import bind_model, export_model, load_exported

    t_phase = time.perf_counter()
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        for family, hparams, maps in (("varnet", FLAGSHIP_HPARAMS, False),
                                      ("cinenet", CINENET_HPARAMS, True)):
            rec = {}
            t0 = time.perf_counter()
            ckpt = reference_checkpoint(family, hparams, seed=0)
            path = Path(tmp) / f"{family}.ckpt"
            torch.save(ckpt, path)
            rec["checkpoint_s"] = time.perf_counter() - t0
            rec["checkpoint_mib"] = path.stat().st_size / 2**20
            t0 = time.perf_counter()
            state_dict, kwargs, fam, dyn = import_torch_checkpoint(path)
            model = build_model(fam, dyn, device=dev, **kwargs)
            model.load_state_dict(state_dict)
            rec["import_s"] = time.perf_counter() - t0
            ref = ckpt["state_dict"]
            net = "sens_net.norm_unet.unet." if family == "varnet" else "cascades.net_xf."
            ref_net = "sens_net.norm_unet.unet." if family == "varnet" else "model.0."
            carried = [(f"{net}down.0.conv0.weight", f"{ref_net}down_sample_layers.0.layers.0.weight"),
                       (f"{net}up_transpose.0.conv.weight", f"{ref_net}up_transpose_conv.0.layers.0.weight"),
                       (f"{net}final.bias", f"{ref_net}up_conv.{hparams['pools'] - 1}.1.bias")]
            got_sd = model.state_dict()
            lam = torch.cat([ref[f"{family}.cascades.{i}.lambda_reg"]
                             for i in range(hparams["num_cascades"])])
            if (dyn, kwargs.get("num_cascades")) != ("XF", hparams["num_cascades"]) or not (
                    torch.equal(got_sd["lambda_reg"].cpu(), lam)
                    and all(torch.equal(got_sd[a].cpu(), ref[f"{family}.{b}"]) for a, b in carried)):
                fail(f"interop-export: the imported {family} does not hold the checkpoint's weights")
            requests = [flagship_inputs(torch, RandomMask([10], [4]), s, dev)
                        + (rss_maps(torch, s, dev) if maps else ()) for s in range(4)]
            eager = bind_model(model, device=dev)
            saves = []
            real_save = torch.export.save

            def timed_save(*args, **kw):
                t = time.perf_counter()
                real_save(*args, **kw)
                saves.append(time.perf_counter() - t)

            torch.export.save = timed_save
            artifact = Path(tmp) / f"{family}.pt2"
            try:
                t0 = time.perf_counter()
                first = requests[0]
                export_model(model, None, Complex(first[0], first[1]), first[2], path=artifact,
                             sens_maps=Complex(first[3], first[4]) if maps else None)
                export_total = time.perf_counter() - t0
            finally:
                torch.export.save = real_save
            rec.update(export_s=export_total - sum(saves), save_s=sum(saves),
                       artifact_mib=artifact.stat().st_size / 2**20)
            t0 = time.perf_counter()
            served = load_exported(artifact)
            rec["load_s"] = time.perf_counter() - t0

            def run(fn):
                dft_cuda.LAUNCHES = normal_cuda.LAUNCHES = 0
                outs = [fn(*r) for r in requests]
                torch.cuda.synchronize()
                return outs, {"dft": dft_cuda.LAUNCHES, "normal": normal_cuda.LAUNCHES}

            e_outs, rec["eager_launches"] = run(eager)
            a_outs, rec["artifact_launches"] = run(served)
            want = {k: 4 * v for k, v in per_forward[family].items()}
            rec["max_rel_err"] = [((a - e).abs().max() / e.abs().max()).item()
                                  for a, e in zip(a_outs, e_outs)]
            finite = all(o.shape == (1, T, H, W) and bool(torch.isfinite(o).all())
                         for o in e_outs + a_outs)
            times = {"eager": [], "artifact": []}
            for i in range(12):
                order = (("eager", eager), ("artifact", served))
                for label, fn in (order if i % 2 == 0 else order[::-1]):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    fn(*requests[i % 4])
                    e1.record()
                    e1.synchronize()
                    times[label].append(e0.elapsed_time(e1))
            rec["ms"] = times
            rec["ms_per_request"] = {k: statistics.median(v) for k, v in times.items()}
            print(f"[interop-export] {family}-XF ({'maps, ' if maps else ''}{hparams}): checkpoint "
                  f"{rec['checkpoint_mib']:.2f} MiB written in {rec['checkpoint_s']:.2f} s, imported "
                  f"and built in {rec['import_s']:.2f} s; export {rec['export_s']:.2f} s, save "
                  f"{rec['save_s']:.2f} s, load {rec['load_s']:.2f} s, artifact "
                  f"{rec['artifact_mib']:.2f} MiB; launches for 4 requests eager "
                  f"{rec['eager_launches']} artifact {rec['artifact_launches']} (expected {want}); "
                  f"artifact vs eager max |diff| / max |out| "
                  f"{[f'{e:.3e}' for e in rec['max_rel_err']]} (tol {MODEL_TOL:.0e}); ms per request "
                  f"(median of 12, CUDA events) eager {rec['ms_per_request']['eager']:.3f} artifact "
                  f"{rec['ms_per_request']['artifact']:.3f}")
            if not finite:
                fail(f"interop-export: a {family} image has the wrong shape or non-finite values")
            if not rec["eager_launches"] == rec["artifact_launches"] == want:
                fail(f"interop-export: {family} launches differ from each other or from {want}")
            if not max(rec["max_rel_err"]) <= MODEL_TOL:
                fail(f"interop-export: the {family} artifact disagrees with the eager forward")
            report[family] = rec
            del model, eager, served, e_outs, a_outs, requests, ckpt, ref, state_dict, got_sd
            torch.cuda.empty_cache()
    report["wall_s"] = time.perf_counter() - t_phase
    print(f"[interop-export] phase wall time {report['wall_s']:.1f} s (limit 120 s)")
    if report["wall_s"] > 120:
        fail(f"interop-export: the phase took {report['wall_s']:.1f} s, not under 120 s")
    return report


def profile_phase(torch, dev, data, launches):
    """``[profile]``: ``Trainer.fit`` of the flagship VarNet-XF (remat on) on
    ``[data]``'s two decoded volumes, 3 epochs of batch 1 (6 steps), with
    ``TrainerConfig.profile_steps=2``: the trace window skips the first step
    and holds steps 2 and 3. The trace is folded by ``instrument.opstats``;
    each of the three on-path kernels must appear in it as many times as the
    counters report launches over those two steps, times its kernels per
    launch at the precision set (KERNELS_PER_LAUNCH; at 'highest' the DFT 1,
    the normal apply 3, its backward 8), and each custom
    op's host events once per call. Per step: CUDA-event ms and host ms,
    traced and untraced."""
    from cinemri_tpu_torch.data import RandomMask, VarNetDataTransform
    from cinemri_tpu_torch.instrument import opstats
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops import fft as FFT
    from cinemri_tpu_torch.train import Loader, Trainer, TrainerConfig

    t_phase = time.perf_counter()
    transform = VarNetDataTransform(RandomMask([10], [4]), use_seed=False)
    ds = MemoryDataset(data["decoded"][:2], data["names"][:2], transform)
    loader = Loader(ds, batch_size=1, shuffle=True, seed=42, prefetch_size=2, num_workers=4)
    with tempfile.TemporaryDirectory() as tmp:
        # no log_dir: the card's host has no tensorboardX
        cfg = TrainerConfig(epochs=3, profile_steps=2, profile_dir=Path(tmp) / "profile")
        trainer = Trainer(build_model("varnet", "XF", device=dev, **FLAGSHIP), cfg,
                          train_loader=loader, device=dev)
        step = trainer._train_step
        rec = dict(launches=[], ms=[], host_ms=[])

        def counted_step(state, batch):
            before, t0 = launches(), time.perf_counter()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            state, aux = step(state, batch)
            e1.record()
            e1.synchronize()
            rec["host_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["ms"].append(e0.elapsed_time(e1))
            rec["launches"].append({k: v - before[k] for k, v in launches().items()})
            return state, aux

        trainer._train_step = counted_step
        trainer.fit()
        traces = sorted((Path(tmp) / "profile").glob("*.pt.trace.json"))
        if len(traces) != 1 or len(rec["launches"]) != 6:
            fail(f"profile: {len(traces)} traces for {len(rec['launches'])} steps, not 1 for 6")
        events = opstats.kernel_events(traces[0])
        fold = opstats.fold_by_kind(events)
        ops = op_events(traces[0])
        trace_mib = traces[0].stat().st_size / 2**20
    per_launch = KERNELS_PER_LAUNCH[FFT.get_dft_precision()]
    traced = {k: sum(s[k] for s in rec["launches"][1:3]) for k in per_launch}
    seen = {k: fold.get(FOLD_KINDS[k], {}).get("count", 0) for k in per_launch}
    op_calls = {k: ops.get(OP_NAMES[k], 0) for k in per_launch}
    busy, window = opstats.busy_share(events)
    report = dict(steps=rec, traced_launches=traced, trace_kernel_events=seen,
                  trace_op_events=ops, trace_mib=trace_mib, device_busy_ms=busy,
                  device_window_ms=window, by_kind=fold, wall_s=time.perf_counter() - t_phase)
    print(f"[profile] Trainer.fit, 6 steps, profile_steps=2: launches per step {rec['launches']}; "
          f"steps 2-3 traced: launches {traced}, kernel events in the trace {seen} (expected "
          f"launches x {per_launch}), custom-op host events {op_calls}; trace "
          f"{trace_mib:.1f} MiB, {len(events)} device events, device busy {busy:.2f} of "
          f"{window:.2f} ms; step ms (CUDA events) {[round(x, 3) for x in rec['ms']]}, host ms "
          f"{[round(x, 3) for x in rec['host_ms']]}; phase {report['wall_s']:.1f} s")
    print("[profile] fold by kind: " + json.dumps(
        {k: {"ms": round(v["ms"], 3), "count": v["count"]} for k, v in fold.items()}))
    if any(seen[k] != traced[k] * per_launch[k] or op_calls[k] != traced[k] or not traced[k]
           for k in per_launch):
        fail(f"profile: the trace holds {seen} kernel events and {op_calls} op calls for "
             f"{traced} launches")
    return report


def tf32_library(torch, mode, library):
    """A library yardstick ``(prep, call)`` at a TF32 mode's nearest library
    arithmetic: the complex64 call with ``allow_tf32`` on for 'default' (one
    TF32 pass) and off for 'high' (f32)."""
    prep, call = library

    def run(*args):
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = mode == "default"
        try:
            return call(*args)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved

    return prep, run


# Dense TF32 rate of the H100 SXM's tensor cores (NVIDIA data sheet), the
# bound of the 'high' (3 passes) and 'default' (1 pass) modes.
TF32_PEAK = 495e12
TF32_PASSES = {"high": 3, "default": 1}
# A TF32 kernel against its emulating plain version (the same TF32 operands
# and partial products, another summation order), relative to max |plain|.
TF32_TOL = 1e-5
# bf16 against f32 (the JAX package's tests/test_models.py bound): the
# largest difference and the mean one, relative to max |f32|.
BF16_MAX_TOL = 0.05
BF16_MEAN_TOL = 1e-2
# A bf16 fit's per-step losses through the kernels against the plain
# versions at the same mode (relative)
BF16_LOSS_RTOL = 1e-3
# Remat policies against full replay, first-step gradients (JAX's bound).
REMAT_RTOL, REMAT_ATOL = 1e-5, 1e-7


def precision_phase(torch, dev, peak_flops, peak_bw):
    """``[precision]``: the DFT (at the flagship layouts (150, 200, 200),
    (30000, 200, 1), (1, 15, 40000), (40000, 15, 1), the sens net's
    (10, 200, 200) and (30, 198, 201), whose rows are not 16-byte aligned)
    and the normal apply (b=1, t=15, c=10, 200x200, kt=15, and kt=1 with
    λ = 0.37) and its backward (kt=15, kt=1, and kt=15 with a K that is not
    Hermitian, so that Kᴴ and K differ) in the TF32 modes
    'high' (3xTF32) and 'default' (1xTF32): each against its emulating plain
    version (TF32_TOL x max |out|), printed against the 'highest' plain
    version, timed (event loop and CUDA graph), beside its bound (the mode's
    FLOP over TF32_PEAK, 'high' three times the FLOP, or the bytes over the
    memory rate) and the nearest library call: one complex64 ``matmul`` /
    ``einsum``, with ``allow_tf32`` on for 'default' and in f32 for 'high'.
    The DFT at N = 15 runs the FP32 kernel in every mode. Then the kernels
    one call of the normal apply and of its backward runs at each mode, by
    name under the profiler: KERNELS_PER_LAUNCH of them, and at 'high' and
    'default' both of the backward's contractions on its own ``wgmma``
    kernels, with no products pass at 'default'. Last, the fused FP32 tile
    at 'highest' (``normal_cuda.set_fp32_tile('fused')``, csrc/fp32_hopper.cuh)
    at the flagship cases: against the plain version (NORMAL_TOL), its bits
    against the engine route's, its device time alone beside the engine
    route's, the plain version's and the complex64 library call's, and its
    kernels by name (FUSED_KERNELS_PER_LAUNCH, no products pass). Returns the
    report and, per (kernel, mode), the largest error against the emulation
    or the plain version over the shapes (the ``kernels`` rows'
    ``max_abs_err``; mode 'highest fused' for the fused tile)."""
    from cinemri_tpu_torch.data.masks import RandomMask
    from cinemri_tpu_torch.ops import fft as FFT
    from cinemri_tpu_torch.ops.kernels import dft_cuda, normal_cuda
    from cinemri_tpu_torch.physics.operators import masked_normal_kernel

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(13)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    cases, errs_by_row = [], {}

    def check(kernel, shape, args, fn, plain, library, cost, mode, parts):
        got, want, highest = fn(*args, mode), plain(*args, mode), plain(*args, "highest")
        prep, lib_fn = tf32_library(torch, mode, library)
        lib_in = prep(*args)
        lib_fn(*lib_in)
        torch.cuda.synchronize()
        errs, moved = [], []
        for sl in parts:
            scale = max(a.abs().max().item() for a in want[sl])
            err = max((a - b_).abs().max().item() for a, b_ in zip(got[sl], want[sl]))
            errs.append((err, scale))
            moved.append(max((a - b_).abs().max().item() for a, b_ in zip(got[sl], highest[sl])) / scale)
            if not err <= TF32_TOL * scale:
                fail(f"{kernel}[{mode}] disagrees with its emulating plain version at {shape}: "
                     f"{err} > {TF32_TOL * scale}")
        if kernel == "normal_apply_bwd":
            lam_err = abs(got[4].sum().item() - want[4].sum().item()) / abs(want[4].sum().item())
            if not lam_err <= LAM_TOL:
                fail(f"normal_apply_bwd[{mode}] λ̄ disagrees at {shape}: rel {lam_err} > {LAM_TOL}")
        flops, nbytes = cost(*args)
        t_ops, t_bytes = flops * TF32_PASSES[mode] / TF32_PEAK * 1e3, nbytes / peak_bw * 1e3
        case = dict(kernel=kernel, mode=mode, **shape, max_abs_err=max(e for e, _ in errs),
                    max_rel_err=max(e / s for e, s in errs), vs_highest_rel=max(moved),
                    ms=cuda_ms(torch, lambda: fn(*args, mode)),
                    device_ms=graph_ms(torch, lambda: fn(*args, mode)),
                    plain_ms=cuda_ms(torch, lambda: plain(*args, mode), iters=10),
                    library_ms=cuda_ms(torch, lambda: lib_fn(*lib_in), iters=10),
                    bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes",
                    library=f"complex64 {'TF32' if mode == 'default' else 'f32'}")
        cases.append(case)
        print(f"[precision] {kernel}[{mode}] {shape}: vs its emulation max_abs_err "
              f"{case['max_abs_err']:.3e} rel {case['max_rel_err']:.3e} (tol {TF32_TOL:.0e}); vs "
              f"'highest' rel {case['vs_highest_rel']:.3e}; kernel {case['ms']:.4f} ms (device alone "
              f"{case['device_ms']:.4f}) plain {case['plain_ms']:.4f} ms library "
              f"({case['library']}) {case['library_ms']:.4f} ms bound {case['bound_ms']:.4f} ms "
              f"({case['bound_by']})")
        errs_by_row[kernel, mode] = max(errs_by_row.get((kernel, mode), 0.0), case["max_abs_err"])

    for mode in TF32_PASSES:
        # the flagship layouts, the sens net's 2000-column slab, rows that are
        # not 16-byte aligned (the mma.sync tile), and N = 15 (FP32)
        for o, n, i in ((T * C, H, W), (T * C * H, W, 1), (C, H, W), (30, 198, 201), (1, T, H * W),
                        (H * W, T, 1)):
            wr, wi = FFT._dft_tensors(n, False, False, "ortho", dev)
            check("complex_dft_matmul", dict(O=o, N=n, I=i), (randn(o, n, i), randn(o, n, i), wr, wi),
                  dft_cuda.complex_dft_matmul, dft_cuda.complex_dft_matmul_torch, dft_library(torch),
                  dft_cost, mode, (slice(0, 2),))
    mask = torch.from_numpy(RandomMask([10], [4])(T, H, seed=0)[None].astype(np.float32)).to(dev)
    kern = masked_normal_kernel(mask)
    sr, si = randn(1, C, H, W), randn(1, C, H, W)
    rss = torch.sqrt((sr * sr + si * si).sum(1, keepdim=True))
    xr, xi = randn(1, T, H, W), randn(1, T, H, W)
    ops = (kern.re.contiguous(), kern.im.contiguous(), sr / rss, si / rss)
    shape = dict(b=1, t=T, c=C, h=H, w=W, kt=T)
    kern1 = masked_normal_kernel(mask[:, :1])  # one K for every frame: kt = 1
    ops1 = (kern1.re.contiguous(), kern1.im.contiguous()) + ops[2:]
    # masked_normal_kernel's K is Hermitian (Kᴴ = K): a backward contracting
    # with K where it should use Kᴴ passes with it, and not with this one
    opsn = non_hermitian(torch, *ops[:2], randn) + ops[2:]
    # a cotangent correlated with x, so that λ̄ does not cancel
    gr, gi = xr + randn(1, T, H, W), xi + randn(1, T, H, W)
    bwd = (normal_cuda.normal_apply_bwd, normal_cuda.normal_apply_bwd_torch,
           normal_bwd_library(torch), normal_bwd_cost)
    for mode in TF32_PASSES:
        check("normal_apply", dict(shape, lam=0.0), (xr, xi) + ops + (0.0,), normal_cuda.normal_apply,
              normal_cuda.normal_apply_torch, normal_library(torch), normal_cost, mode, (slice(0, 2),))
        check("normal_apply", dict(shape, kt=1, lam=0.37), (xr, xi) + ops1 + (0.37,),
              normal_cuda.normal_apply, normal_cuda.normal_apply_torch, normal_library(torch),
              normal_cost, mode, (slice(0, 2),))
        for label, k_ops in ((dict(shape, lam=0.37), ops), (dict(shape, kt=1, lam=0.37), ops1),
                             (dict(shape, lam=0.37, K="non-Hermitian"), opsn)):
            check("normal_apply_bwd", label, (xr, xi, gr, gi) + k_ops + (0.37,), *bwd, mode,
                  (slice(0, 2), slice(2, 4)))
    # the kernels one call runs at each mode, by name under the profiler
    per_call = {}
    for mode in ("highest",) + tuple(TF32_PASSES):
        per_call[mode] = dict(
            normal=kernels_of_call(torch, lambda: normal_cuda.normal_apply(xr, xi, *ops, 0.0, mode)),
            normal_bwd=kernels_of_call(torch, lambda: normal_cuda.normal_apply_bwd(
                xr, xi, gr, gi, *ops, 0.37, mode)))
        for kind, kernels in per_call[mode].items():
            ours = [n for n, _ in kernels if "normal_apply" in n]
            print(f"[precision] {kind} at '{mode}' (b 1, t 15, c 10, 200x200, kt 15): "
                  f"{len(ours)} kernels a call, device µs: "
                  + "; ".join(f"{n} {us:.1f}" for n, us in kernels))
            if len(ours) != KERNELS_PER_LAUNCH[mode][kind]:
                fail(f"precision: {kind} at '{mode}' ran {len(ours)} kernels a call, not "
                     f"{KERNELS_PER_LAUNCH[mode][kind]}")
        if mode == "highest":
            # every contraction on the FP32 tile, ȳ on the copy Kᴴ (no other
            # tile, so not the adjoint's conjugated read of K); the products
            # pass stays (csrc/normal_passes.cuh says why)
            fwd = [n for n, _ in per_call[mode]["normal"] if "contract_kernel" in n]
            names = [n for n, _ in per_call[mode]["normal_bwd"] if "normal_apply" in n]
            bwd = [n for n in names if "contract_kernel" in n]
            if len(fwd) != 1 or len(bwd) != 2 or not all(FP32_TILE in n for n in fwd + bwd) or \
                    sum("normal_apply_bwd_adjoint_kernel" in n for n in names) != 1:
                fail(f"precision: at 'highest' the forward ran {fwd} and the backward {names}: "
                     f"not every contraction on the FP32 tile, ȳ on the copy Kᴴ")
            continue
        names = [n for n, _ in per_call[mode]["normal_bwd"] if "normal_apply" in n]
        wgmma = [n for n in names if "normal_apply_bwd_wgmma" in n]
        if not all("normal_apply_bwd" in n for n in names) or len(wgmma) != 2 or \
                (mode == "default" and any("products" in n for n in names)):
            fail(f"precision: the backward at '{mode}' ran {names}: not both contractions on "
                 f"the backward's own wgmma kernels" + (", products fused" if mode == "default" else ""))
    fused = fused_tile_checks(torch, normal_cuda, peak_flops, peak_bw, errs_by_row, [
        ("normal_apply", dict(shape, lam=0.0), (xr, xi) + ops + (0.0,)),
        ("normal_apply", dict(shape, kt=1, lam=0.37), (xr, xi) + ops1 + (0.37,)),
        ("normal_apply_bwd", dict(shape, lam=0.37), (xr, xi, gr, gi) + ops + (0.37,)),
        ("normal_apply_bwd", dict(shape, kt=1, lam=0.37), (xr, xi, gr, gi) + ops1 + (0.37,)),
        ("normal_apply_bwd", dict(shape, lam=0.37, K="non-Hermitian"),
         (xr, xi, gr, gi) + opsn + (0.37,))])
    wall = time.perf_counter() - t_phase
    print(f"[precision] phase wall time {wall:.1f} s")
    return dict(cases=cases, kernels_per_call=per_call, fused=fused, wall_s=wall), errs_by_row


def fused_tile_checks(torch, normal_cuda, peak_flops, peak_bw, errs_by_row, cases_):
    """The fused FP32 tile at 'highest' on ``cases_`` ((kernel, shape label,
    args) of the flagship): each call against the plain version (x̄ and s̄,
    or out, at NORMAL_TOL x max |plain|; λ̄ at LAM_TOL), the largest |fused -
    engine| over its outputs (0: the same bits), the device time alone of
    both routes, the plain version's and the library call's time and the
    bound; then the kernels one fused call of each runs, by name."""
    fns = {"normal_apply": (normal_cuda.normal_apply, normal_cuda.normal_apply_torch,
                            normal_library(torch), normal_cost),
           "normal_apply_bwd": (normal_cuda.normal_apply_bwd, normal_cuda.normal_apply_bwd_torch,
                                normal_bwd_library(torch), normal_bwd_cost)}
    routes = {"normal_apply": normal_cuda.LAUNCHES_BY_ROUTE,
              "normal_apply_bwd": normal_cuda.BWD_LAUNCHES_BY_ROUTE}
    report = dict(cases=[], kernels_per_call={})

    def on_fused(fn):
        normal_cuda.set_fp32_tile("fused")
        try:
            return fn()
        finally:
            normal_cuda.set_fp32_tile("engine")

    for kernel, shape, args in cases_:
        fn, plain, (prep, lib_fn), cost = fns[kernel]
        before = routes[kernel]["fp32_fused"]
        got = on_fused(lambda: fn(*args))
        if routes[kernel]["fp32_fused"] != before + 1:
            fail(f"fused tile: {kernel} at {shape} did not take the fused route")
        engine, want = fn(*args), plain(*args)
        lib_in = prep(*args)
        lib_fn(*lib_in)
        torch.cuda.synchronize()
        parts = (slice(0, 2),) if kernel == "normal_apply" else (slice(0, 2), slice(2, 4))
        err = 0.0
        for sl in parts:
            scale = max(a.abs().max().item() for a in want[sl])
            part_err = max((a - b_).abs().max().item() for a, b_ in zip(got[sl], want[sl]))
            err = max(err, part_err)
            if not part_err <= NORMAL_TOL * scale:
                fail(f"fused tile: {kernel} disagrees with its plain version at {shape}: "
                     f"{part_err} > {NORMAL_TOL * scale}")
        if kernel == "normal_apply_bwd":
            lam_err = abs(got[4].sum().item() - want[4].sum().item()) / abs(want[4].sum().item())
            if not lam_err <= LAM_TOL:
                fail(f"fused tile: normal_apply_bwd λ̄ disagrees at {shape}: rel {lam_err} > {LAM_TOL}")
        bits = max((a - b_).abs().max().item() for a, b_ in zip(got, engine))
        flops, nbytes = cost(*args)
        t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        case = dict(kernel=kernel, **shape, max_abs_err=err, max_abs_vs_engine=bits,
                    device_ms=on_fused(lambda: graph_ms(torch, lambda: fn(*args))),
                    engine_device_ms=graph_ms(torch, lambda: fn(*args)),
                    plain_ms=cuda_ms(torch, lambda: plain(*args), iters=10),
                    library_ms=cuda_ms(torch, lambda: lib_fn(*lib_in), iters=10),
                    bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes")
        report["cases"].append(case)
        errs_by_row[kernel, "highest fused"] = max(errs_by_row.get((kernel, "highest fused"), 0.0), err)
        print(f"[precision] {kernel}[highest, fused tile] {shape}: vs plain max_abs_err {err:.3e} "
              f"(tol {NORMAL_TOL:.0e} x max); max |fused - engine| {bits:.3e}; device alone: fused "
              f"{case['device_ms']:.4f} ms, engine {case['engine_device_ms']:.4f} ms; plain "
              f"{case['plain_ms']:.4f} ms library {case['library_ms']:.4f} ms bound "
              f"{case['bound_ms']:.4f} ms ({case['bound_by']})")
        del got, engine, want, lib_in
    xr_args = cases_[0][2]
    bwd_args = next(a for k, _, a in cases_ if k == "normal_apply_bwd")
    for kind, call in (("normal", lambda: normal_cuda.normal_apply(*xr_args)),
                       ("normal_bwd", lambda: normal_cuda.normal_apply_bwd(*bwd_args))):
        kernels = on_fused(lambda: kernels_of_call(torch, call))
        report["kernels_per_call"][kind] = kernels
        ours = [n for n, _ in kernels if "normal_apply" in n]
        print(f"[precision] {kind} at 'highest' on the fused tile (b 1, t 15, c 10, 200x200, "
              f"kt 15): {len(ours)} kernels a call, device µs: "
              + "; ".join(f"{n} {us:.1f}" for n, us in kernels))
        contractions = [n for n in ours if "fp32_fused_kernel" in n]
        if len(ours) != FUSED_KERNELS_PER_LAUNCH[kind] or \
                len(contractions) != (1 if kind == "normal" else 2) or \
                any("products" in n or "contract_kernel" in n for n in ours):
            fail(f"fused tile: {kind} ran {ours}: not every contraction on the fused tile, or a "
                 f"products pass")
    return report


def non_hermitian(torch, kr, ki, randn):
    """``(K_re, K_im)`` plus a random complex perturbation of 1 / sqrt(h) a
    part: a K that is not Hermitian (``masked_normal_kernel``'s is)."""
    h = kr.shape[-1]
    kr, ki = kr + randn(*kr.shape) / h ** 0.5, ki + randn(*ki.shape) / h ** 0.5
    if not (kr - kr.transpose(-1, -2)).abs().max().item() > 0.1:
        fail("non_hermitian: the perturbed K is still Hermitian")
    return kr.contiguous(), ki.contiguous()


def kernel_name(name: str) -> str:
    """A demangled kernel name without its return type, namespace prefix and
    argument list (template arguments kept)."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def kernels_of_call(torch, fn):
    """The device kernels one warm call of ``fn`` runs under
    ``torch.profiler``, in launch order: ``(name, device µs)``.

    The call sits in the middle of a window of host sleeps: on the H100 a
    window of one sub-millisecond call, taken late in this script's run,
    held no device event at all (in a fresh process it holds every one),
    as the profiler keeps only the device events it places inside its
    window. The window is widened once more if it still holds none."""
    from torch.profiler import ProfilerActivity, profile

    from cinemri_tpu_torch.instrument import opstats

    fn()
    torch.cuda.synchronize()
    for pad_s in (0.5, 3.0):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_s)
            fn()
            torch.cuda.synchronize()
            time.sleep(pad_s)
        with tempfile.TemporaryDirectory() as tmp:
            prof.export_chrome_trace(str(Path(tmp) / "trace.json"))
            events = sorted(opstats.kernel_events(Path(tmp) / "trace.json"), key=lambda e: e[1])
        if events:
            break
    return [(kernel_name(name), dur) for name, _, dur in events]


def request_profile(torch, fn):
    """One call of ``fn`` under the profiler: host ms, device busy ms, the
    device's idle share of the host time, the device ms of the three
    largest kernel kinds (``instrument/opstats.py``) and the three
    convolution kernels with the most device time (name, ms, launches)."""
    from torch.profiler import ProfilerActivity, profile

    from cinemri_tpu_torch.instrument import opstats

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
    busy, _ = opstats.busy_share(events)
    top = list(opstats.fold_by_kind(events).items())[:3]
    convs = opstats.top_names(events, "conv / gemm (cuDNN, cuBLAS)", 3)
    return dict(host_ms=host_ms, device_busy_ms=busy, idle_share=1 - busy / host_ms,
                top_kinds={k: round(v["ms"], 3) for k, v in top},
                top_convs=[(n[:70], round(ms, 3), count) for n, ms, count in convs])


def bf16_phase(torch, dev, data):
    """``[bf16]``: the flagship VarNet-XF (10 cascades, chans 16, pools 3,
    sens 8/3; RandomMask([10], [4]) requests) served through
    ``serve.bind_model`` (one warm request, then the four requests of
    ``[serve]``, then one profiled: the device's idle share) and fitted by
    ``Trainer.fit`` (1 epoch of 3 steps over ``[data]``'s volumes 0, 1, 0),
    from the same weights, in f32 at 'highest', in bf16 at 'highest', 'high'
    and 'default'; then one CineNet-XF and one XPDNet-XF (norm_buffers on)
    forward in bf16 beside f32. Each bf16 output against the f32 one of the
    same request: max <= BF16_MAX_TOL and mean < BF16_MEAN_TOL of max |f32|
    (the JAX package's bound). Params and gradients stay f32, losses finite;
    the launches of each kernel at each mode are counted (the 'high' and
    'default' runs must launch all three at their mode).

    The 'high' and 'default' runs are the TF32 kernels' main path: each
    kernel call in them is timed (``Timed``), and the same run is repeated
    through the plain versions at that mode and through the library calls
    (``tf32_library``), each timed the same way, for the ``kernels`` rows.
    The plain run's served images and losses are held against the kernel
    run's: the same arithmetic in another summation order, which bf16
    activations carry up to their own rounding (BF16_MAX_TOL /
    BF16_MEAN_TOL of max |out|, losses within BF16_LOSS_RTOL)."""
    from cinemri_tpu_torch.data import EquispacedMask, RandomMask, VarNetDataTransform
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops import fft as FFT
    from cinemri_tpu_torch.ops.cplx import Complex
    from cinemri_tpu_torch.ops.kernels import dft_cuda, normal_cuda
    from cinemri_tpu_torch.physics import operators as OPS
    from cinemri_tpu_torch.serve import bind_model
    from cinemri_tpu_torch.train import Loader, Trainer, TrainerConfig

    t_phase = time.perf_counter()
    requests = [flagship_inputs(torch, mf, s, dev) for mf, s in
                [(RandomMask([10], [4]), s) for s in (0, 1, 2)] + [(EquispacedMask([0.08], [4]), 3)]]
    transform = VarNetDataTransform(RandomMask([10], [4]), use_seed=False)
    ds = MemoryDataset([data["decoded"][i] for i in (0, 1, 0)], ["bf16_0", "bf16_1", "bf16_2"],
                       transform)
    counters = (dft_cuda.LAUNCHES_BY_PRECISION, normal_cuda.LAUNCHES_BY_PRECISION,
                normal_cuda.BWD_LAUNCHES_BY_PRECISION)

    def counts():
        return [dict(c) for c in counters]

    def grads_f32(model):
        for name, p in model.named_parameters():
            if p.dtype != torch.float32 or (p.grad is not None and p.grad.dtype != torch.float32):
                fail(f"bf16: {name} is {p.dtype} with a {p.grad.dtype} gradient, not f32")

    def set_backends(backend):
        FFT.set_dft_backend(backend)
        OPS.set_normal_backend(backend)

    def run(label, bf16, mode, timers=(), backend="kernel"):
        """Serve and fit at ``mode`` through ``backend``, with ``timers``
        standing in for the wrappers; returns the run's record."""
        FFT.set_dft_precision(mode)
        set_backends(backend)
        try:
            with contextlib.ExitStack() as stack:
                for timer in timers:
                    stack.enter_context(timer)
                before = counts()
                model = build_model("varnet", "XF", device=dev,
                                    generator=torch.Generator().manual_seed(0), bf16=bf16,
                                    **FLAGSHIP).eval()
                serve = bind_model(model, device=dev)
                serve(*requests[0])
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                latency, outs = [], []
                for request in requests:
                    t0 = time.perf_counter()
                    outs.append(serve(*request))
                    torch.cuda.synchronize()
                    latency.append((time.perf_counter() - t0) * 1e3)
                serve_peak = torch.cuda.max_memory_allocated()
                profiled = request_profile(torch, lambda: serve(*requests[0]))
                del serve, model
                torch.cuda.empty_cache()
                trainer = Trainer(build_model("varnet", "XF", device=dev,
                                              generator=torch.Generator().manual_seed(0), bf16=bf16,
                                              **FLAGSHIP),
                                  TrainerConfig(epochs=1), device=dev,
                                  train_loader=Loader(ds, batch_size=1, shuffle=False, seed=42,
                                                      prefetch_size=2, num_workers=4))
                step = trainer._train_step
                rec = dict(ms=[], loss=[])

                def timed_step(state, batch):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    state, aux = step(state, batch)
                    e1.record()
                    e1.synchronize()
                    rec["ms"].append(e0.elapsed_time(e1))
                    rec["loss"].append(aux["loss"].item())
                    grads_f32(state.model)
                    return state, aux

                trainer._train_step = timed_step
                torch.cuda.reset_peak_memory_stats()
                trainer.fit()
                fit_peak = torch.cuda.max_memory_allocated()
                grads_f32(trainer.state.model)
                after = counts()
        finally:
            FFT.set_dft_precision("highest")
            set_backends("kernel")
        if len(rec["loss"]) != 3 or not all(math.isfinite(x) for x in rec["loss"]):
            fail(f"bf16 ({label}): the fit took {len(rec['loss'])} steps with losses {rec['loss']}")
        launches = {k: {m: a[m] - b_[m] for m in a} for k, a, b_ in zip(("dft", "normal", "normal_bwd"),
                                                                       after, before)}
        del trainer
        torch.cuda.empty_cache()
        return dict(outs=outs, latency_ms=latency, ms_per_volume=statistics.median(latency),
                    profile=profiled, serve_peak_mib=serve_peak / 2**20, step_ms=rec["ms"],
                    ms_per_step=statistics.median(rec["ms"][1:]), losses=rec["loss"],
                    fit_peak_mib=fit_peak / 2**20, launches=launches)

    runs, timers, plain_vs_kernels = {}, {}, {}
    for label, bf16, mode in (("f32 highest", False, "highest"), ("bf16 highest", True, "highest"),
                              ("bf16 high", True, "high"), ("bf16 default", True, "default")):
        if mode == "highest":
            runs[label] = run(label, bf16, mode)
        else:
            tkern = (Timed(torch, dft_cuda, "complex_dft_matmul", dft_cost),
                     Timed(torch, normal_cuda, "normal_apply", normal_cost),
                     Timed(torch, normal_cuda, "normal_apply_bwd", normal_bwd_cost))
            runs[label] = run(label, bf16, mode, tkern)
            tplain = (Timed(torch, dft_cuda, "complex_dft_matmul_torch", dft_cost),
                      Timed(torch, normal_cuda, "normal_apply_torch", normal_cost),
                      Timed(torch, normal_cuda, "normal_apply_bwd_torch", normal_bwd_cost))
            plain = run(f"{label}, plain versions", bf16, mode, tplain, backend="torch")
            tlib = tuple(Timed(torch, mod, attr, cost, *tf32_library(torch, mode, lib)[::-1])
                         for mod, attr, cost, lib in (
                (dft_cuda, "complex_dft_matmul_torch", dft_cost, dft_library(torch)),
                (normal_cuda, "normal_apply_torch", normal_cost, normal_library(torch)),
                (normal_cuda, "normal_apply_bwd_op", normal_bwd_op_cost, normal_bwd_op_library(torch))))
            lib = run(f"{label}, library calls", bf16, mode, tlib, backend="torch")
            timers[mode] = (tkern, tplain, tlib)
            errs = []
            for a, b_ in zip(plain["outs"], runs[label]["outs"]):
                scale = b_.abs().max().item()
                errs.append(((a - b_).abs().max().item() / scale, (a - b_).abs().mean().item() / scale))
            loss_rel = max(abs(a - b_) / abs(b_) for a, b_ in zip(plain["losses"], runs[label]["losses"]))
            plain_vs_kernels[mode] = dict(vs_kernels=errs, loss_rel=loss_rel,
                                          plain_ms_per_volume=plain["ms_per_volume"],
                                          plain_ms_per_step=plain["ms_per_step"],
                                          library_ms_per_volume=lib["ms_per_volume"],
                                          library_ms_per_step=lib["ms_per_step"])
            print(f"[bf16] VarNet-XF {label} through the plain versions at {mode!r}: "
                  f"{plain['ms_per_volume']:.3f} ms per volume, {plain['ms_per_step']:.3f} ms per step "
                  f"(library calls {lib['ms_per_volume']:.3f} / {lib['ms_per_step']:.3f}); served "
                  f"images vs the kernels' max / mean over max |out| "
                  f"{[(f'{m:.3e}', f'{a:.3e}') for m, a in errs]}, losses rel {loss_rel:.3e} (tol "
                  f"{BF16_LOSS_RTOL:.0e})")
            if not (all(m <= BF16_MAX_TOL and a < BF16_MEAN_TOL for m, a in errs)
                    and loss_rel <= BF16_LOSS_RTOL):
                fail(f"bf16 ({label}): the plain versions at {mode!r} disagree with the kernels: "
                     f"{errs}, losses rel {loss_rel}")
            if any(plain["launches"][k][m] or lib["launches"][k][m] for k in plain["launches"]
                   for m in plain["launches"][k]):
                fail(f"bf16 ({label}): the plain or library run launched a kernel")
            del plain, lib
        launches = runs[label]["launches"]
        if mode != "highest" and not all(launches[k][mode] > 0 for k in launches):
            fail(f"bf16 ({label}): the run did not launch every kernel at {mode!r}: {launches}")
        if any(launches[k][m] for k in launches for m in launches[k] if m != mode):
            fail(f"bf16 ({label}): launches at another precision than {mode!r}: {launches}")
    ref = runs["f32 highest"]
    ref_outs = ref["outs"]
    for label, run_ in runs.items():
        errs = []
        for a, b_ in zip(run_.pop("outs"), ref_outs):
            scale = b_.abs().max().item()
            errs.append(((a - b_).abs().max().item() / scale, (a - b_).abs().mean().item() / scale))
        run_["vs_f32"] = errs
        if label != "f32 highest" and not all(m <= BF16_MAX_TOL and a < BF16_MEAN_TOL for m, a in errs):
            fail(f"bf16 ({label}): the served images leave the bound against f32: {errs}")
        print(f"[bf16] VarNet-XF {label}: {run_['ms_per_volume']:.3f} ms per volume (f32 "
              f"{ref['ms_per_volume']:.3f}), serving peak {run_['serve_peak_mib']:.1f} MiB (f32 "
              f"{ref['serve_peak_mib']:.1f}); Trainer.fit {run_['ms_per_step']:.3f} ms per step (f32 "
              f"{ref['ms_per_step']:.3f}), peak {run_['fit_peak_mib']:.1f} MiB (f32 "
              f"{ref['fit_peak_mib']:.1f}), losses {[round(x, 6) for x in run_['losses']]}; one "
              f"profiled request: device busy {run_['profile']['device_busy_ms']:.3f} of "
              f"{run_['profile']['host_ms']:.3f} host ms, idle {run_['profile']['idle_share']:.1%}, "
              f"top kinds {run_['profile']['top_kinds']}; vs f32 "
              f"max / mean over max |f32| {[(f'{m:.3e}', f'{a:.3e}') for m, a in errs]}; launches "
              f"{run_['launches']}")
    del ref_outs

    others = {}
    kre, kim, mask = requests[0]
    k = Complex(kre, kim)
    # XPDNet's bf16 normalizes its MWCNN buffers (norm_buffers=None resolves
    # to bf16): the f32 run takes the same function, as the JAX package's test
    for family, config, args in (("cinenet", CINENET, (k, mask, Complex(*rss_maps(torch, 0, dev)))),
                                 ("xpdnet", dict(XPDNET, norm_buffers=True), (k, mask))):
        rec = {}
        for bf16 in (False, True):
            model = build_model(family, "XF", device=dev, generator=torch.Generator().manual_seed(0),
                                bf16=bf16, **config).eval()
            with torch.inference_mode():
                model(*args)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = model(*args)
                torch.cuda.synchronize()
            rec[bf16] = dict(out=out, ms=(time.perf_counter() - t0) * 1e3,
                             peak_mib=torch.cuda.max_memory_allocated() / 2**20)
            del model
            torch.cuda.empty_cache()
        scale = rec[False]["out"].abs().max().item()
        diff = (rec[True].pop("out") - rec[False].pop("out")).abs()
        errs = (diff.max().item() / scale, diff.mean().item() / scale)
        others[family] = dict(f32=rec[False], bf16=rec[True], vs_f32=errs)
        print(f"[bf16] {family}-XF forward in bf16: {rec[True]['ms']:.3f} ms (f32 {rec[False]['ms']:.3f}), "
              f"peak {rec[True]['peak_mib']:.1f} MiB (f32 {rec[False]['peak_mib']:.1f}); vs f32 max / "
              f"mean over max |f32| {errs[0]:.3e} / {errs[1]:.3e}")
        if not (errs[0] <= BF16_MAX_TOL and errs[1] < BF16_MEAN_TOL):
            fail(f"bf16: the {family}-XF forward leaves the bound against f32: {errs}")
    wall = time.perf_counter() - t_phase
    print(f"[bf16] phase wall time {wall:.1f} s")
    return dict(varnet=runs, others=others, plain_vs_kernels=plain_vs_kernels, wall_s=wall), timers


def remat_phase(torch, dev):
    """``[remat]``: the flagship VarNet-XF train step (``train_batch``, Adam
    1e-4) under each remat policy, from the same weights. First one step
    with cuDNN's deterministic algorithms, so that two runs of the same work
    agree bit for bit: its gradients against full replay's (``""``) within
    REMAT_RTOL / REMAT_ATOL. Then three steps with cuDNN's defaults, as
    training runs: ms per step (CUDA events, median of steps 2-3), peak
    memory and the outputs each policy kept per step."""
    from cinemri_tpu_torch.models import build_model, remat
    from cinemri_tpu_torch.train import create_train_state, make_train_step

    t_phase = time.perf_counter()
    batch = train_batch(torch, dev)
    step = make_train_step()

    def steps(policy, n):
        model = build_model("varnet", "XF", device=dev, generator=torch.Generator().manual_seed(0),
                            remat_policy=policy, **FLAGSHIP)
        state = create_train_state(model, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec, kept = dict(ms=[], loss=[]), remat.SAVED[policy]
        for i in range(n):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            state, aux = step(state, batch)
            e1.record()
            e1.synchronize()
            rec["ms"].append(e0.elapsed_time(e1))
            rec["loss"].append(aux["loss"].item())
            if i == 0:
                rec["grads"] = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
        rec.update(peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                   kept_per_step=(remat.SAVED[policy] - kept) / n)
        del model, state
        torch.cuda.empty_cache()
        return rec

    saved_det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        first = {policy: steps(policy, 1)["grads"] for policy in remat.REMAT_POLICIES}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_det
    runs = {}
    for policy in remat.REMAT_POLICIES:
        rec = steps(policy, 3)
        rec.pop("grads")
        runs[policy or "full replay"] = dict(rec, ms_per_step=statistics.median(rec["ms"][1:]))
    for policy in remat.REMAT_POLICIES[1:]:
        worst = max(((first[policy][n] - g).abs() - REMAT_RTOL * g.abs()).max().item()
                    for n, g in first[""].items())
        runs[policy]["grad_excess"] = worst
        if not worst <= REMAT_ATOL:
            fail(f"remat {policy!r}: first-step gradients leave rtol {REMAT_RTOL} / atol "
                 f"{REMAT_ATOL} of full replay's (excess {worst})")
    for label, run in runs.items():
        print(f"[remat] {label!r}: {run['ms_per_step']:.3f} ms per step ({[round(x, 3) for x in run['ms']]}), "
              f"peak {run['peak_mib']:.1f} MiB, outputs kept per step {run['kept_per_step']:.0f}, "
              f"losses {[round(x, 6) for x in run['loss']]}"
              + (f"; first-step gradients vs full replay (cuDNN deterministic): excess over rtol "
                 f"{run['grad_excess']:.3e}" if "grad_excess" in run else ""))
    wall = time.perf_counter() - t_phase
    print(f"[remat] phase wall time {wall:.1f} s")
    return dict(runs=runs, wall_s=wall)


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

    from cinemri_tpu_torch.data.espirit import espirit_maps_multi
    from cinemri_tpu_torch.data.masks import EquispacedMask, RandomMask
    from cinemri_tpu_torch.instrument import opstats, trace
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops import fft as FFT
    from cinemri_tpu_torch.ops.cplx import Complex, to_channels
    from cinemri_tpu_torch.ops.kernels import _build, dft_cuda, fft2_cuda, normal_cuda
    from cinemri_tpu_torch.physics import cg
    from cinemri_tpu_torch.physics import operators as OPS
    from cinemri_tpu_torch.serve import bind_model
    from cinemri_tpu_torch.train import create_train_state, make_train_step
    from cinemri_tpu_torch.utils import compile_cache

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
    built = _build.build(verbose=True, force=True)
    print(f"[build] {time.perf_counter() - t0:.2f} s for {sorted(built)} (one nvcc each, in parallel) "
          f"into {compile_cache.build_dir()} (compile cache, host fingerprint "
          f"{compile_cache.host_fingerprint()})")
    for kname, info in built.items():
        print(f"[build] {kname}: {info['seconds']:.2f} s -> {_build.library_path(kname).name}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    t0 = time.perf_counter()
    again = _build.build()
    print(f"[build] second build of the run: {time.perf_counter() - t0:.3f} s, hits "
          f"{ {k: v['hit'] for k, v in again.items()} }")
    if not all(v["hit"] for v in again.values()):
        fail(f"the second build of the run missed the compile cache: {again}")

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
        device = dict(device_ms=graph_ms(torch, lambda: fn(*args)),
                      plain_device_ms=graph_ms(torch, lambda: plain(*args), iters=10),
                      library_device_ms=graph_ms(torch, lambda: lib(*lib_in), iters=10))
        b_ms, b_by = bound(normal_bwd_cost(*args), peak_flops, peak_bw)
        err = max(errs["kernel_xbar"][0], errs["kernel_sbar"][0])
        case = dict(kernel="normal_apply_bwd", **shape, max_abs_err=err,
                    max_rel_err={k: v[0] / v[1] for k, v in errs.items() if isinstance(v, tuple)},
                    lambar_rel_err=errs["kernel_lambar_rel"],
                    library_lambar_rel_err=errs["library_lambar_rel"], ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=b_ms, bound_by=b_by, **device)
        cases.append(case)
        print(f"[kernel] normal_apply_bwd {shape}: rel err x̄ {case['max_rel_err']['kernel_xbar']:.3e} "
              f"s̄ {case['max_rel_err']['kernel_sbar']:.3e} λ̄ {errs['kernel_lambar_rel']:.3e} "
              f"(tol {NORMAL_TOL:.0e} x max, λ̄ {LAM_TOL:.0e}; library x̄ "
              f"{case['max_rel_err']['library_xbar']:.3e} s̄ {case['max_rel_err']['library_sbar']:.3e}) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library {library_ms:.4f} ms "
              f"bound {b_ms:.4f} ms ({b_by}); device alone (CUDA graph): kernel "
              f"{device['device_ms']:.4f} ms plain {device['plain_device_ms']:.4f} ms library "
              f"{device['library_device_ms']:.4f} ms")

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
                    top_other=opstats.top_names(events, "other"),
                    normal_apply_kernels={kind: opstats.top_names(events, kind, 8) for kind in (
                        "normal_apply (port kernels)", "normal_apply_bwd (port kernels)")})

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
                   normal_library(torch), normal_cost, NORMAL_TOL, graph=True)
        # a second yardstick: the contraction alone as one complex64 matmul
        matmul = contraction_matmul(torch, normal_cuda, *args)
        cases[-1].update(contraction_matmul_ms=cuda_ms(torch, matmul, iters=10),
                         contraction_matmul_device_ms=graph_ms(torch, matmul, iters=10))
        print(f"[kernel] normal_apply {(b, kt)}: the contraction alone as one complex64 matmul "
              f"{cases[-1]['contraction_matmul_ms']:.4f} ms (device alone "
              f"{cases[-1]['contraction_matmul_device_ms']:.4f} ms)")
        del matmul
        # the backward on the same operands; g = x + noise keeps λ̄ = Σ Re⟨g, x⟩
        # from cancelling, so its relative error measures the kernel
        xr, xi = args[0], args[1]
        bwd_args = (xr, xi, xr + randn(b, T, H, W), xi + randn(b, T, H, W)) + args[2:6] + (lam,)
        check_bwd_case(dict(b=b, t=T, c=C, h=H, w=W, kt=kt, lam=lam_label), bwd_args)
        # its two contractions alone as complex64 matmuls
        matmul = bwd_contractions_matmul(torch, normal_cuda, *bwd_args[:8])
        cases[-1].update(contractions_matmul_ms=cuda_ms(torch, matmul, iters=10),
                         contractions_matmul_device_ms=graph_ms(torch, matmul, iters=10))
        print(f"[kernel] normal_apply_bwd {(b, kt)}: its two contractions alone as complex64 "
              f"matmuls {cases[-1]['contractions_matmul_ms']:.4f} ms (device alone "
              f"{cases[-1]['contractions_matmul_device_ms']:.4f} ms)")
        del matmul, bwd_args
    del args, sr, si, rss, kern, xr, xi

    # the coil axis's shards (``[mesh]``): each of two ranks runs the sens
    # net's and x_ref's ifft2c, and the normal apply and its backward with
    # λ = 0, on 5 of the 10 coils (maps normalized by the RSS of all 10);
    # the ``mesh`` rows take their max_abs_err from these cases
    shard = dict(shard=f"coil {C // 2} of {C}")
    for o, n, i in ((C // 2, H, W), (C // 2 * H, W, 1), (T * C // 2, H, W), (T * C // 2 * H, W, 1)):
        wr, wi = FFT._dft_tensors(n, False, False, "ortho", dev)
        check_case("complex_dft_matmul", dict(O=o, N=n, I=i, **shard),
                   (randn(o, n, i), randn(o, n, i), wr, wi),
                   dft_cuda.complex_dft_matmul, dft_cuda.complex_dft_matmul_torch,
                   dft_library(torch), dft_cost, DFT_TOL)
    masks = RandomMask([10], [4])(T, H, seed=5)[None]
    kern = OPS.masked_normal_kernel(torch.from_numpy(masks).to(dev))
    sr, si = randn(1, C, H, W), randn(1, C, H, W)
    rss = torch.sqrt((sr * sr + si * si).sum(1, keepdim=True))
    args = (randn(1, T, H, W), randn(1, T, H, W), kern.re.contiguous(), kern.im.contiguous(),
            (sr / rss)[:, :C // 2].contiguous(), (si / rss)[:, :C // 2].contiguous())
    check_case("normal_apply", dict(b=1, t=T, c=C // 2, h=H, w=W, kt=T, lam=0.0, **shard),
               args + (0.0,), normal_cuda.normal_apply, normal_cuda.normal_apply_torch,
               normal_library(torch), normal_cost, NORMAL_TOL)
    xr, xi = args[0], args[1]
    check_bwd_case(dict(b=1, t=T, c=C // 2, h=H, w=W, kt=T, lam=0.0, **shard),
                   (xr, xi, xr + randn(1, T, H, W), xi + randn(1, T, H, W)) + args[2:6] + (0.0,))
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

    # -- 2b. the host cost of the custom ops ------------------------------------------
    # The models reach the kernels through torch.ops.cinemri.* (ComplexDFTMatmul
    # and NormalApply call the ops); the wrapper alone is the route before the
    # ops. Event-loop ms (mean of 20 warm calls): at (1, 15, 40000) the host's
    # rate of issuing calls, not the kernel. In turns: wrapper, op, op, wrapper.
    wt = FFT._dft_tensors(T, False, False, "ortho", dev) + FFT._dft_adjoint_tensors(
        T, False, False, "ortho", dev)
    xr_, xi_ = randn(1, T, H * W), randn(1, T, H * W)
    xg_ = xr_.clone().requires_grad_()
    nk = OPS.masked_normal_kernel(torch.from_numpy(RandomMask([10], [4])(T, H, seed=1)[None]).to(dev))
    ns_r, ns_i = randn(1, C, H, W), randn(1, C, H, W)
    n_args = (randn(1, T, H, W), randn(1, T, H, W), nk.re.contiguous(), nk.im.contiguous(), ns_r, ns_i)
    op_routes = {
        "dft (1, 15, 40000)": (lambda: dft_cuda.complex_dft_matmul(xr_, xi_, *wt[:2]),
                               lambda: dft_cuda.ComplexDFTMatmul.apply(xr_, xi_, *wt, False)),
        "dft (1, 15, 40000), autograd recording": (
            lambda: dft_cuda.complex_dft_matmul(xr_, xi_, *wt[:2]),
            lambda: dft_cuda.ComplexDFTMatmul.apply(xg_, xi_, *wt, False)),
        "normal apply b=1 kt=15 lam=0.0": (lambda: normal_cuda.normal_apply(*n_args, 0.0),
                                           lambda: normal_cuda.NormalApply.apply(*n_args, 0.0, False)),
    }
    op_cost = {}
    for label, (wrapper, op) in op_routes.items():
        turns = {"wrapper": [], "op": []}
        for side in ("wrapper", "op", "op", "wrapper"):
            turns[side].append(cuda_ms(torch, wrapper if side == "wrapper" else op))
        op_cost[label] = dict(turns, wrapper_ms=statistics.mean(turns["wrapper"]),
                              op_ms=statistics.mean(turns["op"]),
                              op_device_ms=graph_ms(torch, op))
        print(f"[custom-op] {label}: event-loop ms per call, wrapper {op_cost[label]['wrapper_ms']:.4f} "
              f"({turns['wrapper']}), custom op {op_cost[label]['op_ms']:.4f} ({turns['op']}); "
              f"custom op device alone (CUDA graph) {op_cost[label]['op_device_ms']:.4f}")
    del wt, xr_, xi_, xg_, nk, ns_r, ns_i, n_args, op_routes
    torch.cuda.empty_cache()

    def set_backends(backend):
        FFT.set_dft_backend(backend)
        OPS.set_normal_backend(backend)

    def dft_layouts(fn):
        """The distinct (O, N, I) of the DFT launches in one call of ``fn``,
        with their counts, the copies ``_apply_dft`` made and those
        ``normal_plus_lambda_kernel`` made of a strided x."""
        seen = collections.Counter()
        saved = dft_cuda.complex_dft_matmul

        def record(xr, xi, wr, wi, precision="highest"):
            seen[tuple(xr.shape)] += 1
            return saved(xr, xi, wr, wi, precision)

        dft_cuda.complex_dft_matmul = record
        FFT.COPIES = OPS.COPIES = 0
        try:
            fn()
        finally:
            dft_cuda.complex_dft_matmul = saved
        return {str(k): v for k, v in seen.items()}, FFT.COPIES, OPS.COPIES

    def forward_phase(tag, forward, expected, max_copies, copies=None, reference=None):
        """The forward through the kernels (launches counted) and through the
        plain versions, checked against each other to MODEL_TOL, or, given
        ``reference`` (the plain versions in float64), each against it: the
        kernels no farther (relative L2) than F64_RATIO times the plain
        versions; the DFT layouts and copies of one more forward (fewer than
        ``max_copies``; or exactly ``copies`` = (DFT, normal apply) input
        copies); then 12 timed warm forwards."""
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
              f"({'tol ' + format(MODEL_TOL * scale, '.3e') if reference is None else 'held against float64'}"
              f", max |out| {scale:.4f})")
        f64 = None
        if reference is not None:
            f64 = {label: dict(l2=(torch.linalg.vector_norm(o - reference)
                                   / torch.linalg.vector_norm(reference)).item(),
                               max=((o - reference).abs().max() / reference.abs().max()).item())
                   for label, o in (("plain", out_plain), ("kernels", out_kernel))}
            print(f"[{tag}] against the plain versions in float64, relative L2 / max |diff| over "
                  f"max |out|: " + ", ".join(f"{k_} {v['l2']:.3e} / {v['max']:.3e}"
                                             for k_, v in f64.items()))
            if not f64["kernels"]["l2"] <= F64_RATIO * f64["plain"]["l2"]:
                fail(f"{tag}: the kernels' forward is more than {F64_RATIO}x as far from float64 "
                     f"as the plain versions'")
        elif not err <= MODEL_TOL * scale:
            fail(f"{tag}: the forward through the kernels disagrees with the plain forward: {err}")
        layouts, dft_copies, normal_copies = dft_layouts(forward)
        print(f"[{tag}] DFT launches by (O, N, I): {layouts}; _apply_dft copies per forward: "
              f"{dft_copies} ({'limit ' + str(max_copies) if copies is None else 'expected ' + str(copies[0])}); "
              f"normal_plus_lambda_kernel copies of a strided x: {normal_copies}")
        if copies is None and not dft_copies < max_copies:
            fail(f"{tag}: _apply_dft made {dft_copies} copies in a forward, not fewer than {max_copies}")
        if copies is not None and (dft_copies, normal_copies) != copies:
            fail(f"{tag}: {(dft_copies, normal_copies)} input copies per forward, not {copies}")
        torch.cuda.reset_peak_memory_stats()
        times = [cuda_ms(torch, forward, iters=1, warmup=1 if i == 0 else 0) for i in range(12)]
        peak = torch.cuda.max_memory_allocated()
        ms_vol = statistics.median(times)
        print(f"[{tag}] kernels: {ms_vol:.3f} ms/volume (median of {len(times)}, min {min(times):.3f}), "
              f"{T / ms_vol * 1e3:.2f} frames/s, peak memory {peak / 2**20:.1f} MiB")
        return dict(out=out_kernel, scale=scale, max_abs_err=err, float64_distance=f64,
                    launches_per_forward=per_forward,
                    dft_layouts=layouts, dft_copies=dft_copies, normal_copies=normal_copies,
                    forward_ms=times, ms_per_volume=ms_vol, frames_per_s=T / ms_vol * 1e3,
                    peak_memory_bytes=peak)

    def serve_phase(tag, serve, inputs, expected, direct_out=None, scale=None, references=None):
        """The requests through ``serve`` four times: (a) through the kernels,
        whose launches are counted per request, (b) through the plain
        versions and (c) through one library call each, both in the plain
        versions' slots, uncounted. CUDA events around every call of each
        (Timed), every CG solve eager. Then (d) untimed through the kernels
        again, CineNet's CG solves on their CUDA graphs: the same launches
        per request and, where a graph replayed, the same images as (a). ``serve`` and ``expected`` (launches per request) are one
        for all requests or a list with one per request. Without
        ``direct_out`` (request 0's direct forward) and its ``scale``, each
        request is held to MODEL_TOL x the max |out| of its plain version,
        or, where ``references`` gives it a float64 evaluation of the plain
        versions, the kernels to no more than F64_RATIO times the relative
        L2 distance from it of the farther of the two other f32 orders, the
        plain versions and the library calls (the largest difference, which
        single pixels of a chaotic output set, is printed too)."""
        serves = serve if isinstance(serve, list) else [serve] * len(inputs)
        expect = expected if isinstance(expected, list) else [expected] * len(inputs)

        def serve_all(*timers):
            latencies, outs, counts = [], [], []
            with contextlib.ExitStack() as stack:
                for timer in timers:
                    stack.enter_context(timer)
                for fn, request in zip(serves, inputs):
                    before = (dft_cuda.LAUNCHES, normal_cuda.LAUNCHES)
                    t0 = time.perf_counter()
                    outs.append(fn(*request))
                    torch.cuda.synchronize()
                    latencies.append((time.perf_counter() - t0) * 1e3)
                    counts.append({"dft": dft_cuda.LAUNCHES - before[0],
                                   "normal": normal_cuda.LAUNCHES - before[1]})
            return latencies, outs, counts

        kern = (Timed(torch, dft_cuda, "complex_dft_matmul", dft_cost),
                Timed(torch, normal_cuda, "normal_apply", normal_cost))
        dft_cuda.LAUNCHES = normal_cuda.LAUNCHES = 0
        latencies, outs, per_request = serve_all(*kern)
        served = {"dft": dft_cuda.LAUNCHES, "normal": normal_cuda.LAUNCHES}
        print(f"[{tag}] kernels: {len(inputs)} requests, latency ms "
              f"{[round(x, 3) for x in latencies]}, launches {served}, per request {per_request}")
        if per_request != expect:
            fail(f"{tag}: the serving run did not launch every kernel as expected: {per_request}")
        replays = cg.GRAPH_REPLAYS
        graph_lat, graph_outs, graph_counts = serve_all()
        replays = cg.GRAPH_REPLAYS - replays
        graph_equal = [bool(torch.equal(a, b_)) for a, b_ in zip(outs, graph_outs)]
        print(f"[{tag}] untimed, CG solves on their CUDA graphs: latency ms "
              f"{[round(x, 3) for x in graph_lat]}, {replays} replays, launches per request "
              f"{graph_counts}, images equal to the timed run's {graph_equal}")
        if graph_counts != per_request or (replays and not all(graph_equal)):
            fail(f"{tag}: the graphed run differs from the timed one: launches {graph_counts}, "
                 f"images equal {graph_equal}")
        for o in outs:
            if o.shape != (1, T, H, W) or not torch.isfinite(o).all():
                fail(f"{tag}: served image has shape {tuple(o.shape)} or non-finite values")
        if direct_out is not None:
            serve_err = (outs[0] - direct_out).abs().max().item()
            if not serve_err <= MODEL_TOL * scale:
                fail(f"{tag}: served image differs from the direct forward on the same input: "
                     f"{serve_err}")
            print(f"[{tag}] request 0 vs direct forward: max_abs_err {serve_err:.3e}")

        set_backends("torch")
        plain = (Timed(torch, dft_cuda, "complex_dft_matmul_torch", dft_cost),
                 Timed(torch, normal_cuda, "normal_apply_torch", normal_cost))
        plain_lat, plain_outs, _ = serve_all(*plain)
        lib = tuple(Timed(torch, mod, attr, cost, fn_[1], fn_[0]) for mod, attr, cost, fn_ in (
            (dft_cuda, "complex_dft_matmul_torch", dft_cost, dft_library(torch)),
            (normal_cuda, "normal_apply_torch", normal_cost, normal_library(torch))))
        lib_lat, lib_outs, _ = serve_all(*lib)
        set_backends("kernel")
        scales = ([scale] * len(inputs) if direct_out is not None
                  else [o.abs().max().item() for o in plain_outs])
        refs = references or [None] * len(inputs)
        errors = {}
        for label, lat, others in (("plain versions", plain_lat, plain_outs),
                                   ("library calls", lib_lat, lib_outs)):
            errs = [(a - b_).abs().max().item() for a, b_ in zip(outs, others)]
            errors[label] = [e / s for e, s in zip(errs, scales)]
            print(f"[{tag}] {label}: latency ms {[round(x, 3) for x in lat]}; max_abs_err vs the "
                  f"kernels {[f'{e:.3e}' for e in errs]}, / max |out| "
                  f"{[f'{e:.3e}' for e in errors[label]]} (tol {MODEL_TOL:.0e} where no float64 "
                  f"reference is given)")
            if not all(e <= MODEL_TOL * s for e, s, r in zip(errs, scales, refs) if r is None):
                fail(f"{tag}: serving through the {label} disagrees with the kernels: {errs}")
        f64_dist = []
        for i, ref in enumerate(refs):
            if ref is None:
                f64_dist.append(None)
                continue
            dist = {label: dict(l2=(torch.linalg.vector_norm(o[i] - ref)
                                    / torch.linalg.vector_norm(ref)).item(),
                                max=((o[i] - ref).abs().max() / ref.abs().max()).item())
                    for label, o in (("plain", plain_outs), ("kernels", outs), ("library", lib_outs))}
            f64_dist.append(dist)
            print(f"[{tag}] request {i} against the plain versions in float64, relative L2 / max "
                  f"|diff| over max |out|: " + ", ".join(
                      f"{k_} {v['l2']:.3e} / {v['max']:.3e}" for k_, v in dist.items()))
            ratio = dist["kernels"]["l2"] / max(dist["plain"]["l2"], dist["library"]["l2"])
            if not ratio <= F64_RATIO:
                fail(f"{tag}: request {i} through the kernels is {ratio:.2f}x as far (relative L2) "
                     f"from float64 as the farther of the plain versions and the library calls "
                     f"(limit {F64_RATIO})")
        return dict(launches=served, launches_per_request=per_request, kern=kern, plain=plain,
                    lib=lib, latency_ms=latencies, graph_latency_ms=graph_lat,
                    graph_replays=replays, plain_latency_ms=plain_lat,
                    library_latency_ms=lib_lat, max_rel_err=errors, max_abs_out=scales,
                    float64_distance=f64_dist)

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
        rec = dict(ms=[], loss=[], grad_norm=[], launches=[], gc_ms=[])
        grads = None
        with contextlib.ExitStack() as stack:
            for timer in timers:
                stack.enter_context(timer)
            gct = stack.enter_context(GCTimer())
            for i in range(steps):
                before, gc0 = launches(), gct.ms
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                state, aux = train_step(state, batch)
                e1.record()
                e1.synchronize()
                rec["ms"].append(e0.elapsed_time(e1))
                rec["gc_ms"].append(gct.ms - gc0)
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
        def mats(n, inverse, alt, device):
            f = np.fft.ifft if inverse else np.fft.fft
            eye = np.eye(n, dtype=np.complex128)
            if not alt:
                m = np.fft.fftshift(f(np.fft.ifftshift(eye, axes=0), axis=0, norm="ortho"), axes=0)
            else:  # XPDNet's opposite shift order; its inverse is the inverted matrix
                m = np.fft.ifftshift(np.fft.fft(np.fft.fftshift(eye, axes=0), axis=0, norm="ortho"),
                                     axes=0)
                m = np.linalg.inv(m) if inverse else m
            return (torch.from_numpy(m.real.copy()).to(device),
                    torch.from_numpy(m.imag.copy()).to(device),
                    torch.from_numpy(m.real.T.copy()).to(device),
                    torch.from_numpy(-m.imag.T.copy()).to(device))

        def lam64(lam, device):
            if torch.is_tensor(lam):
                return lam.detach().reshape(1)
            return torch.full((1,), lam, dtype=torch.float64, device=device)

        FFT._dft_tensors = OPS._dft_tensors = lambda n, inv, alt, norm, d: mats(n, inv, alt, d)[:2]
        FFT._dft_adjoint_tensors = lambda n, inv, alt, norm, d: mats(n, inv, alt, d)[2:]
        normal_cuda.lambda_tensor = lam64
        set_backends("torch")
        try:
            yield
        finally:
            set_backends("kernel")
            (FFT._dft_tensors, FFT._dft_adjoint_tensors, OPS._dft_tensors,
             normal_cuda.lambda_tensor) = saved

    def float64_forward(model, req):
        """``model`` on the request ``(k_re, k_im, mask[, s_re, s_im])``
        through the plain versions in float64 (as float32)."""
        model.to(torch.float64)
        try:
            with float64_plain(), torch.inference_mode():
                k_re, k_im, m, *maps = (a.double() for a in req)
                args = (Complex(k_re, k_im), m) + ((Complex(*maps),) if maps else ())
                return model(*args).float()
        finally:
            model.to(torch.float32)

    def train_phase(tag, model, batch, per_step, loss_tol=TRAIN_LOSS_TOL, grad_tol=TRAIN_GRAD_TOL,
                    f64_reference=False, steps=TRAIN_STEPS, plain_twice=True, profile_step=True,
                    deterministic=False, keep_grads=False):
        """``steps`` steps from the same weights four times: (a) through the
        plain versions twice (their run-to-run gap; once without
        ``plain_twice``), (b) through one library call each in the plain
        versions' slots, (c) through the kernels, whose launches are counted
        per step; the gaps against the plain run, and one profiled warm step
        (with ``profile_step``). With ``f64_reference``, also one step of the
        plain versions in float64, and each run's first-step gradient
        against it. With ``deterministic``, the runs (not the profiled step)
        take cuDNN's deterministic algorithms, so that the gaps measure the
        summation orders alone. With ``keep_grads``, the kernel run's record
        and first-step gradients are returned as ``kernel_run``."""
        cudnn_deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = deterministic or cudnn_deterministic
        try:
            return train_runs(tag, model, batch, per_step, loss_tol, grad_tol, f64_reference,
                              steps, plain_twice, profile_step, cudnn_deterministic, keep_grads)
        finally:
            torch.backends.cudnn.deterministic = cudnn_deterministic

    def train_runs(tag, model, batch, per_step, loss_tol, grad_tol, f64_reference, steps,
                   plain_twice, profile_step, cudnn_deterministic, keep_grads):
        init = {n: v.detach().clone() for n, v in model.state_dict().items()}
        set_backends("torch")
        tplain = (Timed(torch, dft_cuda, "complex_dft_matmul_torch", dft_cost),
                  Timed(torch, normal_cuda, "normal_apply_torch", normal_cost),
                  Timed(torch, normal_cuda, "normal_apply_bwd_torch", normal_bwd_cost))
        plain_rec, plain_grads = train_run(model, init, batch, steps, *tplain)
        plain2_rec, plain2_grads = (train_run(model, init, batch, steps) if plain_twice
                                    else (plain_rec, plain_grads))
        tlib = tuple(Timed(torch, mod, attr, cost, fn_[1], fn_[0]) for mod, attr, cost, fn_ in (
            (dft_cuda, "complex_dft_matmul_torch", dft_cost, dft_library(torch)),
            (normal_cuda, "normal_apply_torch", normal_cost, normal_library(torch)),
            (normal_cuda, "normal_apply_bwd_op", normal_bwd_op_cost, normal_bwd_op_library(torch))))
        lib_rec, lib_grads = train_run(model, init, batch, steps, *tlib)
        set_backends("kernel")

        tkern = (Timed(torch, dft_cuda, "complex_dft_matmul", dft_cost),
                 Timed(torch, normal_cuda, "normal_apply", normal_cost),
                 Timed(torch, normal_cuda, "normal_apply_bwd", normal_bwd_cost))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dft_cuda.LAUNCHES = normal_cuda.LAUNCHES = normal_cuda.BWD_LAUNCHES = 0
        kern_rec, kern_grads = train_run(model, init, batch, steps, *tkern)
        trained = launches()
        peak = torch.cuda.max_memory_allocated()
        print(f"[{tag}] launches per step: {kern_rec['launches']} (expected {per_step}); "
              f"run total {trained}")
        if any(step_launches != per_step for step_launches in kern_rec["launches"]):
            fail(f"{tag}: train steps did not launch the kernels as expected: {kern_rec['launches']}")
        if trained != {n: v * steps for n, v in per_step.items()}:
            fail(f"{tag}: the train run counted {trained} launches")

        gaps = dict(plain_gap=(gap(plain2_rec, plain2_grads, plain_rec, plain_grads) if plain_twice
                               else (0.0, 0.0, [])),
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
            if label.endswith("again") and not plain_twice:
                continue
            print(f"[{tag}] {label}: ms/step {[round(x, 3) for x in rec['ms']]}, "
                  f"loss {rec['loss']}, grad_norm {rec['grad_norm']}, garbage collector ms "
                  f"{[round(x, 3) for x in rec['gc_ms']]}")
        print(f"[{tag}] kernels, remat on: {ms_step:.3f} ms/step (median of steps 2-{steps}), "
              f"{1e3 / ms_step:.3f} volumes/s, peak memory {peak / 2**20:.1f} MiB")

        profile_ = None
        torch.backends.cudnn.deterministic = cudnn_deterministic
        if profile_step:
            model.load_state_dict(init)
            pstate = create_train_state(model, device=dev)
            pstate, _ = train_step(pstate, batch)
            profile_ = profiled(lambda: train_step(pstate, batch))
            print(f"[{tag}-profile] " + json.dumps(profile_))
        return dict(init=init, batch=batch, kernels=kern_rec, plain=plain_rec,
                    plain_again=plain2_rec, library=lib_rec, ms_per_step=ms_step,
                    volumes_per_s=1e3 / ms_step, peak_memory_bytes=peak, launches=trained,
                    launches_per_step=per_step, profile=profile_, timers=(tkern, tplain, tlib),
                    **gaps, **({"kernel_run": (kern_rec, kern_grads)} if keep_grads else {}))

    def perturbation(model, args):
        """How far the plain forward of the k-space x (1 + 1e-7 noise) moves
        from the plain forward on ``args`` (k-space first): max |diff| / max
        |out| and relative L2."""
        k_, rest = args[0], args[1:]
        noise = 1 + 1e-7 * torch.randn(k_.re.shape, generator=gen, device=dev)
        set_backends("torch")
        try:
            with torch.inference_mode():
                moved = model(Complex(k_.re * noise, k_.im * noise), *rest)
                base = model(*args)
        finally:
            set_backends("kernel")
        return dict(max=((moved - base).abs().max() / base.abs().max()).item(),
                    l2=(torch.linalg.vector_norm(moved - base) / torch.linalg.vector_norm(base)).item())

    def forward_host_syncs(tag, forward):
        """One warm forward under set_sync_debug_mode('error'), which fails on
        a host sync; returns its output."""
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = forward()
        except RuntimeError as e:
            fail(f"{tag}: a warm forward synchronized with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print(f"[{tag}] one warm forward under set_sync_debug_mode('error'): 0 host syncs")
        return out

    def step_host_syncs(tag, model, init, batch):
        """The host syncs of one warm train step from ``init`` (sync debug
        mode 'warn'), each named by the port's frame that made it."""
        model.load_state_dict(init)
        sstate = create_train_state(model, device=dev)
        sstate, _ = train_step(sstate, batch)
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
                train_step(sstate, batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        sync_names = sorted(set(syncs))
        print(f"[{tag}] host syncs in one warm step (sync debug mode 'warn'): {len(syncs)}; "
              f"{[(n, syncs.count(n)) for n in sync_names]}")
        return dict(host_syncs_per_step=len(syncs), host_syncs=sync_names)

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

    # The CineNet profiles count fewer DFT kernels than launches (20 of 22, PR 3-5):
    # one and two forwards, each in one instrument.trace window, with the counter's
    # launches, the DFT kernel events, the op's host events and the window's first
    # device events
    cinenet_dft_trace = {}
    for n_fwd in (1, 2):
        with tempfile.TemporaryDirectory() as tmp:
            dft_cuda.LAUNCHES = 0
            with trace(tmp):
                for _ in range(n_fwd):
                    cforward()
            path = next(Path(tmp).glob("*.pt.trace.json"))
            events = sorted(opstats.kernel_events(path), key=lambda e: e[1])
            cinenet_dft_trace[n_fwd] = dict(
                launches=dft_cuda.LAUNCHES,
                kernel_events=opstats.fold_by_kind(events).get(FOLD_KINDS["dft"], {}).get("count", 0),
                op_events=op_events(path).get(OP_NAMES["dft"], 0),
                first_device_events=[name[:60] for name, *_ in events[:4]])
        print(f"[cinenet-profile-dft] {n_fwd} forward(s) in one trace window: "
              + json.dumps(cinenet_dft_trace[n_fwd]))

    # a warm forward (DFT-matrix and λ caches built) makes no host sync: λ
    # = softplus(λᵢ) reaches the kernels on the device
    sync_out = forward_host_syncs("cinenet-forward", cforward)
    sync_err = (sync_out - cfwd["out"]).abs().max().item()
    print(f"[cinenet-forward] that forward against the first: max_abs_err {sync_err:.3e}")
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

    # the same steps with the normal apply on the fused FP32 tile
    # (normal_cuda.set_fp32_tile('fused'), csrc/fp32_hopper.cuh): its calls
    # counted (every one on the fused route) and timed, the run against the
    # engine route's (the same bits in the normal apply; cuDNN's algorithms
    # may differ between runs)
    c_per_step = ctrain["launches_per_step"]
    tfused = (Timed(torch, normal_cuda, "normal_apply", normal_cost),
              Timed(torch, normal_cuda, "normal_apply_bwd", normal_bwd_cost))
    route_before = (normal_cuda.LAUNCHES_BY_ROUTE["fp32_fused"],
                    normal_cuda.BWD_LAUNCHES_BY_ROUTE["fp32_fused"])
    normal_cuda.set_fp32_tile("fused")
    try:
        frec, _ = train_run(ctmodel, ctrain["init"], cbatch, TRAIN_STEPS, *tfused)
    finally:
        normal_cuda.set_fp32_tile("engine")
    fused_launches = {"normal": normal_cuda.LAUNCHES_BY_ROUTE["fp32_fused"] - route_before[0],
                      "normal_bwd": normal_cuda.BWD_LAUNCHES_BY_ROUTE["fp32_fused"] - route_before[1]}
    loss_gap = max(abs(a - b_) / abs(b_) for a, b_ in zip(frec["loss"], ctrain["kernels"]["loss"]))
    print(f"[cinenet-train-fused] the fused FP32 tile: launches on it {fused_launches} (expected "
          f"{TRAIN_STEPS} x {c_per_step['normal']} and {TRAIN_STEPS} x {c_per_step['normal_bwd']}); "
          f"ms/step {[round(x, 3) for x in frec['ms']]} (engine route "
          f"{[round(x, 3) for x in ctrain['kernels']['ms']]}); normal apply device ms over the run "
          f"{tfused[0].ms():.3f}, backward {tfused[1].ms():.3f} (engine route "
          f"{ctrain['timers'][0][1].ms():.3f}, {ctrain['timers'][0][2].ms():.3f}); loss "
          f"{frec['loss']} against the engine route's {ctrain['kernels']['loss']}: rel {loss_gap:.3e} "
          f"(tol {CINENET_TRAIN_LOSS_TOL:.0e})")
    if fused_launches != {k_: TRAIN_STEPS * c_per_step[k_] for k_ in fused_launches}:
        fail(f"cinenet-train-fused: {fused_launches} calls on the fused tile")
    if not loss_gap <= CINENET_TRAIN_LOSS_TOL:
        fail(f"cinenet-train-fused: the losses leave the engine route's by {loss_gap}")
    cfused = dict(launches=fused_launches, steps=frec, loss_gap=loss_gap,
                  timers=(tfused, ctrain["timers"][1][1:], ctrain["timers"][2][1:]))
    ctrain.update(step_host_syncs("cinenet-train", ctmodel, ctrain.pop("init"), cbatch))
    del ctmodel, cbatch, ctrain["batch"]
    torch.cuda.empty_cache()

    # -- 7b. XPDNet-XF at full width: its new operands, forward, serving, training ---
    # the kernels on the operands XPDNet gives them: the alt-matrix DFT along
    # t of the channel-last buffer (1, 15, 200, 200, 6) and its backward (the
    # kernel on the alt matrix's Wᴴ, and autograd through both against the
    # plain version's), the standard inverse on the (1, 15, 200, 200, 5) sum;
    # the normal apply with λ = 0.0 on the buffer's strided head, and its
    # backward
    xn = XPDNET["n_primal"]
    for (o, n, i), inverse, alt in (((1, T, H * W * (xn + 1)), False, True),
                                    ((1, T, H * W * xn), True, False)):
        mats = FFT._dft_tensors(n, inverse, alt, "ortho", dev)
        x_ = (randn(o, n, i), randn(o, n, i))
        label = "alt forward" if alt else "standard inverse"
        check_case("complex_dft_matmul", dict(O=o, N=n, I=i, matrix=label), x_ + mats,
                   dft_cuda.complex_dft_matmul, dft_cuda.complex_dft_matmul_torch,
                   dft_library(torch), dft_cost, DFT_TOL, graph=True)
        if not alt:
            continue
        check_case("complex_dft_matmul", dict(O=o, N=n, I=i, matrix="alt forward, Wᴴ (backward)"),
                   x_ + FFT._dft_adjoint_tensors(n, inverse, alt, "ortho", dev),
                   dft_cuda.complex_dft_matmul, dft_cuda.complex_dft_matmul_torch,
                   dft_library(torch), dft_cost, DFT_TOL, graph=True)
        # autograd through the kernel against autograd through the plain version
        g_ = (randn(o, n, i), randn(o, n, i))
        grads = []
        for plain in (False, True):
            xr_, xi_ = (a.detach().requires_grad_(True) for a in x_)
            y_ = dft_cuda.ComplexDFTMatmul.apply(
                xr_, xi_, *mats, *FFT._dft_adjoint_tensors(n, inverse, alt, "ortho", dev), plain)
            grads.append(torch.autograd.grad(y_, (xr_, xi_), g_))
        scale = max(a.abs().max().item() for a in grads[1])
        err = max((a - b_).abs().max().item() for a, b_ in zip(*grads))
        print(f"[kernel] complex_dft_matmul {(o, n, i)} alt: autograd through the kernel vs the "
              f"plain version: max_abs_err {err:.3e} (tol {DFT_TOL * scale:.3e})")
        if not err <= DFT_TOL * scale:
            fail(f"the alt-matrix DFT's backward disagrees with autograd of the plain version: {err}")
    del x_, g_, grads, y_, xr_, xi_

    xmask = torch.from_numpy(RandomMask([10], [4])(T, H, seed=5)[None].astype(np.float32)).to(dev)
    xkern = OPS.masked_normal_kernel(xmask)
    sr, si = randn(1, C, H, W), randn(1, C, H, W)
    rss = torch.sqrt((sr * sr + si * si).sum(1, keepdim=True))
    sr, si = sr / rss, si / rss
    xbuf = (randn(1, T, H, W, xn + 1), randn(1, T, H, W, xn + 1))
    head = (xbuf[0][..., 0], xbuf[1][..., 0])  # strided views, as XPDNet's head

    def head_apply(xr_, xi_, kr, ki, sr_, si_, lam):
        """normal_plus_lambda_kernel on a strided head, as XPDNet calls it."""
        out = OPS.normal_plus_lambda_kernel(Complex(xr_[:, :, None], xi_[:, :, None]),
                                            Complex(kr, ki), Complex(sr_[:, None], si_[:, None]), lam)
        return out.re[:, :, 0], out.im[:, :, 0]

    def head_apply_plain(*args):
        OPS.set_normal_backend("torch")
        try:
            return head_apply(*args)
        finally:
            OPS.set_normal_backend("kernel")

    OPS.COPIES = 0
    head_args = head + (xkern.re, xkern.im, sr, si, 0.0)
    check_case("normal_apply", dict(b=1, t=T, c=C, h=H, w=W, kt=T, lam=0.0, x="strided head"),
               head_args, head_apply, head_apply_plain, normal_library(torch), normal_cost,
               NORMAL_TOL, graph=True)
    if not OPS.COPIES:
        fail("normal_plus_lambda_kernel copied no strided head")
    hr, hi = head[0].contiguous(), head[1].contiguous()  # what the operator hands the kernel
    check_bwd_case(dict(b=1, t=T, c=C, h=H, w=W, kt=T, lam=0.0, x="strided head"),
                   (hr, hi, hr + randn(1, T, H, W), hi + randn(1, T, H, W), xkern.re, xkern.im,
                    sr, si, 0.0))
    del xbuf, head, head_args, hr, hi, sr, si, rss, xkern
    torch.cuda.empty_cache()

    xmodel = build_model("xpdnet", "XF", device=dev,
                         generator=torch.Generator().manual_seed(0), **XPDNET).eval()
    kre, kim, mask = flagship_inputs(torch, RandomMask([10], [4]), 0, dev)
    xk = Complex(kre, kim)

    def xforward():
        with torch.inference_mode():
            return xmodel(xk, mask)

    # per forward: the sens net's and x_ref's ifft2c (2 + 2 DFTs); per
    # cascade fft1c_alt and ifft1c over t and one normal apply (λ = 0)
    xnc = XPDNET["num_cascades"]
    x_expected = {"dft": 4 + 2 * xnc, "normal": xnc}
    # per forward, per cascade: the plane sum before ifft1c ((b, h, n, w, t)
    # in memory, from the NCHW MWCNN) and the strided head are copied once
    # XPDNet at random weights amplifies an f32 rounding difference cascade
    # by cascade (its MWCNNs see raw buffers): any two f32 orders end ~1e-4
    # of max |out| apart, so its forwards are held against float64 and
    # the sensitivity itself is measured: the plain forward of the k-space
    # times (1 + 1e-7 noise) against the plain forward
    xin = (kre, kim, mask)
    xfwd = forward_phase("xpdnet-forward", xforward, x_expected, None, copies=(xnc, xnc),
                         reference=float64_forward(xmodel, xin))
    xfwd["perturbation_1e-7"] = perturbation(xmodel, (xk, mask))
    print(f"[xpdnet-forward] the plain forward of the k-space x (1 + 1e-7 noise) against the plain "
          f"forward: max |diff| / max |out| {xfwd['perturbation_1e-7']['max']:.3e}, relative L2 "
          f"{xfwd['perturbation_1e-7']['l2']:.3e}")
    xfwd.pop("out")
    print("[xpdnet-profile] " + json.dumps(profiled(xforward)))
    xreqs = [flagship_inputs(torch, mf, s_, dev) for mf, s_ in requests]
    xserve = serve_phase("xpdnet-serve", bind_model(xmodel, device=dev), xreqs, x_expected,
                         references=[float64_forward(xmodel, r) for r in xreqs])
    del xmodel, xk, xreqs
    torch.cuda.empty_cache()

    xtmodel = build_model("xpdnet", "XF", device=dev, generator=torch.Generator().manual_seed(0),
                          **XPDNET)  # remat on
    xbatch = train_batch(torch, dev)
    # per step, with remat: the forward's 22 DFTs and 9 normal applies; the
    # replay of each cascade (its 2 DFTs and its normal apply); the backward
    # of every cascade DFT (the sens net's and x_ref's 4 act on data) and of
    # every normal apply
    # XPDNet's full-width first-step gradient is as ill-conditioned in f32 as
    # CineNet's (every order 3.6-3.8% from float64 on the H100), so its train
    # runs are held as CineNet's: against float64 and to its gaps. cuDNN's
    # nondeterministic backward moved two identical plain runs' losses up to
    # 1.6e-3 apart and the kernels' gap from 5.3e-4 to 2.4e-3 between calls,
    # against a bound of 2e-3; with its deterministic algorithms the plain
    # runs agree exactly and the kernels' gap is the summation order's,
    # 1.012e-3 in both of two runs (H100, 700 W), so these runs take them
    xtrain = train_phase("xpdnet-train", xtmodel, xbatch,
                         {"dft": x_expected["dft"] + 2 * xnc + 2 * xnc, "normal": 2 * xnc,
                          "normal_bwd": xnc},
                         CINENET_TRAIN_LOSS_TOL, CINENET_TRAIN_GRAD_TOL, f64_reference=True,
                         deterministic=True)
    xtrain.update(step_host_syncs("xpdnet-train", xtmodel, xtrain.pop("init"), xbatch))
    del xtmodel, xbatch, xtrain["batch"]
    torch.cuda.empty_cache()

    # -- 7c. XPDNet-2D and XT, and XF with primal_only=False (KSpaceCNN, the direct
    # k-step: fft2c and ifft2c per cascade): one forward each ---------------------------
    variants = (("2D", {}), ("XT", {}), ("XF", dict(primal_only=False)))
    vmodels = [build_model("xpdnet", dyn, device=dev, generator=torch.Generator().manual_seed(0),
                           **dict(XPDNET, **kw)).eval() for dyn, kw in variants]
    vin = flagship_inputs(torch, RandomMask([10], [4]), 0, dev)
    # 2D / XT: the 4 sens-net and x_ref DFTs, a normal apply per cascade;
    # the direct XF: per cascade fft2c, ifft2c, fft1c_alt, ifft1c and no
    # normal apply
    v_expected = [{"dft": 4, "normal": xnc}, {"dft": 4, "normal": xnc},
                  {"dft": 4 + 6 * xnc, "normal": 0}]
    xvariants = serve_phase("xpdnet-variants", [bind_model(m_, device=dev) for m_ in vmodels],
                            [vin] * 3, v_expected,
                            references=[float64_forward(m_, vin) for m_ in vmodels])
    xvariants["variants"] = [f"xpdnet-{dyn} {kw}" for dyn, kw in variants]
    xvariants["forward"] = {}
    for (dyn, kw), m_ in zip(variants, vmodels):
        torch.cuda.reset_peak_memory_stats()
        fwd = lambda: m_(Complex(vin[0], vin[1]), vin[2])
        with torch.inference_mode():
            times = [cuda_ms(torch, fwd, iters=1, warmup=1 if i == 0 else 0) for i in range(5)]
        xvariants["forward"][f"xpdnet-{dyn} {kw}"] = dict(
            ms=times, ms_per_volume=statistics.median(times),
            peak_memory_bytes=torch.cuda.max_memory_allocated())
        print(f"[xpdnet-variants] xpdnet-{dyn} {kw}: {statistics.median(times):.3f} ms/volume "
              f"(median of 5, {[round(x, 3) for x in times]}), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    del vmodels, m_, fwd
    torch.cuda.empty_cache()

    # -- 7d. VarNet and CineNet 2D / 3D at full width: forwards, and the 3D train steps --
    cascades = (("varnet", "2D"), ("varnet", "3D"), ("cinenet", "2D"), ("cinenet", "3D"))
    cmodels = [build_model(fam, dyn, device=dev, generator=torch.Generator().manual_seed(0),
                           **(FLAGSHIP if fam == "varnet" else CINENET)).eval()
               for fam, dyn in cascades]
    cin_v = flagship_inputs(torch, RandomMask([10], [4]), 0, dev)
    cin_c = cin_v + rss_maps(torch, 0, dev)
    # 2D / 3D: VarNet's 4 sens-net and x_ref DFTs and a normal apply per
    # cascade; CineNet's 2 image_ref DFTs and its CG's normal applies
    c3_expected = ([{"dft": 4, "normal": nc}] * 2
                   + [{"dft": 2, "normal": cnc * (1 + cgi)}] * 2)
    # CineNet-2D and 3D (U-Nets on raw channels) are order-sensitive in f32
    # at random weights as CineNet's data-fed requests are (kernels vs plain
    # 5.1e-4 and 8.1e-5 of max |out| on the H100): held against float64
    c2d3d = serve_phase("cascades-2d3d", [bind_model(m_, device=dev) for m_ in cmodels],
                        [cin_v, cin_v, cin_c, cin_c], c3_expected,
                        references=[None, None] + [float64_forward(m_, cin_c) for m_ in cmodels[2:]])
    c2d3d["models"] = [f"{fam}-{dyn}" for fam, dyn in cascades]
    c2d3d["forward"] = {}
    for (fam, dyn), m_ in zip(cascades, cmodels):
        args_ = (Complex(cin_c[0], cin_c[1]), cin_c[2]) + (
            (Complex(cin_c[3], cin_c[4]),) if fam == "cinenet" else ())
        fwd = lambda: m_(*args_)
        FFT.COPIES = OPS.COPIES = 0
        with torch.inference_mode():
            fwd()
        copies = (FFT.COPIES, OPS.COPIES)
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            times = [cuda_ms(torch, fwd, iters=1, warmup=1 if i == 0 else 0) for i in range(5)]
        c2d3d["forward"][f"{fam}-{dyn}"] = dict(
            ms=times, ms_per_volume=statistics.median(times), input_copies=copies,
            peak_memory_bytes=torch.cuda.max_memory_allocated())
        print(f"[cascades-2d3d] {fam}-{dyn}: {statistics.median(times):.3f} ms/volume (median of 5, "
              f"{[round(x, 3) for x in times]}), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; (DFT, normal apply) input "
              f"copies per forward {copies}")
    del cmodels, m_, fwd, args_
    torch.cuda.empty_cache()
    # two train steps of VarNet-3D and CineNet-3D through the plain versions,
    # the library calls and the kernels, at their family's tolerances
    c3train = {}
    for fam, cfg in (("varnet", FLAGSHIP), ("cinenet", CINENET)):
        m_ = build_model(fam, "3D", device=dev, generator=torch.Generator().manual_seed(0), **cfg)
        cb = train_batch(torch, dev, sens_maps=fam == "cinenet")
        per = ({"dft": 4, "normal": 2 * nc, "normal_bwd": nc} if fam == "varnet" else
               {"dft": 2, "normal": 2 * cnc * (1 + cgi), "normal_bwd": cnc * (1 + cgi)})
        tols = ((TRAIN_LOSS_TOL, TRAIN_GRAD_TOL) if fam == "varnet"
                else (CINENET_TRAIN_LOSS_TOL, CINENET_TRAIN_GRAD_TOL))
        c3train[fam] = train_phase(f"cascades-3d-train {fam}-3D", m_, cb, per, *tols,
                                   f64_reference=fam == "cinenet", steps=2, plain_twice=False,
                                   profile_step=False)
        c3train[fam].pop("init"), c3train[fam].pop("batch")
        del m_, cb
        torch.cuda.empty_cache()

    # -- 7e. the CRNN variants at full width: VarNet-, CineNet- and XPDNet-CRNN ------------
    t_crnn = time.perf_counter()

    # per forward (kernel DC): VarNet-CRNN's sens-net and x_ref DFTs (4) and one
    # normal apply per iteration (soft_dc_image_kernel); CineNet-CRNN's image_ref
    # DFTs (2) and its CG's 1 + cg_iters normal applies per iteration;
    # XPDNet-CRNN's 4 DFTs and one normal apply per iteration (N(head) − x_ref,
    # λ = 0), each on a copy of the buffer's strided head. Per train step, with
    # remat: the forward's launches, the replay of every iteration's normal
    # applies (its last op needs their outputs) and their backward; the DFTs act
    # on data and have no backward.
    vcn = VARNET_CRNN["num_cascades"]
    ccn, ccg = CINENET_CRNN["num_cascades"], CINENET_CRNN["cg_iters"]
    xcn = XPDNET_CRNN["num_cascades"]
    crnn_cases = (
        ("varnet", VARNET_CRNN, {"dft": 4, "normal": vcn}, (0, 0), TRAIN_STEPS),
        ("cinenet", CINENET_CRNN, {"dft": 2, "normal": ccn * (1 + ccg)}, (0, 0), 3),
        ("xpdnet", XPDNET_CRNN, {"dft": 4, "normal": xcn}, (0, xcn), 3),
    )
    crnn = {}
    for fam, cfg, expected_, copies_, steps_ in crnn_cases:
        tag = f"{fam}-crnn"
        maps = fam == "cinenet"
        m_ = build_model(fam, "CRNN", device=dev, generator=torch.Generator().manual_seed(0),
                         **cfg).eval()
        req = flagship_inputs(torch, RandomMask([10], [4]), 0, dev) + (
            rss_maps(torch, 0, dev) if maps else ())
        args_ = (Complex(req[0], req[1]), req[2]) + ((Complex(req[3], req[4]),) if maps else ())

        def fwd_():
            with torch.inference_mode():
                return m_(*args_)

        # order sensitivity, measured each run: a 1e-7 relative perturbation of
        # the k-space moved the CRNN outputs by 4.2e-7 to 2.6e-6 of max |out| on
        # the H100 (XPDNet-XF's by 1.24e-4, so that one is held against
        # float64), so the CRNN forwards are held to MODEL_TOL and their train
        # runs to VarNet's tolerances (first-step grads 4.8e-4 to 1.5e-3 apart)
        sens = perturbation(m_, args_)
        print(f"[{tag}-forward] the plain forward of the k-space x (1 + 1e-7 noise) against the "
              f"plain forward: max |diff| / max |out| {sens['max']:.3e}, relative L2 "
              f"{sens['l2']:.3e}")
        fw = forward_phase(f"{tag}-forward", fwd_, expected_, None, copies=copies_)
        forward_host_syncs(f"{tag}-forward", fwd_)
        fw.update({"perturbation_1e-7": sens, "host_syncs_per_forward": 0})
        prof = profiled(fwd_)
        print(f"[{tag}-profile] " + json.dumps(prof))
        print(f"[{tag}-profile] host {prof['host_ms']:.3f} ms, device busy "
              f"{prof['device_busy_ms']:.3f} ms, idle share {prof['idle_share_of_host_time']:.3f}")
        reqs = [flagship_inputs(torch, mf, s_, dev) + (rss_maps(torch, s_, dev) if maps else ())
                for mf, s_ in requests]
        sv = serve_phase(f"{tag}-serve", bind_model(m_, device=dev), reqs, expected_,
                         fw.pop("out"), fw["scale"])
        del m_, args_, req, reqs
        torch.cuda.empty_cache()

        tm_ = build_model(fam, "CRNN", device=dev, generator=torch.Generator().manual_seed(0),
                          **cfg)  # remat on
        tb_ = train_batch(torch, dev, sens_maps=maps)
        per_step = {"dft": expected_["dft"], "normal": 2 * expected_["normal"],
                    "normal_bwd": expected_["normal"]}
        tr = train_phase(f"{tag}-train", tm_, tb_, per_step, steps=steps_)
        tr.update(step_host_syncs(f"{tag}-train", tm_, tr.pop("init"), tb_))
        if tr["host_syncs_per_step"]:
            fail(f"{tag}-train: a warm train step synchronized with the host "
                 f"{tr['host_syncs_per_step']} times")
        tr.pop("batch")
        crnn[fam] = dict(config=cfg, forward=fw, profile=prof, serve=sv, train=tr)
        del tm_, tb_
        torch.cuda.empty_cache()

    # XPDNet-CRNN with primal_only=False: a KSpaceCNN per iteration, the direct
    # k-step (fft2c and ifft2c per iteration, no normal apply); one request
    dcfg = dict(XPDNET_CRNN, primal_only=False)
    dm = build_model("xpdnet", "CRNN", device=dev, generator=torch.Generator().manual_seed(0),
                     **dcfg).eval()
    dreq = flagship_inputs(torch, RandomMask([10], [4]), 0, dev)
    dsens = perturbation(dm, (Complex(dreq[0], dreq[1]), dreq[2]))
    print(f"[xpdnet-crnn-dual] primal_only=False: the plain forward of the k-space x (1 + 1e-7 "
          f"noise) against the plain forward: max |diff| / max |out| {dsens['max']:.3e}, "
          f"relative L2 {dsens['l2']:.3e}")
    dual = serve_phase("xpdnet-crnn-dual", bind_model(dm, device=dev), [dreq],
                       {"dft": 4 + 4 * xcn, "normal": 0})
    dual.update({"config": dcfg, "perturbation_1e-7": dsens})
    print(f"[xpdnet-crnn-dual] kernels: {dual['latency_ms'][0]:.3f} ms for the request")
    crnn["xpdnet_dual"] = dual
    del dm, dreq
    torch.cuda.empty_cache()
    crnn_wall = time.perf_counter() - t_crnn
    print(f"[crnn] the CRNN phases took {crnn_wall:.1f} s of wall time")

    # -- 8. the host data path: two volumes preprocessed, samples built ---------------
    t_data = time.perf_counter()
    data = host_data_phase()

    # -- 9. requests from the samples: VarNet-XF, CineNet-XF at 10 and 6 coils --------
    def request(sample, maps=True):
        """A sample as a serve request: a batch axis on its masked k-space
        (re, im), mask and, for CineNet, maps (re, im)."""
        k = sample["masked_kspace"][None]
        parts = (k.real, k.imag, sample["mask"][None])
        if maps:
            s = sample["sens_maps"][None]
            parts += (s.real, s.imag)
        return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev) for a in parts)

    # the same weights as the VarNet-XF and CineNet-XF of phases 3 and 6
    vserve_model = build_model("varnet", "XF", device=dev,
                               generator=torch.Generator().manual_seed(0), **FLAGSHIP).eval()
    cserve_model = build_model("cinenet", "XF", device=dev,
                               generator=torch.Generator().manual_seed(0), **CINENET).eval()
    dserves = ([bind_model(vserve_model, device=dev)] * 2
               + [bind_model(cserve_model, device=dev)] * 3)
    dinputs = ([request(s, maps=False) for s in data.pop("varnet_samples")]
               + [request(s) for s in data["cinenet_samples"]] + [request(data.pop("cinenet6_sample"))])
    # CineNet on these requests is ill-conditioned in f32: its U-Nets (no
    # normalizing wrapper) instance-normalize planes whose temporal variation
    # is the 2e-3 noise and map them to O(1) outputs, ten times over, so any
    # two f32 summation orders land about 2% apart (as its train gradient,
    # CINENET_TRAIN_GRAD_TOL; by the largest difference, the plain versions
    # 1.3-1.6%, the kernels and the library calls 1.8-2.2% from float64 on
    # the H100). Its requests are held against a float64 evaluation of the
    # plain versions; VarNet's (NormUnet) to MODEL_TOL.
    drefs = [None, None] + [float64_forward(cserve_model, r) for r in dinputs[2:]]
    dserve = serve_phase("data-serve", dserves, dinputs, [expected] * 2 + [c_expected] * 3,
                         references=drefs)
    dserve["requests"] = ["varnet-xf vol 0", "varnet-xf vol 1", "cinenet-xf vol 0, 10 coils",
                          "cinenet-xf vol 1, 10 coils", "cinenet-xf vol 0, 6 virtual coils"]
    print(f"[data-serve] latency ms per request "
          f"{dict(zip(dserve['requests'], (round(x, 3) for x in dserve['latency_ms'])))}")
    # the requests are chaotic end to end, their kernels are not: each kernel
    # on a CineNet request's own operands (its mask's K, its ESPIRiT maps,
    # image_ref; its k-space for the DFT), at 10 and at 6 coils, held to
    # its phase-2 tolerance
    for i in (2, 4):
        k_re, k_im, m, s_re, s_im = dinputs[i]
        c = s_re.shape[2]
        for o, n, i_ in ((T * c, H, W), (T * c * H, W, 1)):
            wr, wi = FFT._dft_tensors(n, True, False, "ortho", dev)
            check_case("complex_dft_matmul", dict(O=o, N=n, I=i_, request=dserve["requests"][i]),
                       (k_re.reshape(o, n, i_), k_im.reshape(o, n, i_), wr, wi),
                       dft_cuda.complex_dft_matmul, dft_cuda.complex_dft_matmul_torch,
                       dft_library(torch), dft_cost, DFT_TOL)
        with torch.no_grad():
            x = OPS.sens_reduce(Complex(k_re, k_im), Complex(s_re, s_im))
            kern = OPS.masked_normal_kernel(m)
        check_case("normal_apply", dict(b=1, t=T, c=c, h=H, w=W, kt=kern.re.shape[1], lam=0.0,
                                        request=dserve["requests"][i]),
                   (x.re[:, :, 0].contiguous(), x.im[:, :, 0].contiguous(), kern.re.contiguous(),
                    kern.im.contiguous(), s_re[:, 0].contiguous(), s_im[:, 0].contiguous(), 0.0),
                   normal_cuda.normal_apply, normal_cuda.normal_apply_torch,
                   normal_library(torch), normal_cost, NORMAL_TOL)
    del x, kern
    # device time by kind of one warm CineNet request at 10 and at 6 coils
    dserve["profiles"] = {}
    for i in (2, 4):
        dserve["profiles"][dserve["requests"][i]] = profiled(lambda: dserves[i](*dinputs[i]))
        print(f"[data-serve-profile] {dserve['requests'][i]}: "
              + json.dumps(dserve["profiles"][dserve["requests"][i]]))
    del vserve_model, cserve_model, dserves, dinputs, drefs
    torch.cuda.empty_cache()

    # -- 10. soft-SENSE CG reconstruction over two ESPIRiT map sets ----------------------
    sample0 = data.pop("cinenet_samples")[0]
    t0 = time.perf_counter()
    maps2 = espirit_maps_multi(sample0["masked_kspace"].mean(axis=0), num_maps=2)
    maps_s = time.perf_counter() - t0
    as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    sk = Complex(as_dev(sample0["masked_kspace"].real[None]), as_dev(sample0["masked_kspace"].imag[None]))
    smask = as_dev(sample0["mask"][None])
    smaps = Complex(as_dev(maps2.real[None]), as_dev(maps2.imag[None]))  # (1, 2, c, h, w)
    print(f"[soft-sense] espirit_maps_multi(num_maps=2, calib 24, crop 0.8) on volume 0's masked "
          f"time-averaged k-space: {maps_s:.3f} host s, maps {tuple(maps2.shape)}")

    def recon():
        with torch.inference_mode():
            return OPS.soft_sense_recon(sk, smask, smaps, lam=1e-2, iters=10, return_components=True)

    def recon_run(*timers):
        with contextlib.ExitStack() as stack:
            for timer in timers:
                stack.enter_context(timer)
            out = recon()
            torch.cuda.synchronize()
        return out

    skern = Timed(torch, dft_cuda, "complex_dft_matmul", dft_cost)
    dft_cuda.LAUNCHES = 0
    x_kern = recon_run(skern)
    ss_launches = dft_cuda.LAUNCHES
    set_backends("torch")
    splain = Timed(torch, dft_cuda, "complex_dft_matmul_torch", dft_cost)
    x_plain = recon_run(splain)
    slib = Timed(torch, dft_cuda, "complex_dft_matmul_torch", dft_cost, dft_library(torch)[1],
                 dft_library(torch)[0])
    x_lib = recon_run(slib)
    set_backends("kernel")
    print(f"[soft-sense] DFT launches per volume: {ss_launches} (2 for the right-hand side, "
          f"4 per operator apply, 11 applies)")
    if ss_launches != 46:
        fail(f"soft-sense: {ss_launches} DFT launches per volume, not 46")
    rss = [OPS.soft_sense_rss(x) for x in (x_kern, x_plain, x_lib)]
    if rss[0].shape != (1, T, H, W) or not torch.isfinite(rss[0]).all():
        fail(f"soft-sense: output has shape {tuple(rss[0].shape)} or non-finite values")
    ss_scale = rss[1].abs().max().item()
    ss_err = (rss[0] - rss[1]).abs().max().item()
    ss_lib_err = (rss[2] - rss[1]).abs().max().item()
    with torch.inference_mode():
        y = OPS.apply_mask(sk, smask)
        resid = OPS.apply_mask(OPS.soft_sense_expand(x_kern, smaps), smask) - y
        rel_resid = math.sqrt(resid.abs_sq().sum().item() / y.abs_sq().sum().item())
    ss_layouts, *_ = dft_layouts(recon)
    ss_times = [cuda_ms(torch, recon, iters=1, warmup=1 if i == 0 else 0) for i in range(5)]
    ss_profile = profiled(recon)
    print("[soft-sense-profile] " + json.dumps(ss_profile))
    print(f"[soft-sense] kernels vs plain versions: max_abs_err {ss_err:.3e} / max |out| "
          f"{ss_scale:.4f} = {ss_err / ss_scale:.3e} (tol {MODEL_TOL:.0e}); library calls "
          f"{ss_lib_err / ss_scale:.3e}; DFT launches by (O, N, I): {ss_layouts}")
    print(f"[soft-sense] kernels: {statistics.median(ss_times):.3f} ms/volume (median of 5, "
          f"{[round(x, 3) for x in ss_times]}); relative data residual ‖M·A x − y‖ / ‖y‖ "
          f"{rel_resid:.4e}")
    if not ss_err <= MODEL_TOL * ss_scale:
        fail(f"soft-sense: the kernels disagree with the plain versions: {ss_err}")
    if not ss_lib_err <= MODEL_TOL * ss_scale:
        fail(f"soft-sense: the library calls disagree with the plain versions: {ss_lib_err}")
    soft_sense = dict(launches=ss_launches, dft_layouts=ss_layouts, ms_per_volume=ss_times,
                      max_abs_err=ss_err, max_abs_out=ss_scale, library_max_abs_err=ss_lib_err,
                      relative_data_residual=rel_resid, espirit_multi_host_s=maps_s,
                      profile=ss_profile)
    del sk, smask, smaps, x_kern, x_plain, x_lib, rss, y, resid, sample0
    torch.cuda.empty_cache()

    # -- 11. ROADMAP Queue 3: two volumes sharing a batch-1 K and batch-1 maps ----------
    queue3 = queue3_phase(torch, dev, set_backends)
    data_wall = time.perf_counter() - t_data
    print(f"[data] phases 8-11 took {data_wall:.1f} s of wall time")

    # -- 12. the training system: Trainer.fit / restore / test / inference -------------
    loop = loop_phase(torch, dev, data, set_backends, vtrain["ms_per_step"],
                      vtrain["launches_per_step"], expected, launches)

    # -- 12b. data parallelism: a one-rank NCCL group, two gloo ranks on the card ----------
    ddp = ddp_phase(torch, dev, data, set_backends, vtrain["launches_per_step"], launches)

    # -- 12c. the plane and coil axes: two gloo ranks on the card ------------------------
    mesh = mesh_phase(torch, dev, data, vtrain["launches_per_step"], expected)

    # -- 12d. the profiler in Trainer.fit: profile_steps=2 -------------------------------
    prof = profile_phase(torch, dev, data, launches)

    # -- 12f. the TF32 modes of the kernels, bf16 activations, the remat policies --------
    precision, tf32_errs = precision_phase(torch, dev, peak_flops, peak_bw)
    bf16, tf32_timers = bf16_phase(torch, dev, data)
    remat_report = remat_phase(torch, dev)
    del data["decoded"]

    # -- 12e. a reference checkpoint served from a torch.export artifact ----------------
    interop = interop_export_phase(torch, dev, {"varnet": expected, "cinenet": c_expected})

    # -- 12g. the space-to-depth (packed) conv stacks against the dense ones ---------------
    def packed_phase():
        """``[packed]``: ``packed=True`` (``models/denoisers/packed_unet.py``)
        against the dense stacks from the same weights (seed 0), at full width
        on 15 x 10 x 200 x 200 volumes. VarNet-3D (the flagship's widths) and
        XPDNet-CRNN (9 iterations, chans 18, n_primal 5, kernel DC: the
        packed-carry iterations): the four requests through ``serve``, dense
        and packed, in f32 and bf16 (CUDA events, ms per volume the median,
        peak MiB), the packed f32 ones also three ways (``serve_phase``, the
        ``packed-serve`` rows); two train steps packed three ways
        (``train_phase``, the ``packed-train`` rows) and two dense, remat on,
        first-step gradients compared (relative L2), and two bf16 steps each.
        Then one request each, packed against dense: VarNet-2D (both
        profiled, their convolution kernels named), CineNet-2D and 3D (with
        maps), VarNet- and CineNet-CRNN, XPDNet-2D; and VarNet-2D's packed
        level-0 decoder conv alone, as cuDNN runs it in f32, split in two
        convs over half the input channels, and in bf16. Packed
        against dense: MODEL_TOL x max |dense| where the model is not
        order-sensitive (VarNet, the CRNN models), within F64_RATIO of the
        dense run's relative L2 from float64 where it is (CineNet, XPDNet);
        a bf16 packed request within the bf16 bound of the f32 dense one;
        train runs at VarNet's train tolerances."""
        import torch.nn.functional as F

        from cinemri_tpu_torch.models.denoisers.packed_unet import choose_blocks
        from cinemri_tpu_torch.models.recurrent import _trunk_block

        t_phase = time.perf_counter()
        reqs = [flagship_inputs(torch, mf, s_, dev) for mf, s_ in requests]
        maps = rss_maps(torch, 0, dev)
        up16 = lambda n: -(-n // 16) * 16  # the NormUnets' pad
        report = dict(level_blocks={
            "VarNet-3D cascade U-Net (16, 208, 208)": choose_blocks(
                (up16(T), up16(H), up16(W)), FLAGSHIP["chans"], FLAGSHIP["pools"]),
            "VarNet sens-net U-Net (208, 208)": choose_blocks(
                (up16(H), up16(W)), FLAGSHIP["sens_chans"], FLAGSHIP["sens_pools"]),
            "CineNet-3D U-Net (15, 200, 200)": choose_blocks((T, H, W), CINENET["chans"],
                                                             CINENET["pools"]),
            "XPDNet-CRNN trunk": _trunk_block(H, W, True, XPDNET_CRNN["chans"]),
            "VarNet-CRNN trunk": _trunk_block(H, W, True, VARNET_CRNN["chans"])})
        print(f"[packed] blocks: {report['level_blocks']}")

        def build(fam, dyn, cfg, packed, bf16=False):
            return build_model(fam, dyn, device=dev, generator=torch.Generator().manual_seed(0),
                               packed=packed, bf16=bf16, **cfg)

        def timed_requests(serve, inputs):
            """One warm request, then each between CUDA events: outputs, ms,
            peak MiB and the DFT and normal-apply launches of all of them."""
            before = (dft_cuda.LAUNCHES, normal_cuda.LAUNCHES)
            serve(*inputs[0])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            outs, ms = [], []
            for req in inputs:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                outs.append(serve(*req))
                e1.record()
                e1.synchronize()
                ms.append(e0.elapsed_time(e1))
            launched = {"dft": dft_cuda.LAUNCHES - before[0], "normal": normal_cuda.LAUNCHES - before[1]}
            return outs, ms, torch.cuda.max_memory_allocated() / 2**20, launched

        def rel(a, b_):
            d = (a - b_).abs()
            return d.max().item() / b_.abs().max().item(), d.mean().item() / b_.abs().max().item()

        full = (("VarNet-3D", "varnet", "3D", FLAGSHIP, {"dft": 4, "normal": nc}),
                ("XPDNet-CRNN", "xpdnet", "CRNN", XPDNET_CRNN, {"dft": 4, "normal": xcn}))
        serves, serve_inputs, serve_expected, kept = [], [], [], []
        for label, fam, dyn, cfg, expected_ in full:
            weights = build(fam, dyn, cfg, False).state_dict()
            runs = {}
            for bf16 in (False, True):
                for packed in (False, True):
                    m_ = build(fam, dyn, cfg, packed, bf16).eval()
                    m_.load_state_dict(weights)
                    outs, ms, peak, launched = timed_requests(bind_model(m_, device=dev), reqs)
                    want = {k_: (len(reqs) + 1) * v for k_, v in expected_.items()}
                    if launched != want:
                        fail(f"packed: {label} ({'bf16' if bf16 else 'f32'}, packed {packed}) "
                             f"launched {launched}, not {want}")
                    runs[bf16, packed] = dict(outs=outs, ms=ms, ms_per_volume=statistics.median(ms),
                                              peak_mib=peak, launches=launched)
                    if packed and not bf16:
                        kept.append(m_)
                        serves += [bind_model(m_, device=dev)] * len(reqs)
                        serve_inputs += reqs
                        serve_expected += [expected_] * len(reqs)
                    del m_
                    torch.cuda.empty_cache()
            dense32 = runs[False, False]["outs"]
            gaps = {"f32 packed vs dense": [rel(a, b_) for a, b_ in zip(runs[False, True]["outs"], dense32)],
                    "bf16 packed vs bf16 dense": [rel(a, b_) for a, b_ in zip(runs[True, True]["outs"],
                                                                              runs[True, False]["outs"])],
                    "bf16 packed vs f32 dense": [rel(a, b_) for a, b_ in zip(runs[True, True]["outs"], dense32)],
                    "bf16 dense vs f32 dense": [rel(a, b_) for a, b_ in zip(runs[True, False]["outs"], dense32)]}
            for run_ in runs.values():
                if any(o.shape != (1, T, H, W) or not torch.isfinite(o).all() for o in run_.pop("outs")):
                    fail(f"packed: {label} served an image of another shape or non-finite values")
            for dtype, bf16 in (("f32", False), ("bf16", True)):
                d_, p_ = runs[bf16, False], runs[bf16, True]
                print(f"[packed] {label} {dtype}: packed {p_['ms_per_volume']:.3f} ms per volume (dense "
                      f"{d_['ms_per_volume']:.3f}; per request {[round(x, 3) for x in p_['ms']]} / "
                      f"{[round(x, 3) for x in d_['ms']]}), serving peak {p_['peak_mib']:.1f} MiB (dense "
                      f"{d_['peak_mib']:.1f}); launches per 5 requests {p_['launches']}")
            for name, g_ in gaps.items():
                print(f"[packed] {label} {name}: max / mean |diff| over max |ref| "
                      f"{[(f'{m:.3e}', f'{a:.3e}') for m, a in g_]}")
            if not all(m <= MODEL_TOL for m, _ in gaps["f32 packed vs dense"]):
                fail(f"packed: {label} f32 packed requests leave {MODEL_TOL} x max |dense|: "
                     f"{gaps['f32 packed vs dense']}")
            if not all(m <= BF16_MAX_TOL and a < BF16_MEAN_TOL for m, a in gaps["bf16 packed vs f32 dense"]):
                fail(f"packed: {label} bf16 packed requests leave the bf16 bound of f32: "
                     f"{gaps['bf16 packed vs f32 dense']}")
            report[label] = dict(config=cfg, serve={f"{'bf16' if b else 'f32'} {'packed' if p else 'dense'}": r
                                                    for (b, p), r in runs.items()}, serve_gaps=gaps)
            del runs, dense32
        pserve = serve_phase("packed-serve", serves, serve_inputs, serve_expected)
        del serves, kept
        torch.cuda.empty_cache()

        timers, train_launches = None, collections.Counter()
        for label, fam, dyn, cfg, expected_ in full:
            per_step = {"dft": expected_["dft"], "normal": 2 * expected_["normal"],
                        "normal_bwd": expected_["normal"]}
            batch = train_batch(torch, dev)
            tr = train_phase(f"packed-train {label}", build(fam, dyn, cfg, True), batch, per_step,
                             steps=2, plain_twice=False, profile_step=False, keep_grads=True)
            init, _ = tr.pop("init"), tr.pop("batch")
            prec, pgrads = tr.pop("kernel_run")
            run_timers = tr.pop("timers")
            if timers is None:
                timers = run_timers
            else:
                for mine, theirs in zip(timers, run_timers):
                    for a, b_ in zip(mine, theirs):
                        a.calls += b_.calls
            train_launches.update(tr["launches"])
            steps = {}
            for bf16 in (False, True):
                for packed in ((False, True) if bf16 else (False,)):
                    m_ = build(fam, dyn, cfg, packed, bf16)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    rec, grads = train_run(m_, init, batch, 2)
                    steps[bf16, packed] = dict(ms=rec["ms"], loss=rec["loss"],
                                               peak_mib=torch.cuda.max_memory_allocated() / 2**20)
                    if not bf16:
                        dense_rec, dense_grads = rec, grads
                    del m_, rec, grads
                    torch.cuda.empty_cache()
            steps[False, True] = dict(ms=prec["ms"], loss=prec["loss"],
                                      peak_mib=tr["peak_memory_bytes"] / 2**20)
            loss_gap, grad_gap, leaves = gap(prec, pgrads, dense_rec, dense_grads)
            del pgrads, dense_grads
            for dtype, bf16 in (("f32", False), ("bf16", True)):
                d_, p_ = steps[bf16, False], steps[bf16, True]
                print(f"[packed] {label} train {dtype}: packed {p_['ms'][-1]:.3f} ms per step (dense "
                      f"{d_['ms'][-1]:.3f}; steps {[round(x, 3) for x in p_['ms']]} / "
                      f"{[round(x, 3) for x in d_['ms']]}), peak {p_['peak_mib']:.1f} MiB (dense "
                      f"{d_['peak_mib']:.1f}), losses {p_['loss']} / {d_['loss']}")
            print(f"[packed] {label} train: packed vs dense loss rel {loss_gap:.3e} (tol "
                  f"{TRAIN_LOSS_TOL:.0e}), step-1 grads rel L2 {grad_gap:.3e} (tol {TRAIN_GRAD_TOL:.0e}), "
                  f"worst leaves {[(n, f'{v:.3e}') for v, n in leaves]}")
            if not (loss_gap <= TRAIN_LOSS_TOL and grad_gap <= TRAIN_GRAD_TOL):
                fail(f"packed: {label}'s packed train steps leave the dense ones' tolerances: "
                     f"{loss_gap}, {grad_gap}")
            report[label].update(train={f"{'bf16' if b else 'f32'} {'packed' if p else 'dense'}": r
                                        for (b, p), r in steps.items()},
                                 train_gaps=dict(loss_rel=loss_gap, grads_rel_l2=grad_gap),
                                 train_vs_plain=dict(kernel_gap=tr["kernel_gap"][:2],
                                                     library_gap=tr["library_gap"][:2]))
            del init, batch, tr
            torch.cuda.empty_cache()

        singles = (("VarNet-2D", "varnet", "2D", FLAGSHIP, None),
                   ("CineNet-2D", "cinenet", "2D", CINENET, "f64"),
                   ("CineNet-3D", "cinenet", "3D", CINENET, "f64"),
                   ("VarNet-CRNN", "varnet", "CRNN", VARNET_CRNN, None),
                   ("CineNet-CRNN", "cinenet", "CRNN", CINENET_CRNN, None),
                   ("XPDNet-2D", "xpdnet", "2D", XPDNET, "f64"))
        for label, fam, dyn, cfg, reference in singles:
            req = reqs[0] + (maps if fam == "cinenet" else ())
            weights = build(fam, dyn, cfg, False).state_dict()
            rec = {}
            for packed in (False, True):
                m_ = build(fam, dyn, cfg, packed).eval()
                m_.load_state_dict(weights)
                srv = bind_model(m_, device=dev)
                outs, ms, peak, launched = timed_requests(srv, [req] * 3)
                rec[packed] = dict(out=outs[0], ms=ms, ms_per_volume=statistics.median(ms),
                                   peak_mib=peak, launches=launched)
                if label == "VarNet-2D":  # where the packed convs' time goes
                    rec[packed]["profile"] = request_profile(torch, lambda: srv(*req))
                    print(f"[packed] {label} {'packed' if packed else 'dense'} request profiled: "
                          f"{json.dumps(rec[packed]['profile'])}")
                if reference and not packed:
                    f64 = float64_forward(m_, req)
                del m_
                torch.cuda.empty_cache()
            got, want = rec[True].pop("out"), rec[False].pop("out")
            gap_ = rel(got, want)
            line = (f"[packed] {label}: packed {rec[True]['ms_per_volume']:.3f} ms per volume (dense "
                    f"{rec[False]['ms_per_volume']:.3f}), peak {rec[True]['peak_mib']:.1f} MiB (dense "
                    f"{rec[False]['peak_mib']:.1f}), max / mean |packed - dense| over max |dense| "
                    f"{gap_[0]:.3e} / {gap_[1]:.3e}, launches per 3 requests {rec[True]['launches']}")
            if rec[True]["launches"] != rec[False]["launches"] or not all(rec[True]["launches"].values()):
                fail(f"packed: {label} packed launches {rec[True]['launches']} against dense "
                     f"{rec[False]['launches']}")
            if not torch.isfinite(got).all():
                fail(f"packed: {label}'s packed image has non-finite values")
            if reference:
                dist = {k_: (torch.linalg.vector_norm(o - f64) / torch.linalg.vector_norm(f64)).item()
                        for k_, o in (("packed", got), ("dense", want))}
                rec["float64_rel_l2"] = dist
                print(line + f"; relative L2 from float64: packed {dist['packed']:.3e}, dense "
                      f"{dist['dense']:.3e}")
                if not dist["packed"] <= F64_RATIO * dist["dense"]:
                    fail(f"packed: {label} packed is more than {F64_RATIO}x as far from float64 as dense")
                del f64
            else:
                print(line + f" (tol {MODEL_TOL:.0e})")
                if not gap_[0] <= MODEL_TOL:
                    fail(f"packed: {label} packed leaves {MODEL_TOL} x max |dense|: {gap_[0]}")
            report[label] = dict(config=cfg, gap=gap_, packed=rec[True], dense=rec[False],
                                 **({"float64_rel_l2": rec["float64_rel_l2"]} if reference else {}))
            del got, want
        # VarNet-2D's level-0 decoder conv on the packed layout (block (2, 4):
        # 2 x 16 logical input channels, 16 output channels), f32 without
        # TF32 as every run here: cuDNN as it comes, and the same sum as two
        # convs over 128 input channels each; bf16 beside them
        x_ = torch.randn(T, 256, 104, 52, generator=gen, device=dev)
        w_ = torch.randn(128, 256, 3, 3, generator=gen, device=dev)
        convs = {"one conv": cuda_ms(torch, lambda: F.conv2d(x_, w_, padding=1), iters=5, warmup=1),
                 "two halves summed": cuda_ms(torch, lambda: F.conv2d(x_[:, :128], w_[:, :128], padding=1)
                                              + F.conv2d(x_[:, 128:], w_[:, 128:], padding=1),
                                              iters=5, warmup=1),
                 "bf16": cuda_ms(torch, lambda: F.conv2d(x_.bfloat16(), w_.bfloat16(), padding=1),
                                 iters=5, warmup=1)}
        report["level0_conv_ms"] = convs
        print(f"[packed] VarNet-2D packed level-0 conv (15, 256, 104, 52) x (128, 256, 3, 3), ms: "
              f"{ {k_: round(v, 3) for k_, v in convs.items()} }")
        del x_, w_
        wall = time.perf_counter() - t_phase
        print(f"[packed] phase wall time {wall:.1f} s")
        report.update(serve=pserve, wall_s=wall)
        return report, dict(launches=dict(train_launches), timers=timers)

    packed_report, ptrain = packed_phase()

    # -- 13. report -------------------------------------------------------------------
    def row(kernel, source, replaces, run, launches, timed, plain, library):
        # the mesh rows: the checks at the coil shards' shapes; else all of the kernel's
        b_ms, b_by = timed.bound(peak_flops, peak_bw)
        return dict(name=kernel, route="cuda", source=source, replaces=replaces, run=run,
                    launches=launches,
                    max_abs_err=max(c["max_abs_err"] for c in cases if c["kernel"] == kernel
                                    and (run != "mesh" or "shard" in c)),
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
    crnn_serves = [(f"{fam}-crnn-serve", crnn[fam]["serve"]) for fam in ("varnet", "cinenet", "xpdnet")]
    for run, srv in (("serve", vserve), ("cinenet-serve", cserve), ("xpdnet-serve", xserve),
                     ("xpdnet-variants", xvariants), ("cascades-2d3d", c2d3d),
                     *crnn_serves, ("data-serve", dserve), ("packed-serve", packed_report["serve"])):
        rows += [row(*dft_src, run, srv["launches"]["dft"], srv["kern"][0], srv["plain"][0], srv["lib"][0]),
                 row(*fwd_src, run, srv["launches"]["normal"], srv["kern"][1], srv["plain"][1],
                     srv["lib"][1])]
    for run, tr in (("train", vtrain), ("cinenet-train", ctrain), ("xpdnet-train", xtrain),
                    ("varnet-3d-train", c3train["varnet"]), ("cinenet-3d-train", c3train["cinenet"]),
                    *[(f"{fam}-crnn-train", crnn[fam]["train"]) for fam in ("varnet", "cinenet", "xpdnet")],
                    ("loop", loop), ("ddp", ddp), ("mesh", mesh), ("packed-train", ptrain)):
        tkern, tplain, tlib = tr.pop("timers")
        rows += [row(*src, run, tr["launches"][key], tkern[i], tplain[i], tlib[i])
                 for i, (src, key) in enumerate(((dft_src, "dft"), (fwd_src, "normal"),
                                                 (bwd_src, "normal_bwd")))]
    # the primal_only=False request runs no normal apply: its DFT row only
    rows.append(row(*dft_src, "xpdnet-crnn-dual", crnn["xpdnet_dual"]["launches"]["dft"],
                    crnn["xpdnet_dual"]["kern"][0], crnn["xpdnet_dual"]["plain"][0],
                    crnn["xpdnet_dual"]["lib"][0]))
    rows.append(row(*dft_src, "soft-sense", ss_launches, skern, splain, slib))
    # the fused FP32 tile at 'highest': its calls in the CineNet-XF train run
    # on it, the plain versions' and library calls' times over the engine
    # route's run of the same steps, the errors of [precision]'s checks
    fkern, fplain, flib = cfused.pop("timers")
    for i, ((kernel, _, replaces), key) in enumerate(((fwd_src, "normal"), (bwd_src, "normal_bwd"))):
        b_ms, b_by = fkern[i].bound(peak_flops, peak_bw)
        rows.append(dict(name=f"{kernel}[highest fused]", route="cuda",
                         source="cinemri_tpu_torch/csrc/fp32_hopper.cuh", replaces=replaces,
                         run="cinenet-train-fused", launches=cfused["launches"][key],
                         max_abs_err=tf32_errs[kernel, "highest fused"], ms=fkern[i].ms(),
                         plain_ms=fplain[i].ms(), bound_ms=b_ms, bound_by=b_by,
                         library_ms=flib[i].ms()))
    rows.append(row(*fft2_src, "check", fft2_launches, *fft2_runs))
    # the TF32 modes: launches and times of [bf16]'s run at that mode (the
    # plain and library times of its repeats through them), the errors of
    # [precision]'s checks at the flagship shapes; the bound at the TF32 rate
    # (the N = 15 DFTs, FP32 in every mode, are bound by bytes at either rate)
    for mode in TF32_PASSES:
        tkern, tplain, tlib = tf32_timers[mode]
        for i, ((kernel, source, replaces), key) in enumerate(((dft_src, "dft"), (fwd_src, "normal"),
                                                               (bwd_src, "normal_bwd"))):
            launched = bf16["varnet"][f"bf16 {mode}"]["launches"][key][mode]
            if launched != len(tkern[i].calls):
                fail(f"{kernel}[{mode}]: {launched} launches but {len(tkern[i].calls)} timed calls")
            b_ms, b_by = tkern[i].bound(TF32_PEAK / TF32_PASSES[mode], peak_bw)
            rows.append(dict(name=f"{kernel}[{mode}]", route="cuda", source=source, replaces=replaces,
                             run=f"bf16 {mode}", launches=launched,
                             max_abs_err=tf32_errs[kernel, mode], ms=tkern[i].ms(),
                             plain_ms=tplain[i].ms(), bound_ms=b_ms, bound_by=b_by,
                             library_ms=tlib[i].ms()))
    for srv in (vserve, cserve, xserve, xvariants, c2d3d, dserve, crnn["xpdnet_dual"],
                packed_report["serve"],
                *(crnn[fam]["serve"] for fam in ("varnet", "cinenet", "xpdnet"))):
        for key in ("kern", "plain", "lib"):
            srv.pop(key)
    print("[details] " + json.dumps(dict(
        cases=cases, forward=vfwd, serve=vserve, train=vtrain,
        cinenet=dict(config=CINENET, forward=cfwd, serve=cserve, train=ctrain, train_fused=cfused),
        xpdnet=dict(config=XPDNET, forward=xfwd, serve=xserve, train=xtrain, variants=xvariants),
        cascades_2d3d=dict(forward=c2d3d, train_3d=c3train),
        crnn=dict(crnn, wall_s=crnn_wall),
        data=data, data_serve=dserve, soft_sense=soft_sense, queue3=queue3,
        data_phases_wall_s=data_wall, loop=loop, ddp=ddp, mesh=mesh, custom_op=op_cost,
        cinenet_dft_trace=cinenet_dft_trace, profile=prof, interop_export=interop,
        precision=precision, bf16=bf16, remat=remat_report, packed=packed_report)))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
