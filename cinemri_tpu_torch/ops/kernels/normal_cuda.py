"""Masked normal operator apply: CUDA kernels and their plain PyTorch versions.

Replaces ``normal_apply_pallas`` (``cinemri_tpu/ops/kernels/
normal_pallas.py``): its forward ``fwd_pallas_call`` / body ``_fwd_kernel``,
which computes ``N(z)`` in every VarNet cascade's data-consistency step, and
its custom-VJP backward ``_bwd_pallas_call`` / body ``_bwd_kernel``.

Forward, on (re, im) pairs, with ``x (b, t, h, w)``, ``K (b, 1|t, h, h)``
applied along h, ``S (b, c, h, w)`` and a scalar ``λ``, in f32 with the
4-multiplication complex product::

    out = Σ_c conj(S_c) ⊙ (K ·_h (S_c ⊙ x)) + λ·x

Backward, for the cotangent ``g`` of ``out``, with ``ȳ_c = Kᴴ (S_c ⊙ g)``
and ``z_c = K (S_c ⊙ x)`` (recomputed)::

    x̄   = Σ_c conj(S_c) ⊙ ȳ_c + λ·g
    s̄_c = Σ_t [conj(g) ⊙ z_c + ȳ_c ⊙ conj(x)]
    λ̄   = Σ_{b,t} Re⟨g, x⟩              (per-(b, t) partials, summed here)
    K̄   = 0                              (K derives from the never-learned mask)

Forward kernel (``csrc/normal_apply.cu``): bound by the FP32 rate (9.6 GFLOP
against ~18 MB per apply at t=15, c=10, h=w=200). For one frame the
contraction over every coil is one complex product, ``K_t (h × h) ·
[S_1⊙x_t | … | S_C⊙x_t] (h × c·w)``, so the C entry runs three passes: the
products ``S_c ⊙ x_t`` into a ``(b·t·c, h, w)`` scratch, the coil-stacked
per-frame contraction on the FP32 tile engine of ``csrc/cgemm_tile.cuh``
(on 16-byte rows its instance ``normal::Fp32Tile``: 96 slab columns × 40
rows a block, 16-deep chunks, four blocks an SM), and the coil reduction
``Σ_c conj(S_c) ⊙ z_c + λx``. :func:`coil_products`, :func:`frame_contract`
and :func:`coil_reduce` are those passes in plain PyTorch, for the CPU
tests.

The FP32 tile at ``'highest'`` (:func:`set_fp32_tile`): ``'engine'``, the
default, is the route above; ``'fused'`` runs the contraction on 16-byte
rows on the tile of ``csrc/fp32_hopper.cuh`` instead, which forms ``S ⊙ u``
in its staging (no products pass, no products scratch). Both give the same
bits; the fused tile is slower on the H100 (``PERF.md``). Rows that are not
16-byte aligned take the engine route either way.

Precision: the contractions take the DFT's precision (the JAX package's
``normal_pallas.py::_precision`` reads ``ops/fft.py``'s, as
``physics/operators.py`` passes :func:`~cinemri_tpu_torch.ops.fft.
get_dft_precision` here): ``'highest'`` in full f32 on the CUDA cores,
``'high'`` (3xTF32) and ``'default'`` (1xTF32) on the tensor cores; the
products and the coil passes stay f32. In the TF32 modes the contraction
runs on the Hopper tile of ``csrc/wgmma_tf32.cuh`` (every Hopper route is
shared with the backward in ``csrc/normal_wgmma.cuh``); at ``'default'``,
where the resident tile fills the card, that tile forms the products while
staging its operand, so a call runs two kernels; at ``'high'`` the three
passes stay. Rows that are not 16-byte aligned keep the three passes, on
``csrc/cgemm_tile.cuh`` at ``'highest'`` and the ``mma.sync`` tile of
``csrc/cgemm_tf32.cuh`` in the TF32 modes. No ``y`` scratch is allocated
where the products are formed in staging. The plain versions take the same
``precision`` and round the contraction's operands as the tile does
(:mod:`.precision`). In the TF32 modes the kernels form each product ``S ⊙
u`` with separate roundings, as PyTorch does, so that a TF32 operand is the
same on both sides; ``'highest'`` keeps the FMA-contracted products.

Backward kernel (``csrc/normal_apply_bwd.cu``): the products and
contractions for ``ȳ`` and ``z``, then ``x̄`` by the coil reduction and
``s̄`` by a pass that sums over the frames in registers
(:func:`bwd_pixel_pass`): deterministic, no atomics, no partials. ``ȳ``
contracts with ``B = Kᴴ`` from a conjugate-transposed copy of ``K``, written
by one small kernel, at ``'highest'`` and on the Hopper routes (the FP32
tiles and TF32 ``wgmma`` read B's rows along k): 8 kernels a call at
``'highest'`` and ``'high'``, 6 at ``'default'`` where both contractions
form their products in the resident tile's staging, and 6 on the fused FP32
route. Rows that are not 16-byte aligned take 7 kernels in the TF32 modes,
``Kᴴ`` read in place. The C entries report their route
(``cinemri_normal_apply[_bwd]_route``), which sets the scratch allocated
(:func:`_planes`); ``LAUNCHES_BY_ROUTE`` and ``BWD_LAUNCHES_BY_ROUTE`` count
the calls on each.

λ stays on the device: both kernels read it through a pointer to a
one-element f32 tensor (:func:`lambda_tensor`), so a learned λ (CineNet's
``softplus(λᵢ)``, 70 applies per forward) costs no device-to-host sync, and
a Python float λ (VarNet's ``0.0``) becomes a tensor cached per (value,
device), so it costs no host-to-device copy per call either.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. ``LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches.

Custom ops: the forward and the backward are registered as
``torch.ops.cinemri.normal_apply`` and ``torch.ops.cinemri.normal_apply_bwd``
(:func:`normal_apply_op`, :func:`normal_apply_bwd_op`), each with a fake
implementation, so ``torch.export`` and the profiler see them; the forward's
gradient is the backward op, with the same ``plain`` flag, which picks the
plain versions in both directions. :class:`NormalApply` calls the forward op
with λ as the one-element tensor the kernels read, keeping a tensor λ's
autograd link.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch
from torch import Tensor

from cinemri_tpu_torch.ops.kernels import _build, counter, trace_safe
from cinemri_tpu_torch.ops.kernels.precision import MODES, check_precision, matmul

__all__ = [
    "normal_apply",
    "normal_apply_torch",
    "normal_apply_bwd",
    "normal_apply_bwd_torch",
    "coil_products",
    "frame_contract",
    "coil_reduce",
    "bwd_pixel_pass",
    "lambda_partials",
    "normal_apply_passes",
    "normal_apply_bwd_passes",
    "lambda_tensor",
    "normal_apply_op",
    "normal_apply_bwd_op",
    "NormalApply",
    "LAUNCHES",
    "BWD_LAUNCHES",
    "LAUNCHES_BY_PRECISION",
    "BWD_LAUNCHES_BY_PRECISION",
    "LAUNCHES_BY_ROUTE",
    "BWD_LAUNCHES_BY_ROUTE",
    "ROUTES",
    "FP32_TILES",
    "set_fp32_tile",
    "get_fp32_tile",
]

LAUNCHES = 0
BWD_LAUNCHES = 0
LAUNCHES_BY_PRECISION = dict.fromkeys(MODES, 0)
BWD_LAUNCHES_BY_PRECISION = dict.fromkeys(MODES, 0)
# Routes of a call (csrc/normal_wgmma.cuh's Route), by the number its C entry
# reports: the products pass and the tile engines ('highest' by default, and
# rows that are not 16-byte aligned), the products pass and the streaming TF32
# tile ('high'), the resident TF32 tile with the products formed in its
# staging ('default'), and the FP32 tile with the products formed in its
# staging ('highest' with set_fp32_tile('fused')).
ROUTES = ("engine", "streaming", "resident", "fp32_fused")
LAUNCHES_BY_ROUTE = dict.fromkeys(ROUTES, 0)
BWD_LAUNCHES_BY_ROUTE = dict.fromkeys(ROUTES, 0)

# The FP32 tile of the 'highest' contractions on 16-byte rows: the engine's
# Fp32Tile after the products pass, or the fused tile of csrc/fp32_hopper.cuh.
FP32_TILES = ("engine", "fused")
_FP32_TILE = "engine"


def set_fp32_tile(tile: str) -> None:
    """Set the FP32 tile that the normal apply and its backward contract on
    at ``'highest'``: ``'engine'`` (the default) or ``'fused'``. It applies
    from the next call; both give the same bits."""
    global _FP32_TILE
    if tile not in FP32_TILES:
        raise ValueError(f"the FP32 tile is one of {FP32_TILES}, got {tile!r}")
    _FP32_TILE = tile


def get_fp32_tile() -> str:
    """The current FP32 tile: ``'engine'`` or ``'fused'``."""
    return _FP32_TILE


def _cmul(ar, ai, br, bi):
    """``a ⊙ b`` with the 4-multiplication product."""
    return ar * br - ai * bi, ar * bi + ai * br


def _k_h(kr, ki, yr, yi, precision="highest"):
    """``K ·_h y`` for ``K (b, 1|t, h, h)`` and ``y (b, t, c, h, w)``."""
    k_r = kr[:, :, None]  # broadcasts over coils (and frames)
    k_i = ki[:, :, None]
    mm = lambda a, b: matmul(a, b, precision)
    return mm(k_r, yr) - mm(k_i, yi), mm(k_r, yi) + mm(k_i, yr)


def normal_apply_torch(xr, xi, kr, ki, sr, si, lam,
                       precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: coil-expand, K along h by ``torch.matmul`` (each real
    product as the kernel takes it at ``precision``), conj-reduce."""
    yr, yi = _cmul(sr[:, None], si[:, None], xr[:, :, None], xi[:, :, None])  # (b, t, c, h, w)
    zr, zi = _k_h(kr, ki, yr, yi, check_precision(precision))
    outr = (sr[:, None] * zr + si[:, None] * zi).sum(dim=2)
    outi = (sr[:, None] * zi - si[:, None] * zr).sum(dim=2)
    return outr + lam * xr, outi + lam * xi


def normal_apply_bwd_torch(xr, xi, gr, gi, kr, ki, sr, si, lam, precision: str = "highest"):
    """Plain version of the backward: ``(x̄_re, x̄_im, s̄_re, s̄_im, λ̄)``
    with ``s̄ (b, c, h, w)`` summed over frames and ``λ̄ (b, t)`` the
    per-(b, t) partials of ``Σ Re⟨g, x⟩``; the contractions at ``precision``."""
    p = check_precision(precision)
    s_r, s_i = sr[:, None], si[:, None]  # (b, 1, c, h, w)
    g_r, g_i = gr[:, :, None], gi[:, :, None]  # (b, t, 1, h, w)
    x_r, x_i = xr[:, :, None], xi[:, :, None]
    # ȳ = Kᴴ (S_c ⊙ g), Kᴴ = conj(K)ᵀ
    vr, vi = _cmul(s_r, s_i, g_r, g_i)
    ybr, ybi = _k_h(kr.transpose(-1, -2), -ki.transpose(-1, -2), vr, vi, p)
    # z = K (S_c ⊙ x)
    yr, yi = _cmul(s_r, s_i, x_r, x_i)
    zr, zi = _k_h(kr, ki, yr, yi, p)
    xbr = (s_r * ybr + s_i * ybi).sum(dim=2) + lam * gr
    xbi = (s_r * ybi - s_i * ybr).sum(dim=2) + lam * gi
    sbr = (g_r * zr + g_i * zi + ybr * x_r + ybi * x_i).sum(dim=1)
    sbi = (g_r * zi - g_i * zr + ybi * x_r - ybr * x_i).sum(dim=1)
    lb = (gr * xr + gi * xi).sum(dim=(2, 3))
    return xbr, xbi, sbr, sbi, lb


# -- the kernels' passes in plain PyTorch (the CPU tests compose them) --------


def coil_products(sr, si, ur, ui):
    """Products pass: ``y[b, t, c] = S[b, c] ⊙ u[b, t]`` as ``(b·t·c, h, w)``
    slabs, the kernels' scratch layout."""
    yr, yi = _cmul(sr[:, None], si[:, None], ur[:, :, None], ui[:, :, None])
    return yr.flatten(0, 2), yi.flatten(0, 2)


def frame_contract(kr, ki, yr, yi, adjoint=False, precision="highest"):
    """Contraction pass on ``(b·t·c, h, w)`` slabs: each group of slabs that
    shares one ``K`` (a frame's c slabs when ``K`` is per frame, a batch
    row's t·c when it is not) goes through one coil-stacked product
    ``K (h × h) · [y_1 | … | y_G] (h × G·w)``; ``Kᴴ`` with ``adjoint``; each
    real product at ``precision``."""
    mm = lambda a, b: matmul(a, b, check_precision(precision))
    b, kt, h, _ = kr.shape
    n, _, w = yr.shape
    g = n // (b * kt)  # slabs sharing one K
    if adjoint:
        kr, ki = kr.transpose(-1, -2), -ki.transpose(-1, -2)
    k_r, k_i = kr.reshape(b * kt, h, h), ki.reshape(b * kt, h, h)
    stack = lambda a: a.reshape(b * kt, g, h, w).transpose(1, 2).reshape(b * kt, h, g * w)
    unstack = lambda a: a.reshape(b * kt, h, g, w).transpose(1, 2).reshape(n, h, w)
    y_r, y_i = stack(yr), stack(yi)
    return unstack(mm(k_r, y_r) - mm(k_i, y_i)), unstack(mm(k_r, y_i) + mm(k_i, y_r))


def coil_reduce(sr, si, zr, zi, xr, xi, lam):
    """Reduction pass: ``out[b, t] = Σ_c conj(S[b, c]) ⊙ z[b, t, c] + λ·x``."""
    b, c = sr.shape[:2]
    z_r, z_i = zr.reshape(b, -1, c, *zr.shape[1:]), zi.reshape(b, -1, c, *zi.shape[1:])
    s_r, s_i = sr[:, None], si[:, None]
    return ((s_r * z_r + s_i * z_i).sum(dim=2) + lam * xr,
            (s_r * z_i - s_i * z_r).sum(dim=2) + lam * xi)


def bwd_pixel_pass(sr, si, ybr, ybi, zr, zi, xr, xi, gr, gi, lam):
    """The backward's passes per pixel after the contractions: ``x̄[b, t] =
    Σ_c conj(S_c) ⊙ ȳ + λg`` (the coil reduction) and ``s̄[b, c] = Σ_t
    conj(g) ⊙ z + ȳ ⊙ conj(x)``, from the ``(b·t·c, h, w)`` slabs of ``ȳ``
    and ``z``."""
    xbr, xbi = coil_reduce(sr, si, ybr, ybi, gr, gi, lam)
    b, c = sr.shape[:2]
    as_5d = lambda a: a.reshape(b, -1, c, *a.shape[1:])
    y_r, y_i, z_r, z_i = map(as_5d, (ybr, ybi, zr, zi))
    g_r, g_i, x_r, x_i = (a[:, :, None] for a in (gr, gi, xr, xi))
    sbr = (g_r * z_r + g_i * z_i + y_r * x_r + y_i * x_i).sum(dim=1)
    sbi = (g_r * z_i - g_i * z_r + y_i * x_r - y_r * x_i).sum(dim=1)
    return xbr, xbi, sbr, sbi


def lambda_partials(xr, xi, gr, gi):
    """``λ̄`` partials per (b, t): ``Σ_{h,w} Re(g ⊙ conj(x))``."""
    return (gr * xr + gi * xi).sum(dim=(2, 3))


def normal_apply_passes(xr, xi, kr, ki, sr, si, lam, precision="highest"):
    """The forward as its kernel computes it: products, contraction, reduction."""
    zr, zi = frame_contract(kr, ki, *coil_products(sr, si, xr, xi), precision=precision)
    return coil_reduce(sr, si, zr, zi, xr, xi, lam)


def normal_apply_bwd_passes(xr, xi, gr, gi, kr, ki, sr, si, lam, precision="highest"):
    """The backward as its kernels compute it: ``ȳ`` and ``z`` by products
    and contraction, the pass per pixel, ``λ̄``'s partials."""
    ybr, ybi = frame_contract(kr, ki, *coil_products(sr, si, gr, gi), adjoint=True,
                              precision=precision)
    zr, zi = frame_contract(kr, ki, *coil_products(sr, si, xr, xi), precision=precision)
    return (*bwd_pixel_pass(sr, si, ybr, ybi, zr, zi, xr, xi, gr, gi, lam),
            lambda_partials(xr, xi, gr, gi))


# Tile rows (slab columns) of the contraction kernel's smaller tile
# (cgemm::Small), which sets its largest grid.
_SMALL_ROWS = 48


def _check(xr, xi, kr, ki, sr, si):
    if xr.ndim != 4 or xi.shape != xr.shape:
        raise ValueError(f"x must be two (b, t, h, w) tensors, got {tuple(xr.shape)}")
    b, t, h, w = xr.shape
    if sr.ndim != 4 or sr.shape[0] != b or sr.shape[2:] != (h, w) or si.shape != sr.shape:
        raise ValueError(f"S must be (b, c, h, w) = ({b}, c, {h}, {w}), got {tuple(sr.shape)}")
    c = sr.shape[1]
    kt = kr.shape[1] if kr.ndim == 4 else -1
    if kr.shape != (b, kt, h, h) or ki.shape != kr.shape or kt not in (1, t):
        raise ValueError(f"K must be ({b}, 1|{t}, {h}, {h}), got {tuple(kr.shape)}")
    for name, a in (("xr", xr), ("xi", xi), ("kr", kr), ("ki", ki), ("sr", sr), ("si", si)):
        if a.device != xr.device:
            raise ValueError(f"{name} is on {a.device}, x on {xr.device}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # the grids: the contraction's (row tile, column tile) blocks of a group
    # (with the small tile) along x and its b·kt groups along y; the
    # elementwise passes' 256-thread blocks
    tiles = -(-(t * c // kt * w) // _SMALL_ROWS) * -(-h // 40)
    if b * kt > 65535 or max(tiles, -(-b * t * c * h * w // 256)) >= 2**31:
        raise ValueError(f"b, t, c, h, w, kt = {(b, t, c, h, w, kt)} exceed the kernels' grid limits")
    return b, t, c, h, w, kt


@lru_cache(maxsize=64)
def _constant_lambda(value, device: torch.device) -> torch.Tensor:
    """A Python-number λ as a one-element f32 tensor on ``device``, made once
    and outside inference mode (it may be saved for backward later)."""
    with torch.inference_mode(False):
        return torch.full((1,), value, dtype=torch.float32, device=device)


def lambda_tensor(lam, device: torch.device) -> torch.Tensor:
    """λ as the one-element f32 tensor on ``device`` that the kernels read.

    A tensor λ (one element) is detached and reshaped: no copy when it is
    already an f32 tensor on ``device``, and never a read to the host. A
    Python number comes from a cache per (value, device)."""
    if torch.is_tensor(lam):
        if lam.numel() != 1:
            raise ValueError(f"λ must have one element, got shape {tuple(lam.shape)}")
        return lam.detach().reshape(1).to(device=device, dtype=torch.float32)
    return trace_safe(_constant_lambda, lam, device)


def _planes(route: int, n: int, nk: int, backward: bool, highest: bool):
    """``(k, sizes)``: the scratch planes (floats each) a call on ``route``
    needs, in the C entry's order, the first ``k`` of them the products
    ``y`` re and im (none on the routes that form them in their staging);
    then the contraction outputs (``z``; the backward's ``ȳ`` and ``z``),
    ``n`` floats each; and for the backward at ``'highest'`` (``highest``)
    and off the engine route the copy ``Kᴴ`` re and im, ``nk`` floats each."""
    k = 0 if ROUTES[route] in ("resident", "fp32_fused") else 2
    sizes = [n] * (k + (4 if backward else 2))
    copy = backward and (highest or ROUTES[route] != "engine")
    return k, sizes + ([nk] * 2 if copy else [])


def _scratch(device, sizes):
    """One f32 allocation cut into planes of ``sizes`` floats: the tensor,
    which keeps them alive, and each plane's device pointer."""
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    ptrs, at = [], buf.data_ptr()
    for n in sizes:
        ptrs.append(at)
        at += n * buf.element_size()
    return buf, ptrs


def _on_cuda(name: str, xr) -> bool:
    if xr.device.type == "cpu":
        return False
    if xr.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {xr.device}")
    return True


def normal_apply(xr, xi, kr, ki, sr, si, lam,
                 precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """``out = Σ_c conj(S_c)⊙(K(S_c⊙x)) + λx`` on raw (re, im) f32 tensors,
    the contraction at ``precision`` (``'highest'``, ``'high'``, ``'default'``).

    Shapes: ``x (b,t,h,w)``, ``K (b,{1|t},h,h)``, ``S (b,c,h,w)``, ``lam`` a
    Python number or a one-element tensor, which the kernel reads on the
    device (:func:`lambda_tensor`). CPU tensors go to
    :func:`normal_apply_torch`, CUDA tensors to the kernel in
    ``csrc/normal_apply.cu``. Returns ``(out_re, out_im)``.
    """
    p = check_precision(precision)
    if not _on_cuda("normal_apply", xr):
        return normal_apply_torch(xr, xi, kr, ki, sr, si, lam, p)
    b, t, c, h, w, kt = _check(xr, xi, kr, ki, sr, si)
    outr = torch.empty_like(xr)
    outi = torch.empty_like(xi)
    if xr.numel() == 0:
        return outr, outi
    lam_t = lambda_tensor(lam, xr.device)
    lib = _build.load("normal_apply")
    operands = (xr.data_ptr(), xi.data_ptr(), kr.data_ptr(), ki.data_ptr(), sr.data_ptr(),
                si.data_ptr())
    n = b * t * c * h * w
    with torch.cuda.device(xr.device):
        fused = int(_FP32_TILE == "fused")
        route = lib.cinemri_normal_apply_route(*operands, b, t, c, h, w, kt, MODES[p], fused)
        # products y (none where the route forms them) and contraction z,
        # (b·t·c, h, w) each, re and im
        k, sizes = _planes(route, n, 0, False, p == "highest")
        scratch, planes = _scratch(xr.device, sizes)
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cinemri_normal_apply(
            *operands, lam_t.data_ptr(), outr.data_ptr(), outi.data_ptr(),
            *(planes[:k] or [None, None]), *planes[k:], b, t, c, h, w, kt, MODES[p], fused,
            stream,
        )
    _build.check(lib, code, "cinemri_normal_apply launch")
    _count(p, route)
    return outr, outi


@counter
def _count(p: str, route: int) -> None:
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_PRECISION[p] += 1
    LAUNCHES_BY_ROUTE[ROUTES[route]] += 1


def normal_apply_bwd(xr, xi, gr, gi, kr, ki, sr, si, lam, precision: str = "highest"):
    """Backward of :func:`normal_apply` for the cotangent ``g`` of ``out``:
    ``(x̄_re, x̄_im, s̄_re, s̄_im, λ̄)`` with ``s̄ (b, c, h, w)`` and the
    per-(b, t) partials ``λ̄ (b, t)``; the contractions at ``precision``.

    CPU tensors go to :func:`normal_apply_bwd_torch`, CUDA tensors to the
    kernels in ``csrc/normal_apply_bwd.cu``. ``g`` must be contiguous.
    """
    p = check_precision(precision)
    if not _on_cuda("normal_apply_bwd", xr):
        return normal_apply_bwd_torch(xr, xi, gr, gi, kr, ki, sr, si, lam, p)
    b, t, c, h, w, kt = _check(xr, xi, kr, ki, sr, si)
    for name, a in (("gr", gr), ("gi", gi)):
        if a.shape != xr.shape or a.device != xr.device or a.dtype != torch.float32:
            raise ValueError(f"{name} must be a float32 {tuple(xr.shape)} tensor on {xr.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    xbr, xbi = torch.empty_like(xr), torch.empty_like(xi)
    sbr, sbi = torch.empty_like(sr), torch.empty_like(si)
    lb = torch.empty((b, t), dtype=torch.float32, device=xr.device)
    if xr.numel() == 0:
        return xbr, xbi, sbr.zero_(), sbi.zero_(), lb.zero_()
    lam_t = lambda_tensor(lam, xr.device)
    lib = _build.load("normal_apply_bwd")
    operands = (xr.data_ptr(), xi.data_ptr(), gr.data_ptr(), gi.data_ptr(), kr.data_ptr(),
                ki.data_ptr(), sr.data_ptr(), si.data_ptr())
    n, nk = b * t * c * h * w, b * kt * h * h
    with torch.cuda.device(xr.device):
        fused = int(_FP32_TILE == "fused")
        route = lib.cinemri_normal_apply_bwd_route(*operands, b, t, c, h, w, kt, MODES[p], fused)
        # products (S⊙g, then S⊙x; none where the route forms them), ȳ and
        # z, (b·t·c, h, w) each, and at 'highest' and on the Hopper routes
        # the copy Kᴴ, (b·kt, h, h); re and im
        k, sizes = _planes(route, n, nk, True, p == "highest")
        scratch, planes = _scratch(xr.device, sizes)
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cinemri_normal_apply_bwd(
            *operands, lam_t.data_ptr(), xbr.data_ptr(), xbi.data_ptr(), sbr.data_ptr(),
            sbi.data_ptr(), lb.data_ptr(), *(planes[:k] or [None, None]), *planes[k:k + 4],
            *(planes[k + 4:] or [None, None]), b, t, c, h, w, kt, MODES[p], fused, stream,
        )
    _build.check(lib, code, "cinemri_normal_apply_bwd launch")
    _count_bwd(p, route)
    return xbr, xbi, sbr, sbi, lb


@counter
def _count_bwd(p: str, route: int) -> None:
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    BWD_LAUNCHES_BY_PRECISION[p] += 1
    BWD_LAUNCHES_BY_ROUTE[ROUTES[route]] += 1


@torch.library.custom_op("cinemri::normal_apply", mutates_args=())
def normal_apply_op(xr: Tensor, xi: Tensor, kr: Tensor, ki: Tensor, sr: Tensor, si: Tensor,
                    lam: Tensor, plain: bool, precision: str = "highest") -> Tuple[Tensor, Tensor]:
    """:func:`normal_apply` (with ``plain``, :func:`normal_apply_torch`) as
    an op; ``lam`` is the one-element f32 tensor of :func:`lambda_tensor`;
    ``precision`` trails with its default, so an artifact exported before it
    existed loads unchanged."""
    return (normal_apply_torch if plain else normal_apply)(xr, xi, kr, ki, sr, si, lam, precision)


@normal_apply_op.register_fake
def _(xr, xi, kr, ki, sr, si, lam, plain, precision="highest"):
    return torch.empty_like(xr), torch.empty_like(xi)


@torch.library.custom_op("cinemri::normal_apply_bwd", mutates_args=())
def normal_apply_bwd_op(xr: Tensor, xi: Tensor, gr: Tensor, gi: Tensor, kr: Tensor, ki: Tensor,
                        sr: Tensor, si: Tensor, lam: Tensor, plain: bool,
                        precision: str = "highest") -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """:func:`normal_apply_bwd` (with ``plain``, :func:`normal_apply_bwd_torch`)
    as an op: ``(x̄_re, x̄_im, s̄_re, s̄_im, λ̄ partials (b, t))``."""
    return (normal_apply_bwd_torch if plain else normal_apply_bwd)(xr, xi, gr, gi, kr, ki, sr, si,
                                                                   lam, precision)


@normal_apply_bwd_op.register_fake
def _(xr, xi, gr, gi, kr, ki, sr, si, lam, plain, precision="highest"):
    return (torch.empty_like(xr), torch.empty_like(xi), torch.empty_like(sr),
            torch.empty_like(si), xr.new_empty(xr.shape[:2]))


def _normal_setup(ctx, inputs, output):
    *operands, plain, precision = inputs
    ctx.save_for_backward(*operands)
    ctx.plain, ctx.precision = plain, precision


def _normal_backward(ctx, gr, gi):
    xr, xi, kr, ki, sr, si, lam = ctx.saved_tensors
    xbr, xbi, sbr, sbi, lb = normal_apply_bwd_op(xr, xi, gr.contiguous(), gi.contiguous(),
                                                 kr, ki, sr, si, lam, ctx.plain, ctx.precision)
    lam_bar = lb.sum().reshape(1) if ctx.needs_input_grad[6] else None
    return xbr, xbi, None, None, sbr, sbi, lam_bar, None, None


normal_apply_op.register_autograd(_normal_backward, setup_context=_normal_setup)


class NormalApply:
    """Differentiable normal apply, the counterpart of the JAX custom VJP.

    ``apply(xr, xi, kr, ki, sr, si, lam, plain, precision="highest")`` calls
    ``torch.ops.cinemri.normal_apply`` (:func:`normal_apply_op`): ``lam`` is
    a Python number or a one-element tensor; a tensor reaches the op
    reshaped to one element, so its gradient flows back to it, and a number
    as the cached device tensor of :func:`lambda_tensor`. ``plain`` picks
    the plain versions over the kernels in both directions, both at
    ``precision``. ``K`` gets no gradient (the caller detaches it).
    """

    @staticmethod
    def apply(xr, xi, kr, ki, sr, si, lam, plain: bool, precision: str = "highest"):
        if torch.is_tensor(lam):
            if lam.numel() != 1:
                raise ValueError(f"λ must have one element, got shape {tuple(lam.shape)}")
            lam_t = lam.reshape(1).to(device=xr.device, dtype=xr.dtype)
        else:
            lam_t = lambda_tensor(lam, xr.device)
        return normal_apply_op(xr, xi, kr, ki, sr, si, lam_t, plain, precision)
