"""CUDA kernels of the port against their plain versions, on the card.

Marked ``cuda`` (registered in ``pyproject.toml``): each test skips without
a CUDA device (and nvcc). Run on a GPU machine without JAX with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``.
Tolerance 2e-5 x max |plain result|: both sides are f32 FMA without TF32
and differ only in summation order.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # TF32 convs round inputs to 10 mantissa bits
    return torch.device("cuda", 0)


def _close(got, want, tol=2e-5):
    scale = max(want[0].abs().max().item(), want[1].abs().max().item())
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= tol * scale


@pytest.mark.parametrize("b,n", [(37, 64), (1000, 15), (513, 200), (3, 7)])
def test_dft_kernel_matches_plain(dev, b, n):
    from cinemri_tpu_torch.ops import fft as F
    from cinemri_tpu_torch.ops.kernels import dft_cuda

    g = torch.Generator(device=dev).manual_seed(b)
    xr = torch.randn(b, n, 1, generator=g, device=dev)
    xi = torch.randn(b, n, 1, generator=g, device=dev)
    wr, wi = F._dft_tensors(n, True, False, "ortho", dev)
    before = dft_cuda.LAUNCHES
    got = dft_cuda.complex_dft_matmul(xr, xi, wr, wi)
    assert dft_cuda.LAUNCHES == before + 1
    _close(got, dft_cuda.complex_dft_matmul_torch(xr, xi, wr, wi))


@pytest.mark.parametrize("o,n,i", [(2000, 200, 1), (10, 200, 200), (30000, 200, 1), (150, 200, 200),
                                   (40000, 15, 1), (1, 15, 40000), (37, 64, 1), (3, 24, 7),
                                   (3, 7, 5), (5, 44, 36), (300, 40, 3)])
def test_dft_layouts_match_plain(dev, o, n, i):
    """Each instance of the (O, N, I) kernel (I == 1 rows, I > 1 slabs,
    N <= 16) at the path's layouts and at ragged ones."""
    from cinemri_tpu_torch.ops import fft as F
    from cinemri_tpu_torch.ops.kernels import dft_cuda

    g = torch.Generator(device=dev).manual_seed(o + n + i)
    xr = torch.randn(o, n, i, generator=g, device=dev)
    xi = torch.randn(o, n, i, generator=g, device=dev)
    wr, wi = F._dft_tensors(n, True, False, "ortho", dev)
    before = dft_cuda.LAUNCHES
    got = dft_cuda.complex_dft_matmul(xr, xi, wr, wi)
    assert dft_cuda.LAUNCHES == before + 1
    assert got[0].shape == (o, n, i)
    _close(got, dft_cuda.complex_dft_matmul_torch(xr, xi, wr, wi))


@pytest.mark.parametrize("o,n,i", [(64, 200, 1), (2, 40, 8), (300, 15, 1), (2, 15, 9)])
def test_dft_unaligned_rows_match_plain(dev, o, n, i):
    """Operands one float past a 16-byte boundary take the 4-byte copies."""
    from cinemri_tpu_torch.ops import fft as F
    from cinemri_tpu_torch.ops.kernels import dft_cuda

    g = torch.Generator(device=dev).manual_seed(n)
    xr, xi = (torch.randn(o * n * i + 1, generator=g, device=dev)[1:].view(o, n, i) for _ in range(2))
    wr, wi = F._dft_tensors(n, False, False, "ortho", dev)
    _close(dft_cuda.complex_dft_matmul(xr, xi, wr, wi),
           dft_cuda.complex_dft_matmul_torch(xr, xi, wr, wi))


def test_dft_kernel_refuses_other_layouts(dev):
    """A CUDA tensor the kernel does not take raises; nothing falls back."""
    from cinemri_tpu_torch.ops import fft as F
    from cinemri_tpu_torch.ops.kernels import dft_cuda

    wr, wi = F._dft_tensors(15, False, False, "ortho", dev)
    x = torch.zeros(4, 15, 6, device=dev)
    before = dft_cuda.LAUNCHES
    with pytest.raises(ValueError, match="contiguous"):
        dft_cuda.complex_dft_matmul(x.transpose(0, 2), x.transpose(0, 2), wr, wi)
    with pytest.raises(ValueError):
        dft_cuda.complex_dft_matmul(x[..., None], x[..., None], wr, wi)
    with pytest.raises(ValueError):
        dft_cuda.complex_dft_matmul(x[:, :, 0], x[:, :, 0], wr, wi)
    with pytest.raises(TypeError):
        dft_cuda.complex_dft_matmul(x.double(), x.double(), wr, wi)
    assert dft_cuda.LAUNCHES == before


@pytest.mark.parametrize("layout", ["contiguous", "transposed"])
def test_dft_every_axis_matches_plain_backend(dev, layout):
    """fft1c/ifft1c along every axis of a (2, 3, 4, 12, 10) tensor, contiguous
    and with its axes reversed in memory, through the kernel and through the
    plain backend; and the backward of each."""
    from cinemri_tpu_torch.ops import fft as F
    from cinemri_tpu_torch.ops.cplx import Complex

    g = torch.Generator(device=dev).manual_seed(7)
    parts = [torch.randn(2, 3, 4, 12, 10, generator=g, device=dev) for _ in range(4)]
    if layout == "transposed":
        parts = [p.permute(4, 3, 2, 1, 0).contiguous().permute(4, 3, 2, 1, 0) for p in parts]
    for fn in (F.fft1c, F.ifft1c):
        for axis in range(5):
            outs = []
            for backend in ("kernel", "torch"):
                leaves = [p.detach().clone().requires_grad_(True) for p in parts[:2]]
                try:
                    F.set_dft_backend(backend)
                    y = fn(Complex(*leaves), axis=axis)
                    ((y.re * parts[2]).sum() + (y.im * parts[3]).sum()).backward()
                finally:
                    F.set_dft_backend("kernel")
                outs.append((y.re.detach(), y.im.detach(), leaves[0].grad, leaves[1].grad))
            _close(outs[0][:2], outs[1][:2])
            _close(outs[0][2:], outs[1][2:])


# Shapes of the normal-apply kernels' tests: b = 2 with a K per frame and
# c·w = 600, not a multiple of the contraction's 128-column row tile (a tile
# that followed the wrong frame's K would show); h = 70 and 36, which 40 (the
# column tile) does not divide; kt = 1 (one K per batch row); w = 33 (4-byte
# copies); 18 coils.
NORMAL_SHAPES = [(1, 3, 4, 24, 20, 3, 0.0), (2, 3, 2, 70, 33, 1, 0.37), (2, 3, 3, 200, 200, 3, 0.0),
                 (1, 2, 3, 36, 28, 2, 0.37), (2, 3, 3, 200, 200, 1, 0.37), (1, 2, 18, 24, 20, 2, 0.37)]
# The FP32 tiles at 'highest' on 16-byte rows (csrc/normal_passes.cuh
# Fp32Tile, 96 x 40 blocks, the default; csrc/fp32_hopper.cuh, the fused
# tile over all of h in 40-row squads): the flagship, kt = 1 with λ, b = 2;
# h = 52 and 244 (16-byte rows that 40 does not divide, 244 in two passes of
# the fused tile's squads), where 96 and 64 columns do not divide c·w either.
FP32_SHAPES = [(1, 15, 10, 200, 200, 15, 0.0), (1, 15, 10, 200, 200, 1, 0.37),
               (2, 15, 10, 200, 200, 15, 0.0), (2, 3, 3, 52, 48, 3, 0.37), (1, 2, 2, 244, 12, 2, 0.2)]
# (tile, offset) of each case: the FP32 tile asked for (normal_cuda.
# set_fp32_tile), and whether x, g and S start one float past a 16-byte
# boundary (K's rows stay 16-byte aligned), which keeps a call off the fused
# route and takes 4-byte passes around the contraction
FWD_CASES = ([s + ("engine", False) for s in NORMAL_SHAPES + FP32_SHAPES]
             + [s + ("fused", False) for s in FP32_SHAPES + NORMAL_SHAPES[1:2] + NORMAL_SHAPES[3:4]]
             + [FP32_SHAPES[0] + ("engine", True), FP32_SHAPES[3] + ("fused", True)])


def _route(h, w, tile, offset):
    """The route a call at 'highest' takes: the fused FP32 tile where it is
    asked for on 16-byte rows, else the engine (Fp32Tile on 16-byte rows)."""
    aligned = h % 4 == 0 and w % 4 == 0 and not offset
    return "fp32_fused" if tile == "fused" and aligned else "engine"


def _randn(g, dev, offset):
    """``torch.randn`` from ``g``; with ``offset`` a contiguous view that
    starts one float past the allocation (4-byte aligned only)."""
    def r(*shape):
        n = int(np.prod(shape))
        a = torch.randn(n + int(offset), generator=g, device=dev)
        return a[int(offset):].view(shape)
    return r


def _on_tile(tile, fn):
    """``fn()`` with the FP32 tile ``tile`` set, the default restored after."""
    from cinemri_tpu_torch.ops.kernels import normal_cuda

    try:
        normal_cuda.set_fp32_tile(tile)
        return fn()
    finally:
        normal_cuda.set_fp32_tile("engine")


@pytest.mark.parametrize("b,t,c,h,w,kt,lam,tile,offset", FWD_CASES)
def test_normal_kernel_matches_plain(dev, b, t, c, h, w, kt, lam, tile, offset):
    from cinemri_tpu_torch.ops.kernels import normal_cuda
    from cinemri_tpu_torch.physics.operators import masked_normal_kernel

    rng = np.random.default_rng(0)
    mask = torch.from_numpy((rng.random((b, kt, 1, h, 1)) < 0.4).astype(np.float32)).to(dev)
    k = masked_normal_kernel(mask)
    r = _randn(torch.Generator(device=dev).manual_seed(1), dev, offset)
    args = (r(b, t, h, w), r(b, t, h, w), k.re.contiguous(), k.im.contiguous(),
            r(b, c, h, w), r(b, c, h, w), lam)
    route = _route(h, w, tile, offset)
    before = normal_cuda.LAUNCHES, normal_cuda.LAUNCHES_BY_ROUTE[route]
    got = _on_tile(tile, lambda: normal_cuda.normal_apply(*args))
    assert (normal_cuda.LAUNCHES, normal_cuda.LAUNCHES_BY_ROUTE[route]) == \
        (before[0] + 1, before[1] + 1)
    _close(got, normal_cuda.normal_apply_torch(*args))
    if tile == "fused":  # the same bits as the engine route
        for a, b_ in zip(got, normal_cuda.normal_apply(*args)):
            assert torch.equal(a, b_)


def _normal_k(rng, b, kt, h, hermitian, dev):
    """``(K_re, K_im)`` of ``masked_normal_kernel`` on a random line mask,
    which is Hermitian (``Kᴴ = K``); without ``hermitian`` a random complex
    perturbation of it, so that a backward contracting with ``K`` where it
    should use ``Kᴴ`` disagrees with the plain version."""
    from cinemri_tpu_torch.physics.operators import masked_normal_kernel

    mask = torch.from_numpy((rng.random((b, kt, 1, h, 1)) < 0.4).astype(np.float32)).to(dev)
    k = masked_normal_kernel(mask)
    kr, ki = k.re.contiguous(), k.im.contiguous()
    if not hermitian:
        d = lambda: torch.from_numpy(rng.standard_normal((b, kt, h, h)).astype(np.float32)).to(dev)
        kr, ki = kr + d() / h ** 0.5, ki + d() / h ** 0.5
        assert (kr - kr.transpose(-1, -2)).abs().max().item() > 0.1
    return kr, ki


# the flagship and ragged shapes (4-byte copies at w = 33, kt = 1; 16-byte
# rows on the TF32 modes' streaming tile at 36 x 28) with a K that is not
# Hermitian
NON_HERMITIAN = [(1, 15, 10, 200, 200, 15, 0.0, False), (2, 3, 2, 70, 33, 1, 0.37, False),
                 (1, 2, 3, 36, 28, 2, 0.37, False)]


@pytest.mark.parametrize("b,t,c,h,w,kt,lam,hermitian,tile,offset",
                         [s + (True, "engine", False)
                          for s in NORMAL_SHAPES + [(1, 4, 3, 24, 20, 4, 0.0)]]
                         + [s + ("engine", False) for s in NON_HERMITIAN]
                         + [s + (True, "engine", False) for s in FP32_SHAPES]
                         + [s + (False, "engine", False) for s in FP32_SHAPES[1:]]
                         + [s + (h_, "fused", False) for s in FP32_SHAPES for h_ in (True, False)]
                         + [s + ("fused", False) for s in NON_HERMITIAN[1:]]
                         + [FP32_SHAPES[0] + (False, "engine", True),
                            FP32_SHAPES[3] + (False, "fused", True)])
def test_normal_bwd_kernel_matches_plain(dev, b, t, c, h, w, kt, lam, hermitian, tile, offset):
    from cinemri_tpu_torch.ops.kernels import normal_cuda

    rng = np.random.default_rng(2)
    kr, ki = _normal_k(rng, b, kt, h, hermitian, dev)
    r = _randn(torch.Generator(device=dev).manual_seed(3), dev, offset)
    args = (r(b, t, h, w), r(b, t, h, w), r(b, t, h, w), r(b, t, h, w), kr, ki, r(b, c, h, w),
            r(b, c, h, w), lam)
    route = _route(h, w, tile, offset)
    before = normal_cuda.BWD_LAUNCHES, normal_cuda.BWD_LAUNCHES_BY_ROUTE[route]
    got = _on_tile(tile, lambda: normal_cuda.normal_apply_bwd(*args))
    assert (normal_cuda.BWD_LAUNCHES, normal_cuda.BWD_LAUNCHES_BY_ROUTE[route]) == \
        (before[0] + 1, before[1] + 1)
    want = normal_cuda.normal_apply_bwd_torch(*args)
    _close(got[:2], want[:2])
    _close(got[2:4], want[2:4])
    assert got[4].shape == (b, t)
    torch.testing.assert_close(got[4].sum(), want[4].sum(), rtol=1e-5, atol=0)
    if tile == "fused":  # the same bits as the engine route
        for a, b_ in zip(got, normal_cuda.normal_apply_bwd(*args)):
            assert torch.equal(a, b_)


def _kernels_of_call(fn):
    """The names of the device kernels one warm call of ``fn`` runs, under
    ``torch.profiler``, in launch order. Host sleeps pad the window, which
    keeps only the device events it places inside it."""
    import tempfile
    import time
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from cinemri_tpu_torch.instrument import opstats

    fn()
    torch.cuda.synchronize()
    for pad_s in (0.2, 2.0):
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
    return [name for name, _, _ in events if "normal_apply" in name]


FP32_TILE = "cgemm::Tile<96, 40, 16, 8, 5, 3, 4, 1>"  # csrc/normal_passes.cuh Fp32Tile
SMALL_TILE = "cgemm::Tile<48, 40, 8, 3, 5, 3, 4, 8>"  # csrc/cgemm_tile.cuh Small


@pytest.mark.parametrize("b,t,c,h,w,kt,tile,offset,fwd,bwd", [
    # 16-byte rows: the products pass, Fp32Tile, the passes; ȳ on the copy Kᴴ
    (2, 3, 3, 52, 48, 3, "engine", False, ["products_kernel<4", FP32_TILE, "reduce_kernel<4"],
     ["adjoint", "products_kernel<4", FP32_TILE, "products_kernel<4", FP32_TILE, "xbar", "sbar",
      "lambda"]),
    # the fused FP32 tile forms the products in its staging
    (2, 3, 3, 52, 48, 3, "fused", False, ["fp32_fused", "reduce_kernel<4"],
     ["adjoint", "fp32_fused", "fp32_fused", "xbar", "sbar", "lambda"]),
    # x, g and S one float off: 4-byte passes, Fp32Tile on K's 16-byte rows
    (2, 3, 3, 52, 48, 3, "fused", True, ["products_kernel<1", FP32_TILE, "reduce_kernel<1"],
     ["adjoint", "products_kernel<1", FP32_TILE, "products_kernel<1", FP32_TILE, "xbar", "sbar",
      "lambda"]),
    # rows that are not 16-byte aligned: the small tile, ȳ on the copy Kᴴ
    (2, 3, 2, 70, 33, 1, "fused", False, ["products_kernel<1", SMALL_TILE, "reduce_kernel<1"],
     ["adjoint", "products_kernel<1", SMALL_TILE, "products_kernel<1", SMALL_TILE, "xbar", "sbar",
      "lambda"]),
])
def test_normal_highest_kernels_by_name(dev, b, t, c, h, w, kt, tile, offset, fwd, bwd):
    """The kernels one 'highest' call of the normal apply and of its backward
    runs, by name under the profiler: the FP32 tile of each route, and no
    contraction that reads Kᴴ in place (the backward's contractions are its
    k-contiguous instances, ADJOINT false)."""
    from cinemri_tpu_torch.ops.kernels import normal_cuda

    rng = np.random.default_rng(4)
    kr, ki = _normal_k(rng, b, kt, h, False, dev)
    r = _randn(torch.Generator(device=dev).manual_seed(5), dev, offset)
    x, g, s = (r(b, t, h, w), r(b, t, h, w)), (r(b, t, h, w), r(b, t, h, w)), \
        (r(b, c, h, w), r(b, c, h, w))
    names = _on_tile(tile, lambda: (
        _kernels_of_call(lambda: normal_cuda.normal_apply(*x, kr, ki, *s, 0.37)),
        _kernels_of_call(lambda: normal_cuda.normal_apply_bwd(*x, *g, kr, ki, *s, 0.37))))
    for got, want in zip(names, (fwd, bwd)):
        assert len(got) == len(want), got
        for name, part in zip(got, want):
            assert part in name, (part, got)
    contractions = [n for n in names[1] if "contract_kernel" in n]
    assert all(", false, 0>" in n for n in contractions), contractions


@pytest.mark.parametrize("c", [5, 1])
def test_normal_apply_on_coil_shards_matches_plain(dev, c):
    """The normal apply and its backward at the flagship's (t 15, 200 x 200,
    a K per frame) on a coil shard of 5 or 1 coils with λ = 0, as each rank
    of a coil axis of 2 or 10 runs them."""
    from cinemri_tpu_torch.ops.kernels import normal_cuda
    from cinemri_tpu_torch.physics.operators import masked_normal_kernel

    b, t, h, w = 1, 15, 200, 200
    rng = np.random.default_rng(c)
    mask = torch.from_numpy((rng.random((b, t, 1, h, 1)) < 0.4).astype(np.float32)).to(dev)
    k = masked_normal_kernel(mask)
    g = torch.Generator(device=dev).manual_seed(c)
    r = lambda *s_: torch.randn(s_, generator=g, device=dev)
    x, s = (r(b, t, h, w), r(b, t, h, w)), (r(b, c, h, w), r(b, c, h, w))
    kk = (k.re.contiguous(), k.im.contiguous())
    before = (normal_cuda.LAUNCHES, normal_cuda.BWD_LAUNCHES)
    got = normal_cuda.normal_apply(*x, *kk, *s, 0.0)
    _close(got, normal_cuda.normal_apply_torch(*x, *kk, *s, 0.0))
    gy = (r(b, t, h, w), r(b, t, h, w))
    got = normal_cuda.normal_apply_bwd(*x, *gy, *kk, *s, 0.0)
    want = normal_cuda.normal_apply_bwd_torch(*x, *gy, *kk, *s, 0.0)
    assert (normal_cuda.LAUNCHES, normal_cuda.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _close(got[:2], want[:2])
    _close(got[2:4], want[2:4])


@pytest.mark.parametrize("kernel", ["dft", "normal"])
def test_kernel_grads_match_plain(dev, kernel):
    """Autograd through each kernel's Function on the card (kernel forward
    and backward) against the same Function on the plain versions."""
    from cinemri_tpu_torch.ops import fft as F
    from cinemri_tpu_torch.ops.kernels import dft_cuda, normal_cuda
    from cinemri_tpu_torch.physics.operators import masked_normal_kernel

    g = torch.Generator(device=dev).manual_seed(4)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    if kernel == "dft":
        mats = (F._dft_tensors(15, False, False, "ortho", dev)
                + F._dft_adjoint_tensors(15, False, False, "ortho", dev))
        inputs, shape = (r(300, 15, 1), r(300, 15, 1)), (300, 15, 1)
        call = lambda xr, xi, plain: dft_cuda.ComplexDFTMatmul.apply(xr, xi, *mats, plain)
        counts = lambda: (dft_cuda.LAUNCHES,)
        expected = (2,)  # forward, and backward on Wᴴ
    else:
        k = masked_normal_kernel((torch.rand(1, 3, 1, 40, 1, generator=g, device=dev) < 0.4).float())
        kr, ki = k.re.contiguous(), k.im.contiguous()
        inputs = (r(1, 3, 40, 24), r(1, 3, 40, 24), r(1, 2, 40, 24), r(1, 2, 40, 24),
                  torch.tensor(0.3, device=dev))
        shape = (1, 3, 40, 24)
        call = lambda xr, xi, sr, si, lam, plain: normal_cuda.NormalApply.apply(
            xr, xi, kr, ki, sr, si, lam, plain)
        counts = lambda: (normal_cuda.LAUNCHES, normal_cuda.BWD_LAUNCHES)
        expected = (1, 1)
    cr, ci = r(*shape), r(*shape)
    grads = []
    for plain in (False, True):
        leaves = [a.clone().requires_grad_(True) for a in inputs]
        before = counts()
        yr, yi = call(*leaves, plain)
        ((yr * cr).sum() + (yi * ci).sum()).backward()
        launched = tuple(a - b for a, b in zip(counts(), before))
        assert launched == ((0,) * len(expected) if plain else expected)
        grads.append([a.grad for a in leaves])
    for got, want in zip(*grads):
        assert (got - want).abs().max().item() <= 2e-5 * want.abs().max().item()


@pytest.mark.parametrize("b,h,w,dft", [(3, 32, 32, True), (4, 24, 20, False), (5, 70, 33, False),
                                       (2, 200, 200, True), (150, 200, 200, True), (10, 200, 200, True),
                                       (2, 44, 260, False)])
def test_fft2_plane_kernel_matches_plain(dev, b, h, w, dft):
    """The fused 2-D DFT against its plain version: the centered DFT
    matrices, and random non-symmetric W_h ≠ W_w (which would show a
    transposed or swapped W_w)."""
    from cinemri_tpu_torch.ops import fft as F
    from cinemri_tpu_torch.ops.kernels import fft2_cuda

    g = torch.Generator(device=dev).manual_seed(b)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    if dft:
        mats = F._dft_tensors(h, True, False, "ortho", dev) + F._dft_tensors(w, True, False, "ortho", dev)
    else:
        mats = (r(h, h), r(h, h), r(w, w), r(w, w))
    x = (r(b, h, w), r(b, h, w))
    before = fft2_cuda.LAUNCHES
    got = fft2_cuda.fft2_plane(*x, *mats)
    assert fft2_cuda.LAUNCHES == before + 1
    _close(got, fft2_cuda.fft2_plane_torch(*x, *mats))


def test_normal_apply_device_lambda_makes_no_sync(dev):
    """A CUDA-tensor λ reaches both kernels by pointer: forward and backward
    run under sync debug mode "error" once warm, and agree with the plain
    versions."""
    from cinemri_tpu_torch.ops.kernels import normal_cuda
    from cinemri_tpu_torch.physics.operators import masked_normal_kernel

    g = torch.Generator(device=dev).manual_seed(5)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    k = masked_normal_kernel((torch.rand(1, 3, 1, 40, 1, generator=g, device=dev) < 0.4).float())
    kr, ki = k.re.contiguous(), k.im.contiguous()
    x, s = (r(1, 3, 40, 24), r(1, 3, 40, 24)), (r(1, 2, 40, 24), r(1, 2, 40, 24))
    lam = torch.tensor(0.6, device=dev, requires_grad=True)
    outs = []
    for plain in (False, True):
        leaves = [a.clone().requires_grad_(True) for a in x]
        normal_cuda.NormalApply.apply(*leaves, kr, ki, *s, lam, plain)  # warm
        lam.grad = None
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yr, yi = normal_cuda.NormalApply.apply(*leaves, kr, ki, *s, lam, plain)
            (yr.sum() + 2 * yi.sum()).backward()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        outs.append((yr.detach(), yi.detach(), leaves[0].grad, leaves[1].grad, lam.grad.clone()))
    _close(outs[0][:2], outs[1][:2])
    _close(outs[0][2:4], outs[1][2:4])
    torch.testing.assert_close(outs[0][4], outs[1][4], rtol=1e-5, atol=0)


def test_small_cinenet_kernels_match_plain(dev):
    """A small CineNet-XF forward through the kernels against the plain
    versions, and its launch counts: 2 + 2 per cascade DFT products, and
    1 + cg_iters normal applies per cascade."""
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops import fft as F
    from cinemri_tpu_torch.ops.cplx import Complex
    from cinemri_tpu_torch.ops.kernels import dft_cuda, normal_cuda
    from cinemri_tpu_torch.physics import operators as OPS

    rng = np.random.default_rng(6)
    b, t, c, h, w = 1, 4, 3, 40, 24
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    mask = (rng.random((b, t, 1, h, 1)) < 0.4).astype(np.float32)
    k = (rng.standard_normal((b, t, c, h, w)) + 1j * rng.standard_normal((b, t, c, h, w))) * mask
    s = rng.standard_normal((b, 1, c, h, w)) + 1j * rng.standard_normal((b, 1, c, h, w))
    s /= np.sqrt((np.abs(s) ** 2).sum(2, keepdims=True))
    args = (Complex(f(k.real), f(k.imag)), f(mask), Complex(f(s.real), f(s.imag)))
    model = build_model("cinenet", "XF", device=dev, num_cascades=2, cg_iters=3, chans=4, pools=2)
    before = (dft_cuda.LAUNCHES, normal_cuda.LAUNCHES)
    with torch.inference_mode():
        got = model(*args)
    assert (dft_cuda.LAUNCHES - before[0], normal_cuda.LAUNCHES - before[1]) == (2 + 2 * 2, 2 * 4)
    try:
        F.set_dft_backend("torch")
        OPS.set_normal_backend("torch")
        with torch.inference_mode():
            want = model(*args)
    finally:
        F.set_dft_backend("kernel")
        OPS.set_normal_backend("kernel")
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_shared_kernel_and_maps_match_plain(dev):
    """b = 2 volumes sharing a batch-1 K and a batch-1 S (ROADMAP Queue 3):
    the operator copies them to batch 2 and the kernel runs; values and the
    gradients (x, the shared S, λ) against the plain versions."""
    from cinemri_tpu_torch.ops.cplx import Complex
    from cinemri_tpu_torch.ops.kernels import normal_cuda
    from cinemri_tpu_torch.physics import operators as OPS

    g = torch.Generator(device=dev).manual_seed(7)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    kern = OPS.masked_normal_kernel((torch.rand(1, 1, 1, 40, 1, generator=g, device=dev) < 0.4).float())
    x, s = (r(2, 3, 1, 40, 24), r(2, 3, 1, 40, 24)), (r(1, 1, 3, 40, 24), r(1, 1, 3, 40, 24))
    cr, ci = r(2, 3, 1, 40, 24), r(2, 3, 1, 40, 24)
    results = []
    for backend in ("kernel", "torch"):
        leaves = [a.clone().requires_grad_(True) for a in (*x, *s)]
        lam = torch.tensor(0.3, device=dev, requires_grad=True)
        before = normal_cuda.LAUNCHES
        try:
            OPS.set_normal_backend(backend)
            out = OPS.normal_plus_lambda_kernel(Complex(*leaves[:2]), kern, Complex(*leaves[2:]), lam)
            ((out.re * cr).sum() + (out.im * ci).sum()).backward()
        finally:
            OPS.set_normal_backend("kernel")
        assert normal_cuda.LAUNCHES - before == (1 if backend == "kernel" else 0)
        assert leaves[2].grad.shape == (1, 1, 3, 40, 24)
        results.append((out.re.detach(), out.im.detach(), *(a.grad for a in leaves), lam.grad))
    got, want = results
    _close(got[:2], want[:2])
    _close(got[2:4], want[2:4])
    _close(got[4:6], want[4:6])
    torch.testing.assert_close(got[6], want[6], rtol=1e-5, atol=0)


def test_small_soft_sense_recon_matches_plain(dev):
    """The soft-SENSE CG reconstruction through the DFT kernel (2 + 4 x
    (iters + 1) launches) against the plain versions, to 1e-4 x max |out|."""
    from cinemri_tpu_torch.ops import fft as F
    from cinemri_tpu_torch.ops.cplx import Complex
    from cinemri_tpu_torch.ops.kernels import dft_cuda
    from cinemri_tpu_torch.physics import operators as OPS

    rng = np.random.default_rng(8)
    b, t, m, c, h, w = 1, 3, 2, 4, 40, 24
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    cplx = lambda *shape: rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    mask = (rng.random((b, t, 1, h, 1)) < 0.5).astype(np.float32)
    k, s = cplx(b, t, c, h, w) * mask, cplx(b, m, c, h, w)
    args = (Complex(f(k.real), f(k.imag)), f(mask), Complex(f(s.real), f(s.imag)))
    before = dft_cuda.LAUNCHES
    got = OPS.soft_sense_recon(*args, lam=1e-2, iters=5)
    assert dft_cuda.LAUNCHES - before == 2 + 4 * 6
    try:
        F.set_dft_backend("torch")
        want = OPS.soft_sense_recon(*args, lam=1e-2, iters=5)
    finally:
        F.set_dft_backend("kernel")
    assert got.shape == (b, t, h, w)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


class _ListLoader:
    """Batches from in-memory samples (the card's host has no h5py); no
    ``dataset``, so the Trainer sends every batch from the host."""

    def __init__(self, samples):
        self.samples = samples

    def steps_per_epoch(self):
        return len(self.samples)

    def epoch(self, epoch):
        from cinemri_tpu_torch.train import collate

        return iter([collate([s]) for s in self.samples])


def test_small_trainer_fit_launches_the_kernels(dev, tmp_path):
    """A 2-epoch Trainer.fit of a small VarNet-XF (2 cascades, chans 4,
    t=4, c=3, 32x32) on the card launches the three kernels, matches the
    same fit through the plain versions (losses within 1e-4 relative), and
    its checkpoint restores bit-identically."""
    from cinemri_tpu_torch.data import RandomMask, VarNetDataTransform
    from cinemri_tpu_torch.data.synthetic import synthetic_volume
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops import fft as F
    from cinemri_tpu_torch.ops.kernels import dft_cuda, normal_cuda
    from cinemri_tpu_torch.physics import operators as OPS
    from cinemri_tpu_torch.train import Trainer, TrainerConfig

    tf = VarNetDataTransform(RandomMask([6], [2]), use_seed=True)
    samples = []
    for seed in (0, 1):
        vol = synthetic_volume(num_frames=4, num_coils=3, h=32, w=32, noise=1e-2, seed=seed)
        samples.append(tf(vol["kspace"], None, vol["image"], {}, f"vol{seed}.h5", 0))

    def fit(backend, ckpt_dir=None):
        F.set_dft_backend(backend)
        OPS.set_normal_backend(backend)
        try:
            model = build_model("varnet", "XF", device=dev, num_cascades=2, chans=4, pools=2,
                                sens_chans=4, sens_pools=2)
            trainer = Trainer(model, TrainerConfig(epochs=2, log_dir=None, ckpt_dir=ckpt_dir),
                              train_loader=_ListLoader(samples), val_loader=_ListLoader(samples[:1]),
                              device=dev)
            losses, step = [], trainer._train_step

            def recording(state, batch):
                state, aux = step(state, batch)
                losses.append(aux["loss"].item())
                return state, aux

            trainer._train_step = recording
            trainer.fit()
            return trainer, losses
        finally:
            F.set_dft_backend("kernel")
            OPS.set_normal_backend("kernel")

    before = (dft_cuda.LAUNCHES, normal_cuda.LAUNCHES, normal_cuda.BWD_LAUNCHES)
    trainer, losses = fit("kernel", tmp_path / "ckpt")
    after = (dft_cuda.LAUNCHES, normal_cuda.LAUNCHES, normal_cuda.BWD_LAUNCHES)
    assert all(a > b for a, b in zip(after, before))
    _, plain = fit("torch")
    np.testing.assert_allclose(losses, plain, rtol=1e-4)
    fresh = Trainer(build_model("varnet", "XF", device=dev, num_cascades=2, chans=4, pools=2,
                                sens_chans=4, sens_pools=2),
                    TrainerConfig(log_dir=None, ckpt_dir=tmp_path / "ckpt"), device=dev)
    assert fresh.restore_latest() == 2
    for a, b in zip(trainer.state.model.state_dict().values(), fresh.state.model.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("o,n,i,inverse,alt", [(1, 15, 240000, False, True),
                                               (1, 15, 200000, True, False),
                                               (2, 5, 3 * 24 * 4, False, True)])
def test_dft_xpdnet_layouts_match_plain(dev, o, n, i, inverse, alt):
    """XPDNet's temporal DFTs on its channel-last buffer: fft1c_alt at
    (1, 15, 240000) (the buffer (1, 15, 200, 200, 6)) and ifft1c at
    (1, 15, 200000); forward and autograd (the kernel on the alt matrix's
    Wᴴ) against the plain version."""
    from cinemri_tpu_torch.ops import fft as F
    from cinemri_tpu_torch.ops.kernels import dft_cuda

    g = torch.Generator(device=dev).manual_seed(o + n + i)
    r = lambda: torch.randn(o, n, i, generator=g, device=dev)
    mats = (F._dft_tensors(n, inverse, alt, "ortho", dev)
            + F._dft_adjoint_tensors(n, inverse, alt, "ortho", dev))
    inputs, cot = (r(), r()), (r(), r())
    outs = []
    for plain in (False, True):
        xr, xi = (a.clone().requires_grad_(True) for a in inputs)
        before = dft_cuda.LAUNCHES
        y = dft_cuda.ComplexDFTMatmul.apply(xr, xi, *mats, plain)
        grads = torch.autograd.grad(y, (xr, xi), cot)
        assert dft_cuda.LAUNCHES - before == (0 if plain else 2)
        outs.append((y, grads))
    _close(outs[0][0], outs[1][0])
    _close(outs[0][1], outs[1][1])


def test_normal_apply_on_a_strided_head_matches_plain(dev):
    """normal_plus_lambda_kernel with XPDNet's λ = 0.0 on the strided head
    of a channel-last buffer (copied once for the kernel, counted), forward
    and gradient, against the plain versions."""
    from cinemri_tpu_torch.ops.cplx import Complex
    from cinemri_tpu_torch.physics import operators as OPS

    g = torch.Generator(device=dev).manual_seed(8)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    b, t, c, h, w = 1, 4, 3, 40, 24
    k = OPS.masked_normal_kernel((torch.rand(b, t, 1, h, 1, generator=g, device=dev) < 0.4).float())
    s = Complex(r(b, 1, c, h, w), r(b, 1, c, h, w))
    buf = (r(b, t, h, w, 4), r(b, t, h, w, 4))
    cot = (r(b, t, 1, h, w), r(b, t, 1, h, w))
    outs = []
    for backend in ("kernel", "torch"):
        leaves = [a.clone().requires_grad_(True) for a in buf]
        head = Complex(leaves[0][..., 0][:, :, None], leaves[1][..., 0][:, :, None])
        OPS.set_normal_backend(backend)
        try:
            before = OPS.COPIES
            y = OPS.normal_plus_lambda_kernel(head, k, s, 0.0)
            assert OPS.COPIES == before + 1
            grads = torch.autograd.grad((y.re, y.im), leaves, cot)
        finally:
            OPS.set_normal_backend("kernel")
        outs.append(((y.re, y.im), grads))
    _close(outs[0][0], outs[1][0])
    _close(outs[0][1], outs[1][1])


@pytest.mark.parametrize("family,dyn", [("xpdnet", "XF"), ("xpdnet", "2D"), ("varnet", "3D"),
                                        ("cinenet", "3D")])
def test_small_new_variants_match_plain(dev, family, dyn):
    """Small XPDNet / 2-D / 3-D models through the kernels against the plain
    versions."""
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops import fft as F
    from cinemri_tpu_torch.ops.cplx import Complex
    from cinemri_tpu_torch.physics import operators as OPS

    rng = np.random.default_rng(9)
    b, t, c, h, w = 1, 5, 3, 40, 24
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    mask = (rng.random((b, t, 1, h, 1)) < 0.4).astype(np.float32)
    mask[:, :, :, h // 2 - 3:h // 2 + 3] = 1
    k = (rng.standard_normal((b, t, c, h, w)) + 1j * rng.standard_normal((b, t, c, h, w))) * mask
    args = (Complex(f(k.real), f(k.imag)), f(mask))
    if family == "cinenet":
        s = rng.standard_normal((b, 1, c, h, w)) + 1j * rng.standard_normal((b, 1, c, h, w))
        s /= np.sqrt((np.abs(s) ** 2).sum(2, keepdims=True))
        args += (Complex(f(s.real), f(s.imag)),)
    kw = {"xpdnet": dict(num_cascades=2, sens_chans=4, sens_pools=2, n_scales=2,
                         n_filters_per_scale=(4, 8), n_convs_per_scale=(2, 2), n_primal=3),
          "varnet": dict(num_cascades=2, sens_chans=4, sens_pools=2, chans=4, pools=2),
          "cinenet": dict(num_cascades=2, cg_iters=2, chans=4, pools=2)}[family]
    model = build_model(family, dyn, device=dev, **kw)
    with torch.inference_mode():
        got = model(*args)
    try:
        F.set_dft_backend("torch")
        OPS.set_normal_backend("torch")
        with torch.inference_mode():
            want = model(*args)
    finally:
        F.set_dft_backend("kernel")
        OPS.set_normal_backend("kernel")
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.fixture
def nccl_world1(dev, tmp_path):
    """A one-rank NCCL group on the card, torn down after the test."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60), device_id=dev)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("weights", [None, [1.0, 0.0]])
def test_data_parallel_step_on_nccl_matches_plain_step(nccl_world1, weights):
    """The data-parallel step of a small VarNet-XF (2 cascades, chans 4, t=4,
    c=3, 32x32, b=2) on a one-rank NCCL group against the plain step from
    the same weights, two steps: the losses within 1e-4 (cuDNN's backward
    is not deterministic), the same kernel launches, and per step one
    gradient all-reduce of Σ numel x 4 bytes and two scalar ones."""
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops.cplx import Complex
    from cinemri_tpu_torch.ops.kernels import dft_cuda, normal_cuda
    from cinemri_tpu_torch.parallel import distributed as D
    from cinemri_tpu_torch.parallel import make_mesh
    from cinemri_tpu_torch.train import create_train_state, make_train_step

    dev = nccl_world1
    rng = np.random.default_rng(3)
    b, t, c, h, w = 2, 4, 3, 32, 32
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    mask = (rng.random((b, 1, 1, h, 1)) < 0.4).astype(np.float32)
    mask[:, :, :, h // 2 - 3:h // 2 + 3] = 1
    k = (rng.standard_normal((b, t, c, h, w)) + 1j * rng.standard_normal((b, t, c, h, w))) * mask
    batch = {"masked_kspace": Complex(f(k.real), f(k.imag)), "mask": f(mask),
             "target": f(np.abs(k).mean(axis=2))}
    if weights is not None:
        batch["sample_weight"] = f(np.asarray(weights))
    model = build_model("varnet", "XF", device=dev, num_cascades=2, chans=4, pools=2,
                        sens_chans=4, sens_pools=2)
    init = {n: v.detach().clone() for n, v in model.state_dict().items()}
    runs = []
    for step in (make_train_step(), make_train_step(mesh=make_mesh({"data": 1}))):
        model.load_state_dict(init)
        state = create_train_state(model, device=dev)
        losses, counts = [], []
        for _ in range(2):
            before = (dft_cuda.LAUNCHES, normal_cuda.LAUNCHES, normal_cuda.BWD_LAUNCHES)
            D.COLLECTIVES.clear()
            D.COLLECTIVE_BYTES.clear()
            state, aux = step(state, batch)
            losses.append(aux["loss"].item())
            after = (dft_cuda.LAUNCHES, normal_cuda.LAUNCHES, normal_cuda.BWD_LAUNCHES)
            counts.append(([a - b_ for a, b_ in zip(after, before)], dict(D.COLLECTIVES),
                           dict(D.COLLECTIVE_BYTES)))
        runs.append((losses, counts, [p.detach().clone() for p in model.parameters()]))
    (plain_losses, plain_counts, plain_params), (losses, counts, params) = runs
    np.testing.assert_allclose(losses, plain_losses, rtol=1e-4)
    nbytes = 4 * sum(p.numel() for p in params)
    for (launched, calls, sent), (plain_launched, plain_calls, _) in zip(counts, plain_counts):
        assert launched == plain_launched and all(launched)
        assert calls == {"grad": 1, "scalar": 2} and not plain_calls
        assert sent == {"grad": nbytes, "scalar": 12}
    for p, q in zip(params, plain_params):  # two Adam steps of lr 1e-4 move a weight < 1e-3
        assert (p - q).abs().max().item() <= 1e-3


NCCL_WORKER = """
import pickle, sys, time
import torch
from cinemri_tpu_torch.data import RandomMask, VarNetDataTransform
from cinemri_tpu_torch.data.synthetic import synthetic_volume
from cinemri_tpu_torch.models import build_model
from cinemri_tpu_torch.parallel import distributed as D
from cinemri_tpu_torch.parallel import initialize, make_mesh, make_process_sum
from cinemri_tpu_torch.train import Trainer, TrainerConfig, collate


class ListLoader:  # in-memory batches (the card's host has no h5py); no dataset, no cache
    def __init__(self, samples, batch_size=1):
        self.batches = [samples[i:i + batch_size] for i in range(0, len(samples), batch_size)]

    def steps_per_epoch(self, epoch=0):
        return len(self.batches)

    def epoch(self, epoch):
        return iter([collate(b) for b in self.batches])


def samples(n):
    tf = VarNetDataTransform(RandomMask([6], [2]), use_seed=True)
    out = []
    for seed in range(n):
        vol = synthetic_volume(num_frames=4, num_coils=3, h=32, w=32, noise=1e-2, seed=seed)
        out.append(tf(vol["kspace"], None, vol["image"], {}, f"vol{seed}.h5", 0))
    return out


def fit(world, rank, device, ckpt_dir, mesh=None):
    data = samples(2 * world)
    train = data[rank::world] if mesh is not None else data
    batch = 1 if mesh is not None else world
    model = build_model("varnet", "XF", device=device, num_cascades=2, chans=4, pools=2,
                        sens_chans=4, sens_pools=2)
    trainer = Trainer(model, TrainerConfig(epochs=2, log_dir=None, ckpt_dir=ckpt_dir),
                      train_loader=ListLoader(train, batch), val_loader=ListLoader(train[:1]),
                      mesh=mesh, reduce_fn=make_process_sum(), device=device)
    losses, step = [], trainer._train_step

    def recording(state, batch_, **kw):
        state, aux = step(state, batch_, **kw)
        losses.append(aux["loss"].item())
        return state, aux

    trainer._train_step = recording
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    trainer.fit_ms_per_step = (time.perf_counter() - t0) * 1e3 / trainer.state.step
    return trainer, losses


if __name__ == "__main__":
    out_dir = sys.argv[1]
    rank, world = initialize(device="cuda")  # torchrun's environment: NCCL, cuda:LOCAL_RANK
    trainer, losses = fit(world, rank, None, f"{out_dir}/ckpt", mesh=make_mesh())
    fresh = Trainer(build_model("varnet", "XF", device=trainer.device, num_cascades=2, chans=4,
                                pools=2, sens_chans=4, sens_pools=2),
                    TrainerConfig(log_dir=None, ckpt_dir=f"{out_dir}/ckpt"), mesh=trainer.mesh,
                    device=trainer.device)
    next_epoch = fresh.restore_latest()
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump({"device": str(trainer.device), "losses": losses, "history": trainer.history,
                     "fit_ms_per_step": trainer.fit_ms_per_step,
                     "collectives": dict(D.COLLECTIVES), "next_epoch": next_epoch,
                     "restored": all(torch.equal(a, b) for a, b in zip(
                         trainer.model.parameters(), fresh.model.parameters())),
                     "params": [p.detach().cpu() for p in trainer.model.parameters()]}, f)
    torch.distributed.destroy_process_group()
"""


def test_data_parallel_fit_over_nccl_ranks(dev, tmp_path):
    """With two or more cards: one process per card, started as torchrun
    starts them (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and joined by ``parallel.initialize`` over NCCL; a
    2-epoch ``Trainer.fit`` of a small VarNet-XF (one sample per rank and
    step, validation, checkpoints) against this process fitting the global
    batches: the ranks' weights bit-identical, the losses within 1e-4 and
    the weights within 1e-3 (four Adam steps of lr 1e-4) of the one-process
    fit, the checkpoint restored bit-identically on every rank."""
    import importlib.util
    import os
    import pickle
    import socket
    import subprocess
    import sys
    from pathlib import Path

    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more CUDA devices")
    repo = Path(__file__).resolve().parent.parent
    script = tmp_path / "worker.py"
    script.write_text(NCCL_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    base = dict(os.environ, PYTHONPATH=str(repo), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                WORLD_SIZE=str(world))
    procs = [subprocess.Popen([sys.executable, str(script), str(tmp_path)],
                              env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0])
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    ranks = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))

    spec = importlib.util.spec_from_file_location("nccl_worker", script)
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    one, want = worker.fit(world, 0, dev, tmp_path / "ckpt_one")
    print(f"[nccl-fit] {world} ranks: Trainer.fit wall ms per step (2 epochs, validation, "
          f"checkpoints; the loss read each step) {[round(r_['fit_ms_per_step'], 3) for r_ in ranks]}; "
          f"one process with the global batch {one.fit_ms_per_step:.3f}")
    assert [r_["device"] for r_ in ranks] == [f"cuda:{r}" for r in range(world)]
    for r_ in ranks:
        assert r_["losses"] == ranks[0]["losses"] and r_["history"] == ranks[0]["history"]
        np.testing.assert_allclose(r_["losses"], want, rtol=1e-4)
        for p, q, w in zip(r_["params"], ranks[0]["params"], one.model.parameters()):
            assert torch.equal(p, q)
            assert (p - w.detach().cpu()).abs().max().item() <= 1e-3
        assert r_["restored"] and r_["next_epoch"] == 2
        assert r_["collectives"]["grad"] == 4 and r_["collectives"]["broadcast"] >= 1
        assert r_["collectives"]["barrier"] >= 2 and r_["collectives"]["metric"] > 0


MESH_WORKER = """
import pickle, sys, time
import numpy as np
import torch
from cinemri_tpu_torch.data.masks import RandomMask
from cinemri_tpu_torch.models import build_model
from cinemri_tpu_torch.parallel import distributed as D
from cinemri_tpu_torch.parallel import initialize, make_mesh, shard_batch
from cinemri_tpu_torch.train import create_train_state, make_train_step

FLAGSHIP = dict(num_cascades=10, sens_chans=8, sens_pools=3, chans=16, pools=3)


def batch():
    # the flagship train-step batch: 15 frames x 10 coils x 200 x 200, 4x with 10 center lines
    rng = np.random.default_rng(0)
    k = (rng.standard_normal((1, 15, 10, 200, 200))
         + 1j * rng.standard_normal((1, 15, 10, 200, 200))).astype(np.complex64)
    mask = RandomMask([10], [4])(15, 200, seed=0)[None].astype(np.float32)
    return {"masked_kspace": k * mask, "mask": mask,
            "target": np.abs(k).mean(axis=2).astype(np.float32)}


def run(device, mesh=None, steps=3):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    axes = {} if mesh is None else {"plane_axis": "plane", "coil_axis": "coil"}
    model = build_model("varnet", "XF", device=device, generator=torch.Generator().manual_seed(0),
                        **FLAGSHIP, **axes)
    state = create_train_state(model, device=device)
    step = make_train_step(mesh=mesh)
    arrays = shard_batch(batch(), mesh, device=device)
    losses, ms, grads = [], [], None
    for i in range(steps):
        D.COLLECTIVES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = step(state, arrays)
        losses.append(aux["loss"].item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            grads = [p.grad.detach().cpu() for p in model.parameters()]
    return dict(losses=losses, ms=ms, grads=grads, collectives=dict(D.COLLECTIVES),
                params=[p.detach().cpu() for p in model.parameters()])


if __name__ == "__main__":
    out_dir = sys.argv[1]
    rank, world = initialize(device="cuda")  # torchrun's environment: NCCL, cuda:LOCAL_RANK
    out = run(None, make_mesh({"plane": 2, "coil": 2}))
    with open(f"{out_dir}/mesh{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
"""


def test_plane_coil_mesh_over_nccl_ranks(dev, tmp_path):
    """With four or more cards: four processes, one per card, started as
    torchrun starts them and joined over NCCL, train the flagship VarNet-XF
    (full width, 15 x 10 x 200 x 200) 3 steps on ``{plane: 2, coil: 2}``:
    each rank runs the plane nets on 100 of the 200 planes of each plane
    batch and the normal apply on 5 of the 10 coils. Held against this
    process's one-card run from the same weights: losses within 1e-4,
    first-step gradients within 1e-2 (relative L2), the ranks' weights
    bit-identical; prints ms per step on each."""
    import importlib.util
    import math
    import os
    import pickle
    import socket
    import subprocess
    import sys
    from pathlib import Path

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    world = 4
    repo = Path(__file__).resolve().parent.parent
    script = tmp_path / "mesh_worker.py"
    script.write_text(MESH_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    base = dict(os.environ, PYTHONPATH=str(repo), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                WORLD_SIZE=str(world))
    procs = [subprocess.Popen([sys.executable, str(script), str(tmp_path)],
                              env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0])
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    ranks = []
    for r in range(world):
        with open(tmp_path / f"mesh{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    spec = importlib.util.spec_from_file_location("mesh_worker", script)
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    one = worker.run(dev)
    num = math.sqrt(sum(((a - b) ** 2).sum().item() for a, b in zip(ranks[0]["grads"], one["grads"])))
    grad_rel = num / math.sqrt(sum((b ** 2).sum().item() for b in one["grads"]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(f"[nccl-mesh] {smi[:world]}, 4 ranks on {{plane: 2, coil: 2}} over "
          f"NCCL: ms per step {[[round(x, 3) for x in r_['ms']] for r_ in ranks]}; one card "
          f"{[round(x, 3) for x in one['ms']]}; collectives per step {ranks[0]['collectives']}; "
          f"losses {ranks[0]['losses']} vs {one['losses']}; step-1 grads rel L2 {grad_rel:.3e}")
    for r_ in ranks:
        assert r_["losses"] == ranks[0]["losses"]
        for p, q in zip(r_["params"], ranks[0]["params"]):
            assert torch.equal(p, q)
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=1e-4)
    assert grad_rel <= 1e-2


@pytest.mark.parametrize("name", ["dft_matmul", "normal_apply", "normal_apply_bwd", "fft2_plane"])
def test_custom_op_launches_its_kernel_and_matches_plain(dev, name):
    """Each ``torch.ops.cinemri`` op on CUDA tensors launches its kernel once
    (the wrapper's count) and agrees with the plain version; with ``plain``
    it launches nothing; ``opcheck`` passes on the card."""
    from cinemri_tpu_torch.ops import fft as F
    from cinemri_tpu_torch.ops.kernels import dft_cuda, fft2_cuda, normal_cuda

    g = torch.Generator(device=dev).manual_seed(7)
    r = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    b, t, c, h, w = 1, 15, 10, 200, 200
    lam = torch.full((1,), 0.25, device=dev)
    if name == "dft_matmul":
        mats = F._dft_tensors(15, False, False, "ortho", dev) + F._dft_adjoint_tensors(
            15, False, False, "ortho", dev)
        op, mod, counter, args = dft_cuda.dft_matmul_op, dft_cuda, "LAUNCHES", (
            r(1, 15, 40000), r(1, 15, 40000), *mats)
        plain = dft_cuda.complex_dft_matmul_torch(*args[:4])
    elif name == "normal_apply":
        args = (r(b, t, h, w), r(b, t, h, w), r(b, t, h, h), r(b, t, h, h), r(b, c, h, w),
                r(b, c, h, w), lam)
        op, mod, counter = normal_cuda.normal_apply_op, normal_cuda, "LAUNCHES"
        plain = normal_cuda.normal_apply_torch(*args)
    elif name == "normal_apply_bwd":
        args = (r(b, t, h, w), r(b, t, h, w), r(b, t, h, w), r(b, t, h, w), r(b, t, h, h),
                r(b, t, h, h), r(b, c, h, w), r(b, c, h, w), lam)
        op, mod, counter = normal_cuda.normal_apply_bwd_op, normal_cuda, "BWD_LAUNCHES"
        plain = normal_cuda.normal_apply_bwd_torch(*args)
    else:
        mats = F._dft_tensors(h, True, False, "ortho", dev) + F._dft_tensors(w, True, False, "ortho", dev)
        args = (r(150, h, w), r(150, h, w), *mats)
        op, mod, counter = fft2_cuda.fft2_plane_op, fft2_cuda, "LAUNCHES"
        plain = fft2_cuda.fft2_plane_torch(*args)
    flag = () if name == "fft2_plane" else (False,)
    before = getattr(mod, counter)
    got = op(*args, *flag)
    torch.cuda.synchronize()
    assert getattr(mod, counter) == before + 1
    if name == "normal_apply_bwd":  # x̄ and s̄ pairs; λ̄ partials (b, t)
        _close(got[:2], plain[:2])
        _close(got[2:4], plain[2:4])
        torch.testing.assert_close(got[4], plain[4], rtol=1e-5, atol=1e-5 * plain[4].abs().max().item())
    else:
        _close(got, plain)
    if flag:
        before = getattr(mod, counter)
        op(*args, True)
        assert getattr(mod, counter) == before
    torch.library.opcheck(op, (*args, *flag))


# The TF32 modes ('high': 3xTF32, 'default': 1xTF32; csrc/wgmma_tf32.cuh, and
# csrc/cgemm_tf32.cuh for rows that are not 16-byte aligned)
# against their emulating plain versions (ops/kernels/precision.py): the
# same TF32 operands and partial products, another summation order, so the
# tolerance is the f32 one's order: 1e-5 x max |plain result|.
TF32_TOL = 1e-5


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("o,n,i", [(150, 200, 200), (30000, 200, 1), (1, 15, 40000), (40000, 15, 1),
                                   (2000, 200, 1), (10, 200, 200), (37, 64, 1), (3, 24, 7)])
def test_dft_tf32_modes_match_their_emulation(dev, o, n, i, precision):
    """Each tile of the TF32 path in both instances (the Hopper tile's
    resident and streaming 128- and 64-row tiles, the mma.sync tile for rows
    that are not 16-byte aligned), and N <= 16, which runs the FP32 kernel in
    every mode; the launch is counted under its precision; the result moves
    from 'highest' by the mode's rounding."""
    from cinemri_tpu_torch.ops import fft as F
    from cinemri_tpu_torch.ops.kernels import dft_cuda

    g = torch.Generator(device=dev).manual_seed(o + n + i)
    xr, xi = torch.randn(o, n, i, generator=g, device=dev), torch.randn(o, n, i, generator=g, device=dev)
    wr, wi = F._dft_tensors(n, False, False, "ortho", dev)
    before = dft_cuda.LAUNCHES_BY_PRECISION[precision]
    got = dft_cuda.complex_dft_matmul(xr, xi, wr, wi, precision)
    assert dft_cuda.LAUNCHES_BY_PRECISION[precision] == before + 1
    _close(got, dft_cuda.complex_dft_matmul_torch(xr, xi, wr, wi, precision), TF32_TOL)
    highest = dft_cuda.complex_dft_matmul_torch(xr, xi, wr, wi)
    scale = highest[0].abs().max().item()
    moved = max((a - b).abs().max().item() for a, b in zip(got, highest))
    assert moved <= (5e-5 if precision == "high" else 5e-3) * scale


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("b,t,c,h,w,kt,lam,hermitian",
                         [(1, 15, 10, 200, 200, 15, 0.0, True), (2, 3, 2, 70, 33, 1, 0.37, True),
                          (1, 2, 3, 36, 28, 2, 0.37, True)] + NON_HERMITIAN)
def test_normal_apply_tf32_modes_match_their_emulation(dev, b, t, c, h, w, kt, lam, hermitian,
                                                       precision):
    """The forward and the backward's x̄, s̄ and λ̄ at the flagship shape
    and at ragged ones (4-byte copies at w = 33, the 64-row tile), with
    ``masked_normal_kernel``'s Hermitian K and with one that is not."""
    from cinemri_tpu_torch.ops.kernels import normal_cuda

    rng = np.random.default_rng(4)
    k = _normal_k(rng, b, kt, h, hermitian, dev)
    g = torch.Generator(device=dev).manual_seed(5)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    x, s = (r(b, t, h, w), r(b, t, h, w)), (r(b, c, h, w), r(b, c, h, w))
    args = (*x, *k, *s, lam)
    before = normal_cuda.LAUNCHES_BY_PRECISION[precision]
    got = normal_cuda.normal_apply(*args, precision)
    assert normal_cuda.LAUNCHES_BY_PRECISION[precision] == before + 1
    _close(got, normal_cuda.normal_apply_torch(*args, precision), TF32_TOL)
    gr = (r(b, t, h, w), r(b, t, h, w))
    bargs = (*x, *gr, *k, *s, lam)
    before = normal_cuda.BWD_LAUNCHES_BY_PRECISION[precision]
    got = normal_cuda.normal_apply_bwd(*bargs, precision)
    assert normal_cuda.BWD_LAUNCHES_BY_PRECISION[precision] == before + 1
    want = normal_cuda.normal_apply_bwd_torch(*bargs, precision)
    _close(got[:2], want[:2], TF32_TOL)
    _close(got[2:4], want[2:4], TF32_TOL)
    torch.testing.assert_close(got[4].sum(), want[4].sum(), rtol=1e-5, atol=0)


def test_varnet_xf_at_high_launches_the_tf32_kernels(dev):
    """A small VarNet-XF train step at 'high': every DFT and normal-apply
    launch, forward and backward, runs at 'high', and the loss equals the
    emulating plain versions' within the model tolerance."""
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops import fft as F
    from cinemri_tpu_torch.ops.cplx import Complex
    from cinemri_tpu_torch.ops.kernels import dft_cuda, normal_cuda
    from cinemri_tpu_torch.ops.ssim import ssim_loss
    from cinemri_tpu_torch.physics import operators as OPS

    g = torch.Generator(device=dev).manual_seed(6)
    mask = (torch.rand(1, 4, 1, 32, 1, generator=g, device=dev) < 0.5).float()
    k = Complex(torch.randn(1, 4, 3, 32, 32, generator=g, device=dev) * mask,
                torch.randn(1, 4, 3, 32, 32, generator=g, device=dev) * mask)
    small = dict(num_cascades=2, sens_chans=4, sens_pools=2, chans=4, pools=2)
    losses = {}
    F.set_dft_precision("high")
    try:
        for backend in ("kernel", "torch"):
            F.set_dft_backend(backend)
            OPS.set_normal_backend(backend)
            model = build_model("varnet", "XF", device=dev, generator=torch.Generator().manual_seed(0),
                                **small)
            counts = (dict(dft_cuda.LAUNCHES_BY_PRECISION), dict(normal_cuda.LAUNCHES_BY_PRECISION),
                      dict(normal_cuda.BWD_LAUNCHES_BY_PRECISION))
            loss = ssim_loss(model(k, mask), k.abs()[:, :, 0])
            loss.backward()
            torch.cuda.synchronize()
            losses[backend] = loss.item()
            after = (dft_cuda.LAUNCHES_BY_PRECISION, normal_cuda.LAUNCHES_BY_PRECISION,
                     normal_cuda.BWD_LAUNCHES_BY_PRECISION)
            for before, now in zip(counts, after):
                assert now["highest"] == before["highest"] and now["default"] == before["default"]
                assert (now["high"] > before["high"]) == (backend == "kernel")
    finally:
        F.set_dft_precision("highest")
        F.set_dft_backend("kernel")
        OPS.set_normal_backend("kernel")
    assert losses["kernel"] == pytest.approx(losses["torch"], rel=1e-4)


@pytest.mark.parametrize("family, dyn", [("varnet", "3D"), ("cinenet", "3D"), ("varnet", "CRNN"),
                                         ("xpdnet", "CRNN"), ("xpdnet", "XF")])
def test_bf16_models_match_f32_on_the_card(dev, family, dyn):
    """bf16 small models on cuDNN (3-D and transposed 3-D convolutions in
    bf16, the CRNN's sequential cell) against their f32 selves from the same
    weights, at the JAX package's bound (max 5e-2, mean 1e-2 of max |f32|);
    a loss's gradients are f32."""
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops.cplx import Complex

    g = torch.Generator(device=dev).manual_seed(8)
    mask = (torch.rand(1, 4, 1, 32, 1, generator=g, device=dev) < 0.5).float()
    mask[:, :, :, 12:20] = 1
    k = Complex(torch.randn(1, 4, 3, 32, 32, generator=g, device=dev) * mask,
                torch.randn(1, 4, 3, 32, 32, generator=g, device=dev) * mask)
    args = (k, mask)
    if family == "cinenet":
        s = Complex(torch.randn(1, 1, 3, 32, 32, generator=g, device=dev),
                    torch.randn(1, 1, 3, 32, 32, generator=g, device=dev))
        rss = (s.re ** 2 + s.im ** 2).sum(2, keepdim=True).sqrt()
        args += (Complex(s.re / rss, s.im / rss),)
    kw = {"varnet": dict(sens_chans=4, sens_pools=2), "cinenet": dict(cg_iters=2),
          "xpdnet": dict(sens_chans=4, sens_pools=2, n_primal=3)}[family]
    if dyn == "XF":
        kw.update(n_scales=2, n_filters_per_scale=(4, 8), n_convs_per_scale=(2, 2), norm_buffers=True)
    elif dyn != "CRNN":
        kw.update(chans=4, pools=2)
    else:
        kw.update(chans=6)
    outs = {}
    for bf16 in (False, True):
        model = build_model(family, dyn, device=dev, generator=torch.Generator().manual_seed(0),
                            num_cascades=2, bf16=bf16, **kw)
        outs[bf16] = model(*args)
    scale = outs[False].abs().max().item()
    diff = (outs[True] - outs[False]).abs()
    assert outs[True].dtype == torch.float32 and torch.isfinite(outs[True]).all()
    assert diff.max().item() <= 5e-2 * scale and diff.mean().item() < 1e-2 * scale
    outs[True].sum().backward()
    assert all(p.grad.dtype == torch.float32 for p in model.parameters() if p.grad is not None)


def test_packed_varnet_2d_matches_dense_on_the_card(dev):
    """A small packed VarNet-2D (``models/denoisers/packed_unet.py``: packed
    U-Nets on cuDNN, the kernels' DC) against the dense model from the same
    weights, at 1e-4 x max |out|, launching the DFT and normal-apply kernels;
    and one train step's gradients, whose backward launches the normal
    apply's, within VarNet's train tolerance, 1e-2 (relative L2)."""
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops.cplx import Complex
    from cinemri_tpu_torch.ops.kernels import dft_cuda, normal_cuda

    g = torch.Generator(device=dev).manual_seed(5)
    mask = (torch.rand(1, 4, 1, 48, 1, generator=g, device=dev) < 0.4).float()
    mask[:, :, :, 20:28] = 1
    k = Complex(torch.randn(1, 4, 3, 48, 40, generator=g, device=dev) * mask,
                torch.randn(1, 4, 3, 48, 40, generator=g, device=dev) * mask)
    kw = dict(num_cascades=2, sens_chans=4, sens_pools=2, chans=8, pools=2)
    dense = build_model("varnet", "2D", device=dev, **kw)
    packed = build_model("varnet", "2D", device=dev, packed=True, **kw)
    packed.load_state_dict(dense.state_dict())
    before = (dft_cuda.LAUNCHES, normal_cuda.LAUNCHES, normal_cuda.BWD_LAUNCHES)
    outs, grads = [], []
    for model in (dense, packed):
        out = model(k, mask)
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append(torch.cat([p.grad.flatten() for p in model.parameters()]))
    launched = [a - b for a, b in zip((dft_cuda.LAUNCHES, normal_cuda.LAUNCHES,
                                       normal_cuda.BWD_LAUNCHES), before)]
    assert all(n > 0 for n in launched), launched
    assert (outs[1] - outs[0]).abs().max().item() <= 1e-4 * outs[0].abs().max().item()
    assert ((grads[1] - grads[0]).norm() / grads[0].norm()).item() <= 1e-2


@pytest.fixture
def eager_dc(monkeypatch):
    """``with eager_dc():`` every CG solve runs the eager loop, the one a
    solve's CUDA graphs are held to; the graphs are dropped before and
    after."""
    import contextlib

    from cinemri_tpu_torch.physics import cg

    @contextlib.contextmanager
    def eager():
        with monkeypatch.context() as m:
            m.setattr(cg, "graph_blocker", lambda tensors, coil_axis="": "eager")
            yield

    cg.clear_graphs()
    yield eager
    cg.clear_graphs()


def _cinenet_request(dev, seed, t, c, h, w):
    """k-space, a line mask (centre lines kept) and RSS-normalized maps."""
    from cinemri_tpu_torch.ops.cplx import Complex

    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    mask = (torch.rand(1, t, 1, h, 1, generator=g, device=dev) < 0.25).float()
    mask[:, :, :, h // 2 - 5:h // 2 + 5] = 1
    k = Complex(r(1, t, c, h, w) * mask, r(1, t, c, h, w) * mask)
    sr, si = r(1, 1, c, h, w), r(1, 1, c, h, w)
    rss = (sr ** 2 + si ** 2).sum(2, keepdim=True).sqrt()
    return k, mask, Complex(sr / rss, si / rss)


# CineNet forwards whose CG solves replay CUDA graphs between their normal
# applies: the benchmark's CineNet-XF at full width, and small XT and CRNN;
# and a direct-form XF, whose solves stay eager
GRAPHED = {"xf_full": ("XF", dict(num_cascades=10, cg_iters=6, chans=16, pools=3), (15, 10, 200, 200)),
           "xt": ("XT", dict(num_cascades=2, cg_iters=3, chans=4, pools=2), (6, 3, 40, 24)),
           "crnn": ("CRNN", dict(num_cascades=2, cg_iters=3, chans=6), (4, 3, 32, 32)),
           "xf_direct": ("XF", dict(num_cascades=2, cg_iters=3, chans=4, pools=2, kernel_dc=False),
                         (6, 3, 40, 24))}


@pytest.mark.parametrize("case", sorted(GRAPHED))
def test_graphed_cinenet_is_the_eager_loop(dev, eager_dc, case):
    """Served forwards whose CG solves replay CUDA graphs against the eager
    loop, exactly: two requests with their own data, K and maps; the first's
    image untouched by the second; a ``no_grad`` call after them. One
    capture; the second request replays once a cascade and launches the
    eager loop's kernels on the host (kernel form: 1 + cg_iters normal
    applies a cascade). The direct form captures nothing and replays
    nothing."""
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops.kernels import dft_cuda, normal_cuda
    from cinemri_tpu_torch.physics import cg

    dyn, kw, (t, c, h, w) = GRAPHED[case]
    model = build_model("cinenet", dyn, device=dev, generator=torch.Generator().manual_seed(0), **kw)
    first, second = (_cinenet_request(dev, seed, t, c, h, w) for seed in (1, 2))
    counters = lambda: (cg.GRAPH_REPLAYS, normal_cuda.LAUNCHES, dft_cuda.LAUNCHES)

    def serve_two():
        with torch.inference_mode():
            out = [model(*first)]
            kept = out[0].clone()
            before = counters()
            out.append(model(*second))
            return out, kept, [a - b for a, b in zip(counters(), before)]

    with eager_dc():
        want, _, eager_counts = serve_two()
    captures = cg.GRAPH_CAPTURES
    got, kept, counts = serve_two()
    with torch.no_grad():
        again = model(*first)
    n, iters = kw["num_cascades"], kw["cg_iters"]
    graphed = kw.get("kernel_dc", True)
    assert cg.GRAPH_CAPTURES == captures + graphed
    assert eager_counts[0] == 0 and counts == [n * graphed] + eager_counts[1:]
    if graphed:
        assert counts[1] == n * (iters + 1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(again, want[0]) and torch.equal(got[0], kept)
    assert not torch.equal(got[0], got[1]) and torch.isfinite(got[1]).all()


def test_cinenet_train_step_stays_eager(dev, eager_dc):
    """A small CineNet-XF train step (remat, gradients recorded) after a
    served forward has captured its graph: no replay, and the loss, the
    gradients and the updated weights of the step with every solve eager
    (cuDNN deterministic, so both steps are the same bits)."""
    import contextlib

    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.physics import cg
    from cinemri_tpu_torch.train.step import create_train_state, make_train_step

    k, mask, s = _cinenet_request(dev, 3, 6, 3, 40, 24)
    target = torch.rand(1, 6, 40, 24, generator=torch.Generator(device=dev).manual_seed(4), device=dev)
    batch = {"masked_kspace": k, "mask": mask, "sens_maps": s, "target": target}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for eager in (True, False):
            model = build_model("cinenet", "XF", device=dev, generator=torch.Generator().manual_seed(0),
                                num_cascades=2, cg_iters=3, chans=4, pools=2)
            with eager_dc() if eager else contextlib.nullcontext():
                with torch.inference_mode():
                    model(k, mask, s)
                state = create_train_state(model, device=dev, lr=1e-3)
                captures, replays = cg.GRAPH_CAPTURES, cg.GRAPH_REPLAYS
                state, aux = make_train_step()(state, batch)
                assert (cg.GRAPH_CAPTURES, cg.GRAPH_REPLAYS) == (captures, replays)
            runs.append((aux["loss"], [p.grad.clone() for p in model.parameters()],
                         [p.detach().clone() for p in model.parameters()]))
    finally:
        torch.backends.cudnn.deterministic = saved
    assert cg.GRAPH_CAPTURES >= 1
    (loss_e, grads_e, params_e), (loss_g, grads_g, params_g) = runs
    assert torch.equal(loss_e, loss_g)
    assert all(torch.equal(a, b) for a, b in zip(grads_e, grads_g))
    assert all(torch.equal(a, b) for a, b in zip(params_e, params_g))


def test_replayed_normal_applies_keep_their_profiler_link(dev, eager_dc):
    """Under the profiler with the card's activity, a served CineNet-XF
    forward on the CUDA graphs records as many ``cinemri::normal_apply``
    calls as the eager loop, each with the same operand shapes and with
    the device time of the kernels its replay launched linked to it."""
    from torch.profiler import ProfilerActivity, profile

    from cinemri_tpu_torch.models import build_model

    kw = dict(num_cascades=2, cg_iters=3, chans=4, pools=2)
    model = build_model("cinenet", "XF", device=dev, generator=torch.Generator().manual_seed(0), **kw)
    request = _cinenet_request(dev, 5, 6, 3, 40, 24)

    def calls():
        with torch.inference_mode():
            model(*request)  # the capture, where the graphs engage
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         record_shapes=True) as prof:
                model(*request)
                torch.cuda.synchronize()
        return [(e.input_shapes, e.device_time_total) for e in prof.events()
                if e.name == "cinemri::normal_apply"]

    with eager_dc():
        eager = calls()
    graphed = calls()
    assert len(eager) == kw["num_cascades"] * (kw["cg_iters"] + 1)
    assert [s for s, _ in graphed] == [s for s, _ in eager]
    assert all(t > 0 for _, t in eager + graphed)
