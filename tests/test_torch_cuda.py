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


@pytest.mark.parametrize("b,t,c,h,w,kt,lam", [(1, 3, 4, 24, 20, 3, 0.0),
                                              (2, 3, 2, 70, 33, 1, 0.37)])
def test_normal_kernel_matches_plain(dev, b, t, c, h, w, kt, lam):
    from cinemri_tpu_torch.ops.kernels import normal_cuda
    from cinemri_tpu_torch.physics.operators import masked_normal_kernel

    rng = np.random.default_rng(0)
    mask = torch.from_numpy((rng.random((b, kt, 1, h, 1)) < 0.4).astype(np.float32)).to(dev)
    k = masked_normal_kernel(mask)
    g = torch.Generator(device=dev).manual_seed(1)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    args = (r(b, t, h, w), r(b, t, h, w), k.re.contiguous(), k.im.contiguous(),
            r(b, c, h, w), r(b, c, h, w), lam)
    before = normal_cuda.LAUNCHES
    got = normal_cuda.normal_apply(*args)
    assert normal_cuda.LAUNCHES == before + 1
    _close(got, normal_cuda.normal_apply_torch(*args))


@pytest.mark.parametrize("b,t,c,h,w,kt,lam", [(2, 3, 2, 70, 33, 1, 0.37),
                                              (1, 4, 3, 24, 20, 4, 0.0)])
def test_normal_bwd_kernel_matches_plain(dev, b, t, c, h, w, kt, lam):
    from cinemri_tpu_torch.ops.kernels import normal_cuda
    from cinemri_tpu_torch.physics.operators import masked_normal_kernel

    rng = np.random.default_rng(2)
    mask = torch.from_numpy((rng.random((b, kt, 1, h, 1)) < 0.4).astype(np.float32)).to(dev)
    k = masked_normal_kernel(mask)
    g = torch.Generator(device=dev).manual_seed(3)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    args = (r(b, t, h, w), r(b, t, h, w), r(b, t, h, w), r(b, t, h, w), k.re.contiguous(),
            k.im.contiguous(), r(b, c, h, w), r(b, c, h, w), lam)
    before = normal_cuda.BWD_LAUNCHES
    got = normal_cuda.normal_apply_bwd(*args)
    assert normal_cuda.BWD_LAUNCHES == before + 1
    want = normal_cuda.normal_apply_bwd_torch(*args)
    _close(got[:2], want[:2])
    _close(got[2:4], want[2:4])
    assert got[4].shape == (b, t)
    torch.testing.assert_close(got[4].sum(), want[4].sum(), rtol=1e-5, atol=0)


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
