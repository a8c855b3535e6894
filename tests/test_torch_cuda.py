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
    xr = torch.randn(b, n, generator=g, device=dev)
    xi = torch.randn(b, n, generator=g, device=dev)
    wr, wi = F._dft_tensors(n, True, False, "ortho", dev)
    before = dft_cuda.LAUNCHES
    got = dft_cuda.complex_dft_matmul(xr, xi, wr, wi)
    assert dft_cuda.LAUNCHES == before + 1
    _close(got, dft_cuda.complex_dft_matmul_torch(xr, xi, wr, wi))


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


@pytest.mark.parametrize("kernel", ["dft", "normal"])
def test_kernels_refuse_grad(dev, kernel):
    from cinemri_tpu_torch.ops.kernels import dft_cuda, normal_cuda

    r = lambda *s, grad=False: torch.randn(s, device=dev, requires_grad=grad)
    if kernel == "dft":
        x, w = r(4, 8, grad=True), r(8, 8)
        call = lambda: dft_cuda.complex_dft_matmul(x, x, w, w)
        counter = lambda: dft_cuda.LAUNCHES
    else:
        x, k, s = r(1, 2, 8, 8, grad=True), r(1, 2, 8, 8), r(1, 3, 8, 8)
        call = lambda: normal_cuda.normal_apply(x, x, k, k, s, s, 0.0)
        counter = lambda: normal_cuda.LAUNCHES
    before = counter()
    with pytest.raises(NotImplementedError):
        call()
    assert counter() == before
