"""Port ops (cinemri_tpu_torch.ops) against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both sides. Tolerance
1e-5 rel/abs for f32 ops (as tests/test_kernels.py holds the normal apply):
both sides compute in f32, in a different summation order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cinemri_tpu.ops.fft as JF
from cinemri_tpu.ops.cplx import Complex as JComplex
from cinemri_tpu.ops.cplx import to_numpy as j_to_numpy
from cinemri_tpu.ops.kernels.dft_pallas import complex_dft_matmul_pallas
from cinemri_tpu.ops.kernels.fft2_pallas import fft2_plane_pallas

from cinemri_tpu_torch.ops import fft as TF
from cinemri_tpu_torch.ops.cplx import Complex, cmean, csum, from_channels, from_complex, to_channels, to_numpy
from cinemri_tpu_torch.ops.coil import rss, rss_complex
from cinemri_tpu_torch.ops.kernels import dft_cuda, fft2_cuda
from cinemri_tpu_torch.ops.pad import pad_to_multiple, unpad
from cinemri_tpu_torch.physics.lowfreq import center_band, mask_center_band
from cinemri_tpu.physics import lowfreq as JL
from cinemri_tpu.ops import pad as JP

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def c64(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def jc(x):
    return JComplex(jnp.asarray(x.real), jnp.asarray(x.imag))


class TestComplex:
    def test_arithmetic_matches_numpy(self, rng):
        a, b = c64(rng, 3, 5), c64(rng, 3, 5)
        ta, tb = from_complex(a), from_complex(b)
        np.testing.assert_allclose(to_numpy(ta * tb), a * b, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(to_numpy(ta / tb), a / b, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(to_numpy(ta - tb + 2.0), a - b + 2.0, rtol=1e-6)
        np.testing.assert_allclose(to_numpy(ta.conj()), a.conj())
        np.testing.assert_allclose(ta.abs().numpy(), np.abs(a), rtol=1e-6)
        np.testing.assert_allclose(to_numpy(ta.transpose(1, 0)), a.T)
        np.testing.assert_allclose(to_numpy(ta[1:]), a[1:])

    def test_reductions_and_channels(self, rng):
        a = c64(rng, 2, 3, 4)
        ta = from_complex(a)
        np.testing.assert_allclose(to_numpy(csum(ta, axis=1)), a.sum(1), rtol=1e-5)
        np.testing.assert_allclose(to_numpy(cmean(ta, axis=1, keepdims=True)),
                                   a.mean(1, keepdims=True), rtol=1e-5)
        r = to_channels(ta, axis=1)
        assert r.shape == (2, 2, 3, 4)
        np.testing.assert_allclose(to_numpy(from_channels(r, axis=1)), a)
        np.testing.assert_allclose(to_numpy(from_complex(torch.from_numpy(a))), a)


class TestDFT:
    @pytest.mark.parametrize("shape", [(2, 3, 32, 32), (2, 3, 24, 20)])
    @pytest.mark.parametrize("fn", ["fft1c", "ifft1c", "fft2c", "ifft2c"])
    def test_matches_jax_xla(self, rng, shape, fn):
        x = c64(rng, *shape)
        kw = {"axis": 1} if fn.endswith("1c") else {}
        got = to_numpy(getattr(TF, fn)(from_complex(x), **kw))
        want = j_to_numpy(getattr(JF, fn)(jc(x), **kw))
        np.testing.assert_allclose(got, want, **TOL)

    @pytest.mark.parametrize("n", [15, 24])
    @pytest.mark.parametrize("inverse", [False, True])
    @pytest.mark.parametrize("alt", [False, True])
    def test_dft_matrix_equals_jax(self, n, inverse, alt):
        for got, want in zip(TF._dft_matrix(n, inverse, alt, "ortho"),
                             JF._dft_matrix(n, inverse, alt, "ortho")):
            np.testing.assert_array_equal(got, want)

    def test_native_path_matches_pair_path(self, rng):
        x = c64(rng, 3, 16, 12)
        pair = to_numpy(TF.fft2c(from_complex(x)))
        np.testing.assert_allclose(TF.fft2c(x), pair, **TOL)
        np.testing.assert_allclose(TF.ifft1c(torch.from_numpy(x), axis=1).numpy(),
                                   to_numpy(TF.ifft1c(from_complex(x), axis=1)), **TOL)

    def test_plain_matmul_matches_pallas_interpret(self, rng):
        b, n = 37, 64  # non-multiple of the Pallas row tile, as tests/test_kernels.py
        x, w = c64(rng, b, n), c64(rng, n, n)
        yr, yi = complex_dft_matmul_pallas(
            jnp.asarray(x.real), jnp.asarray(x.imag),
            w.real.astype(np.float32), w.imag.astype(np.float32), interpret=True,
        )
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
        gr, gi = dft_cuda.complex_dft_matmul(t(x.real)[..., None], t(x.imag)[..., None],
                                             t(w.real), t(w.imag))
        # unnormalized random W: |y| ~ 11, so the 1e-5 budget is taken relative
        np.testing.assert_allclose(gr[..., 0].numpy() + 1j * gi[..., 0].numpy(),
                                   np.asarray(yr) + 1j * np.asarray(yi), rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("o,n,i", [(3, 24, 7), (2, 16, 5), (37, 64, 1), (1, 15, 40)])
    def test_middle_axis_plain_matches_pallas_interpret(self, rng, o, n, i):
        """The (O, N, I) product against the Pallas kernel on the same data
        moved to rows, ``x.moveaxis(1, -1).reshape(-1, N)``."""
        x, w = c64(rng, o, n, i), c64(rng, n, n)
        rows = np.moveaxis(x, 1, -1).reshape(-1, n)
        yr, yi = complex_dft_matmul_pallas(
            jnp.asarray(rows.real), jnp.asarray(rows.imag),
            w.real.astype(np.float32), w.imag.astype(np.float32), interpret=True,
        )
        want = np.moveaxis((np.asarray(yr) + 1j * np.asarray(yi)).reshape(o, i, n), -1, 1)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
        gr, gi = dft_cuda.complex_dft_matmul(t(x.real), t(x.imag), t(w.real), t(w.imag))
        assert gr.shape == (o, n, i) and gr.is_contiguous()
        # unnormalized random W: the 1e-5 budget is taken relative
        np.testing.assert_allclose(gr.numpy() + 1j * gi.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())

    @pytest.mark.parametrize("layout", ["contiguous", "transposed"])
    @pytest.mark.parametrize("axis", [0, 1, 2, 3, 4, -1])
    @pytest.mark.parametrize("fn", ["fft1c", "ifft1c"])
    def test_every_axis_and_layout_matches_jax_xla(self, rng, fn, axis, layout):
        """A (2, 3, 4, 12, 10) input along each axis, contiguous and as a
        transposed view (axes reversed in memory): every route of _apply_dft."""
        x = c64(rng, 2, 3, 4, 12, 10)
        if layout == "contiguous":
            xt = from_complex(x)
        else:
            stored = np.ascontiguousarray(x.transpose(4, 3, 2, 1, 0))
            xt = from_complex(stored).transpose(4, 3, 2, 1, 0)
            assert not xt.re.is_contiguous()
        got = to_numpy(getattr(TF, fn)(xt, axis=axis))
        want = j_to_numpy(getattr(JF, fn)(jc(x), axis=axis))
        np.testing.assert_allclose(got, want, **TOL)

    @pytest.mark.parametrize("axis", [0, 2, 4])
    def test_routes_keep_the_layout_and_copy_only_strided_inputs(self, rng, axis):
        """Innermost in memory, the rest in order: the result has the input's
        strides, no copy. Contiguous: a contiguous result, no copy. Neither
        (axes reversed in memory): one copy."""
        x = c64(rng, 2, 3, 4, 12, 10)
        perm = {0: (1, 2, 3, 4, 0), 2: (0, 1, 3, 4, 2), 4: (0, 1, 2, 3, 4)}[axis]
        inv = tuple(int(a) for a in np.argsort(perm))
        innermost = from_complex(np.ascontiguousarray(x.transpose(perm))).transpose(*inv)
        strided = from_complex(np.ascontiguousarray(x.transpose(4, 3, 2, 1, 0))).transpose(4, 3, 2, 1, 0)
        before = TF.COPIES
        y = TF.fft1c(innermost, axis=axis)
        assert y.re.stride() == innermost.re.stride() and TF.COPIES == before
        y = TF.fft1c(from_complex(x), axis=axis)
        assert y.re.is_contiguous() and TF.COPIES == before
        y = TF.fft1c(strided, axis=axis)
        # (axis 0 is innermost there, but the other axes are not in row-major order)
        assert TF.COPIES == before + 1

    def test_ifft2c_of_contiguous_input_copies_nothing(self, rng):
        x = from_complex(c64(rng, 1, 5, 3, 24, 20))
        before = TF.COPIES
        y = TF.ifft2c(x)
        assert TF.COPIES == before
        np.testing.assert_allclose(to_numpy(y), j_to_numpy(JF.ifft2c(jc(to_numpy(x)))), **TOL)

    def test_varnet_forward_copies_fewer_than_before(self, rng):
        """The VarNet-XF forward copied 5 times in the DFT's axis moves when
        every transform moved its axis last (PERF.md §3); now fewer."""
        from cinemri_tpu_torch.data.masks import RandomMask
        from cinemri_tpu_torch.models import build_model

        t, c, h, w = 5, 3, 32, 24
        k = c64(rng, 1, t, c, h, w)
        mask = RandomMask([6], [4])(t, h, seed=0)[None].astype(np.float32)
        model = build_model("varnet", "XF", num_cascades=2, sens_chans=4, sens_pools=2, chans=4,
                            pools=2, device="cpu", generator=torch.Generator().manual_seed(0))
        before = TF.COPIES
        with torch.inference_mode():
            model.eval()(from_complex(k * mask), torch.from_numpy(mask))
        assert TF.COPIES - before < 5

    def test_cpu_tensors_take_the_plain_version(self, rng):
        before = dft_cuda.LAUNCHES
        x = from_complex(c64(rng, 2, 8, 8))
        back = TF.ifft2c(TF.fft2c(x))
        assert dft_cuda.LAUNCHES == before
        np.testing.assert_allclose(to_numpy(back), to_numpy(x), **TOL)

    def test_backend_switch(self, rng):
        x = from_complex(c64(rng, 2, 8, 8))
        want = to_numpy(TF.fft2c(x))
        try:
            TF.set_dft_backend("torch")
            assert TF._DFT_BACKEND == "torch"
            np.testing.assert_array_equal(to_numpy(TF.fft2c(x)), want)
        finally:
            TF.set_dft_backend("kernel")
        with pytest.raises(ValueError):
            TF.set_dft_backend("pallas")

    def test_wrapper_refuses_other_devices(self):
        x = torch.zeros(2, 4, 1, device="meta")
        with pytest.raises(ValueError):
            dft_cuda.complex_dft_matmul(x, x, torch.zeros(4, 4, device="meta"),
                                        torch.zeros(4, 4, device="meta"))


def _f32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


class TestFFT2Plane:
    """The plain version of the fused 2-D DFT kernel against the Pallas
    kernel in interpret mode, run as tests/test_kernels.py runs it."""

    def test_random_non_symmetric_matrices_match_pallas(self, rng):
        """W_h ≠ W_w, neither symmetric, h ≠ w: a transposition of W_w (the
        wrapper passes it untransposed) or a swap of the two would show."""
        x, wh, ww = c64(rng, 3, 24, 20), c64(rng, 24, 24), c64(rng, 20, 20)
        yr, yi = fft2_plane_pallas(jnp.asarray(x.real), jnp.asarray(x.imag),
                                   (wh.real.astype(np.float32), wh.imag.astype(np.float32)),
                                   (ww.real.astype(np.float32), ww.imag.astype(np.float32)),
                                   interpret=True)
        want = np.asarray(yr) + 1j * np.asarray(yi)
        before = fft2_cuda.LAUNCHES
        gr, gi = fft2_cuda.fft2_plane(_f32(x.real), _f32(x.imag), _f32(wh.real), _f32(wh.imag),
                                      _f32(ww.real), _f32(ww.imag))
        assert fft2_cuda.LAUNCHES == before  # CPU tensors take the plain version
        got = gr.numpy() + 1j * gi.numpy()
        np.testing.assert_allclose(got, (wh @ x) @ ww.T, rtol=1e-4, atol=1e-4 * np.abs(want).max())
        # unnormalized random W: |y| ~ 100, so the 1e-5 budget is taken relative
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    def test_centered_dft_matrices_give_fft2c(self, rng):
        n = 32
        x = c64(rng, 3, n, n)
        wh = TF._dft_matrix(n, False, False, "ortho")
        yr, yi = fft2_cuda.fft2_plane(_f32(x.real), _f32(x.imag), *map(_f32, wh), *map(_f32, wh))
        want = np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(x, axes=(-2, -1)), norm="ortho"),
                               axes=(-2, -1))
        np.testing.assert_allclose(yr.numpy() + 1j * yi.numpy(), want, **TOL)
        jr, ji = fft2_plane_pallas(jnp.asarray(x.real), jnp.asarray(x.imag), wh, wh, interpret=True)
        np.testing.assert_allclose(yr.numpy() + 1j * yi.numpy(), np.asarray(jr) + 1j * np.asarray(ji),
                                   **TOL)

    def test_wrapper_checks(self):
        x = torch.zeros(2, 4, 6, device="meta")
        with pytest.raises(ValueError):
            fft2_cuda.fft2_plane(x, x, *(torch.zeros(4, 4, device="meta"),) * 2,
                                 *(torch.zeros(6, 6, device="meta"),) * 2)
        with pytest.raises(ValueError, match="W_w"):
            fft2_cuda._check(torch.zeros(2, 4, 6), torch.zeros(2, 4, 6), torch.zeros(4, 4),
                             torch.zeros(4, 4), torch.zeros(4, 4), torch.zeros(4, 4))


class TestCoilPad:
    def test_rss(self, rng):
        a = c64(rng, 4, 6, 5)
        np.testing.assert_allclose(rss_complex(from_complex(a), axis=0).numpy(),
                                   np.sqrt((np.abs(a) ** 2).sum(0)), rtol=1e-5)
        np.testing.assert_allclose(rss_complex(torch.from_numpy(a), axis=1).numpy(),
                                   np.sqrt((np.abs(a) ** 2).sum(1)), rtol=1e-5)
        r = a.real.astype(np.float32)
        np.testing.assert_allclose(rss(torch.from_numpy(r)).numpy(), np.sqrt((r * r).sum(0)), rtol=1e-5)

    @pytest.mark.parametrize("shape", [(2, 2, 20, 24), (1, 2, 17, 33), (1, 2, 16, 32)])
    def test_pad_matches_jax(self, rng, shape):
        x = rng.standard_normal(shape).astype(np.float32)
        got, spec = pad_to_multiple(torch.from_numpy(x), 16, axes=(2, 3))
        want, jspec = JP.pad_to_multiple(jnp.asarray(x), 16, axes=(2, 3))
        assert spec == jspec
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(unpad(got, spec, axes=(2, 3)).numpy(), x)


class TestOpstats:
    def test_trace_folding(self, tmp_path):
        from cinemri_tpu_torch.instrument import opstats

        trace = {"traceEvents": [
            {"cat": "kernel", "name": "void (anonymous namespace)::dft_matmul_kernel<64>", "ts": 0, "dur": 10},
            {"cat": "kernel", "name": "void fft2d_r2c_64x64<float>", "ts": 5, "dur": 10},
            {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 30, "dur": 5},
            {"cat": "cpu_op", "name": "aten::conv2d", "ts": 0, "dur": 100},
            {"cat": "kernel", "name": "void (anonymous namespace)::normal_apply_bwd_reduce_kernel", "ts": 40, "dur": 2},
            {"cat": "kernel", "name": "mystery_kernel", "ts": 42, "dur": 3},
            {"cat": "kernel", "name": "mystery_kernel", "ts": 45, "dur": 1},
        ]}
        path = tmp_path / "t.json"
        path.write_text(__import__("json").dumps(trace))
        events = opstats.kernel_events(path)
        assert len(events) == 6
        kinds = opstats.fold_by_kind(events)
        assert kinds["dft_matmul (port kernel)"] == {"ms": 0.01, "count": 1}
        assert kinds["normal_apply_bwd (port kernels)"] == {"ms": 0.002, "count": 1}
        assert kinds["conv / gemm (cuDNN, cuBLAS)"]["count"] == 1
        assert kinds["copy / cat / pad"]["count"] == 1
        assert opstats.top_names(events, "other") == [("mystery_kernel", 0.004, 2)]
        busy, window = opstats.busy_share(events[:3])
        assert (busy, window) == (0.02, 0.035)

    def test_fft2_plane_and_cudnn_fft_kinds(self):
        """The fused 2-D DFT kernel has its own kind ahead of the
        convolutions (whose keys include cuDNN's fft2d_*), and cuDNN's
        vector_fft and region_transform kernels fold into convolution."""
        from cinemri_tpu_torch.instrument import opstats

        names = ["void (anonymous namespace)::fft2_plane_kernel(float const*, ...)",
                 "void DSE::vector_fft<0, 1, 256, 16, 16, 1, float, float, float2>(...)",
                 "region_transform_ABC_val<int, 32, 32, float2>"]
        kinds = opstats.fold_by_kind([(n, 0.0, 1.0) for n in names])
        assert kinds["fft2_plane (port kernel)"] == {"ms": 0.001, "count": 1}
        assert kinds["conv / gemm (cuDNN, cuBLAS)"]["count"] == 2
        assert "other" not in kinds


    def test_dft_kernel_names_fold_to_their_kind(self):
        """The DFT kernels of dft_matmul.cu, whose template arguments name the
        tile engine (cgemm::Tile), fold to the DFT kind, not to gemm."""
        from cinemri_tpu_torch.instrument import opstats

        names = ["void (anonymous namespace)::dft_kernel<cgemm::Tile<128, 40, 8, 8, 5, 3, 4, 1>, "
                 "true, 4>(float const*, ...)",
                 "(anonymous namespace)::dft_small_rows_kernel(float const*, ...)",
                 "(anonymous namespace)::dft_small_cols_kernel(float const*, ...)",
                 "void (anonymous namespace)::fft2_plane_kernel<4>(float const*, ...)"]
        kinds = opstats.fold_by_kind([(n, 0.0, 1.0) for n in names])
        assert kinds["dft_matmul (port kernel)"] == {"ms": 0.003, "count": 3}
        assert kinds["fft2_plane (port kernel)"] == {"ms": 0.001, "count": 1}
        assert "conv / gemm (cuDNN, cuBLAS)" not in kinds

    def test_normal_kernel_names_fold_to_their_kinds(self):
        """The normal apply's three kernels and its backward's six, whose
        contraction names hold the tile engine (cgemm::Tile), fold to the two
        normal-apply kinds, not to gemm."""
        from cinemri_tpu_torch.instrument import opstats

        tile = "cgemm::Tile<128, 40, 8, 8, 5, 3, 4, 1>"
        fwd = ["void (anonymous namespace)::normal_apply_products_kernel<4>(float const*, ...)",
               f"void (anonymous namespace)::normal_apply_contract_kernel<{tile}, 4>(float const*, ...)",
               "void (anonymous namespace)::normal_apply_reduce_kernel<4>(float const*, ...)"]
        bwd = ["void (anonymous namespace)::normal_apply_bwd_products_kernel<4>(float const*, ...)",
               f"void (anonymous namespace)::normal_apply_bwd_contract_kernel<{tile}, 4, true>(...)",
               f"void (anonymous namespace)::normal_apply_bwd_contract_kernel<{tile}, 4, false>(...)",
               "void (anonymous namespace)::normal_apply_bwd_xbar_kernel<4>(float const*, ...)",
               "void (anonymous namespace)::normal_apply_bwd_sbar_kernel<4>(float const*, ...)",
               "void (anonymous namespace)::normal_apply_bwd_lambda_kernel<4>(float const*, ...)"]
        kinds = opstats.fold_by_kind([(n, 0.0, 1.0) for n in fwd + bwd])
        assert kinds["normal_apply (port kernels)"] == {"ms": 0.003, "count": 3}
        assert kinds["normal_apply_bwd (port kernels)"] == {"ms": 0.006, "count": 6}
        assert set(kinds) == {"normal_apply (port kernels)", "normal_apply_bwd (port kernels)"}


class TestLowFreq:
    def test_center_band_matches_jax(self):
        from cinemri_tpu_torch.data.masks import RandomMask

        for seed in range(4):
            m = RandomMask([6], [4])(3, 32, seed=seed)[None]
            pad, num_low = center_band(torch.from_numpy(m))
            jpad, jnum = JL.center_band(jnp.asarray(m))
            assert (int(pad), int(num_low)) == (int(jpad), int(jnum))

    def test_mask_center_band_matches_jax(self, rng):
        x = rng.standard_normal((2, 3, 24, 20)).astype(np.float32)
        got = mask_center_band(torch.from_numpy(x), torch.tensor(7), torch.tensor(6), axis=-2)
        want = JL.mask_center_band(jnp.asarray(x), 7, 6, axis=-2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_per_sample_band(self, rng):
        x = rng.standard_normal((2, 3, 24, 20)).astype(np.float32)
        got = mask_center_band(torch.from_numpy(x), torch.tensor([2, 7]), torch.tensor([4, 6]))
        for i, (p, n) in enumerate(((2, 4), (7, 6))):
            want = mask_center_band(torch.from_numpy(x[i]), torch.tensor(p), torch.tensor(n))
            np.testing.assert_array_equal(got[i].numpy(), want.numpy())


class TestDFTGradient:
    """The DFT product's autograd Function against ``jax.grad`` of the JAX
    transforms on Complex pairs (max |diff| ≤ 1e-5): the backward is the same
    product with ``Wᴴ``."""

    @pytest.mark.parametrize("fn,kw", [("fft1c", {"axis": 1}), ("ifft1c", {"axis": -1}),
                                       ("ifft2c", {}), ("fft2c", {})])
    @pytest.mark.parametrize("backend", ["kernel", "torch"])
    def test_matches_jax_grad(self, rng, fn, kw, backend):
        import jax

        x = c64(rng, 2, 5, 12, 10)
        cr = rng.standard_normal(x.shape).astype(np.float32)
        ci = rng.standard_normal(x.shape).astype(np.float32)

        def loss_j(xre, xim):
            y = getattr(JF, fn)(JComplex(xre, xim), **kw)
            return jnp.sum(y.re * cr) + jnp.sum(y.im * ci)

        want = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x.real), jnp.asarray(x.imag))
        xt = from_complex(x)
        xt.re.requires_grad_(True)
        xt.im.requires_grad_(True)
        try:
            TF.set_dft_backend(backend)
            y = getattr(TF, fn)(xt, **kw)
        finally:
            TF.set_dft_backend("kernel")
        loss = (y.re * torch.from_numpy(cr)).sum() + (y.im * torch.from_numpy(ci)).sum()
        got = torch.autograd.grad(loss, (xt.re, xt.im))
        for g, w in zip(got, want):
            assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-5

    @pytest.mark.parametrize("fn,axis,layout", [("fft1c", 1, "contiguous"), ("ifft1c", 2, "contiguous"),
                                                ("fft1c", 0, "contiguous"), ("ifft1c", -1, "transposed"),
                                                ("fft1c", 2, "transposed")])
    def test_every_route_matches_jax_vjp(self, rng, fn, axis, layout):
        """The backward along the middle axis of (O, N, I): I > 1 on a
        contiguous input, I = 1 on an innermost axis, and the copy route,
        against ``jax.vjp`` of the JAX transform with the same cotangent."""
        import jax

        x = c64(rng, 2, 5, 12, 10)
        cot = c64(rng, *x.shape)
        _, vjp = jax.vjp(lambda xre, xim: tuple(
            (lambda y: (y.re, y.im))(getattr(JF, fn)(JComplex(xre, xim), axis=axis))),
            jnp.asarray(x.real), jnp.asarray(x.imag))
        want = vjp((jnp.asarray(cot.real), jnp.asarray(cot.imag)))
        if layout == "contiguous":
            leaves = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
                      for a in (x.real, x.imag)]
            xt = Complex(*leaves)
        else:
            leaves = [torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 1, 0))).requires_grad_(True)
                      for a in (x.real, x.imag)]
            xt = Complex(*(a.permute(3, 2, 1, 0) for a in leaves))
        y = getattr(TF, fn)(xt, axis=axis)
        loss = (y.re * torch.from_numpy(cot.real)).sum() + (y.im * torch.from_numpy(cot.imag)).sum()
        got = torch.autograd.grad(loss, leaves)
        for g, w in zip(got, want):
            g = g.numpy() if layout == "contiguous" else g.permute(3, 2, 1, 0).numpy()
            assert np.abs(g - np.asarray(w)).max() <= 1e-5

    def test_adjoint_is_conjugate_transpose_of_the_same_matrix(self):
        for inverse in (False, True):
            wr, wi = TF._dft_tensors(15, inverse, False, "ortho", torch.device("cpu"))
            hr, hi = TF._dft_adjoint_tensors(15, inverse, False, "ortho", torch.device("cpu"))
            assert hr.is_contiguous() and hi.is_contiguous()
            torch.testing.assert_close(hr, wr.T, rtol=0, atol=0)
            torch.testing.assert_close(hi, -wi.T, rtol=0, atol=0)

    def test_matrices_get_no_gradient_and_grad_may_be_strided(self, rng):
        x = from_complex(c64(rng, 3, 8, 1))
        x.re.requires_grad_(True)
        wr, wi = (a.clone().requires_grad_(True)
                  for a in TF._dft_tensors(8, False, False, "ortho", torch.device("cpu")))
        hr, hi = TF._dft_adjoint_tensors(8, False, False, "ortho", torch.device("cpu"))
        yr, yi = dft_cuda.ComplexDFTMatmul.apply(x.re, x.im, wr, wi, hr, hi, False)
        # the incoming gradient is a transposed (non-contiguous) view
        (yr * torch.ones(8, 3).T[..., None]).sum().backward()
        assert wr.grad is None and wi.grad is None
        torch.testing.assert_close(x.re.grad[..., 0], torch.ones(3, 8) @ hr.T, rtol=1e-6, atol=1e-6)
