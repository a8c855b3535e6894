"""Port physics (cinemri_tpu_torch.physics) and the normal-apply kernel's
plain version against the JAX package on the CPU.

Tolerance 1e-5 rel/abs, as tests/test_kernels.py holds the Pallas normal
apply against the XLA path: f32 on both sides, different summation order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cinemri_tpu.ops.kernels.normal_pallas as NP
import cinemri_tpu.physics.operators as JO
from cinemri_tpu.ops.cplx import Complex as JComplex
from cinemri_tpu.ops.cplx import to_numpy as j_to_numpy

import cinemri_tpu_torch.physics.operators as TO
from cinemri_tpu_torch.ops.cplx import Complex, from_complex, to_numpy
from cinemri_tpu_torch.ops.kernels import normal_cuda

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def c64(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def jc(x):
    return JComplex(jnp.asarray(x.real), jnp.asarray(x.imag))


def line_mask(rng, b, kt, h):
    return (rng.random((b, kt, 1, h, 1)) < 0.4).astype(np.float32)


def with_pallas(fn):
    """Run ``fn`` with the JAX normal backend on the Pallas kernel in
    interpret mode (the toggle of tests/test_kernels.py)."""
    old = NP._INTERPRET
    try:
        NP._INTERPRET = True
        JO.set_normal_backend("pallas")
        return fn()
    finally:
        NP._INTERPRET = old
        JO.set_normal_backend("xla")


@pytest.mark.parametrize("hw", [(32, 32), (24, 20)])
class TestOperators:
    def test_sens_expand_reduce(self, rng, hw):
        h, w = hw
        x, s, k = c64(rng, 2, 4, 1, h, w), c64(rng, 2, 1, 3, h, w), c64(rng, 2, 4, 3, h, w)
        np.testing.assert_allclose(to_numpy(TO.sens_expand(from_complex(x), from_complex(s))),
                                   j_to_numpy(JO.sens_expand(jc(x), jc(s))), **TOL)
        for keep in (True, False):
            np.testing.assert_allclose(
                to_numpy(TO.sens_reduce(from_complex(k), from_complex(s), keepdims=keep)),
                j_to_numpy(JO.sens_reduce(jc(k), jc(s), keepdims=keep)), **TOL)

    def test_soft_dc_and_mask(self, rng, hw):
        h, w = hw
        a, r = c64(rng, 1, 4, 3, h, w), c64(rng, 1, 4, 3, h, w)
        m = line_mask(rng, 1, 4, h)
        v = 0.7
        np.testing.assert_allclose(
            to_numpy(TO.soft_dc(from_complex(a), from_complex(r), torch.from_numpy(m), torch.tensor(v))),
            j_to_numpy(JO.soft_dc(jc(a), jc(r), jnp.asarray(m), v)), **TOL)
        np.testing.assert_allclose(to_numpy(TO.apply_mask(from_complex(a), torch.from_numpy(m))),
                                   a * m, **TOL)

    @pytest.mark.parametrize("kt", [1, 4])
    def test_masked_normal_kernel(self, rng, hw, kt):
        h, _ = hw
        m = line_mask(rng, 2, kt, h)
        np.testing.assert_allclose(to_numpy(TO.masked_normal_kernel(torch.from_numpy(m))),
                                   j_to_numpy(JO.masked_normal_kernel(jnp.asarray(m))), **TOL)

    def test_soft_dc_image_kernel_matches_jax(self, rng, hw):
        h, w = hw
        z, xr, s = c64(rng, 1, 4, 1, h, w), c64(rng, 1, 4, 1, h, w), c64(rng, 1, 1, 3, h, w)
        m = line_mask(rng, 1, 4, h)
        kern_t = TO.masked_normal_kernel(torch.from_numpy(m))
        kern_j = JO.masked_normal_kernel(jnp.asarray(m))
        got = TO.soft_dc_image_kernel(from_complex(z), from_complex(xr), kern_t, from_complex(s),
                                      torch.tensor(0.8))
        want = JO.soft_dc_image_kernel(jc(z), jc(xr), kern_j, jc(s), 0.8)
        np.testing.assert_allclose(to_numpy(got), j_to_numpy(want), **TOL)
        np.testing.assert_allclose(TO.coil_weight(from_complex(s)).numpy(),
                                   np.asarray(JO.coil_weight(jc(s))), **TOL)

    def test_line_mask_predicate(self, rng, hw):
        h, w = hw
        assert TO.is_line_mask(torch.zeros(1, 4, 1, h, 1))
        assert not TO.is_line_mask(torch.zeros(1, 4, 1, h, w))
        with pytest.raises(ValueError):
            TO.masked_normal_kernel(torch.zeros(1, 4, 1, h, w))


class TestNormalApply:
    """The port's normal apply (plain version on CPU tensors) against JAX
    ``normal_plus_lambda_kernel``: the XLA path and the Pallas kernel in
    interpret mode."""

    def _setup(self, rng, b, t, c, h, w, per_frame):
        x, s = c64(rng, b, t, 1, h, w), c64(rng, b, 1, c, h, w)
        m = line_mask(rng, b, t if per_frame else 1, h)
        return x, s, m

    @pytest.mark.parametrize("per_frame", [True, False])
    @pytest.mark.parametrize("lam", [0.0, 0.37])
    @pytest.mark.parametrize("backend", ["xla", "pallas"])
    def test_matches_jax(self, rng, per_frame, lam, backend):
        x, s, m = self._setup(rng, 2, 3, 4, 24, 20, per_frame)
        kern_j = JO.masked_normal_kernel(jnp.asarray(m))
        run = lambda: j_to_numpy(JO.normal_plus_lambda_kernel(jc(x), kern_j, jc(s), lam))
        want = with_pallas(run) if backend == "pallas" else run()
        before = normal_cuda.LAUNCHES
        got = TO.normal_plus_lambda_kernel(
            from_complex(x), TO.masked_normal_kernel(torch.from_numpy(m)), from_complex(s), lam)
        assert normal_cuda.LAUNCHES == before  # CPU tensors take the plain version
        np.testing.assert_allclose(to_numpy(got), want, **TOL)

    def test_plain_version_matches_dense_operator(self, rng):
        """``N(x) + λx`` equals ``sens_reduce(M ⊙ sens_expand(x)) + λx``."""
        x, s, m = self._setup(rng, 1, 3, 2, 16, 12, True)
        xt, st, mt = from_complex(x), from_complex(s), torch.from_numpy(m)
        want = TO.sens_reduce(TO.apply_mask(TO.sens_expand(xt, st), mt), st) + 0.2 * xt
        got = TO.normal_plus_lambda_kernel(xt, TO.masked_normal_kernel(mt), st, 0.2)
        np.testing.assert_allclose(to_numpy(got), to_numpy(want), **TOL)

    def test_backend_switch(self, rng):
        x, s, m = self._setup(rng, 1, 2, 2, 16, 12, False)
        args = (from_complex(x), TO.masked_normal_kernel(torch.from_numpy(m)), from_complex(s), 0.1)
        want = to_numpy(TO.normal_plus_lambda_kernel(*args))
        try:
            TO.set_normal_backend("torch")
            assert TO.get_normal_backend() == "torch"
            np.testing.assert_array_equal(to_numpy(TO.normal_plus_lambda_kernel(*args)), want)
        finally:
            TO.set_normal_backend("kernel")
        with pytest.raises(ValueError):
            TO.set_normal_backend("pallas")

    def test_wrapper_refuses_other_devices(self):
        z = torch.zeros(1, 2, 4, 4, device="meta")
        k = torch.zeros(1, 1, 4, 4, device="meta")
        with pytest.raises(ValueError):
            normal_cuda.normal_apply(z, z, k, k, z, z, 0.0)


class TestLambdaTensor:
    """λ reaches the kernels as a one-element f32 tensor on the device: a
    tensor λ without a copy or a host read, a Python number from a cache."""

    def test_tensor_lambda_is_a_view(self):
        lam = torch.tensor(0.25)
        t = normal_cuda.lambda_tensor(lam, lam.device)
        assert t.shape == (1,) and t.data_ptr() == lam.data_ptr()
        with pytest.raises(ValueError, match="one element"):
            normal_cuda.lambda_tensor(torch.zeros(2), torch.device("cpu"))

    def test_number_is_cached_outside_inference_mode(self):
        with torch.inference_mode():
            a = normal_cuda.lambda_tensor(0.125, torch.device("cpu"))
        b = normal_cuda.lambda_tensor(0.125, torch.device("cpu"))
        assert a is b and not a.is_inference()
        assert a.dtype == torch.float32 and a.item() == 0.125


class TestNormalApplyBackward:
    """The port's plain backward against the JAX custom VJP of
    ``normal_apply_pallas`` (Pallas interpret mode, as tests/test_kernels.py
    runs it) and against autograd of the plain forward, at
    tests/test_kernels.py's gradient tolerance (2e-4)."""

    TOL = dict(rtol=2e-4, atol=2e-4)

    def _inputs(self, rng, b, kt, t=3, c=3, h=16, w=12):
        x, s = c64(rng, b, t, h, w), c64(rng, b, c, h, w)
        kern = TO.masked_normal_kernel(torch.from_numpy(line_mask(rng, b, kt, h)))
        g = c64(rng, b, t, h, w)
        f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
        arrays = (f32(x.real), f32(x.imag), f32(kern.re.numpy()), f32(kern.im.numpy()),
                  f32(s.real), f32(s.imag))
        return arrays, (f32(g.real), f32(g.imag))

    @pytest.mark.parametrize("b", [1, 2])
    @pytest.mark.parametrize("kt", [1, 3])
    def test_matches_jax_custom_vjp(self, rng, b, kt):
        import jax

        arrays, (gr, gi) = self._inputs(rng, b, kt)
        lam = 0.21
        old = NP._INTERPRET
        try:
            NP._INTERPRET = True
            _, vjp = jax.vjp(NP.normal_apply_pallas, *map(jnp.asarray, arrays), jnp.float32(lam))
            xbr, xbi, _, _, sbr, sbi, lbar = vjp((jnp.asarray(gr), jnp.asarray(gi)))
        finally:
            NP._INTERPRET = old
        xr, xi, kr, ki, sr, si = map(torch.from_numpy, arrays)
        before = normal_cuda.BWD_LAUNCHES
        got = normal_cuda.normal_apply_bwd(xr, xi, torch.from_numpy(gr), torch.from_numpy(gi),
                                           kr, ki, sr, si, lam)
        assert normal_cuda.BWD_LAUNCHES == before  # CPU tensors take the plain version
        assert got[2].shape == (b, 3, 16, 12) and got[4].shape == (b, 3)
        for g_, w_ in zip(got[:4], (xbr, xbi, sbr, sbi)):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **self.TOL)
        np.testing.assert_allclose(got[4].sum().item(), float(lbar), **self.TOL)

    @pytest.mark.parametrize("b", [1, 2])
    @pytest.mark.parametrize("kt", [1, 3])
    def test_kernel_passes_match_jax(self, rng, b, kt):
        """The passes that the CUDA kernels implement, composed in plain
        PyTorch (products, the coil-stacked per-frame contraction and the
        coil reduction; for the backward ȳ with Kᴴ, z, the pass per pixel
        and λ̄'s partials), against the JAX ``normal_apply_pallas`` and its
        custom VJP in interpret mode."""
        import jax

        arrays, (gr, gi) = self._inputs(rng, b, kt)
        lam = 0.21
        old = NP._INTERPRET
        try:
            NP._INTERPRET = True
            out, vjp = jax.vjp(NP.normal_apply_pallas, *map(jnp.asarray, arrays), jnp.float32(lam))
            xbr, xbi, _, _, sbr, sbi, lbar = vjp((jnp.asarray(gr), jnp.asarray(gi)))
        finally:
            NP._INTERPRET = old
        xr, xi, kr, ki, sr, si = map(torch.from_numpy, arrays)
        got = normal_cuda.normal_apply_passes(xr, xi, kr, ki, sr, si, lam)
        for g_, w_ in zip(got, out):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **self.TOL)
        got = normal_cuda.normal_apply_bwd_passes(xr, xi, torch.from_numpy(gr), torch.from_numpy(gi),
                                                  kr, ki, sr, si, lam)
        for g_, w_ in zip(got[:4], (xbr, xbi, sbr, sbi)):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **self.TOL)
        assert got[4].shape == (b, 3)
        np.testing.assert_allclose(got[4].sum().item(), float(lbar), **self.TOL)

    @pytest.mark.parametrize("b,kt", [(1, 3), (2, 1)])
    def test_matches_autograd_of_plain_forward(self, rng, b, kt):
        arrays, (gr, gi) = self._inputs(rng, b, kt)
        xr, xi, kr, ki, sr, si = (torch.from_numpy(a).requires_grad_(i not in (2, 3))
                                  for i, a in enumerate(arrays))
        lam = torch.tensor(0.21, requires_grad=True)
        outr, outi = normal_cuda.normal_apply_torch(xr, xi, kr, ki, sr, si, lam)
        want = torch.autograd.grad((outr * torch.from_numpy(gr)).sum() + (outi * torch.from_numpy(gi)).sum(),
                                   (xr, xi, sr, si, lam))
        got = normal_cuda.normal_apply_bwd_torch(xr.detach(), xi.detach(), torch.from_numpy(gr),
                                                 torch.from_numpy(gi), kr, ki, sr.detach(),
                                                 si.detach(), 0.21)
        for g_, w_ in zip(got[:4], want[:4]):
            np.testing.assert_allclose(g_.numpy(), w_.numpy(), **self.TOL)
        np.testing.assert_allclose(got[4].sum().item(), want[4].item(), **self.TOL)

    @pytest.mark.parametrize("backend", ["kernel", "torch"])
    def test_operator_grads_match_jax(self, rng, backend):
        """``normal_plus_lambda_kernel`` through the autograd Function (the K
        matrix detached, a tensor λ) against ``jax.grad`` of the JAX XLA path."""
        import jax

        x, s = c64(rng, 2, 3, 1, 16, 12), c64(rng, 2, 1, 3, 16, 12)
        m = line_mask(rng, 2, 3, 16)
        gr = rng.standard_normal(x.shape).astype(np.float32)
        gi = rng.standard_normal(x.shape).astype(np.float32)
        kern_j = JO.masked_normal_kernel(jnp.asarray(m))

        def loss_j(xre, xim, sre, sim, lam):
            out = JO.normal_plus_lambda_kernel(JComplex(xre, xim), kern_j, JComplex(sre, sim), lam)
            return jnp.sum(out.re * gr) + jnp.sum(out.im * gi)

        want = jax.grad(loss_j, argnums=(0, 1, 2, 3, 4))(
            *(jnp.asarray(a.astype(np.float32)) for a in (x.real, x.imag, s.real, s.imag)),
            jnp.float32(0.21))
        xt, st = from_complex(x), from_complex(s)
        for a in (xt.re, xt.im, st.re, st.im):
            a.requires_grad_(True)
        lam = torch.tensor(0.21, requires_grad=True)
        kern = TO.masked_normal_kernel(torch.from_numpy(m))
        kern.re.requires_grad_(True)  # detached inside: gets no gradient
        try:
            TO.set_normal_backend(backend)
            out = TO.normal_plus_lambda_kernel(xt, kern, st, lam)
        finally:
            TO.set_normal_backend("kernel")
        loss = (out.re * torch.from_numpy(gr)).sum() + (out.im * torch.from_numpy(gi)).sum()
        got = torch.autograd.grad(loss, (xt.re, xt.im, st.re, st.im, lam, kern.re), allow_unused=True)
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **self.TOL)
        assert got[5] is None


class TestSharedKernelAndMaps:
    """A K (and maps) of batch 1 shared by b volumes, which the JAX operator
    broadcasts: the operator copies them to batch b for the normal apply,
    whose kernel takes one K and one S per volume."""

    def _recording(self, monkeypatch):
        shapes = []
        real = normal_cuda.NormalApply.apply

        def record(xr, xi, kr, ki, sr, si, *rest):
            shapes.append((tuple(kr.shape), tuple(sr.shape)))
            return real(xr, xi, kr, ki, sr, si, *rest)

        monkeypatch.setattr(normal_cuda.NormalApply, "apply", record)
        return shapes

    def test_normal_apply_receives_batch_b(self, rng, monkeypatch):
        shapes = self._recording(monkeypatch)
        x, s = c64(rng, 2, 3, 1, 16, 12), c64(rng, 1, 1, 4, 16, 12)
        m = line_mask(rng, 1, 1, 16)
        want = j_to_numpy(JO.normal_plus_lambda_kernel(jc(x), JO.masked_normal_kernel(jnp.asarray(m)),
                                                        jc(s), 0.3))
        got = TO.normal_plus_lambda_kernel(from_complex(x), TO.masked_normal_kernel(torch.from_numpy(m)),
                                           from_complex(s), 0.3)
        assert shapes == [((2, 1, 16, 16), (2, 4, 16, 12))]
        np.testing.assert_allclose(to_numpy(got), want, **TOL)

    def test_shared_maps_grads_sum_over_the_batch(self, rng):
        """Gradients with respect to a batch-1 S (and x, λ) against
        ``jax.grad`` of the JAX operator, which broadcasts S."""
        import jax

        x, s = c64(rng, 2, 3, 1, 16, 12), c64(rng, 1, 1, 3, 16, 12)
        m = line_mask(rng, 1, 3, 16)
        gr = rng.standard_normal(x.shape).astype(np.float32)
        gi = rng.standard_normal(x.shape).astype(np.float32)
        kern_j = JO.masked_normal_kernel(jnp.asarray(m))

        def loss_j(xre, xim, sre, sim, lam):
            out = JO.normal_plus_lambda_kernel(JComplex(xre, xim), kern_j, JComplex(sre, sim), lam)
            return jnp.sum(out.re * gr) + jnp.sum(out.im * gi)

        arrays = [a.astype(np.float32) for a in (x.real, x.imag, s.real, s.imag)]
        want = jax.grad(loss_j, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays), jnp.float32(0.4))
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        lam = torch.tensor(0.4, requires_grad=True)
        out = TO.normal_plus_lambda_kernel(Complex(*leaves[:2]), TO.masked_normal_kernel(torch.from_numpy(m)),
                                           Complex(*leaves[2:]), lam)
        loss = (out.re * torch.from_numpy(gr)).sum() + (out.im * torch.from_numpy(gi)).sum()
        got = torch.autograd.grad(loss, (*leaves, lam))
        assert got[2].shape == (1, 1, 3, 16, 12)
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=2e-4, atol=2e-4)

    def test_cinenet_with_a_shared_mask_matches_jax(self, monkeypatch):
        """The case of ROADMAP Queue 3: CineNet-XF (2 cascades, 2 CG
        iterations, chans 4, pools 2), b = 2, t = 4, c = 3, 16x16, one mask
        (1, 1, 1, h, 1) for both volumes, data seed 1, against the JAX
        package at the model tolerance 1e-4 x max |out|; every CG apply gets
        a batch-2 K and S built once per forward."""
        import jax

        from cinemri_tpu.data.masks import RandomMask as JRandomMask
        from cinemri_tpu.models import build_model as j_build_model

        from cinemri_tpu_torch.interop.flax_params import cinenet_state_dict
        from cinemri_tpu_torch.models import build_model

        rng = np.random.default_rng(1)
        b, t, c, h, w = 2, 4, 3, 16, 16
        mask = JRandomMask([4], [2])(1, h, seed=1)[None].astype(np.float32)  # (1, 1, 1, h, 1)
        k = c64(rng, b, t, c, h, w) * mask
        s = c64(rng, b, 1, c, h, w)
        s /= np.sqrt((np.abs(s) ** 2).sum(2, keepdims=True))
        cfg = dict(num_cascades=2, cg_iters=2, chans=4, pools=2)
        jm = j_build_model("cinenet", "XF", **cfg)
        params = jm.init(jax.random.PRNGKey(1), jc(k), jnp.asarray(mask), jc(s))
        want = np.asarray(jm.apply(params, jc(k), jnp.asarray(mask), jc(s)))
        model = build_model("cinenet", "XF", device="cpu", **cfg)
        model.load_state_dict(cinenet_state_dict(jax.tree.map(np.asarray, params)))
        shapes = self._recording(monkeypatch)
        data_ptrs = set()
        real_kernel = TO.normal_plus_lambda_kernel

        def spy(x, kernel, sens_maps, lam):
            data_ptrs.add((kernel.re.data_ptr(), sens_maps.re.data_ptr()))
            return real_kernel(x, kernel, sens_maps, lam)

        monkeypatch.setattr("cinemri_tpu_torch.models.cinenet.normal_plus_lambda_kernel", spy)
        with torch.inference_mode():
            got = model(from_complex(k), torch.from_numpy(mask), from_complex(s)).numpy()
        assert got.shape == (b, t, h, w)
        assert set(shapes) == {((b, 1, h, h), (b, c, h, w))} and len(shapes) == 2 * (1 + 2)
        assert len(data_ptrs) == 1  # one K and one S for every apply of the forward
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


class TestHostAdapters:
    """``ops/complex.py``, ``ops/fft.py``'s shifts and
    ``physics/lowfreq.py::low_frequency_kspace`` against the JAX package."""

    def test_complex_layouts_match_jax(self, rng):
        from cinemri_tpu.ops import complex as JCX

        from cinemri_tpu_torch.ops import complex as CX

        x = c64(rng, 2, 3, 4)
        xt = torch.from_numpy(x)
        np.testing.assert_array_equal(CX.to_real2(xt).numpy(), np.asarray(JCX.to_real2(jnp.asarray(x))))
        r2 = rng.standard_normal((3, 5, 2))
        got = CX.from_real2(torch.from_numpy(r2))
        assert got.dtype == torch.complex64
        np.testing.assert_array_equal(got.numpy(), np.asarray(JCX.from_real2(jnp.asarray(r2.astype(np.float32)))))
        np.testing.assert_allclose(CX.complex_abs(xt).numpy(), np.asarray(JCX.complex_abs(jnp.asarray(x))),
                                   rtol=1e-6)
        np.testing.assert_array_equal(CX.complex_abs_sq(xt).numpy(),
                                      np.asarray(JCX.complex_abs_sq(jnp.asarray(x))))
        for axis in (-1, 1):
            packed = CX.split_to_real_channels(xt, axis=axis)
            np.testing.assert_array_equal(
                packed.numpy(), np.asarray(JCX.split_to_real_channels(jnp.asarray(x), axis=axis)))
            n = x.shape[axis]
            np.testing.assert_array_equal(
                CX.merge_real_channels(packed, n, axis=axis).numpy(),
                np.asarray(JCX.merge_real_channels(jnp.asarray(packed.numpy()), n, axis=axis)))
        with pytest.raises(ValueError):
            CX.from_real2(torch.zeros(3, 3))
        with pytest.raises(ValueError):
            CX.merge_real_channels(torch.zeros(2, 5), 2)

    @pytest.mark.parametrize("axes", [None, (-2, -1), 1, (0, 2)])
    def test_shifts_match_jax(self, rng, axes):
        from cinemri_tpu.ops import fft as JF

        from cinemri_tpu_torch.ops import fft as F

        x = c64(rng, 5, 4, 7)
        for ours, theirs in ((F.fftshift, JF.fftshift), (F.ifftshift, JF.ifftshift)):
            np.testing.assert_array_equal(ours(torch.from_numpy(x), axes=axes).numpy(),
                                          np.asarray(theirs(jnp.asarray(x), axes=axes)))

    def test_low_frequency_kspace_matches_jax(self, rng):
        from cinemri_tpu.data.masks import RandomMask as JRandomMask
        from cinemri_tpu.physics.lowfreq import low_frequency_kspace as j_lowfreq

        from cinemri_tpu_torch.physics import low_frequency_kspace

        """A shared mask (JAX reads sample 0's band), and one mask per sample
        against JAX's function on each sample (as JAX's VarNet vmaps it)."""
        k = c64(rng, 2, 4, 3, 24, 20)
        masks = np.stack([JRandomMask([6], [2])(4, 24, seed=i) for i in (0, 5)]).astype(np.float32)
        assert not np.array_equal(masks[0, 0], masks[1, 0])
        for mask, want in (
                (masks[:1], np.asarray(j_lowfreq(jnp.asarray(k), jnp.asarray(masks[:1])))),
                (masks, np.concatenate([np.asarray(j_lowfreq(jnp.asarray(k[i:i + 1]),
                                                             jnp.asarray(masks[i:i + 1])))
                                        for i in range(2)]))):
            got = low_frequency_kspace(torch.from_numpy(k), torch.from_numpy(mask))
            np.testing.assert_allclose(got.numpy(), want, **TOL)
            got_pair = low_frequency_kspace(from_complex(k), torch.from_numpy(mask))
            np.testing.assert_allclose(to_numpy(got_pair), want, **TOL)
        np.testing.assert_allclose(to_numpy(low_frequency_kspace(from_complex(k), torch.from_numpy(masks[:1]))),
                                   j_to_numpy(j_lowfreq(jc(k), jnp.asarray(masks[:1]))), **TOL)


class TestSoftSense:
    """Soft-SENSE operators and the CG reconstruction against the JAX
    package, to 1e-5 x max |value| (b = 1, t = 3, m = 2, c = 4, 16x16)."""

    def _inputs(self, rng):
        b, t, m, c, h, w = 1, 3, 2, 4, 16, 16
        mask = line_mask(rng, b, t, h)
        return c64(rng, b, t, m, h, w), c64(rng, b, t, c, h, w) * mask, c64(rng, b, m, c, h, w), mask

    @staticmethod
    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    def test_operators_match_jax(self, rng):
        x, y, s, _ = self._inputs(rng)
        self.close(to_numpy(TO.soft_sense_expand(from_complex(x), from_complex(s))),
                   j_to_numpy(JO.soft_sense_expand(jc(x), jc(s))))
        self.close(to_numpy(TO.soft_sense_reduce(from_complex(y), from_complex(s))),
                   j_to_numpy(JO.soft_sense_reduce(jc(y), jc(s))))
        self.close(TO.soft_sense_rss(from_complex(x)).numpy(), np.asarray(JO.soft_sense_rss(jc(x))))

    def test_recon_matches_jax(self, rng):
        _, y, s, mask = self._inputs(rng)
        for components in (False, True):
            want = JO.soft_sense_recon(jc(y), jnp.asarray(mask), jc(s), lam=1e-2, iters=5,
                                       return_components=components)
            got = TO.soft_sense_recon(from_complex(y), torch.from_numpy(mask), from_complex(s),
                                      lam=1e-2, iters=5, return_components=components)
            if components:
                self.close(to_numpy(got), j_to_numpy(want))
            else:
                assert got.shape == (1, 3, 16, 16)
                self.close(got.numpy(), np.asarray(want))

    def test_adjoint_identity(self):
        """⟨A x, y⟩ = ⟨x, Aᴴ y⟩ (tests/test_espirit.py's case)."""
        rng = np.random.default_rng(7)
        x, y, s = c64(rng, 1, 3, 2, 16, 16), c64(rng, 1, 3, 4, 16, 16), c64(rng, 1, 2, 4, 16, 16)
        ax = to_numpy(TO.soft_sense_expand(from_complex(x), from_complex(s)))
        aty = to_numpy(TO.soft_sense_reduce(from_complex(y), from_complex(s)))
        np.testing.assert_allclose(np.vdot(ax, y), np.vdot(x, aty), rtol=1e-4)

    def test_one_set_is_hard_sense(self):
        rng = np.random.default_rng(8)
        x, s, k = c64(rng, 1, 2, 1, 16, 16), c64(rng, 1, 1, 3, 16, 16), c64(rng, 1, 2, 3, 16, 16)
        xt, st, kt = from_complex(x), from_complex(s), from_complex(k)
        np.testing.assert_allclose(to_numpy(TO.soft_sense_expand(xt, st)),
                                   to_numpy(TO.sens_expand(xt, st)), atol=1e-5)
        np.testing.assert_allclose(to_numpy(TO.soft_sense_reduce(kt, st)),
                                   to_numpy(TO.sens_reduce(kt, st)), atol=1e-5)

    def test_recon_dft_launch_count(self, rng, monkeypatch):
        """2 DFT products for the right-hand side and 4 per operator apply,
        ``iters + 1`` applies: 46 at 10 iterations."""
        from cinemri_tpu_torch.ops.kernels import dft_cuda

        calls = []
        real = dft_cuda.ComplexDFTMatmul.apply
        monkeypatch.setattr(dft_cuda.ComplexDFTMatmul, "apply",
                            lambda *a: (calls.append(tuple(a[0].shape)), real(*a))[1])
        _, y, s, mask = self._inputs(rng)
        TO.soft_sense_recon(from_complex(y), torch.from_numpy(mask), from_complex(s), iters=10)
        assert len(calls) == 46
        assert set(calls) == {(3 * 4, 16, 16), (3 * 4 * 16, 16, 1)}
