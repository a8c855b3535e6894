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
from cinemri_tpu_torch.ops.cplx import from_complex, to_numpy
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
