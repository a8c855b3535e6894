"""The port's CineNet slice (CG, the direct normal operator, the model, its
train step and its serving) against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both sides; model
weights are carried from flax by ``interop.flax_params.cinenet_state_dict``.
Tolerances: 1e-5 for the solver and the operators (f32 on both sides in
another summation order), 1e-4 x max |out| for whole models (as
tests/test_torch_models.py), the train step's as tests/test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cinemri_tpu.data.masks import RandomMask as JRandomMask
from cinemri_tpu.models import build_model as j_build_model
from cinemri_tpu.ops.cplx import Complex as JComplex
from cinemri_tpu.ops.cplx import real_dot as j_real_dot
from cinemri_tpu.ops.cplx import to_numpy as j_to_numpy
from cinemri_tpu.physics import operators as JOPS
from cinemri_tpu.physics.cg import conj_grad as j_conj_grad
from cinemri_tpu.train import create_train_state as j_create_train_state
from cinemri_tpu.train import make_optimizer as j_make_optimizer
from cinemri_tpu.train import make_train_step as j_make_train_step

from cinemri_tpu_torch.interop.flax_params import cinenet_state_dict
from cinemri_tpu_torch.models import build_model
from cinemri_tpu_torch.models.cinenet import CineNet
from cinemri_tpu_torch.ops.cplx import Complex, from_complex, real_dot, to_numpy
from cinemri_tpu_torch.physics import conj_grad
from cinemri_tpu_torch.physics import operators as OPS
from cinemri_tpu_torch.serve import bind_model
from cinemri_tpu_torch.train import create_train_state, make_train_step

torch.set_num_threads(2)

SMALL = dict(num_cascades=2, cg_iters=3, chans=4, pools=2)


def c64(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def jc(x):
    return JComplex(jnp.asarray(x.real), jnp.asarray(x.imag))


def f32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def inputs(seed, b=1, t=4, c=3, h=32, w=32):
    """Masked k-space, line mask and RSS-normalized maps, as the JAX
    package's bench/train_step.py makes its CineNet batch; target |k|
    averaged over coils."""
    rng = np.random.default_rng(seed)
    k = c64(rng, b, t, c, h, w)
    mask = np.stack([JRandomMask([4], [2])(t, h, seed=seed + i) for i in range(b)]).astype(np.float32)
    s = c64(rng, b, 1, c, h, w)
    s /= np.sqrt((np.abs(s) ** 2).sum(2, keepdims=True))
    return k * mask, mask, s, np.abs(k).mean(axis=2).astype(np.float32)


class TestConjGrad:
    N = 12

    def _system(self, rng):
        """An SPD complex operator ``H z = Aᴴ A z + 0.5 z`` on the last axis
        of (2, 3, n), as JAX and port callables, and rhs / x0."""
        a = c64(rng, self.N, self.N) / np.sqrt(self.N)
        h = a.conj().T @ a + 0.5 * np.eye(self.N)
        hr, hi = h.real.astype(np.float32), h.imag.astype(np.float32)

        def j_op(z):
            return JComplex(z.re @ hr.T - z.im @ hi.T, z.re @ hi.T + z.im @ hr.T)

        tr, ti = f32(hr), f32(hi)

        def t_op(z):
            return Complex(z.re @ tr.T - z.im @ ti.T, z.re @ ti.T + z.im @ tr.T)

        return j_op, t_op, h, c64(rng, 2, 3, self.N), c64(rng, 2, 3, self.N)

    def test_real_dot_sums_every_axis(self, rng):
        u, v = c64(rng, 2, 3, 5), c64(rng, 2, 3, 5)
        got = real_dot(from_complex(u), from_complex(v))
        assert got.ndim == 0
        np.testing.assert_allclose(got.item(), float(j_real_dot(jc(u), jc(v))), rtol=1e-5)
        np.testing.assert_allclose(got.item(), np.real(np.vdot(u, v)), rtol=1e-5)

    @pytest.mark.parametrize("iters", [1, 4])
    def test_matches_jax_value_and_grad(self, rng, iters):
        j_op, t_op, _, rhs, x0 = self._system(rng)
        wgt = rng.standard_normal((2, 3, self.N)).astype(np.float32)

        def loss_j(rre, rim):
            x = j_conj_grad(j_op, JComplex(rre, rim), jc(x0), iters)
            return jnp.sum(wgt * x.re) + jnp.sum(x.im * x.im)

        want = j_to_numpy(j_conj_grad(j_op, jc(rhs), jc(x0), iters))
        jg = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(rhs.real), jnp.asarray(rhs.imag))
        rr, ri = f32(rhs.real).requires_grad_(True), f32(rhs.imag).requires_grad_(True)
        x = conj_grad(t_op, Complex(rr, ri), from_complex(x0), iters)
        np.testing.assert_allclose(to_numpy(x), want, rtol=1e-5, atol=1e-5)
        ((f32(wgt) * x.re).sum() + (x.im * x.im).sum()).backward()
        for got, w in zip((rr.grad, ri.grad), jg):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)

    def test_converges_to_the_solution(self, rng):
        _, t_op, h, rhs, x0 = self._system(rng)
        x = conj_grad(t_op, from_complex(rhs), from_complex(x0), 3 * self.N)
        want = np.linalg.solve(h, rhs.reshape(-1, self.N).T).T.reshape(rhs.shape)
        np.testing.assert_allclose(to_numpy(x), want, rtol=1e-4, atol=1e-4)

    def test_start_at_the_solution_gives_no_nan(self, rng):
        """A zero residual makes every step 0/0: the guarded division gives a
        zero step, and its gradient stays finite."""
        j_op, t_op, _, _, x0 = self._system(rng)
        xr, xi = f32(x0.real).requires_grad_(True), f32(x0.imag).requires_grad_(True)
        with torch.no_grad():
            rhs = t_op(Complex(xr, xi))  # operator(x0) == rhs exactly
        x = conj_grad(t_op, rhs, Complex(xr, xi), 3)
        assert torch.equal(x.re, xr) and torch.equal(x.im, xi)
        (x.re.sum() + x.im.sum()).backward()
        assert torch.isfinite(xr.grad).all() and torch.isfinite(xi.grad).all()

        def loss_j(a, b):
            x = j_conj_grad(j_op, j_op(JComplex(a, b)), JComplex(a, b), 3)
            return jnp.sum(x.re) + jnp.sum(x.im)

        jg = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x0.real), jnp.asarray(x0.imag))
        assert all(np.isfinite(np.asarray(g)).all() for g in jg)


class TestNormalPlusLambda:
    def _inputs(self, rng, b=2, t=3, c=3, h=16, w=12):
        x, s = c64(rng, b, t, 1, h, w), c64(rng, b, 1, c, h, w)
        mask = np.stack([JRandomMask([4], [2])(t, h, seed=i) for i in range(b)]).astype(np.float32)
        return x, s, mask

    def test_direct_form_matches_jax(self, rng):
        x, s, mask = self._inputs(rng)
        lam = np.float32(0.7)
        want = j_to_numpy(JOPS.normal_plus_lambda(jc(x), jnp.asarray(mask), jc(s), lam))
        got = OPS.normal_plus_lambda(from_complex(x), f32(mask), from_complex(s), torch.tensor(lam))
        np.testing.assert_allclose(to_numpy(got), want, rtol=1e-5, atol=1e-5)

    def test_kernel_form_with_a_tensor_lambda_matches_jax_with_grads(self, rng):
        """Value and gradients (x, maps, λ) of the kernel form with a 0-d
        tensor λ against JAX's direct operator and its gradients; the value
        also against JAX's kernel form."""
        x, s, mask = self._inputs(rng)
        g = c64(rng, *x.shape)
        lam = np.float32(0.3)

        def loss_j(xre, xim, sre, sim, l):
            out = JOPS.normal_plus_lambda(JComplex(xre, xim), jnp.asarray(mask),
                                          JComplex(sre, sim), l)
            return jnp.sum(out.re * g.real + out.im * g.imag)

        args = (x.real, x.imag, s.real, s.imag)
        want_out = j_to_numpy(JOPS.normal_plus_lambda(jc(x), jnp.asarray(mask), jc(s), lam))
        want_g = jax.grad(loss_j, argnums=tuple(range(5)))(*map(jnp.asarray, args), jnp.asarray(lam))
        leaves = [f32(a).requires_grad_(True) for a in args] + [torch.tensor(lam, requires_grad=True)]
        kern = OPS.masked_normal_kernel(f32(mask))
        out = OPS.normal_plus_lambda_kernel(Complex(*leaves[:2]), kern, Complex(*leaves[2:4]), leaves[4])
        np.testing.assert_allclose(to_numpy(out), want_out, rtol=1e-5, atol=1e-5)
        want_k = JOPS.normal_plus_lambda_kernel(jc(x), JOPS.masked_normal_kernel(jnp.asarray(mask)),
                                                jc(s), jnp.asarray(lam))
        np.testing.assert_allclose(to_numpy(out), j_to_numpy(want_k), rtol=1e-5, atol=1e-5)
        ((out.re * f32(g.real)).sum() + (out.im * f32(g.imag)).sum()).backward()
        assert leaves[4].grad.shape == ()
        for got, w in zip(leaves, want_g):
            w = np.asarray(w)
            np.testing.assert_allclose(got.grad.numpy(), w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()))


def _pair(seed, dynamic_type, b=1, h=32, w=32, **kw):
    """A JAX CineNet with random λ, the port's with carried-over weights, and
    both outputs on the same inputs."""
    km, mask, s, _ = inputs(seed, b=b, h=h, w=w)
    kw = dict(SMALL, **kw)
    jm = j_build_model("cinenet", dynamic_type, **kw)
    params = jm.init(jax.random.PRNGKey(seed), jc(km), jnp.asarray(mask), jc(s))
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(rng.standard_normal(a.shape), a.dtype)
        if getattr(p[-1], "key", None) == "lambda_reg" else a, params)
    want = np.asarray(jm.apply(params, jc(km), jnp.asarray(mask), jc(s)))
    tm = build_model("cinenet", dynamic_type, device="cpu", **kw)
    tm.load_state_dict(cinenet_state_dict(jax.tree.map(np.asarray, params)))
    with torch.inference_mode():
        got = tm(from_complex(km), f32(mask), from_complex(s)).numpy()
    return got, want


def assert_model_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


class TestCineNet:
    @pytest.mark.parametrize("dynamic_type,kw", [
        ("XF", dict(kernel_dc=True)),
        ("XF", dict(kernel_dc=False)),
        ("XF", dict(weight_sharing=True)),
        ("XT", dict()),
    ])
    def test_matches_jax(self, dynamic_type, kw):
        got, want = _pair(1, dynamic_type, **kw)
        assert got.shape == (1, 4, 32, 32)
        assert_model_close(got, want)

    def test_batch_two_non_square_shares_the_cg_steps(self):
        """b = 2: the CG inner products sum over the batch, as JAX's (and the
        reference's flattened dot) do; per-sample steps would differ."""
        got, want = _pair(2, "XF", b=2, h=24, w=20)
        assert got.shape == (2, 4, 24, 20)
        assert_model_close(got, want)

    def test_kernel_dc_equals_direct_form(self):
        km, mask, s, _ = inputs(3, h=24, w=20)
        outs = []
        for kdc in (True, False):
            m = build_model("cinenet", "XF", device="cpu", kernel_dc=kdc, **SMALL)
            with torch.inference_mode():
                outs.append(m(from_complex(km), f32(mask), from_complex(s)).numpy())
        assert_model_close(outs[0], outs[1])

    def test_build_options(self):
        with pytest.raises(NotImplementedError, match="item 14"):
            CineNet(dynamic_type="3D", remat_policy="dots")
        crnn = build_model("cinenet", "CRNN", device="cpu", num_cascades=2, chans=4)
        assert crnn.lambda_reg.shape == () and crnn.cg_iters == 4  # one shared λ; JAX's default
        with pytest.raises(TypeError):
            build_model("cinenet", "XF", device="cpu", sens_chans=4)
        m = build_model("cinenet", "XF", device="cpu", **SMALL)
        assert m.lambda_reg.shape == (2,)
        assert {n.split(".")[1] for n in m.state_dict() if n.startswith("cascades.")} == {"net_xf", "net_yf"}


def _as_port(tree):
    """A JAX CineNet param-shaped tree as the port's state_dict (linear in
    the leaves, so it maps grads and Adam moments too)."""
    return cinenet_state_dict(jax.tree.map(np.asarray, tree))


def _adam_state(opt_state):
    import optax

    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    return next(s for s in leaves if isinstance(s, optax.ScaleByAdamState))


def test_two_train_steps_match_jax():
    """Two steps of CineNet-XF (2 cascades, cg_iters 3, chans 4, pools 2,
    t=4, c=3, 32x32, remat on) with ``sens_maps`` in the batch, from
    carried-over params: the port's train step against the JAX package's
    jitted ``make_train_step``. Compared each step as in
    tests/test_torch_train.py: loss and grad norm (1e-5 relative), output,
    each grad leaf (JAX's from its Adam first moment) and both Adam moments
    (1e-4 x max per leaf), params (atol 2·lr).

    Data seed 2: a LeakyReLU input that is 0 up to f32 rounding makes the
    gradient below it differ by percents between any two f32 evaluations
    (ROADMAP Queue 3). Seeds 0 and 3 of this setup have one (grad leaves
    off by 2-5%); seeds 1 and 2 have none within rounding in either step
    and match to 5e-6."""
    lr = 1e-4
    km, mask, s, target = inputs(2)
    jb = {"masked_kspace": jc(km), "mask": jnp.asarray(mask), "sens_maps": jc(s),
          "target": jnp.asarray(target)}
    tb = {"masked_kspace": from_complex(km), "mask": f32(mask), "sens_maps": from_complex(s),
          "target": f32(target)}
    jmodel = j_build_model("cinenet", "XF", remat=True, **SMALL)
    jstate = j_create_train_state(jmodel, jb, j_make_optimizer(lr=lr), rng=jax.random.PRNGKey(0))
    model = CineNet(dynamic_type="XF", remat=True, **SMALL)
    model.load_state_dict(_as_port(jstate.params))
    state = create_train_state(model, device="cpu", lr=lr)
    jstep, step = j_make_train_step(donate=False), make_train_step()
    params = dict(model.named_parameters())

    def close(got, want, rel):
        for name, w in want.items():
            g = got[name].detach()
            assert (g - w).abs().max().item() <= rel * w.abs().max().item(), name

    mu_prev = None
    for _ in range(2):
        jstate, jaux = jstep(jstate, jb)
        state, aux = step(state, tb)
        np.testing.assert_allclose(aux["loss"].item(), float(jaux["loss"]), rtol=1e-5)
        np.testing.assert_allclose(aux["grad_norm"].item(), float(jaux["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(aux["output"].numpy(), np.asarray(jaux["output"]),
                                   rtol=0, atol=1e-4 * np.abs(np.asarray(jaux["output"])).max())
        adam = _adam_state(jstate.opt_state)
        mu, nu = _as_port(adam.mu), _as_port(adam.nu)
        jgrads = {n: (mu[n] - (0 if mu_prev is None else 0.9 * mu_prev[n])) / 0.1 for n in mu}
        mu_prev = mu
        moments = {n: state.optimizer.adam.state[p] for n, p in params.items()}
        close({n: p.grad for n, p in params.items()}, jgrads, 1e-4)
        close({n: m["exp_avg"] for n, m in moments.items()}, mu, 1e-4)
        close({n: m["exp_avg_sq"] for n, m in moments.items()}, nu, 1e-4)
        for name, w in _as_port(jstate.params).items():
            assert (params[name].detach() - w).abs().max().item() <= 2 * lr, name
    assert state.step == 2


class TestServe:
    def test_request_with_maps_equals_direct_forward(self):
        """A batch of two volumes with their maps, served one at a time,
        equals the direct forward of each volume."""
        km, mask, s, _ = inputs(4, b=2)
        model = build_model("cinenet", "XF", device="cpu", **SMALL)
        serve = bind_model(model, device="cpu")
        got = serve(km.real, km.imag, mask, s.real, s.imag)
        assert got.shape == (2, 4, 32, 32)
        with torch.inference_mode():
            for i in range(2):
                want = model(from_complex(km[i:i + 1]), f32(mask[i:i + 1]), from_complex(s[i:i + 1]))
                torch.testing.assert_close(got[i:i + 1], want, rtol=0, atol=0)
        with pytest.raises(ValueError, match="sens_re"):
            serve(km.real, km.imag, mask, s.real)
