"""The port's XPDNet slice (wavelets, MWCNN padding, the alt temporal DFT,
the multi-channel buffer packing, MWCNN, the k-space CNN, XPDNet 2D / XT /
XF, its train step and its serving) against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both sides; model
weights are carried from flax by ``interop.flax_params``. Tolerances:
exact or 1e-6 for the reshape arithmetic, 1e-5 for the DFTs and their
gradients, 1e-4 x max |out| for networks and whole models (as
tests/test_torch_models.py), the train step's as tests/test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cinemri_tpu.data.masks import RandomMask as JRandomMask
from cinemri_tpu.models import build_model as j_build_model
from cinemri_tpu.models.denoisers.kspace_cnn import KSpaceCNN as JKSpaceCNN
from cinemri_tpu.models.denoisers.mwcnn import MWCNN as JMWCNN
from cinemri_tpu.ops import cplx as JCX
from cinemri_tpu.ops import fft as JF
from cinemri_tpu.ops import pad as JP
from cinemri_tpu.ops import wavelet as JW
from cinemri_tpu.ops.cplx import Complex as JComplex
from cinemri_tpu.train import create_train_state as j_create_train_state
from cinemri_tpu.train import make_optimizer as j_make_optimizer
from cinemri_tpu.train import make_train_step as j_make_train_step

from cinemri_tpu_torch.interop.flax_params import (
    kspace_cnn_state_dict,
    mwcnn_state_dict,
    xpdnet_state_dict,
)
from cinemri_tpu_torch.models import build_model
from cinemri_tpu_torch.models.denoisers import MWCNN, KSpaceCNN
from cinemri_tpu_torch.models.xpdnet import XPDNet
from cinemri_tpu_torch.ops import cplx as TCX
from cinemri_tpu_torch.ops import fft as TF
from cinemri_tpu_torch.ops import pad as TP
from cinemri_tpu_torch.ops import wavelet as TW
from cinemri_tpu_torch.ops.cplx import Complex, from_complex, to_numpy
from cinemri_tpu_torch.serve import bind_model
from cinemri_tpu_torch.train import create_train_state, make_train_step

torch.set_num_threads(2)

# tests/test_models.py's XPDNet size
SMALL = dict(num_cascades=2, sens_chans=4, sens_pools=2, n_scales=2,
             n_filters_per_scale=(4, 8), n_convs_per_scale=(2, 2), n_primal=3)


def c64(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def jc(x):
    return JComplex(jnp.asarray(x.real), jnp.asarray(x.imag))


def f32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def assert_model_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def inputs(seed, b=1, t=4, c=3, h=24, w=16):
    """Masked k-space and a line mask from ``default_rng(seed)``; target =
    |k| averaged over coils."""
    rng = np.random.default_rng(seed)
    k = c64(rng, b, t, c, h, w)
    mask = np.stack([JRandomMask([4], [2])(t, h, seed=seed + i) for i in range(b)]).astype(np.float32)
    return k * mask, mask, np.abs(k).mean(axis=2).astype(np.float32)


class TestWavelet:
    @pytest.mark.parametrize("shape", [(2, 8, 12, 3), (1, 16, 4, 5)])
    def test_channels_last_matches_jax(self, rng, shape):
        x = rng.standard_normal(shape).astype(np.float32)
        d = TW.dwt2(f32(x))
        np.testing.assert_allclose(d.numpy(), np.asarray(JW.dwt2(jnp.asarray(x))), rtol=0, atol=1e-6)
        y = rng.standard_normal(d.shape).astype(np.float32)
        np.testing.assert_allclose(TW.iwt2(f32(y)).numpy(), np.asarray(JW.iwt2(jnp.asarray(y))),
                                   rtol=0, atol=1e-6)

    def test_channels_first_is_the_permuted_channels_last(self, rng):
        x = rng.standard_normal((2, 3, 8, 12)).astype(np.float32)
        want = np.asarray(JW.dwt2(jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
        d = TW.dwt2(f32(x), channel_axis=1)
        np.testing.assert_allclose(d.numpy(), want, rtol=0, atol=1e-6)
        want = np.asarray(JW.iwt2(jnp.asarray(want.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(TW.iwt2(d, channel_axis=1).numpy(), want, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("channel_axis", [-1, 1])
    def test_round_trip(self, rng, channel_axis):
        x = f32(rng.standard_normal((2, 8, 8, 4)))
        torch.testing.assert_close(TW.iwt2(TW.dwt2(x, channel_axis), channel_axis), x,
                                   rtol=0, atol=1e-6)

    def test_rejects_other_layouts(self):
        with pytest.raises(ValueError):
            TW.dwt2(torch.zeros(2, 3, 4, 4), channel_axis=2)


class TestPadForMWCNN:
    @pytest.mark.parametrize("shape", [(2, 15, 24, 3), (1, 17, 20, 2), (1, 16, 8, 1)])
    def test_matches_jax(self, rng, shape):
        """Odd sizes take the extra sample on the left: t = 15 at 3 scales
        pads (1, 0)."""
        x = rng.standard_normal(shape).astype(np.float32)
        want, wpad = JP.pad_for_mwcnn(jnp.asarray(x), 3, axes=(1, 2))
        got, pad = TP.pad_for_mwcnn(f32(x), 3, axes=(1, 2))
        assert pad == wpad
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(TP.unpad_from_mwcnn(got, pad, axes=(1, 2)).numpy(), x)
        if shape[1] == 15:
            assert pad[2:] == [1, 0]


class TestBufferPacking:
    def test_multi_channels_concat_and_repeat_match_jax(self, rng):
        x, y = c64(rng, 2, 3, 4, 2), c64(rng, 2, 3, 4, 1)
        for axis in (-1, 1):
            want = np.asarray(JCX.to_multi_channels(jc(x), axis=axis))
            got = TCX.to_multi_channels(from_complex(x), axis=axis)
            np.testing.assert_array_equal(got.numpy(), want)
            back = TCX.from_multi_channels(got, axis=axis)
            np.testing.assert_array_equal(to_numpy(back), x)
        np.testing.assert_array_equal(
            to_numpy(TCX.concat([from_complex(x), from_complex(y)], axis=-1)),
            JCX.to_numpy(JCX.concat([jc(x), jc(y)], axis=-1)))
        np.testing.assert_array_equal(to_numpy(TCX.crepeat(from_complex(y), 3, axis=-1)),
                                      JCX.to_numpy(JCX.crepeat(jc(y), 3, axis=-1)))


class TestAltFFT:
    @pytest.mark.parametrize("t", [4, 5])
    @pytest.mark.parametrize("fn", ["fft1c_alt", "ifft1c_alt"])
    def test_values_and_grads_match_jax(self, rng, t, fn):
        """On the channel-last buffer (1, t, 6, 4, 3), along t: the slab
        layout (O, N, I) = (1, t, 72) XPDNet's cascades take."""
        x = c64(rng, 1, t, 6, 4, 3)
        cr, ci = (rng.standard_normal(x.shape).astype(np.float32) for _ in range(2))

        def loss_j(xre, xim):
            y = getattr(JF, fn)(JComplex(xre, xim), axis=1)
            return jnp.sum(y.re * cr) + jnp.sum(y.im * ci)

        want = JCX.to_numpy(getattr(JF, fn)(jc(x), axis=1))
        want_g = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x.real), jnp.asarray(x.imag))
        xt = from_complex(x)
        xt.re.requires_grad_(True)
        xt.im.requires_grad_(True)
        TF.COPIES = 0
        y = getattr(TF, fn)(xt, axis=1)
        assert TF.COPIES == 0
        np.testing.assert_allclose(to_numpy(y), want, rtol=0, atol=1e-5)
        loss = (y.re * f32(cr)).sum() + (y.im * f32(ci)).sum()
        for g, w in zip(torch.autograd.grad(loss, (xt.re, xt.im)), want_g):
            assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-5
        # the native (complex64) route agrees with the pair route
        np.testing.assert_allclose(getattr(TF, fn)(x, axis=1), want, rtol=0, atol=1e-5)

    @pytest.mark.parametrize("t", [4, 5])
    def test_inverse_and_the_reference_quirk(self, rng, t):
        """ifft1c_alt inverts fft1c_alt; the standard ifft1c, which XPDNet's
        reference applies, does only for even t."""
        x = from_complex(c64(rng, 2, t, 3))
        y = TF.fft1c_alt(x, axis=1)
        np.testing.assert_allclose(to_numpy(TF.ifft1c_alt(y, axis=1)), to_numpy(x), atol=1e-5)
        err = np.abs(to_numpy(TF.ifft1c(y, axis=1)) - to_numpy(x)).max()
        assert (err < 1e-5) == (t % 2 == 0)


class TestDenoisers:
    @pytest.mark.parametrize("n_first_convs,res", [(1, False), (0, False), (2, True)])
    def test_mwcnn_matches_jax(self, rng, n_first_convs, res):
        chans = 6 if res else 8  # the residual needs out = in
        x = rng.standard_normal((2, 8, 12, chans)).astype(np.float32)
        kw = dict(n_scales=2, n_filters_per_scale=(4, 8), n_convs_per_scale=(2, 1),
                  n_first_convs=n_first_convs, first_conv_n_filters=8, res=res)
        jm = JMWCNN(in_chans=chans, out_chans=6, **kw)
        params = jm.init(jax.random.PRNGKey(n_first_convs), jnp.asarray(x))
        want = np.asarray(jm.apply(params, jnp.asarray(x)))
        tm = MWCNN(chans, 6, **kw)
        tm.load_state_dict(mwcnn_state_dict(jax.tree.map(np.asarray, params)["params"], ""))
        with torch.no_grad():
            got = tm(f32(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        assert_model_close(got, want)

    def test_mwcnn_options(self):
        with pytest.raises(NotImplementedError, match="item 14"):
            MWCNN(4, 4, packed=True)
        with pytest.raises(ValueError, match="divisible"):
            MWCNN(4, 4, n_scales=2)(torch.zeros(1, 4, 6, 8))

    def test_kspace_cnn_matches_jax(self, rng):
        x = rng.standard_normal((1, 4, 3, 8, 6, 6)).astype(np.float32)
        jm = JKSpaceCNN(out_chans=2)
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
        want = np.asarray(jm.apply(params, jnp.asarray(x)))
        tm = KSpaceCNN(6, 2)
        tm.load_state_dict(kspace_cnn_state_dict(jax.tree.map(np.asarray, params)["params"], ""))
        with torch.no_grad():
            got = tm(f32(x)).numpy()
        assert got.shape == (1, 4, 3, 8, 6, 2)
        assert_model_close(got, want)


def _pair(seed, dynamic_type, b=1, t=4, **kw):
    """The JAX XPDNet and the port's with carried-over weights; both outputs
    on the same inputs, and the port's model."""
    km, mask, _ = inputs(seed, b=b, t=t)
    kw = dict(SMALL, **kw)
    jm = j_build_model("xpdnet", dynamic_type, **kw)
    params = jm.init(jax.random.PRNGKey(seed), jc(km), jnp.asarray(mask))
    want = np.asarray(jm.apply(params, jc(km), jnp.asarray(mask)))
    tm = build_model("xpdnet", dynamic_type, device="cpu", **kw)
    tm.load_state_dict(xpdnet_state_dict(jax.tree.map(np.asarray, params)))
    with torch.inference_mode():
        got = tm(from_complex(km), f32(mask)).numpy()
    return got, want, tm


class TestXPDNet:
    @pytest.mark.parametrize("dynamic_type,b,t,kw", [
        ("XF", 1, 5, dict()),  # odd t: the alt-forward / standard-inverse quirk
        ("XF", 2, 4, dict(kernel_dc=False)),  # the direct form, a mask per volume
        ("XF", 1, 4, dict(primal_only=False, n_dual=2)),  # KSpaceCNN
        ("XF", 1, 4, dict(norm_buffers=True)),
        ("XT", 1, 5, dict()),
        ("2D", 1, 4, dict()),
        ("2D", 1, 4, dict(weight_sharing=True)),
    ])
    def test_matches_jax(self, dynamic_type, b, t, kw):
        got, want, _ = _pair(1, dynamic_type, b=b, t=t, **kw)
        assert got.shape == (b, t, 24, 16)
        assert_model_close(got, want)

    def test_kernel_dc_equals_direct_form(self):
        km, mask, _ = inputs(3, t=5)
        outs = []
        for kdc in (True, False):
            m = build_model("xpdnet", "XF", device="cpu", kernel_dc=kdc, **SMALL)
            with torch.inference_mode():
                outs.append(m(from_complex(km), f32(mask)).numpy())
        assert_model_close(outs[0], outs[1])

    def test_weight_sharing_xf_is_one_net_on_both_planes(self):
        """XF with ``weight_sharing``: one MWCNN per cascade on the (w, t) and
        the (h, t) planes, i.e. the unshared model with that net in both
        slots. (The JAX package's XPDNet raises flax's NameInUseError for
        XF/XT with weight sharing, so the port is held against itself.)"""
        km, mask, _ = inputs(4)
        shared = build_model("xpdnet", "XF", device="cpu", weight_sharing=True, **SMALL)
        two = build_model("xpdnet", "XF", device="cpu", **SMALL)
        sd = {}
        for name, v in shared.state_dict().items():
            if ".image_net." in name:
                sd[name.replace(".image_net.", ".image_net_xf.")] = v
                sd[name.replace(".image_net.", ".image_net_yf.")] = v
            else:
                sd[name] = v
        two.load_state_dict(sd)
        with torch.inference_mode():
            a = shared(from_complex(km), f32(mask))
            b = two(from_complex(km), f32(mask))
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    def test_build_options_and_tree(self):
        with pytest.raises(ValueError):
            build_model("xpdnet", "3D", device="cpu")
        crnn = build_model("xpdnet", "CRNN", device="cpu", num_cascades=2, chans=4)
        assert crnn.trunk.bcrnn.cell.conv.sizes == (12, 4, 4)  # 2 x (n_primal + 1) = 12
        with pytest.raises(NotImplementedError, match="item 14"):
            build_model("xpdnet", "XF", device="cpu", packed=True, **SMALL)
        with pytest.raises(TypeError):
            build_model("xpdnet", "XF", device="cpu", bf16=True)
        m = build_model("xpdnet", "XF", device="cpu", **SMALL)
        assert len(m.cascades) == 2  # per-cascade nets
        assert {n.split(".")[2] for n in m.state_dict() if n.startswith("cascades.")} == {
            "image_net_xf", "image_net_yf"}
        m = build_model("xpdnet", "XF", device="cpu", primal_only=False, **SMALL)
        assert any(".kspace_net." in n for n in m.state_dict())


def _adam_state(opt_state):
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    return next(s for s in leaves if isinstance(s, optax.ScaleByAdamState))


def test_two_train_steps_match_jax():
    """Two steps of XPDNet-XF (SMALL, t=5, c=3, 24x16, kernel DC, remat on)
    from carried-over params: the port's train step against the JAX
    package's jitted ``make_train_step``, compared as in
    tests/test_torch_train.py: loss and grad norm (1e-5 relative), output,
    each grad leaf (JAX's from its Adam first moment) and both Adam moments
    (1e-4 x max per leaf), params (atol 2·lr). Data seed 4: seeds 1, 3 and
    6 of this setup have a LeakyReLU input at 0 up to rounding (grad norms
    4e-3 apart by step 2, ROADMAP Queue 3); seeds 2, 4 and 7 match to 2e-6."""
    lr = 1e-4
    km, mask, target = inputs(4, t=5)
    jb = {"masked_kspace": jc(km), "mask": jnp.asarray(mask), "target": jnp.asarray(target)}
    tb = {"masked_kspace": from_complex(km), "mask": f32(mask), "target": f32(target)}
    jmodel = j_build_model("xpdnet", "XF", remat=True, **SMALL)
    jstate = j_create_train_state(jmodel, jb, j_make_optimizer(lr=lr), rng=jax.random.PRNGKey(4))
    as_port = lambda tree: xpdnet_state_dict(jax.tree.map(np.asarray, tree))
    model = XPDNet(dynamic_type="XF", remat=True, **SMALL)
    model.load_state_dict(as_port(jstate.params))
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
        assert_model_close(aux["output"].numpy(), jaux["output"])
        adam = _adam_state(jstate.opt_state)
        mu, nu = as_port(adam.mu), as_port(adam.nu)
        jgrads = {n: (mu[n] - (0 if mu_prev is None else 0.9 * mu_prev[n])) / 0.1 for n in mu}
        mu_prev = mu
        moments = {n: state.optimizer.adam.state[p] for n, p in params.items()}
        close({n: p.grad for n, p in params.items()}, jgrads, 1e-4)
        close({n: m["exp_avg"] for n, m in moments.items()}, mu, 1e-4)
        close({n: m["exp_avg_sq"] for n, m in moments.items()}, nu, 1e-4)
        for name, w in as_port(jstate.params).items():
            assert (params[name].detach() - w).abs().max().item() <= 2 * lr, name
    assert state.step == 2


def test_serve_takes_no_maps():
    """A batch of two volumes served one at a time equals the direct
    forward of each (XPDNet estimates its own maps, as VarNet)."""
    km, mask, _ = inputs(6, b=2)
    model = build_model("xpdnet", "XF", device="cpu", **SMALL)
    serve = bind_model(model, device="cpu")
    got = serve(km.real, km.imag, mask)
    with torch.inference_mode():
        for i in range(2):
            want = model(from_complex(km[i:i + 1]), f32(mask[i:i + 1]))
            torch.testing.assert_close(got[i:i + 1], want, rtol=0, atol=0)
