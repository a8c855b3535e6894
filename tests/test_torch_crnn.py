"""The port's CRNN slice (the fused sum of convolutions, the CRNN cell, the
bidirectional CRNN, the trunk, VarNet-, CineNet- and XPDNet-CRNN, their
init, train steps and serving) against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both sides; model
weights are carried from flax by ``interop.flax_params``. Sizes are
``tests/test_models.py::CRNN_SMALL`` on a (b 1, t 4, c 3, 24x16) volume.
Tolerances: 1e-6 for the fused conv against separate convs, 1e-5 for the
CRNN blocks, 1e-4 x max |out| for whole models (as
tests/test_torch_models.py), the train step's as tests/test_torch_train.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from cinemri_tpu.data.masks import RandomMask as JRandomMask
from cinemri_tpu.models import build_model as j_build_model
from cinemri_tpu.models.denoisers.crnn import BCRNN as JBCRNN
from cinemri_tpu.models.denoisers.crnn import CRNNCell as JCRNNCell
from cinemri_tpu.models.init import torch_style_init as j_torch_style_init
from cinemri_tpu.models.recurrent import CineNetRNN as JCineNetRNN
from cinemri_tpu.models.recurrent import CRNNTrunk as JCRNNTrunk
from cinemri_tpu.models.recurrent import VarNetRNN as JVarNetRNN
from cinemri_tpu.models.recurrent import XPDNetRNN as JXPDNetRNN
from cinemri_tpu.ops.cplx import Complex as JComplex
from cinemri_tpu.train import create_train_state as j_create_train_state
from cinemri_tpu.train import make_optimizer as j_make_optimizer
from cinemri_tpu.train import make_train_step as j_make_train_step

from cinemri_tpu_torch.interop.flax_params import (
    cinenet_rnn_state_dict,
    conv_weight,
    crnn_trunk_state_dict,
    varnet_rnn_state_dict,
    xpdnet_rnn_state_dict,
)
from cinemri_tpu_torch.models import CineNetRNN, VarNetRNN, XPDNetRNN, build_model
from cinemri_tpu_torch.models.denoisers import BCRNN, CRNNCell, FusedSumConv2d
from cinemri_tpu_torch.models.init import lecun_normal_init
from cinemri_tpu_torch.models.recurrent import CRNNTrunk
from cinemri_tpu_torch.ops.cplx import from_complex
from cinemri_tpu_torch.serve import bind_model
from cinemri_tpu_torch.train import create_train_state, make_train_step

torch.set_num_threads(2)

# tests/test_models.py::CRNN_SMALL
CRNN_SMALL = dict(
    varnet=dict(num_cascades=2, sens_chans=4, sens_pools=2, chans=6),
    cinenet=dict(num_cascades=2, cg_iters=2, chans=6),
    xpdnet=dict(num_cascades=2, sens_chans=4, sens_pools=2, chans=6, n_primal=3),
)
STATE_DICTS = dict(varnet=varnet_rnn_state_dict, cinenet=cinenet_rnn_state_dict,
                   xpdnet=xpdnet_rnn_state_dict)


def c64(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def jc(x):
    return JComplex(jnp.asarray(x.real), jnp.asarray(x.imag))


def f32(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


def assert_model_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def inputs(seed, b=1, t=4, c=3, h=24, w=16):
    """Masked k-space, a line mask, RSS-normalized maps and a target (|k|
    averaged over coils), from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    k = c64(rng, b, t, c, h, w)
    mask = np.stack([JRandomMask([4], [2])(t, h, seed=seed + i) for i in range(b)]).astype(np.float32)
    s = c64(rng, b, 1, c, h, w)
    s /= np.sqrt((np.abs(s) ** 2).sum(2, keepdims=True))
    return k * mask, mask, s, np.abs(k).mean(axis=2).astype(np.float32)


class TestBlocks:
    def test_fused_sum_conv_equals_separate_convs(self, rng):
        """One conv over the concatenated inputs is the sum of one conv per
        input slice of its weight (the bias once). In f64: in f32 the two
        summation orders differ by rounding at the tolerance's own scale
        (9.5e-7, and past 1e-6 for some of the unseeded initial weights)."""
        conv = FusedSumConv2d((2, 5, 5), 5).double()
        xs = [torch.from_numpy(rng.standard_normal((3, s, 12, 8))) for s in (2, 5, 5)]
        with torch.no_grad():
            got = conv(*xs)
            parts = torch.split(conv.weight, [2, 5, 5], dim=1)
            want = sum(F.conv2d(x, p, padding=1) for x, p in zip(xs, parts)) + conv.bias[:, None, None]
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        assert conv.sizes == (2, 5, 5)
        with pytest.raises(ValueError, match="channels"):
            conv(xs[1], xs[0], xs[2])

    def test_cell_matches_jax(self, rng):
        """relu(conv([x, h_time, h_iteration])), the inputs in that order."""
        x, h, g = (rng.standard_normal((2, 12, 8, s)).astype(np.float32) for s in (2, 6, 6))
        jm = JCRNNCell(hidden_size=6)
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(h), (jnp.asarray(x), jnp.asarray(g)))
        want, _ = jm.apply(params, jnp.asarray(h), (jnp.asarray(x), jnp.asarray(g)))
        tree = jax.tree.map(np.asarray, params)["params"]["i2h_h2h_ih2ih__f2_6_6"]
        cell = CRNNCell(2, 6)
        cell.load_state_dict({"conv.weight": conv_weight(tree["kernel"]),
                              "conv.bias": f32(tree["bias"])})
        nchw = lambda a: f32(a).permute(0, 3, 1, 2)
        with torch.no_grad():
            got = cell(nchw(x), nchw(h), nchw(g)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)

    def test_bcrnn_matches_jax(self, rng):
        """Both directions in one loop, stacked on the batch axis, one cell."""
        x = rng.standard_normal((5, 2, 12, 8, 3)).astype(np.float32)
        g = rng.standard_normal((5, 2, 12, 8, 6)).astype(np.float32)
        jm = JBCRNN(hidden_size=6)
        params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(g))
        want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(g)))
        tree = jax.tree.map(np.asarray, params)["params"]["cell"]["i2h_h2h_ih2ih__f3_6_6"]
        m = BCRNN(3, 6)
        m.load_state_dict({"cell.conv.weight": conv_weight(tree["kernel"]),
                           "cell.conv.bias": f32(tree["bias"])})
        ncthw = lambda a: f32(a).permute(0, 1, 4, 2, 3)
        with torch.no_grad():
            got = m(ncthw(x), ncthw(g)).permute(0, 1, 3, 4, 2).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    def test_trunk_matches_jax(self, rng):
        """The correction and all four new hiddens, from nonzero hiddens."""
        t, b, h, w, ch = 4, 1, 12, 8, 6
        x = rng.standard_normal((t, b, h, w, 8)).astype(np.float32)
        hid = (rng.standard_normal((t, b, h, w, ch)).astype(np.float32),) + tuple(
            rng.standard_normal((t * b, h, w, ch)).astype(np.float32) for _ in range(3))
        jm = JCRNNTrunk(ch, in_ch=8, out_ch=6)
        jhid = tuple(jnp.asarray(a) for a in hid)
        params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jhid)
        want, want_h = jm.apply(params, jnp.asarray(x), jhid)
        m = CRNNTrunk(ch, in_ch=8, out_ch=6)
        m.load_state_dict(crnn_trunk_state_dict(jax.tree.map(np.asarray, params)["params"], ""))
        last = lambda a: f32(a).movedim(-1, -3)  # channels to NCHW
        with torch.no_grad():
            got, got_h = m(last(x), tuple(last(a) for a in hid))
        np.testing.assert_allclose(got.movedim(-3, -1).numpy(), np.asarray(want), rtol=0, atol=1e-5)
        for g_, w_ in zip(got_h, want_h):
            np.testing.assert_allclose(g_.movedim(-3, -1).numpy(), np.asarray(w_), rtol=0, atol=1e-5)


class TestInit:
    @staticmethod
    def _slices(conv):
        return torch.split(conv.weight.detach(), list(conv.sizes), dim=1)

    def test_torch_style_fused_slices(self):
        """Each input slice of a fused conv is uniform in ±1/sqrt(9·sᵢ), the
        bias a sum of one such draw per slice; the JAX package's
        torch_style_init draws the same bounds."""
        m = build_model("varnet", "CRNN", device="cpu", generator=torch.Generator().manual_seed(3),
                        num_cascades=1, sens_chans=4, sens_pools=2, chans=16)
        jm = JVarNetRNN(num_cascades=1, sens_chans=4, sens_pools=2, chans=16)
        k, mask, _, _ = inputs(0)
        jp = j_torch_style_init(jm.init(jax.random.PRNGKey(0), jc(k), jnp.asarray(mask)),
                                jax.random.PRNGKey(3))
        jtrunk = jax.tree.map(np.asarray, jp)["params"]["iterations"]["trunk"]
        jcell = jtrunk["bcrnn"]["cell"]["i2h_h2h_ih2ih__f2_16_16"]
        for conv, jconv in ((m.trunk.bcrnn.cell.conv, jcell),
                            (m.trunk.conv1, jtrunk["conv1_xh__f16_16"])):
            jw = conv_weight(jconv["kernel"])
            bounds = [1 / math.sqrt(9 * s) for s in conv.sizes]
            for part, jpart, bound in zip(self._slices(conv), torch.split(jw, list(conv.sizes), 1),
                                          bounds):
                for p in (part, jpart):
                    assert 0.9 * bound < p.abs().max() <= bound
            for bias in (conv.bias.detach(), f32(jconv["bias"])):
                assert bias.abs().max() <= sum(bounds)
        # the 2-channel image slice is drawn 3x wider than one fan-in of 9·34 would
        assert self._slices(m.trunk.bcrnn.cell.conv)[0].abs().max() > 2.5 / math.sqrt(9 * 34)
        final = m.trunk.conv4
        assert 0.9 / math.sqrt(9 * 16) < final.weight.abs().max() <= 1 / math.sqrt(9 * 16)

    def test_lecun_normal_fused_slices(self):
        """Without torch_init: each slice ~ lecun_normal with its own fan-in
        (std 1/sqrt(9·sᵢ), truncated at 2σ), biases 0."""
        m = XPDNetRNN(num_cascades=1, sens_chans=4, sens_pools=2, chans=16, n_primal=5)
        lecun_normal_init(m, torch.Generator().manual_seed(0))
        conv = m.trunk.bcrnn.cell.conv  # sizes (12, 16, 16)
        assert conv.sizes == (12, 16, 16)
        for part, s in zip(self._slices(conv), conv.sizes):
            std = 1 / math.sqrt(9 * s)
            assert abs(part.std().item() / std - 1) < 0.1
            assert part.abs().max() <= 2 * std / 0.87962566103423978
        assert not conv.bias.detach().any()


def _jax_model(family, **kw):
    cls = dict(varnet=JVarNetRNN, cinenet=JCineNetRNN, xpdnet=JXPDNetRNN)[family]
    return cls(**dict(CRNN_SMALL[family], **kw))


def _pair(family, seed, kw, line_mask=True):
    """The JAX model's output and the port's with carried-over weights on the
    same inputs; a mask broadcast over w is not a line mask by shape (the
    k-space routes)."""
    k, mask, s, _ = inputs(seed)
    if not line_mask:
        mask = np.broadcast_to(mask, mask.shape[:-1] + (k.shape[-1],)).copy()
    jargs = (jc(k), jnp.asarray(mask)) + ((jc(s),) if family == "cinenet" else ())
    jm = _jax_model(family, **kw)
    params = jm.init(jax.random.PRNGKey(seed), *jargs)
    want = np.asarray(jax.jit(jm.apply)(params, *jargs))
    tm = build_model(family, "CRNN", device="cpu", **dict(CRNN_SMALL[family], **kw))
    tm.load_state_dict(STATE_DICTS[family](jax.tree.map(np.asarray, params)))
    targs = (from_complex(k), f32(mask)) + ((from_complex(s),) if family == "cinenet" else ())
    with torch.inference_mode():
        got = tm(*targs).numpy()
    return got, want


@pytest.mark.parametrize("family, kw, line_mask", [
    ("varnet", dict(), True),  # kernel DC: soft_dc_image_kernel
    ("varnet", dict(), False),  # the k-space soft DC
    ("cinenet", dict(), True),  # CG on normal_plus_lambda_kernel
    ("cinenet", dict(kernel_dc=False), True),  # CG on the direct operator
    ("xpdnet", dict(), True),  # N(head) − x_ref
    ("xpdnet", dict(kernel_dc=False), True),  # the measurement residual in k-space
    ("xpdnet", dict(primal_only=False), True),  # a KSpaceCNN per iteration
])
def test_model_matches_jax(family, kw, line_mask):
    got, want = _pair(family, 1, kw, line_mask)
    assert got.shape == (1, 4, 24, 16) and np.isfinite(got).all()
    assert_model_close(got, want)


def test_build_options_and_tree():
    """CRNN builds through build_model with the JAX classes' defaults, in
    bf16 and under a remat policy too, and with the packed trunk (same
    state dict); one shared λ and trunk."""
    for cls, jcls in ((VarNetRNN, JVarNetRNN), (CineNetRNN, JCineNetRNN), (XPDNetRNN, JXPDNetRNN)):
        port = cls()
        for name in ("num_cascades", "chans", "remat", "kernel_dc"):
            assert getattr(port, name) == getattr(jcls, name), (cls, name)
    assert CineNetRNN().cg_iters == JCineNetRNN.cg_iters
    x = XPDNetRNN()
    assert (x.n_primal, x.n_dual, x.primal_only) == (JXPDNetRNN.n_primal, JXPDNetRNN.n_dual, True)
    for family in ("varnet", "cinenet", "xpdnet"):
        packed = build_model(family, "CRNN", device="cpu", packed=True, num_cascades=1, chans=4)
        blocked = build_model(family, "CRNN", device="cpu", trunk_block=(2, 4), num_cascades=1,
                              chans=4)
        assert packed.packed and blocked.trunk_block == (2, 4)
        assert packed.state_dict().keys() == blocked.state_dict().keys() == build_model(
            family, "CRNN", device="cpu", num_cascades=1, chans=4).state_dict().keys()
    with pytest.raises(TypeError):
        build_model("varnet", "CRNN", device="cpu", pools=3)
    half = build_model("cinenet", "CRNN", device="cpu", bf16=True, remat_policy="convs")
    assert half.trunk.dtype == half.trunk.bcrnn.cell.conv.dtype == torch.bfloat16
    assert half.remat_policy == "convs"
    m = build_model("varnet", "CRNN", device="cpu", **CRNN_SMALL["varnet"])
    assert m.lambda_reg.shape == ()
    assert {n.split(".")[0] for n in m.state_dict()} == {"sens_net", "trunk", "lambda_reg"}
    m = build_model("xpdnet", "CRNN", device="cpu", primal_only=False, **CRNN_SMALL["xpdnet"])
    assert len(m.kspace_nets) == 2 and m.trunk.bcrnn.cell.conv.sizes == (8, 6, 6)


def _adam_state(opt_state):
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    return next(s for s in leaves if isinstance(s, optax.ScaleByAdamState))


@pytest.mark.parametrize("family, seed", [("varnet", 4), ("cinenet", 2)])
def test_two_train_steps_match_jax(family, seed):
    """Two steps of VarNet-CRNN (kernel DC) and CineNet-CRNN (maps in the
    batch, kernel DC), CRNN_SMALL, remat on, from carried-over params: the
    port's train step against the JAX package's jitted ``make_train_step``,
    compared as in tests/test_torch_train.py: loss and grad norm (1e-5
    relative), output (1e-4 x max), each grad leaf (JAX's from its Adam
    first moment) and both Adam moments (1e-4 x max per leaf), params
    (atol 2·lr). A ReLU input that is 0 up to f32 rounding moves the
    gradient below it by percents between any two f32 evaluations (ROADMAP
    Queue 3): VarNet-CRNN's data seed 2 has one (the cell's weight gradient
    4.6% off at step 1). The one shared λ's gradient is a single sum over
    the volume, about 2e-8 apart between the two packages in every seed;
    where it nearly cancels at step 2 (seed 1: 9.7e-5, seed 3: 1.1e-5) that
    is 2.6e-4 and 7.0e-4 of it. VarNet seeds 0, 4, 5 and 6 match to 3e-5 in
    both steps; CineNet-CRNN's seeds 0-4 match to 1e-5 at step 1."""
    lr = 1e-4
    k, mask, s, target = inputs(seed)
    jb = {"masked_kspace": jc(k), "mask": jnp.asarray(mask), "target": jnp.asarray(target)}
    tb = {"masked_kspace": from_complex(k), "mask": f32(mask), "target": f32(target)}
    if family == "cinenet":
        jb["sens_maps"], tb["sens_maps"] = jc(s), from_complex(s)
    jmodel = _jax_model(family, remat=True)
    jstate = j_create_train_state(jmodel, jb, j_make_optimizer(lr=lr), rng=jax.random.PRNGKey(seed))
    as_port = lambda tree: STATE_DICTS[family](jax.tree.map(np.asarray, tree))
    model = build_model(family, "CRNN", device="cpu", remat=True, **CRNN_SMALL[family])
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


def test_serve_cinenet_crnn_with_maps():
    """A batch of two volumes with their maps, served one at a time,
    equals the direct forward of each volume."""
    k, mask, s, _ = inputs(4, b=2)
    model = build_model("cinenet", "CRNN", device="cpu", **CRNN_SMALL["cinenet"])
    serve = bind_model(model, device="cpu")
    got = serve(k.real, k.imag, mask, s.real, s.imag)
    assert got.shape == (2, 4, 24, 16)
    with torch.inference_mode():
        for i in range(2):
            want = model(from_complex(k[i:i + 1]), f32(mask[i:i + 1]), from_complex(s[i:i + 1]))
            torch.testing.assert_close(got[i:i + 1], want, rtol=0, atol=0)
