"""The port's space-to-depth ("packed") conv stacks against the JAX package
on the CPU: ``models/denoisers/packed_unet.py`` (blocks, phase maps, pack,
pool, the packed convolutions), the packed wavelets, the packed U-Net, and
``packed=True`` models of every family.

Inputs are made with numpy from ``default_rng(seed)`` and handed to both
sides; weights are carried from flax by ``interop/flax_params.py``. The JAX
packed models take their params from the dense model's ``init`` (the trees
are one; a packed ``init`` traces the kernel assembly eagerly and takes a
minute) and run jitted. Tolerances: the primitives 1e-6 (pure data
movement, or one add per output); the U-Net 2e-4 x max |out| and its
gradients 5e-4 x max per leaf (``tests/test_models.py::TestPackedUnet``'s);
whole models 1e-4 x max |out| (the port's tolerance for every family and
type, ``tests/test_torch_{models,cascades,cinenet,crnn,xpdnet}.py``);
XPDNet-CRNN's gradients 1e-4 x max per leaf (``tests/test_torch_xpdnet.py``'s
for a train step).

Seeds of the gradient cases follow ROADMAP Queue 3 (an activation input at
0 up to f32 rounding moves the gradients below it by percents between two
summation orders): ``test_gradient_seeds_keep_activations_off_zero``
checks that no ReLU / LeakyReLU input of those cases changes sign between
the port's f32 and f64 forwards and that each lies at least twice its f32
error from 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cinemri_tpu.models import build_model as j_build_model
from cinemri_tpu.models.denoisers import packed_unet as J
from cinemri_tpu.models.denoisers.unet import Unet as JUnet
from cinemri_tpu.models.recurrent import _trunk_block as j_trunk_block
from cinemri_tpu.ops import wavelet as JW
from cinemri_tpu.ops.cplx import Complex as JComplex

from cinemri_tpu_torch.interop import flax_params as FP
from cinemri_tpu_torch.models import build_model
from cinemri_tpu_torch.models.denoisers import packed_unet as P
from cinemri_tpu_torch.models.denoisers.unet import Unet
from cinemri_tpu_torch.models.recurrent import _trunk_block
from cinemri_tpu_torch.ops import wavelet as TW
from cinemri_tpu_torch.ops.cplx import Complex, from_complex

torch.set_num_threads(2)

# tests/test_models.py::SMALL, CRNN_SMALL and its batch: (1, 4, 3, 24, 16)
SMALL = dict(
    varnet=dict(num_cascades=2, sens_chans=4, sens_pools=2, chans=4, pools=2),
    cinenet=dict(num_cascades=2, cg_iters=2, chans=4, pools=2),
    xpdnet=dict(num_cascades=2, sens_chans=4, sens_pools=2, n_scales=2,
                n_filters_per_scale=(4, 8), n_convs_per_scale=(2, 2), n_primal=3),
)
CRNN_SMALL = dict(
    varnet=dict(num_cascades=2, sens_chans=4, sens_pools=2, chans=6),
    cinenet=dict(num_cascades=2, cg_iters=2, chans=6),
    xpdnet=dict(num_cascades=2, sens_chans=4, sens_pools=2, chans=6, n_primal=3),
)
STATE_DICTS = {
    ("varnet", False): FP.varnet_state_dict, ("cinenet", False): FP.cinenet_state_dict,
    ("xpdnet", False): FP.xpdnet_state_dict, ("varnet", True): FP.varnet_rnn_state_dict,
    ("cinenet", True): FP.cinenet_rnn_state_dict, ("xpdnet", True): FP.xpdnet_rnn_state_dict,
}
B, T, C, H, W = 1, 4, 3, 24, 16
UNET_SEED = 0  # the U-Net gradient case's data seed (checked below)
XPDNET_CRNN_SEED = 0  # XPDNet-CRNN's gradient case's data seed (checked below)


def np_tree(params):
    return jax.tree.map(np.asarray, params)


def to_first(x: np.ndarray) -> torch.Tensor:
    """Channels-last numpy -> the port's channels-first tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def to_last(x: torch.Tensor) -> np.ndarray:
    return x.detach().movedim(1, -1).numpy()


def model_batch(seed):
    """``tests/test_models.py``'s batch at ``seed``: masked k-space, a line
    mask and RSS-normalized maps."""
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((B, T, C, H, W)) + 1j * rng.standard_normal((B, T, C, H, W))
         ).astype(np.complex64)
    m = np.zeros((B, T, 1, H, 1), np.float32)
    m[:, :, :, H // 2 - 3:H // 2 + 3] = 1
    m[:, :, :, 2] = 1
    m[:, :, :, H - 3] = 1
    s = (rng.standard_normal((B, 1, C, H, W)) + 1j * rng.standard_normal((B, 1, C, H, W))
         ).astype(np.complex64)
    s /= np.sqrt((np.abs(s) ** 2).sum(2, keepdims=True))
    return k * m, m, s


def jax_args(family, batch):
    k, m, s = batch
    jc = lambda x: JComplex(jnp.asarray(x.real), jnp.asarray(x.imag))
    return (jc(k), jnp.asarray(m)) + ((jc(s),) if family == "cinenet" else ())


def port_args(family, batch):
    k, m, s = batch
    return (from_complex(k), torch.from_numpy(m)) + ((from_complex(s),) if family == "cinenet" else ())


def jax_and_port(family, dyn, kw, batch):
    """(the JAX packed model, its params, the port's packed model carrying them)."""
    crnn = dyn == "CRNN"
    dense = {k: v for k, v in kw.items() if k != "trunk_block"}
    params = j_build_model(family, dyn, **dense).init(jax.random.PRNGKey(0), *jax_args(family, batch))
    jm = j_build_model(family, dyn, packed=True, **kw)
    tm = build_model(family, dyn, device="cpu", packed=True, **kw)
    tm.load_state_dict(STATE_DICTS[family, crnn](np_tree(params)))
    return jm, params, tm


def assert_close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


class TestPrimitives:
    @pytest.mark.parametrize("spatial, chans, pools", [
        ((16, 32, 32), 16, 3), ((7, 32, 24), 16, 2), ((5, 25, 30), 16, 2), ((48, 48), 16, 3),
        ((50, 35), 16, 3), ((15, 200, 200), 16, 3), ((16, 208, 208), 16, 3), ((208, 16), 16, 3),
        ((3, 20), 4, 2)])
    def test_choose_blocks_matches_jax(self, spatial, chans, pools):
        assert P.choose_blocks(spatial, chans, pools) == J.choose_blocks(spatial, chans, pools)

    @pytest.mark.parametrize("block, ksizes", [
        ((2, 2), (3, 3)), ((1, 2), (3, 3)), ((2, 4), (3, 3)), ((4, 4), (1, 1)),
        ((2, 2, 2), (3, 3, 3)), ((1, 2, 4), (3, 3, 3)), ((1, 1, 2), (1, 1, 1))])
    def test_conv_phase_map_equals_jax(self, block, ksizes):
        np.testing.assert_array_equal(P._conv_phase_map(block, ksizes),
                                      J._conv_phase_map(block, ksizes))

    @pytest.mark.parametrize("block_in, block_out", [
        ((1, 1), (1, 1)), ((1, 1), (1, 2)), ((1, 2), (2, 2)), ((2, 2), (2, 2)), ((2, 2), (2, 4)),
        ((1, 2, 2), (1, 2, 4)), ((2, 2, 2), (2, 2, 2))])
    def test_convt_phase_map_is_jax_map_in_torch_convention(self, block_in, block_out):
        """The port's map is derived for torch's stored weight; lax's
        convention reverses the tap and the slot of every dim."""
        got, ks, st = P._convt_phase_map(block_in, block_out)
        want, jks, jst = J._convt_phase_map(block_in, block_out)
        d = len(block_in)
        flip = tuple(range(d)) + tuple(range(d + 2, 2 * d + 2))
        np.testing.assert_array_equal(got, np.flip(want, flip))
        assert (ks, st) == (tuple(jks), tuple(jst))

    def test_trunk_block_matches_jax(self):
        for args in ((16, 16, True, 18), (16, 16, True, 64), (16, 16, True, 200),
                     (15, 16, True, 18), (16, 16, False, 18)):
            assert _trunk_block(*args) == j_trunk_block(*args)
        assert [_trunk_block(16, 16, True, c) for c in (18, 64, 200)] == [(2, 2), (1, 2), ()]

    @pytest.mark.parametrize("block", [(2, 2), (1, 2), (2, 4), (1, 2, 4)])
    def test_pack_and_unpack_match_jax(self, rng, block):
        x = rng.standard_normal((2, *(8 for _ in block), 3)).astype(np.float32)
        got = P.pack(to_first(x), block)
        np.testing.assert_allclose(to_last(got), np.asarray(J.pack(jnp.asarray(x), block)), atol=1e-6)
        torch.testing.assert_close(P.unpack(got, block), to_first(x), rtol=0, atol=0)

    @pytest.mark.parametrize("block_in, block_out, grid", [
        ((2, 2), (1, 2), (4, 6)), ((1, 2), (1, 1), (5, 4)), ((2, 4), (2, 4), (4, 2)),
        ((2, 4), (1, 2), (3, 3)), ((1, 2, 4), (1, 2, 2), (5, 4, 2)), ((2, 2, 2), (1, 2, 2), (2, 4, 4))])
    def test_packed_avg_pool_matches_jax(self, rng, block_in, block_out, grid):
        x = rng.standard_normal((2, *grid, 3 * P.block_size(block_in))).astype(np.float32)
        got = P.packed_avg_pool_2x(to_first(x), block_in, block_out)
        want = np.asarray(J.packed_avg_pool_2x(jnp.asarray(x), block_in, block_out))
        np.testing.assert_allclose(to_last(got), want, rtol=0, atol=1e-6)

    def test_packed_wavelets_match_jax(self, rng):
        x = rng.standard_normal((2, 6, 4, 12)).astype(np.float32)
        for fn in ("dwt2_from_packed", "iwt2_to_packed"):
            want = np.asarray(getattr(JW, fn)(jnp.asarray(x)))
            np.testing.assert_allclose(getattr(TW, fn)(torch.from_numpy(x)).numpy(), want,
                                       rtol=0, atol=1e-6)
            got = getattr(TW, fn)(to_first(x), channel_axis=1)
            np.testing.assert_allclose(to_last(got), want, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("block_in, block_out", [
        ((1, 1), (1, 1)), ((1, 1), (1, 2)), ((1, 2), (2, 2)), ((2, 2), (2, 2)), ((1, 2), (2, 4)),
        ((1, 1, 2), (1, 2, 4)), ((2, 2, 2), (2, 2, 2))])
    def test_packed_convs_equal_the_dense_ones(self, block_in, block_out):
        """On random torch weights: the packed conv of the packed input is the
        packed dense conv, and the packed transpose conv from ``block_in`` to
        ``block_out`` the packed dense transpose conv, for each block pair
        ``choose_blocks`` yields per dim ((1, 1), (1, 2), (2, 2)). Float64,
        so the two summation orders agree to 1e-12."""
        d = len(block_in)
        g = torch.Generator().manual_seed(0)
        conv = P.PACKED_CONV[d](3, 5, 3, padding=1).double()
        tconv = P.PACKED_CONV_T[d](4, 3, 2, stride=2).double()
        for module in (conv, tconv):
            for p in module.parameters():
                p.data = torch.randn(p.shape, generator=g, dtype=torch.float64)
        x = torch.randn(2, 3, *(4 * b for b in block_out), generator=g, dtype=torch.float64)
        dense = F.conv2d if d == 2 else F.conv3d
        want = P.pack(dense(x, conv.weight, conv.bias, padding=1), block_out)
        torch.testing.assert_close(conv(P.pack(x, block_out), block_out), want, rtol=0, atol=1e-12)
        y = torch.randn(2, 4, *(2 * b for b in block_in), generator=g, dtype=torch.float64)
        dense_t = F.conv_transpose2d if d == 2 else F.conv_transpose3d
        want = P.pack(dense_t(y, tconv.weight, tconv.bias, stride=2), block_out)
        got = tconv(P.pack(y, block_in), block_in, block_out)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def unet_gradient_case():
    """The JAX packed U-Net of the gradient case, its params, the port's
    packed U-Net carrying them and the input (``TestPackedUnet.
    test_gradients_match``'s: chans 8, 2 pools, a (1, 8, 16, 16) volume)."""
    x = np.random.default_rng(UNET_SEED).standard_normal((1, 8, 16, 16, 2)).astype(np.float32)
    params = JUnet(chans=8, num_pool_layers=2, dims=3).init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = Unet(chans=8, num_pool_layers=2, dims=3, packed=True)
    tm.load_state_dict(FP.unet_state_dict(np_tree(params)["params"], ""))
    return JUnet(chans=8, num_pool_layers=2, dims=3, packed=True), params, tm, x


# tests/test_models.py::TestPackedUnet's shapes, and two with an empty level
UNET_CASES = [(3, (16, 32, 32), 3), (3, (7, 32, 24), 2), (3, (5, 25, 30), 2), (2, (48, 48), 3),
              (2, (50, 35), 3), (2, (3, 20), 2), (3, (3, 12, 8), 2)]


class TestPackedUnet:
    @pytest.mark.parametrize("dims, shape, pools", UNET_CASES)
    def test_matches_jax(self, dims, shape, pools):
        """Against JAX's packed U-Net at 2e-4 x max |out|; t = 3 at 2 pools
        (3 -> 1 -> 0) and h = 3 give an empty level, which comes out empty."""
        x = np.random.default_rng(0).standard_normal((2, *shape, 2)).astype(np.float32)
        params = JUnet(chans=16, num_pool_layers=pools, dims=dims).init(
            jax.random.PRNGKey(0), jnp.asarray(x))
        want = jax.jit(JUnet(chans=16, num_pool_layers=pools, dims=dims, packed=True).apply)(
            params, jnp.asarray(x))
        tm = Unet(chans=16, num_pool_layers=pools, dims=dims, packed=True)
        tm.load_state_dict(FP.unet_state_dict(np_tree(params)["params"], ""))
        with torch.no_grad():
            got = to_last(tm(to_first(x)))
        assert_close(got, want, 2e-4)

    def test_gradients_match_jax(self):
        """The gradient of Σ out² of every parameter within 5e-4 x its max of
        JAX's (jitted), on :func:`unet_gradient_case`."""
        jm, params, tm, x = unet_gradient_case()
        want = FP.unet_state_dict(np_tree(jax.jit(jax.grad(
            lambda q: jnp.sum(jm.apply(q, jnp.asarray(x)) ** 2)))(params))["params"], "")
        (tm(to_first(x)) ** 2).sum().backward()
        grads = dict(tm.named_parameters())
        assert set(grads) == set(want)
        for name, w in want.items():
            assert_close(grads[name].grad.numpy(), w.numpy(), 5e-4)


# tests/test_models.py::TestPackedModels's ten family / type pairs
MODEL_CASES = [("varnet", "3D"), ("varnet", "XF"), ("varnet", "2D"), ("cinenet", "3D"),
               ("cinenet", "XT"), ("varnet", "CRNN"), ("cinenet", "CRNN"), ("xpdnet", "CRNN"),
               ("xpdnet", "XF"), ("xpdnet", "2D")]


class TestPackedModels:
    @pytest.mark.parametrize("family, dyn", MODEL_CASES)
    def test_matches_jax(self, family, dyn):
        """``packed=True`` against the JAX package's ``packed=True`` at 1e-4 x
        max |out|, the port's tolerance for each of these families and types."""
        kw = dict(CRNN_SMALL[family] if dyn == "CRNN" else SMALL[family])
        batch = model_batch(0)
        jm, params, tm = jax_and_port(family, dyn, kw, batch)
        want = jax.jit(jm.apply)(params, *jax_args(family, batch))
        with torch.inference_mode():
            got = tm(*port_args(family, batch)).numpy()
        assert got.shape == (B, T, H, W) and np.isfinite(got).all()
        assert_close(got, want, 1e-4)

    @pytest.mark.parametrize("family, kw, block", [
        ("varnet", dict(trunk_block=(2, 4)), (2, 4)),  # beyond the rule
        ("cinenet", dict(chans=34), (1, 2)),  # 2·34 lanes <= 128 < 4·34: the half block
    ])
    def test_trunk_blocks_match_jax(self, family, kw, block):
        kw = dict(CRNN_SMALL[family], **kw)
        batch = model_batch(0)
        jm, params, tm = jax_and_port(family, "CRNN", kw, batch)
        want = jax.jit(jm.apply)(params, *jax_args(family, batch))
        with torch.inference_mode():
            got = tm(*port_args(family, batch)).numpy()
        assert (tm.trunk_block or _trunk_block(H, W, True, kw["chans"])) == block
        assert_close(got, want, 1e-4)

    def test_xpdnet_crnn_gradients_match_jax(self):
        """The packed-carry iterations (the buffer packed across them, the
        head unpacked for the normal apply) under autograd and remat: the
        gradient of Σ out² of every parameter within 1e-4 x its max of JAX's
        packed model's (jitted)."""
        kw = dict(CRNN_SMALL["xpdnet"])
        batch = model_batch(XPDNET_CRNN_SEED)
        jm, params, tm = jax_and_port("xpdnet", "CRNN", kw, batch)
        jargs = jax_args("xpdnet", batch)
        jgrads = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, *jargs) ** 2)))(params)
        want = FP.xpdnet_rnn_state_dict(np_tree(jgrads))
        (tm(*port_args("xpdnet", batch)) ** 2).sum().backward()
        grads = dict(tm.named_parameters())
        assert set(grads) == set(want)
        for name, w in want.items():
            assert_close(grads[name].grad.numpy(), w.numpy().reshape(grads[name].shape), 1e-4)

    @pytest.mark.parametrize("family, dyn", [("varnet", "3D"), ("cinenet", "2D"), ("xpdnet", "XF"),
                                             ("xpdnet", "CRNN")])
    def test_dense_state_dict_loads_unchanged(self, family, dyn):
        """A packed model holds the dense model's keys and shapes (and draws
        the same init from a seed); a dense state dict loads into it and the
        two compute the same function (1e-4 x max |out|)."""
        kw = dict(CRNN_SMALL[family] if dyn == "CRNN" else SMALL[family])
        dense = build_model(family, dyn, device="cpu", generator=torch.Generator().manual_seed(1), **kw)
        packed = build_model(family, dyn, device="cpu", packed=True, **kw)
        want = dense.state_dict()
        assert {k: v.shape for k, v in packed.state_dict().items()} == {
            k: v.shape for k, v in want.items()}
        seeded = build_model(family, dyn, device="cpu", packed=True,
                             generator=torch.Generator().manual_seed(1), **kw).state_dict()
        assert all(torch.equal(seeded[k], v) for k, v in want.items())
        packed.load_state_dict(want)
        args = port_args(family, model_batch(0))
        with torch.inference_mode():
            assert_close(packed(*args).numpy(), dense(*args).numpy(), 1e-4)
        dense.load_state_dict(packed.state_dict())


def test_a_served_request_then_a_train_step():
    """A packed model serves a request under ``torch.inference_mode`` and
    then takes a gradient: the device copies of the phase maps made by the
    request are not inference tensors, which autograd could not save."""
    P._gather_tensor.cache_clear()
    model = build_model("varnet", "2D", device="cpu", packed=True, **SMALL["varnet"])
    args = port_args("varnet", model_batch(0))
    with torch.inference_mode():
        served = model(*args)
    out = model(*args)
    out.sum().backward()
    assert P._gather_tensor.cache_info().hits > 0
    torch.testing.assert_close(out.detach(), served, rtol=0, atol=0)
    assert all(p.grad is not None for p in model.parameters())


def _activation_inputs(model, args, monkeypatch):
    """``(name, input in f64)`` of every ReLU and LeakyReLU call of one
    forward of ``model``."""
    seen, real = [], {"relu": F.relu, "leaky_relu": F.leaky_relu}

    def record(name):
        def fn(x, *a, **kw):
            seen.append((name, x.detach().to(torch.float64)))
            return real[name](x, *a, **kw)
        return fn

    with monkeypatch.context() as m:
        for name in real:
            m.setattr(F, name, record(name))
        with torch.no_grad():
            model(*args)
    return seen


@pytest.mark.parametrize("case", ["unet", "xpdnet-crnn"])
def test_gradient_seeds_keep_activations_off_zero(case, monkeypatch):
    """The gradient cases' seeds (UNET_SEED, XPDNET_CRNN_SEED) keep every
    ReLU / LeakyReLU input off 0 up to rounding: between the port's packed
    f32 and f64 forwards no input changes sign, and each lies at least twice
    its f32 error from 0 (inputs at exactly 0 in both are ReLU's, whose
    derivative there both packages take as 0)."""
    from cinemri_tpu_torch.ops import fft as FFT
    from cinemri_tpu_torch.physics import operators as OPS

    if case == "unet":
        _, _, model, x = unet_gradient_case()
        make_args = lambda dt: (to_first(x).to(dt),)
    else:
        batch = model_batch(XPDNET_CRNN_SEED)
        _, _, model = jax_and_port("xpdnet", "CRNN", dict(CRNN_SMALL["xpdnet"]), batch)
        make_args = lambda dt: tuple(
            Complex(a.re.to(dt), a.im.to(dt)) if isinstance(a, Complex) else a.to(dt)
            for a in port_args("xpdnet", batch))
    out = []
    for dt in (torch.float32, torch.float64):
        model.to(dt)
        with monkeypatch.context() as m:
            if dt == torch.float64:
                f32 = FFT._dft_tensors
                for mod in (FFT, OPS):
                    m.setattr(mod, "_dft_tensors", lambda *a: tuple(w.double() for w in f32(*a)))
            out.append(_activation_inputs(model, make_args(dt), monkeypatch))
    assert len(out[0]) == len(out[1]) > 0
    for i, ((kind, x32), (_, x64)) in enumerate(zip(*out)):
        exact = (x32 == 0) & (x64 == 0)
        assert kind == "relu" or not exact.any(), f"{kind} call {i}: inputs at exactly 0"
        assert not ((x32 > 0) != (x64 > 0)).any(), f"{kind} call {i}: a sign flip"
        margin = x64[~exact].abs() / (x32 - x64)[~exact].abs()
        assert margin.min().item() >= 2.0, f"{kind} call {i}: margin {margin.min().item()}"
