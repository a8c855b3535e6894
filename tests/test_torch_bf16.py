"""The port's bf16 denoiser activations against the JAX package's, on the CPU.

The pairs of the JAX package's ``TestBf16Mode`` (``tests/test_models.py``),
at its sizes (``SMALL`` / ``CRNN_SMALL``, b, t, c, h, w = 1, 4, 3, 24, 16),
from the same params: the port's bf16 output must lie no farther from the
JAX package's bf16 output than that lies from the f32 output (measured in
each test), and within the JAX test's own bound of the f32 output; and it
must move from the f32 output by at least half that gap, so a bf16 setting
that changed nothing would fail. The f32
output is the port's, which the f32 tests hold to 1e-4 x max of the JAX
package's (``tests/test_torch_{models,cascades,crnn,xpdnet}.py``; 1e-5 here),
far below the bf16 gaps (1e-2).

CineNet-3D is chaotic in bf16 at this input: the JAX package's own bf16
output moves by about 40% of its bf16-f32 gap when its input moves by one
part in 2²², so two evaluations whose f32 parts differ in summation order
land as far apart as two independent bf16 roundings (1.17x the gap). Its
bound adds twice that measured move. Its denoiser, the 3-D U-Net, is not
chaotic on the model's first-cascade input, and is held there to the gap
itself.

The conv inputs are bf16 and the norm statistics f32 (seen at the
dispatcher), gradients and params are f32, XPDNet's ``norm_buffers=None``
resolves to the bf16 setting, and one VarNet-XF bf16 train step is held
against the JAX package's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cinemri_tpu.models import build_model as j_build_model
from cinemri_tpu.ops.cplx import Complex as JComplex
from cinemri_tpu.train import create_train_state as j_create_train_state
from cinemri_tpu.train import make_optimizer as j_make_optimizer
from cinemri_tpu.train import make_train_step as j_make_train_step

from cinemri_tpu_torch.interop.flax_params import (
    cinenet_rnn_state_dict,
    cinenet_state_dict,
    varnet_rnn_state_dict,
    varnet_state_dict,
    xpdnet_rnn_state_dict,
    xpdnet_state_dict,
)
from cinemri_tpu_torch.models import build_model
from cinemri_tpu_torch.ops.cplx import Complex, from_complex
from cinemri_tpu_torch.ops.ssim import ssim_loss
from cinemri_tpu_torch.train import create_train_state, make_train_step

torch.set_num_threads(2)

B, T, C, H, W = 1, 4, 3, 24, 16
# tests/test_models.py's SMALL and CRNN_SMALL
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
    ("varnet", False): varnet_state_dict, ("cinenet", False): cinenet_state_dict,
    ("xpdnet", False): xpdnet_state_dict, ("varnet", True): varnet_rnn_state_dict,
    ("cinenet", True): cinenet_rnn_state_dict, ("xpdnet", True): xpdnet_rnn_state_dict,
}
PAIRS = [("varnet", "XF"), ("varnet", "3D"), ("varnet", "CRNN"), ("cinenet", "3D"),
         ("cinenet", "CRNN"), ("xpdnet", "CRNN"), ("xpdnet", "XF")]
CHAOTIC = {("cinenet", "3D")}


def _batch():
    """tests/test_models.py's batch: k-space, a line mask, RSS-normalized maps."""
    rng = np.random.default_rng(0)
    k = (rng.standard_normal((B, T, C, H, W)) + 1j * rng.standard_normal((B, T, C, H, W))).astype(np.complex64)
    m = np.zeros((B, T, 1, H, 1), np.float32)
    m[:, :, :, H // 2 - 3: H // 2 + 3] = 1
    m[:, :, :, 2] = 1
    m[:, :, :, H - 3] = 1
    s = (rng.standard_normal((B, 1, C, H, W)) + 1j * rng.standard_normal((B, 1, C, H, W))).astype(np.complex64)
    s /= np.sqrt((np.abs(s) ** 2).sum(2, keepdims=True))
    return k * m, m, s


def _kwargs(family, dyn):
    kwargs = dict(CRNN_SMALL[family] if dyn == "CRNN" else SMALL[family])
    if family == "xpdnet" and dyn != "CRNN":
        kwargs["norm_buffers"] = True  # as the JAX test: bf16 against f32 on the same function
    return kwargs


def _args(family, k, m, s):
    jargs = (JComplex(jnp.asarray(k.real), jnp.asarray(k.imag)), jnp.asarray(m))
    targs = (from_complex(k), torch.from_numpy(m))
    if family == "cinenet":
        jargs += (JComplex(jnp.asarray(s.real), jnp.asarray(s.imag)),)
        targs += (from_complex(s),)
    return jargs, targs


class _ConvDtypes(TorchDispatchMode):
    """Records the dtypes of every convolution's input and weight, and of
    every batch norm's input (instance norm's statistics)."""

    def __init__(self):
        super().__init__()
        self.convs, self.norms = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.convs.append((args[0].dtype, args[1].dtype))
        elif "batch_norm" in func.__name__:
            self.norms.append(args[0].dtype)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("family, dyn", PAIRS)
def test_bf16_forward_matches_jax(family, dyn):
    k, m, s = _batch()
    jargs, targs = _args(family, k, m, s)
    kwargs = _kwargs(family, dyn)
    half = j_build_model(family, dyn, bf16=True, **kwargs)
    params = half.init(jax.random.PRNGKey(0), *jargs)
    want16 = np.asarray(half.apply(params, *jargs))
    sd = STATE_DICTS[family, dyn == "CRNN"](jax.tree.map(np.asarray, params))
    outs = {}
    for bf16 in (False, True):
        tm = build_model(family, dyn, device="cpu", bf16=bf16, **kwargs)
        tm.load_state_dict(sd)
        with torch.inference_mode():
            outs[bf16] = tm(*targs).numpy()
    got, f32 = outs[True], outs[False]
    assert got.dtype == np.float32 and got.shape == want16.shape and np.isfinite(got).all()
    scale = np.abs(f32).max()
    # the JAX test's bound on bf16 against f32, for the port's bf16
    assert np.abs(got - f32).max() <= 0.05 * scale and np.abs(got - f32).mean() < 1e-2 * scale
    bound = np.abs(want16 - f32).max()
    assert np.abs(got - f32).max() >= 0.5 * bound  # the bf16 setting took effect
    if (family, dyn) in CHAOTIC:
        jargs2, _ = _args(family, (k * np.float32(1 + 2.0 ** -22)).astype(np.complex64), m, s)
        move = np.abs(np.asarray(half.apply(params, *jargs2)) - want16).max()
        assert move > 0.1 * bound  # chaotic: one part in 2^22 moves it this far
        bound += 2 * move
    assert 0 < np.abs(got - want16).max() <= bound



def test_cinenet_3d_denoiser_bf16_matches_jax():
    """CineNet-3D's 3-D U-Net alone, from the bf16 model's params, on the
    model's first-cascade input (the coil-combined image): where the model
    is chaotic this is not (the JAX package's bf16 output does not move when
    its input moves by one part in 2^22), so the port's bf16 output is held
    to the bound of the other pairs: no farther from the JAX package's bf16
    output than that is from the f32 output, and moved from f32 by at least
    half that gap."""
    from cinemri_tpu.models.denoisers.unet import Unet as JUnet

    from cinemri_tpu_torch.interop.flax_params import unet_state_dict
    from cinemri_tpu_torch.models.denoisers.unet import Unet
    from cinemri_tpu_torch.ops.cplx import to_channels
    from cinemri_tpu_torch.physics.operators import sens_reduce

    k, m, s = _batch()
    jargs, targs = _args("cinenet", k, m, s)
    kwargs = _kwargs("cinenet", "3D")
    params = j_build_model("cinenet", "3D", bf16=True, **kwargs).init(jax.random.PRNGKey(0), *jargs)
    unet = {"params": jax.tree.map(np.asarray, params["params"]["cascades"]["net"])}
    x = to_channels(sens_reduce(targs[0], targs[2])[:, :, 0], axis=-1).numpy()  # (b, t, h, w, 2)
    half = JUnet(chans=kwargs["chans"], num_pool_layers=kwargs["pools"], dims=3, dtype=jnp.bfloat16)
    want16 = np.asarray(half.apply(unet, jnp.asarray(x)))
    f32 = np.asarray(JUnet(chans=kwargs["chans"], num_pool_layers=kwargs["pools"], dims=3)
                     .apply(unet, jnp.asarray(x)))
    gap = np.abs(want16 - f32).max()
    move = np.abs(np.asarray(half.apply(unet, jnp.asarray(x * np.float32(1 + 2.0 ** -22)))) - want16).max()
    assert move < 0.1 * gap  # not chaotic here
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        net = Unet(kwargs["chans"], kwargs["pools"], dims=3, dtype=dtype)
        net.load_state_dict(unet_state_dict(unet["params"], ""))
        with torch.inference_mode():
            outs[dtype] = np.moveaxis(net(torch.from_numpy(np.moveaxis(x, -1, 1).copy())).numpy(), 1, -1)
    got = outs[torch.bfloat16]
    assert got.dtype == np.float32 and np.abs(outs[torch.float32] - f32).max() <= 1e-5 * np.abs(f32).max()
    assert np.abs(got - want16).max() <= gap
    assert np.abs(got - outs[torch.float32]).max() >= 0.5 * gap

@pytest.mark.parametrize("family, dyn, f32_convs", [("varnet", "XF", 0), ("xpdnet", "XF", 13),
                                                    ("cinenet", "XF", 0), ("cinenet", "3D", 0)])
def test_conv_inputs_bf16_norms_f32_grads_f32(family, dyn, f32_convs):
    """Every convolution of a bf16 VarNet-XF, CineNet-XF and CineNet-3D
    takes bf16 input and weight; XPDNet-XF keeps its sens net's U-Net in f32,
    as the JAX package does (2 pools: 2 x 2 encoder, 2 bottom, 2 transposed,
    2 x 2 decoder and 1 final convolutions). Instance norm's statistics are
    f32 everywhere, and the gradients of a loss are f32 on f32 params."""
    k, m, s = _batch()
    _, targs = _args(family, k, m, s)
    model = build_model(family, dyn, device="cpu", bf16=True, **SMALL[family])
    mode = _ConvDtypes()
    with mode:
        out = model(*targs)
    assert out.dtype == torch.float32
    bf16 = (torch.bfloat16, torch.bfloat16)
    assert sum(c != bf16 for c in mode.convs) == f32_convs
    assert all(c in (bf16, (torch.float32, torch.float32)) for c in mode.convs)
    assert mode.norms and all(d == torch.float32 for d in mode.norms)
    out.sum().backward()
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32, name


def test_xpdnet_norm_buffers_default_resolution():
    """tests/test_models.py's case: ``norm_buffers=None`` is off in f32 and
    on in bf16, and the normalization changes the function."""
    k, m, _ = _batch()
    _, targs = _args("xpdnet", k, m, None)

    def run(**kw):
        model = build_model("xpdnet", "XF", device="cpu", generator=torch.Generator().manual_seed(0),
                            **SMALL["xpdnet"], **kw)
        with torch.inference_mode():
            return model(*targs)

    plain = run()
    assert torch.equal(plain, run(norm_buffers=False))
    assert torch.equal(run(bf16=True), run(bf16=True, norm_buffers=True))
    assert (run(norm_buffers=True) - plain).abs().max().item() > 1e-4


def _adam_mu(opt_state):
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    return next(x for x in leaves if isinstance(x, optax.ScaleByAdamState)).mu


def test_varnet_xf_bf16_train_step_matches_jax():
    """One train step of a bf16 VarNet-XF (remat on, SSIM loss, Adam) from
    the same params on both sides. The port's loss, output and gradient (all
    leaves, relative L2; JAX's from its first Adam moment, g = μ / (1 − β₁))
    lie no farther from the JAX package's bf16 step than that lies from the
    (port's) f32 step; the params stay f32. bf16 gradients at this size are
    rounding-dominated (20-45% per leaf from f32), so the whole gradient is
    compared, not each leaf."""
    k, m, _ = _batch()
    jargs, targs = _args("varnet", k, m, None)
    target = np.abs(k).mean(axis=2).astype(np.float32)
    jb = {"masked_kspace": jargs[0], "mask": jargs[1], "target": jnp.asarray(target)}
    tb = {"masked_kspace": targs[0], "mask": targs[1], "target": torch.from_numpy(target)}
    jm = j_build_model("varnet", "XF", bf16=True, **SMALL["varnet"])
    jstate = j_create_train_state(jm, jb, j_make_optimizer(lr=1e-4), rng=jax.random.PRNGKey(4))
    sd = varnet_state_dict(jax.tree.map(np.asarray, jstate.params))
    jstate, jaux = j_make_train_step(donate=False)(jstate, jb)
    jgrad = {n: g / 0.1 for n, g in varnet_state_dict(jax.tree.map(np.asarray, _adam_mu(jstate.opt_state))).items()}
    auxes, grads = {}, {}
    for bf16 in (False, True):
        model = build_model("varnet", "XF", device="cpu", bf16=bf16, **SMALL["varnet"])
        model.load_state_dict(sd)
        state, auxes[bf16] = make_train_step()(create_train_state(model, device="cpu", lr=1e-4), tb)
        grads[bf16] = {n: p.grad for n, p in state.model.named_parameters()}
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in state.model.parameters())
    # each no farther from JAX's bf16 step than the f32 step is, and moved
    # from the f32 step by at least half that gap (the bf16 setting took effect)
    for key in ("loss", "output"):
        want = np.asarray(jaux[key])
        gap = np.abs(want - auxes[False][key].numpy()).max()
        assert np.abs(auxes[True][key].numpy() - want).max() <= gap, key
        assert np.abs(auxes[True][key].numpy() - auxes[False][key].numpy()).max() >= 0.5 * gap, key
    dist = lambda a, b: math.sqrt(sum(((a[n] - b[n]) ** 2).sum().item() for n in jgrad))
    gap = dist(grads[False], jgrad)
    assert dist(grads[True], jgrad) <= gap
    assert dist(grads[True], grads[False]) >= 0.5 * gap
    assert torch.isfinite(auxes[True]["loss"])


def test_ssim_loss_of_bf16_model_output_is_f32():
    """The loss stays f32: the model's output is f32 whatever its activations."""
    k, m, _ = _batch()
    _, targs = _args("varnet", k, m, None)
    model = build_model("varnet", "CRNN", device="cpu", bf16=True, **CRNN_SMALL["varnet"])
    out = model(*targs)
    loss = ssim_loss(out, out.detach() + 0.1)
    assert out.dtype == loss.dtype == torch.float32
    assert isinstance(targs[0], Complex) and targs[0].re.dtype == torch.float32
