"""Port models (cinemri_tpu_torch.models) against the JAX package on the CPU.

Each case initializes the flax model, carries its params into the port
through ``interop/flax_params.py``, and runs both on the same numpy inputs.
Tolerance: max |port − JAX| ≤ 1e-4 × max |JAX output|. Instance norm and
the cascades accumulate f32 rounding, and flax's GroupNorm takes the
variance as E[x²] − E[x]² where torch takes it about the mean.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cinemri_tpu.data.masks import RandomMask as JRandomMask
from cinemri_tpu.models import build_model as j_build_model
from cinemri_tpu.models.denoisers.norm_unet import NormUnet as JNormUnet
from cinemri_tpu.models.denoisers.unet import Unet as JUnet
from cinemri_tpu.models.varnet import SensitivityModel as JSensitivityModel
from cinemri_tpu.ops.cplx import Complex as JComplex
from cinemri_tpu.ops.cplx import to_numpy as j_to_numpy

from cinemri_tpu_torch.interop.flax_params import (
    conv_transpose_weight,
    cinenet_state_dict,
    conv_weight,
    unet_state_dict,
    varnet_state_dict,
)
from cinemri_tpu_torch.models import CineNetRNN, VarNetRNN, XPDNetRNN, build_model, torch_style_init
from cinemri_tpu_torch.models.denoisers import NormUnet, Unet
from cinemri_tpu_torch.models.varnet import LAMBDA_INIT, SensitivityModel, VarNet
from cinemri_tpu_torch.ops.cplx import from_complex, to_numpy

torch.set_num_threads(2)

SMALL = dict(num_cascades=2, sens_chans=4, sens_pools=2, chans=4, pools=2)


def c64(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def jc(x):
    return JComplex(jnp.asarray(x.real), jnp.asarray(x.imag))


def to_np_tree(params):
    return jax.tree.map(np.asarray, params)


def assert_model_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def kspace_and_mask(rng, b, t, c, h, w, seed=0):
    masks = np.stack([JRandomMask([4], [2])(t, h, seed=seed + i) for i in range(b)])
    k = c64(rng, b, t, c, h, w) * masks
    return k, masks.astype(np.float32)


class TestWeightCarry:
    def test_conv_layouts_round_trip_port_py(self, rng):
        """Inverse of cinemri_tpu/interop/port.py::conv_w / convT_w."""
        from cinemri_tpu.interop.port import conv_w, convT_w

        conv = torch.nn.Conv2d(3, 5, 3, bias=False)
        tconv = torch.nn.ConvTranspose2d(4, 6, 2, stride=2, bias=False)
        torch.testing.assert_close(conv_weight(conv_w(conv)["kernel"]), conv.weight.detach())
        torch.testing.assert_close(conv_transpose_weight(convT_w(tconv)["kernel"]),
                                   tconv.weight.detach())


class TestDenoisers:
    @pytest.mark.parametrize("shape", [(2, 32, 32), (3, 20, 12)])
    def test_unet_matches_jax(self, rng, shape):
        n, h, w = shape
        x = rng.standard_normal((n, h, w, 2)).astype(np.float32)
        jm = JUnet(chans=4, num_pool_layers=2, in_chans=2, out_chans=2, dims=2)
        params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
        want = np.asarray(jm.apply(params, jnp.asarray(x)))
        tm = Unet(chans=4, num_pool_layers=2)
        tm.load_state_dict(unet_state_dict(to_np_tree(params)["params"], ""))
        with torch.no_grad():
            got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        assert_model_close(got, want)

    @pytest.mark.parametrize("shape", [(2, 32, 32), (2, 24, 20)])
    def test_norm_unet_matches_jax(self, rng, shape):
        x = c64(rng, *shape)
        jm = JNormUnet(chans=4, num_pools=2)
        params = jm.init(jax.random.PRNGKey(2), jc(x))
        want = j_to_numpy(jm.apply(params, jc(x)))
        tm = NormUnet(chans=4, num_pools=2)
        tm.load_state_dict(unet_state_dict(to_np_tree(params)["params"]["Unet_0"], "unet."))
        with torch.no_grad():
            got = to_numpy(tm(from_complex(x)))
        assert_model_close(got, want)

    def test_unsupported_options_raise(self, rng):
        """The packed (space-to-depth) option, once unported, builds each
        denoiser with the dense one's state dict and computes its function
        (1e-4 x max |out|; tests/test_torch_packed.py holds it against JAX)."""
        from cinemri_tpu_torch.models.denoisers import MWCNN

        x3 = torch.from_numpy(rng.standard_normal((1, 2, 8, 16, 16)).astype(np.float32))
        x2 = from_complex(c64(rng, 2, 24, 20))
        x4 = torch.from_numpy(rng.standard_normal((1, 4, 16, 16)).astype(np.float32))
        for make, x in ((lambda p: Unet(chans=4, num_pool_layers=2, dims=3, packed=p), x3),
                        (lambda p: NormUnet(4, 2, packed=p), x2),
                        (lambda p: MWCNN(4, 4, n_scales=2, n_filters_per_scale=(4, 8),
                                         n_convs_per_scale=(2, 2), packed=p), x4)):
            dense, packed = make(False), make(True)
            packed.load_state_dict(dense.state_dict())
            with torch.no_grad():
                want, got = dense(x), packed(x)
            if isinstance(want, torch.Tensor):
                want, got = want.numpy(), got.numpy()
            else:
                want, got = to_numpy(want), to_numpy(got)
            assert_model_close(got, want)


class TestEmptyLevel:
    """A U-Net level pooled from a size of 1 is empty, as in the JAX package
    (ROADMAP Queue 3, repaired): the port gives JAX's output where
    ``F.avg_pool`` and the convolutions raised."""

    @pytest.mark.parametrize("dims,shape", [(2, (2, 3, 20)), (3, (1, 3, 12, 8))])
    def test_unet_with_an_empty_level_matches_jax(self, rng, dims, shape):
        x = rng.standard_normal((*shape, 2)).astype(np.float32)
        jm = JUnet(chans=4, num_pool_layers=2, in_chans=2, out_chans=2, dims=dims)
        params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
        want = np.asarray(jm.apply(params, jnp.asarray(x)))
        tm = Unet(chans=4, num_pool_layers=2, dims=dims)
        tm.load_state_dict(unet_state_dict(to_np_tree(params)["params"], ""))
        with torch.no_grad():
            got = tm(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1).numpy()
        assert np.isfinite(got).all()
        assert_model_close(got, want)

    def test_cinenet_xf_at_three_frames_matches_jax(self):
        """Queue 3's input: CineNet-XF (1 cascade, cg 2, chans 4, pools 2) on
        a (1, 3, 2, 18, 16) volume at seed 0; its (w, t) planes have t = 3,
        pooled to 1 and then 0."""
        rng = np.random.default_rng(0)
        kw = dict(num_cascades=1, cg_iters=2, chans=4, pools=2)
        mask = JRandomMask([4], [2])(3, 18, seed=0)[None].astype(np.float32)
        k = c64(rng, 1, 3, 2, 18, 16) * mask
        s = c64(rng, 1, 1, 2, 18, 16)
        s /= np.sqrt((np.abs(s) ** 2).sum(2, keepdims=True))
        jm = j_build_model("cinenet", "XF", **kw)
        params = jm.init(jax.random.PRNGKey(0), jc(k), jnp.asarray(mask), jc(s))
        want = np.asarray(jm.apply(params, jc(k), jnp.asarray(mask), jc(s)))
        tm = build_model("cinenet", "XF", device="cpu", **kw)
        tm.load_state_dict(cinenet_state_dict(to_np_tree(params)))
        with torch.no_grad():
            got = tm(from_complex(k), torch.from_numpy(mask), from_complex(s)).numpy()
        assert got.shape == (1, 3, 18, 16) and np.isfinite(got).all()
        assert_model_close(got, want)


class TestSensitivityModel:
    @pytest.mark.parametrize("b", [1, 2])
    def test_matches_jax(self, rng, b):
        k, mask = kspace_and_mask(rng, b, 4, 3, 32, 32, seed=3)
        jm = JSensitivityModel(chans=4, num_pools=2)
        params = jm.init(jax.random.PRNGKey(3), jc(k), jnp.asarray(mask))
        want = j_to_numpy(jm.apply(params, jc(k), jnp.asarray(mask)))
        tm = SensitivityModel(chans=4, num_pools=2)
        tm.load_state_dict(unet_state_dict(
            to_np_tree(params)["params"]["NormUnet_0"]["Unet_0"], "norm_unet.unet."))
        with torch.no_grad():
            got = to_numpy(tm(from_complex(k), torch.from_numpy(mask)))
        assert got.shape == (b, 1, 3, 32, 32)
        assert_model_close(got, want)


def _varnet_pair(rng, dynamic_type, kernel_dc, shape, weight_sharing=False):
    b, t, c, h, w = shape
    k, mask = kspace_and_mask(rng, b, t, c, h, w)
    kw = dict(SMALL, kernel_dc=kernel_dc, weight_sharing=weight_sharing)
    jm = j_build_model("varnet", dynamic_type, **kw)
    params = jm.init(jax.random.PRNGKey(0), jc(k), jnp.asarray(mask))
    # random λ so each cascade's DC weight differs from the init
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(rng.standard_normal(a.shape), a.dtype)
        if getattr(p[-1], "key", None) == "lambda_reg" else a, params)
    want = np.asarray(jm.apply(params, jc(k), jnp.asarray(mask)))
    tm = build_model("varnet", dynamic_type, device="cpu", **kw)
    tm.load_state_dict(varnet_state_dict(to_np_tree(params)))
    with torch.inference_mode():
        got = tm(from_complex(k), torch.from_numpy(mask)).numpy()
    return got, want


class TestVarNet:
    @pytest.mark.parametrize("kernel_dc", [True, False])
    def test_xf_matches_jax(self, rng, kernel_dc):
        got, want = _varnet_pair(rng, "XF", kernel_dc, (1, 4, 3, 32, 32))
        assert got.shape == (1, 4, 32, 32)
        assert_model_close(got, want)

    def test_xf_non_square_batch_two(self, rng):
        got, want = _varnet_pair(rng, "XF", True, (2, 4, 3, 24, 20))
        assert_model_close(got, want)

    @pytest.mark.parametrize("weight_sharing", [False, True])
    def test_xt_matches_jax(self, rng, weight_sharing):
        got, want = _varnet_pair(rng, "XT", True, (1, 4, 3, 32, 32), weight_sharing)
        assert_model_close(got, want)

    def test_kernel_dc_equals_direct_form(self, rng):
        k, mask = kspace_and_mask(rng, 1, 4, 3, 24, 20)
        outs = []
        for kdc in (True, False):
            m = build_model("varnet", "XF", device="cpu", kernel_dc=kdc, **SMALL)
            with torch.inference_mode():
                outs.append(m(from_complex(k), torch.from_numpy(mask)).numpy())
        assert_model_close(outs[0], outs[1])


class TestBuildModel:
    def test_default_device_raises_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model("varnet", "XF", **SMALL)

    def test_not_ported_raise(self):
        """Nothing of the three families is left unported: CRNN builds for
        each (tests/test_torch_crnn.py holds it against the JAX package), and
        so do bf16 (tests/test_torch_bf16.py) and the packed layouts
        (tests/test_torch_packed.py), which keep the dense state dict."""
        for family, cls in (("varnet", VarNetRNN), ("cinenet", CineNetRNN), ("xpdnet", XPDNetRNN)):
            assert isinstance(build_model(family, "CRNN", device="cpu", num_cascades=1, chans=4), cls)
        packed = build_model("varnet", "2D", device="cpu", packed=True, **SMALL)
        assert packed.packed and packed.cascades.net.unet.packed and packed.sens_net.norm_unet.unet.packed
        dense = build_model("varnet", "2D", device="cpu", **SMALL)
        assert not dense.packed and packed.state_dict().keys() == dense.state_dict().keys()
        with pytest.raises(ValueError):
            build_model("xpdnet", "3D", device="cpu")
        with pytest.raises(ValueError):
            build_model("nope", "XF", device="cpu")
        m = build_model("varnet", "XF", device="cpu", bf16=True, **SMALL)
        assert m.bf16 and m.cascades.net_xf.unet.dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in m.parameters())
        with pytest.raises(TypeError):
            build_model("varnet", "XF", device="cpu", bf17=True)

    def test_torch_style_init(self):
        a = build_model("varnet", "XF", device="cpu", generator=torch.Generator().manual_seed(5), **SMALL)
        b = build_model("varnet", "XF", device="cpu", generator=torch.Generator().manual_seed(5), **SMALL)
        for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
            torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
        torch.testing.assert_close(a.lambda_reg.detach(), torch.full((2,), LAMBDA_INIT))
        conv = a.cascades.net_xf.unet.down[1].conv0  # 4 -> 8 channels, 3x3
        bound = 1 / math.sqrt(4 * 9)
        assert conv.weight.abs().max() <= bound and conv.weight.abs().max() > 0.9 * bound
        tconv = a.cascades.net_xf.unet.up_transpose[0].conv  # 16 -> 8, 2x2
        assert tconv.weight.abs().max() <= 1 / math.sqrt(16 * 4)
        final = a.cascades.net_xf.unet.final
        assert final.bias.abs().max() <= 1 / math.sqrt(4)

    def test_init_redraws_every_conv(self):
        m = Unet(chans=4, num_pool_layers=2)
        before = [p.clone() for p in m.parameters()]
        torch_style_init(m, torch.Generator().manual_seed(0))
        assert all(not torch.equal(p, q) for p, q in zip(m.parameters(), before))

    def test_constructor_rejects_unknown_type(self):
        with pytest.raises(ValueError):
            VarNet(dynamic_type="CRNN")
