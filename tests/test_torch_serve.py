"""Port serving entry, the ``torch.export`` artifact, the kernels' custom
ops and the mask generators on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cinemri_tpu.data import masks as JM
from cinemri_tpu.models import build_model as j_build_model
from cinemri_tpu.ops.cplx import Complex as JComplex
from cinemri_tpu.serve import export_model as j_export_model
from cinemri_tpu.serve import load_exported as j_load_exported

from cinemri_tpu_torch import resolve_device
from cinemri_tpu_torch.data import masks as TM
from cinemri_tpu_torch.interop.flax_params import cinenet_state_dict, varnet_state_dict
from cinemri_tpu_torch.models import build_model
from cinemri_tpu_torch.ops import fft as TF
from cinemri_tpu_torch.ops.cplx import Complex
from cinemri_tpu_torch.ops.kernels import dft_cuda, fft2_cuda, normal_cuda
from cinemri_tpu_torch.serve import bind_model, export_model, load_exported, serial_batch

torch.set_num_threads(2)

SMALL = dict(num_cascades=2, sens_chans=4, sens_pools=2, chans=4, pools=2)


class TestMasks:
    @pytest.mark.parametrize("seed", [0, 1, 7])
    def test_random_mask_equals_jax(self, seed):
        got = TM.RandomMask([10], [4])(15, 200, seed=seed)
        want = JM.RandomMask([10], [4])(15, 200, seed=seed)
        assert got.shape == (15, 1, 200, 1)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("seed", [0, 3])
    def test_equispaced_mask_equals_jax(self, seed):
        got = TM.EquispacedMask([0.08], [4])(15, 200, seed=seed)
        want = JM.EquispacedMask([0.08], [4])(15, 200, seed=seed)
        assert got.shape == (1, 1, 200, 1)
        np.testing.assert_array_equal(got, want)

    def test_factory_and_errors_equal_jax(self):
        for kind in ("random", "equispaced"):
            got = TM.create_mask_for_mask_type(kind, [0.08, 0.04], [4, 8])(4, 64, seed=2)
            want = JM.create_mask_for_mask_type(kind, [0.08, 0.04], [4, 8])(4, 64, seed=2)
            np.testing.assert_array_equal(got, want)
        with pytest.raises(ValueError):
            TM.create_mask_for_mask_type("radial", [0.08], [4])
        with pytest.raises(ValueError):
            TM.RandomMask([40], [4])(2, 64, seed=0)


def _request(b, seed):
    rng = np.random.default_rng(seed)
    shape = (b, 4, 3, 24, 20)
    k = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    mask = np.stack([TM.RandomMask([4], [2])(4, 24, seed=seed + i) for i in range(b)]).astype(np.float32)
    k = k * mask
    return k.real.astype(np.float32), k.imag.astype(np.float32), mask


class TestServe:
    def test_request_equals_direct_forward(self):
        model = build_model("varnet", "XF", device="cpu", **SMALL)
        kre, kim, mask = _request(1, 0)
        with torch.inference_mode():
            want = model(Complex(torch.from_numpy(kre), torch.from_numpy(kim)), torch.from_numpy(mask))
        serve = bind_model(model, device="cpu")
        got = serve(kre, kim, mask)
        assert got.dtype == torch.float32 and got.shape == (1, 4, 24, 20)
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    def test_batch_is_served_one_volume_at_a_time(self):
        model = build_model("varnet", "XF", device="cpu", **SMALL)
        serve = bind_model(model, state_dict=model.state_dict(), device="cpu")
        kre, kim, mask = _request(2, 5)
        got = serve(kre, kim, mask)
        for i in range(2):
            one = serve(kre[i : i + 1], kim[i : i + 1], mask[i : i + 1])
            torch.testing.assert_close(got[i : i + 1], one, rtol=0, atol=0)

    def test_serial_batch(self):
        fn = serial_batch(lambda a, b: a * 2 + b)
        a, b = torch.arange(6.0).reshape(3, 2), torch.ones(3, 2)
        torch.testing.assert_close(fn(a, b), a * 2 + b)

    def test_default_device_raises_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        model = build_model("varnet", "XF", device="cpu", **SMALL)
        with pytest.raises(RuntimeError, match="CUDA"):
            bind_model(model)
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        assert resolve_device("cpu") == torch.device("cpu")


class TestServeThenTrain:
    def test_backward_after_a_served_request(self):
        """A request served under inference mode builds the DFT-matrix cache;
        a later backward pass through ``ifft2c`` at the same size must be
        able to save those matrices for backward."""
        from cinemri_tpu_torch.ops import fft as TF

        TF._dft_tensors.cache_clear()
        TF._dft_adjoint_tensors.cache_clear()
        model = build_model("varnet", "XF", device="cpu", **SMALL)
        serve = bind_model(model, device="cpu")
        kre, kim, mask = _request(1, 3)
        assert serve(kre, kim, mask).shape == (1, 4, 24, 20)
        x = Complex(torch.randn(2, 24, 20, requires_grad=True), torch.randn(2, 24, 20))
        y = TF.ifft2c(x)
        (y.re.square().sum() + y.im.square().sum()).backward()
        # ifft2c is unitary: the gradient of ‖ifft2c(x)‖² in x_re is 2·x_re
        torch.testing.assert_close(x.re.grad, 2 * x.re.detach(), rtol=1e-4, atol=1e-4)
        # and serving again after training still works and gives the same image
        torch.testing.assert_close(serve(kre, kim, mask), serve(kre, kim, mask), rtol=0, atol=0)


# (id, family, the small config, batch, serial, with maps)
_EXPORTS = [
    ("varnet-XF", "varnet", SMALL, 1, False),
    ("cinenet-XF-maps", "cinenet", dict(num_cascades=2, cg_iters=3, chans=4, pools=2), 1, False),
    ("varnet-XF-serial-b2", "varnet", SMALL, 2, True),
]


@pytest.mark.parametrize("family, config, b, serial", [c[1:] for c in _EXPORTS],
                         ids=[c[0] for c in _EXPORTS])
def test_exported_artifact_matches_jax_and_bind_model(tmp_path, family, config, b, serial):
    """The port's artifact (``export_model`` -> bytes and a file ->
    ``load_exported``) against the JAX package's artifact on the same
    weights (carried by ``flax_params``) and inputs, within 1e-4 x max |out|
    (the model tolerance of tests/test_torch_models.py), and equal to
    ``bind_model`` bit for bit."""
    kre, kim, mask = _request(b, 11)
    maps = family == "cinenet"
    rng = np.random.default_rng(12)
    s = (rng.standard_normal((b, 1, 3, 24, 20)) + 1j * rng.standard_normal((b, 1, 3, 24, 20)))
    s = (s / np.sqrt((np.abs(s) ** 2).sum(2, keepdims=True))).astype(np.complex64)
    sens = (s.real.astype(np.float32), s.imag.astype(np.float32)) if maps else ()

    jm = j_build_model(family, "XF", **config)
    jk, jmask = JComplex(jnp.asarray(kre), jnp.asarray(kim)), jnp.asarray(mask)
    jsens = JComplex(*map(jnp.asarray, sens)) if maps else None
    params = jm.init(jax.random.PRNGKey(4), jk, jmask, *([jsens] if maps else []))
    blob = j_export_model(jm, params, jk, jmask, sens_maps=jsens, serial=serial)
    want = np.asarray(j_load_exported(blob)(kre, kim, mask, *sens))

    model = build_model(family, "XF", device="cpu", **config)
    carry = cinenet_state_dict if maps else varnet_state_dict
    state_dict = carry(jax.tree.map(np.asarray, params))
    k = Complex(torch.from_numpy(kre), torch.from_numpy(kim))
    s_t = Complex(*map(torch.from_numpy, sens)) if maps else None
    path = tmp_path / "served.pt2"
    data = export_model(model, state_dict, k, torch.from_numpy(mask), path=path, sens_maps=s_t,
                        serial=serial)
    assert path.read_bytes() == data
    got = load_exported(data)(kre, kim, mask, *sens)
    assert got.dtype == torch.float32 and got.shape == (b, 4, 24, 20)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    torch.testing.assert_close(load_exported(path)(kre, kim, mask, *sens), got, rtol=0, atol=0)
    torch.testing.assert_close(bind_model(model, device="cpu")(kre, kim, mask, *sens), got,
                               rtol=0, atol=0)


def _op_args(name):
    """Operands of each custom op at a small shape, x requiring grad where
    the op has a gradient."""
    g = torch.Generator().manual_seed(0)
    r = lambda *shape, grad=False: torch.randn(*shape, generator=g).requires_grad_(grad)
    cpu = torch.device("cpu")
    if name == "dft_matmul":
        mats = TF._dft_tensors(8, False, False, "ortho", cpu) + TF._dft_adjoint_tensors(
            8, False, False, "ortho", cpu)
        return dft_cuda.dft_matmul_op, (r(2, 8, 5, grad=True), r(2, 8, 5, grad=True), *mats, False)
    b, t, c, h, w = 1, 3, 2, 6, 5
    if name == "normal_apply":
        return normal_cuda.normal_apply_op, (
            r(b, t, h, w, grad=True), r(b, t, h, w, grad=True), r(b, t, h, h), r(b, t, h, h),
            r(b, c, h, w, grad=True), r(b, c, h, w, grad=True),
            torch.tensor([0.3], requires_grad=True), False)
    if name == "normal_apply_bwd":
        return normal_cuda.normal_apply_bwd_op, (
            r(b, t, h, w), r(b, t, h, w), r(b, t, h, w), r(b, t, h, w), r(b, 1, h, h),
            r(b, 1, h, h), r(b, c, h, w), r(b, c, h, w), torch.tensor([0.3]), False)
    return fft2_cuda.fft2_plane_op, (r(2, 4, 6), r(2, 4, 6), r(4, 4), r(4, 4), r(6, 6), r(6, 6))


@pytest.mark.parametrize("name", ["dft_matmul", "normal_apply", "normal_apply_bwd", "fft2_plane"])
def test_custom_op_passes_opcheck(name):
    """``torch.library.opcheck`` on each ``torch.ops.cinemri`` op: its
    schema, fake implementation, autograd registration and tracing."""
    op, args = _op_args(name)
    torch.library.opcheck(op, args)
