"""Port serving entry and mask generators on the CPU."""

import numpy as np
import pytest
import torch

from cinemri_tpu.data import masks as JM

from cinemri_tpu_torch import resolve_device
from cinemri_tpu_torch.data import masks as TM
from cinemri_tpu_torch.models import build_model
from cinemri_tpu_torch.ops.cplx import Complex
from cinemri_tpu_torch.serve import bind_model, serial_batch

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
