"""The DFT precision modes of the port on the CPU.

``'high'`` (3xTF32) and ``'default'`` (1xTF32) are what the CUDA kernels
compute on the tensor cores (``csrc/cgemm_tf32.cuh``); on the CPU the
wrappers run their plain versions, which round the operands as
``cvt.rna.tf32.f32`` does and take the same partial products in f32
(``ops/kernels/precision.py``). Held against float64 here: ``'high'`` within
4x the ``'highest'`` plain version's own error, ``'default'`` within
5e-3 x max |out|. On the card, ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` ``[precision]`` hold each kernel against these plain
versions. The setting (``ops/fft.py::set_dft_precision``) takes the JAX
package's strings and ``CINEMRI_DFT_PRECISION``; a VarNet-XF forward at
``'high'`` is held against the JAX package's at ``'high'`` (exact f32 on the
CPU) within the emulation's error.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cinemri_tpu.models import build_model as j_build_model
from cinemri_tpu.ops import fft as JF
from cinemri_tpu.ops.cplx import Complex as JComplex

from cinemri_tpu_torch.interop.flax_params import varnet_state_dict
from cinemri_tpu_torch.models import build_model
from cinemri_tpu_torch.ops import fft as TF
from cinemri_tpu_torch.ops.cplx import Complex, from_complex
from cinemri_tpu_torch.ops.kernels import dft_cuda, normal_cuda
from cinemri_tpu_torch.ops.kernels import precision as P
from cinemri_tpu_torch.physics.operators import masked_normal_kernel

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
MODES = ("highest", "high", "default")


@pytest.fixture
def restore_precision():
    yield
    TF.set_dft_precision("highest")
    JF.set_dft_precision("highest")


def _f64_err(got, ref):
    return max((g.double() - r).abs().max().item() for g, r in zip(got, ref))


def _check_modes(errs, scale):
    assert errs["high"] <= 4 * errs["highest"], errs
    assert errs["default"] <= 5e-3 * scale, (errs, scale)
    assert errs["default"] > errs["high"]  # the mode took effect


class TestTF32Round:
    def test_rounds_half_away_from_zero_to_10_bits(self):
        one = 1.0
        ulp = 2.0 ** -10
        x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -23,
                          one + 3 * ulp / 2, 0.0, -0.0, 2.0 ** -130], dtype=torch.float32)
        want = [one + ulp, -(one + ulp), one, one + 2 * ulp, 0.0, -0.0]
        got = P.tf32_round(x)
        assert got[:6].tolist() == want
        assert torch.signbit(got[5])

    def test_keeps_10_mantissa_bits_and_splits_exactly(self, rng):
        x = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.integers(-8, 8, 4096))
                             .astype(np.float32))
        hi, lo = P.split(x, "high")
        assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
        assert ((hi - x).abs() <= 2.0 ** -11 * x.abs()).all()
        assert ((hi.double() + lo.double() - x.double()).abs() <= 2.0 ** -21 * x.abs().double()).all()
        assert P.split(x, "default")[1] is None


@pytest.mark.parametrize("o, n, i", [(4, 200, 1), (3, 40, 20), (50, 15, 1), (1, 15, 400)])
def test_dft_plain_versions_against_float64(rng, o, n, i):
    """N <= 16 (the temporal transforms) is full f32 in every mode, as the
    kernel's N <= 16 instance is."""
    wr, wi = TF._dft_tensors(n, False, False, "ortho", torch.device("cpu"))
    xr = torch.from_numpy(rng.standard_normal((o, n, i)).astype(np.float32))
    xi = torch.from_numpy(rng.standard_normal((o, n, i)).astype(np.float32))
    w = torch.complex(wr.double(), wi.double())
    ref = torch.einsum("jk,oki->oji", w, torch.complex(xr.double(), xi.double()))
    outs = {p: dft_cuda.complex_dft_matmul(xr, xi, wr, wi, p) for p in MODES}
    if n <= dft_cuda.SMALL_N:
        for p in ("high", "default"):
            assert all(torch.equal(a, b) for a, b in zip(outs[p], outs["highest"]))
        return
    errs = {p: _f64_err(outs[p], (ref.real, ref.imag)) for p in MODES}
    _check_modes(errs, ref.abs().max().item())


def _normal_operands(rng, b=1, t=3, c=2, h=24, w=16):
    from cinemri_tpu.data.masks import RandomMask

    mask = torch.from_numpy(np.stack([RandomMask([4], [2])(t, h, seed=i) for i in range(b)])
                            .astype(np.float32))
    k = masked_normal_kernel(mask)
    arr = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    x = (arr(b, t, h, w), arr(b, t, h, w))
    g = (arr(b, t, h, w), arr(b, t, h, w))
    s = (0.5 * arr(b, c, h, w), 0.5 * arr(b, c, h, w))
    return x, g, (k.re.contiguous(), k.im.contiguous()), s


def test_normal_apply_plain_versions_against_float64(rng):
    """The forward and the backward (x̄, s̄) at each mode; the float64
    reference is the 'highest' plain version on float64 operands."""
    x, g, k, s = _normal_operands(rng)
    d = lambda pair: tuple(a.double() for a in pair)
    fwd_ref = normal_cuda.normal_apply_torch(*d(x), *d(k), *d(s), 0.25)
    bwd_ref = normal_cuda.normal_apply_bwd_torch(*d(x), *d(g), *d(k), *d(s), 0.25)
    fwd, xbar, sbar = {}, {}, {}
    for p in MODES:
        fwd[p] = _f64_err(normal_cuda.normal_apply(*x, *k, *s, 0.25, p), fwd_ref)
        got = normal_cuda.normal_apply_bwd(*x, *g, *k, *s, 0.25, p)
        xbar[p], sbar[p] = _f64_err(got[:2], bwd_ref[:2]), _f64_err(got[2:4], bwd_ref[2:4])
        # the passes as the kernels run them compute the same
        passes = normal_cuda.normal_apply_passes(*x, *k, *s, 0.25, precision=p)
        for a, b_ in zip(passes, normal_cuda.normal_apply(*x, *k, *s, 0.25, p)):
            torch.testing.assert_close(a, b_, rtol=0, atol=1e-6 * b_.abs().max().item())
    _check_modes(fwd, max(a.abs().max().item() for a in fwd_ref))
    _check_modes(xbar, max(a.abs().max().item() for a in bwd_ref[:2]))
    _check_modes(sbar, max(a.abs().max().item() for a in bwd_ref[2:4]))


class TestSetting:
    def test_strings_case_insensitive(self, restore_precision):
        for given, want in (("HIGH", "high"), ("Default", "default"), ("highest", "highest")):
            TF.set_dft_precision(given)
            assert TF.get_dft_precision() == want
        with pytest.raises(ValueError, match="highest"):
            TF.set_dft_precision("bf16")
        assert TF.get_dft_precision() == "highest"

    def test_environment_read_at_import(self):
        env = dict(os.environ, CINEMRI_DFT_PRECISION="High", PYTHONPATH=str(ROOT))
        code = "from cinemri_tpu_torch.ops import fft; print(fft.get_dft_precision())"
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                             cwd=str(ROOT), timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip().splitlines()[-1] == "high"

    def test_the_ops_carry_the_mode_into_their_backward(self, rng, restore_precision):
        """A DFT and a normal apply at 'default' under autograd: the forward
        and the gradient equal the plain versions at 'default' (x̄ = Wᴴ ȳ
        in the DFT's case), not those at 'highest'."""
        TF.set_dft_precision("default")
        xr = torch.from_numpy(rng.standard_normal((2, 24, 6)).astype(np.float32)).requires_grad_()
        xi = torch.zeros_like(xr, requires_grad=True)
        y = TF.fft1c(Complex(xr, xi), axis=1)
        gr = torch.from_numpy(rng.standard_normal((2, 24, 6)).astype(np.float32))
        (y.re * gr).sum().backward()
        whr, whi = TF._dft_adjoint_tensors(24, False, False, "ortho", torch.device("cpu"))
        want = dft_cuda.complex_dft_matmul_torch(gr, torch.zeros_like(gr), whr, whi, "default")[0]
        assert torch.equal(xr.grad, want)
        highest = dft_cuda.complex_dft_matmul_torch(gr, torch.zeros_like(gr), whr, whi)[0]
        assert not torch.equal(xr.grad, highest)

        x, g, k, s = _normal_operands(rng)
        xr, xi = (a.clone().requires_grad_() for a in x)
        out = normal_cuda.NormalApply.apply(xr, xi, *k, *s, 0.25, False, "default")
        (out[0] * g[0] + out[1] * g[1]).sum().backward()
        want = normal_cuda.normal_apply_bwd_torch(*x, *g, *k, *s, 0.25, "default")
        assert torch.equal(xr.grad, want[0]) and torch.equal(xi.grad, want[1])


def test_varnet_xf_forward_at_high_matches_jax(rng, restore_precision):
    """VarNet-XF (2 cascades, chans 4, pools 2) at 'high' on both sides: the
    JAX package computes exact f32 on the CPU whatever the precision, the
    port emulates 3xTF32. The port's output lies within the model tolerance
    (1e-4 x max) of JAX's, no farther than the emulation moves the port's own
    output from 'highest' plus the f32 gap at 'highest'."""
    from cinemri_tpu.data.masks import RandomMask

    small = dict(num_cascades=2, sens_chans=4, sens_pools=2, chans=4, pools=2)
    b, t, c, h, w = 1, 4, 3, 24, 16
    mask = np.stack([RandomMask([4], [2])(t, h, seed=0)]).astype(np.float32)
    k = ((rng.standard_normal((b, t, c, h, w)) + 1j * rng.standard_normal((b, t, c, h, w)))
         .astype(np.complex64) * mask)
    jm = j_build_model("varnet", "XF", **small)
    jk = JComplex(jnp.asarray(k.real), jnp.asarray(k.imag))
    params = jm.init(jax.random.PRNGKey(0), jk, jnp.asarray(mask))
    JF.set_dft_precision("high")
    want = np.asarray(jm.apply(params, jk, jnp.asarray(mask)))
    tm = build_model("varnet", "XF", device="cpu", **small)
    tm.load_state_dict(varnet_state_dict(jax.tree.map(np.asarray, params)))
    outs = {}
    for p in ("highest", "high"):
        TF.set_dft_precision(p)
        with torch.inference_mode():
            outs[p] = tm(from_complex(k), torch.from_numpy(mask)).numpy()
    scale = np.abs(want).max()
    gap = np.abs(outs["high"] - want).max()
    emulation = np.abs(outs["high"] - outs["highest"]).max()
    assert emulation > 0  # the port did emulate
    assert gap <= emulation + np.abs(outs["highest"] - want).max()
    assert gap <= 1e-4 * scale
