"""The remat saving policies of the port (``models/remat.py``) on the CPU.

Each policy changes only what the backward recomputes, so the loss and the
gradients equal those of full replay (``""``) and of no remat at the JAX
package's tolerance (``tests/test_models.py``: loss rel 1e-6, gradients
rtol 1e-5, atol 1e-7): VarNet-XF for every policy, VarNet-CRNN for
``"convs"``. Selective checkpointing sees the ``cinemri`` custom ops (the
DFT under ``"dots"``, the normal apply under ``"dots_batch"``), and the
count of outputs kept grows as the policy keeps more.
"""

import numpy as np
import pytest
import torch

from cinemri_tpu_torch.models import build_model, remat
from cinemri_tpu_torch.ops.cplx import from_complex
from cinemri_tpu_torch.ops.ssim import ssim_loss

torch.set_num_threads(2)

B, T, C, H, W = 1, 4, 3, 24, 16
SMALL = dict(num_cascades=2, sens_chans=4, sens_pools=2, chans=4, pools=2)
CRNN_SMALL = dict(num_cascades=2, sens_chans=4, sens_pools=2, chans=6)


def _batch():
    rng = np.random.default_rng(0)
    k = (rng.standard_normal((B, T, C, H, W)) + 1j * rng.standard_normal((B, T, C, H, W))).astype(np.complex64)
    m = np.zeros((B, T, 1, H, 1), np.float32)
    m[:, :, :, H // 2 - 3: H // 2 + 3] = 1
    m[:, :, :, 2] = 1
    m[:, :, :, H - 3] = 1
    return from_complex(k * m), torch.from_numpy(m), torch.from_numpy(np.abs(k[:, :, 0]))


def _loss_and_grads(dyn, kw, **flags):
    """The SSIM loss and every gradient of one forward and backward, and the
    outputs each policy kept (``remat.SAVED``) in them."""
    k, m, target = _batch()
    model = build_model("varnet", dyn, device="cpu", generator=torch.Generator().manual_seed(0),
                        **kw, **flags)
    before = dict(remat.SAVED)
    loss = ssim_loss(model(k, m), target)
    loss.backward()
    saved = {p: remat.SAVED[p] - before[p] for p in remat.REMAT_POLICIES}
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}, saved


def _assert_same(a, b):
    assert a[0] == pytest.approx(b[0], rel=1e-6)
    for name, g in a[1].items():
        np.testing.assert_allclose(g.numpy(), b[1][name].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=name)


@pytest.fixture(scope="module")
def varnet_xf():
    """VarNet-XF without remat, with full replay, and under each policy."""
    runs = {"none": _loss_and_grads("XF", SMALL, remat=False)}
    for policy in remat.REMAT_POLICIES:
        runs[policy] = _loss_and_grads("XF", SMALL, remat_policy=policy, remat_prevent_cse=False)
    return runs


@pytest.mark.parametrize("policy", ["dots", "dots_batch", "convs"])
def test_policy_equals_full_replay_and_no_remat(varnet_xf, policy):
    _assert_same(varnet_xf[policy], varnet_xf[""])
    _assert_same(varnet_xf[policy], varnet_xf["none"])


def test_kept_outputs_grow_with_the_policy(varnet_xf):
    """Full replay keeps nothing; "dots" keeps the DFT custom op's outputs
    (the kernel-DC cascade's temporal fft1c / ifft1c pair); "dots_batch"
    those and the normal apply's (one a cascade); "convs" the tagged U-Net
    convolutions (2 plane nets x 12 a cascade at 2 pools: not the final 1x1,
    as in the JAX package)."""
    kept = {p: varnet_xf[p][2][p] for p in remat.REMAT_POLICIES}
    assert kept[""] == 0 and all(varnet_xf[p][2][""] == 0 for p in remat.REMAT_POLICIES)
    n = SMALL["num_cascades"]
    assert kept["dots"] == 2 * n
    assert kept["dots_batch"] == kept["dots"] + n
    assert kept["convs"] == n * 2 * 12


def test_crnn_convs_policy_equals_full_replay():
    """VarNet-CRNN under "convs": the BCRNN cell's and the trunk's fused
    convolutions kept, loss and gradients as full replay's and as no
    remat's."""
    convs = _loss_and_grads("CRNN", CRNN_SMALL, remat_policy="convs")
    _assert_same(convs, _loss_and_grads("CRNN", CRNN_SMALL))
    _assert_same(convs, _loss_and_grads("CRNN", CRNN_SMALL, remat=False))
    # per iteration: the cell's T steps (both directions in one batched
    # sweep) and conv1..conv4
    assert convs[2]["convs"] == CRNN_SMALL["num_cascades"] * (T + 4)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        build_model("varnet", "XF", device="cpu", remat_policy="everything", **SMALL)
