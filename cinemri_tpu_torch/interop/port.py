"""Weight movers: reference torch module trees -> the flax-layout tree.

The port's own copy of ``cinemri_tpu/interop/port.py`` (numpy only; nothing
of the JAX package is imported). Each function accepts either a live torch
module of the reference or a :class:`~cinemri_tpu_torch.interop.
torch_import._Node` pseudo-module rebuilt from a checkpoint's
``state_dict``; both expose ``.weight`` / ``.bias`` leaves whose
``.detach().numpy()`` gives the array, plus the child-module attributes the
reference architecture defines. The result is the JAX package's parameter
tree (nested dicts of numpy arrays, flax layouts), which
:mod:`cinemri_tpu_torch.interop.flax_params` turns into the port's state
dict: conv and transpose-conv layouts change there and back, exactly, so
the import through both is bit-exact. Structure knowledge is keyed to the
reference sources (cited per function).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "conv_w",
    "convT_w",
    "convblock_params",
    "transposeblock_params",
    "unet_params",
    "norm_unet_params",
    "sens_model_params",
    "mwcnn_params",
    "kspace_cnn_params",
    "fused_conv_w",
    "fused_name",
    "crnn_trunk_params",
]


def _np(t) -> np.ndarray:
    """Array out of a torch tensor or a checkpoint leaf, decoupled from the
    source buffer (in-place torch optimizer steps must not mutate exports)."""
    return np.asarray(t.detach().numpy()).copy()


def conv_w(m) -> dict:
    """torch ConvNd -> flax Conv params (OIHW/OIDHW -> HWIO/DHWIO)."""
    w = _np(m.weight)
    axes = tuple(range(2, w.ndim)) + (1, 0)
    out = {"kernel": np.ascontiguousarray(np.transpose(w, axes))}
    bias = getattr(m, "bias", None)
    if bias is not None:
        out["bias"] = _np(bias)
    return out


def convT_w(m) -> dict:
    """torch ConvTransposeNd -> flax ConvTranspose params.

    torch stores (I, O, *k) and computes a correlation of the dilated input
    with the *flipped* kernel; flax's ConvTranspose (transpose_kernel=False)
    uses the unflipped kernel, so flip all spatial axes.
    """
    w = _np(m.weight)
    spatial = tuple(range(2, w.ndim))
    w = np.flip(w, axis=spatial)
    axes = spatial + (0, 1)
    return {"kernel": np.ascontiguousarray(np.transpose(w, axes))}


def convblock_params(tcb) -> dict:
    """reference ConvBlock (unet.py:128-182): convs at layers[0], layers[4]."""
    return {"Conv_0": conv_w(tcb.layers[0]), "Conv_1": conv_w(tcb.layers[4])}


def transposeblock_params(tb) -> dict:
    return {"ConvTranspose_0": convT_w(tb.layers[0])}


def unet_params(tunet) -> dict:
    """reference Unet (unet.py:6-125) -> flax Unet params['params'] dict."""
    p = {}
    pools = len(tunet.down_sample_layers)
    for j, blk in enumerate(tunet.down_sample_layers):
        p[f"ConvBlock_{j}"] = convblock_params(blk)
    p[f"ConvBlock_{pools}"] = convblock_params(tunet.conv)
    for i in range(pools):
        p[f"TransposeConvBlock_{i}"] = transposeblock_params(tunet.up_transpose_conv[i])
        if i < pools - 1:
            p[f"ConvBlock_{pools + 1 + i}"] = convblock_params(tunet.up_conv[i])
        else:
            seq = tunet.up_conv[i]
            p[f"ConvBlock_{2 * pools}"] = convblock_params(seq[0])
            p["Conv_0"] = conv_w(seq[1])
    return p


def norm_unet_params(tnu) -> dict:
    """reference NormUnet / NormUnet3D (norm_unet.py) wraps one Unet."""
    return {"Unet_0": unet_params(tnu.unet)}


def sens_model_params(tsm) -> dict:
    """reference varnet.SensitivityModel (varnet.py:14-86) -> flax params."""
    return {"NormUnet_0": norm_unet_params(tsm.norm_unet)}


def mwcnn_params(tm) -> dict:
    """reference MWCNN (mwcnn.py:8-179) -> flax MWCNN params.

    Flax modules are named in creation order (MWConvBlock_0..N + the plain
    final Conv_0); the reference's construction gives ``first_convs`` exactly
    2*n_first_convs entries (the last a plain conv, mwcnn.py:66-80) and
    ``conv_blocks_per_scale[i]`` exactly 2*n_convs_per_scale[i], so the
    structural counts are derived from the lists themselves and work for
    both live modules and checkpoint trees.
    """
    p = {}
    idx = 0

    def add_block(tcb):
        nonlocal idx
        p[f"MWConvBlock_{idx}"] = {"Conv_0": conv_w(tcb.layers[0])}
        idx += 1

    first_convs = getattr(tm, "first_convs", None)
    n_first = len(first_convs) // 2 if first_convs is not None else 0
    n_scales = len(tm.conv_blocks_per_scale)
    if n_first > 0:
        for blk in first_convs[:n_first]:
            add_block(blk)
    for i_scale in range(n_scales):
        scale = tm.conv_blocks_per_scale[i_scale]
        for blk in scale[: len(scale) // 2]:
            add_block(blk)
    plain = {}
    for i_scale in range(n_scales - 1, -1, -1):
        scale = tm.conv_blocks_per_scale[i_scale]
        n = len(scale) // 2
        for k, blk in enumerate(scale[n:]):
            is_last = i_scale == 0 and k == n - 1
            if is_last and n_first < 1:
                plain["Conv_0"] = conv_w(blk)  # replaced by plain conv
            else:
                add_block(blk)
    if n_first > 0:
        for blk in first_convs[n_first:-1]:
            add_block(blk)
        plain["Conv_0"] = conv_w(first_convs[-1])
    p.update(plain)
    return p


def kspace_cnn_params(tknet) -> dict:
    """reference KSpaceCNN (kspace_net.py:6-61): Sequential of Conv3d+ReLU."""
    convs = [m for m in tknet.layers if getattr(m, "weight", None) is not None]
    return {f"Conv_{i}": conv_w(m) for i, m in enumerate(convs)}


def fused_conv_w(*mods) -> dict:
    """Sum-of-convs -> the framework's fused single conv: kernels concatenate
    along the input-channel axis (matching the input concat order) and
    biases sum (the JAX package's ``crnn.fused_sum_conv``; the port's ``FusedSumConv2d``)."""
    parts = [conv_w(m) for m in mods]
    out = {"kernel": np.concatenate([p["kernel"] for p in parts], axis=-2)}
    if "bias" in parts[0]:
        out["bias"] = np.sum([p["bias"] for p in parts], axis=0)
    return out


def fused_name(base: str, *mods) -> str:
    """Fused-conv module name with the ``__f<sizes>`` input-slice suffix
    (crnn.fused_sum_conv naming convention)."""
    sizes = [m.weight.shape[1] for m in mods]
    return f"{base}__f{'_'.join(str(s) for s in sizes)}"


def crnn_trunk_params(tmodel) -> dict:
    """reference *_RNN conv trunk + BCRNN -> flax CRNNTrunk params
    (recurrent_varnet.py:49-58 and the twins in recurrent_cinenet/xpdnet)."""
    cell = tmodel.bcrnn.CRNN_model
    return {
        "bcrnn": {
            "cell": {
                # fused conv input order: (x, hidden_time, hidden_iteration)
                fused_name("i2h_h2h_ih2ih", cell.i2h, cell.h2h, cell.ih2ih):
                    fused_conv_w(cell.i2h, cell.h2h, cell.ih2ih),
            }
        },
        fused_name("conv1_xh", tmodel.conv1_x, tmodel.conv1_h):
            fused_conv_w(tmodel.conv1_x, tmodel.conv1_h),
        fused_name("conv2_xh", tmodel.conv2_x, tmodel.conv2_h):
            fused_conv_w(tmodel.conv2_x, tmodel.conv2_h),
        fused_name("conv3_xh", tmodel.conv3_x, tmodel.conv3_h):
            fused_conv_w(tmodel.conv3_x, tmodel.conv3_h),
        "conv4_x": conv_w(tmodel.conv4_x),
    }
