"""VarNet-XF.

Sensitivity maps: the time-mean k-space kept on the central band of rows
found from frame 0 of the mask (``left`` the last unsampled row before ``h //
2``, ``right`` the first unsampled row from it, ``num_low = right - left``,
the band ``[(h - num_low + 1) // 2, ... + num_low)``), its centered inverse
2-D DFT, a normalized U-Net per coil, divided by the coils' root sum of
squares. ``x_ref = Σ_c conj(S_c) F⁻¹ k_c``, ``R0 = Σ_c |S_c|²``. Each cascade
``i`` regularizes the image ``z`` with normalized U-Nets over the XF planes
and takes the data-consistency step in image space ``R0·z − α·N(z) +
α·x_ref``, ``α = v / (1 + v)``, ``v = softplus(λ_i)``. Output ``|z|``.

Shapes: k-space ``(b, t, c, h, w)`` complex, line mask ``(b, t, 1, h, 1)``,
image ``(b, t, h, w)`` real.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cinebench.reference.fourier import ifft2c, normal_kernel
from cinebench.reference.nets import norm_unet
from cinebench.reference.xf import normal_op, xf_regularizer

DYNAMIC_TYPES = ("XF",)

__all__ = ["forward", "flop", "sens_maps"]


def _band(mask: torch.Tensor) -> torch.Tensor:
    """``(b, 1, 1, h, 1)`` 0/1 rows of each sample's central band."""
    m = mask[:, 0, 0, :, 0]  # (b, h)
    h = m.shape[-1]
    idx = torch.arange(h, device=m.device)
    zero = m == 0
    left = torch.where(zero & (idx < h // 2), idx, -1).amax(dim=-1)
    right = torch.where(zero & (idx >= h // 2), idx, h).amin(dim=-1)
    num_low = right - left
    pad = torch.div(h - num_low + 1, 2, rounding_mode="floor")
    band = (idx >= pad[:, None]) & (idx < (pad + num_low)[:, None])
    return band.to(torch.float32)[:, None, None, :, None]


def sens_maps(k: torch.Tensor, mask: torch.Tensor, p: dict, pools: int) -> torch.Tensor:
    """``(b, c, h, w)`` maps from the masked k-space."""
    b, _, c, h, w = k.shape
    low = (k * _band(mask)).mean(dim=1)  # (b, c, h, w)
    x = norm_unet(ifft2c(low).reshape(b * c, h, w), p, "sens_net.norm_unet.unet", pools)
    x = x.reshape(b, c, h, w)
    return x / x.abs().square().sum(dim=1, keepdim=True).sqrt()


def forward(cfg: dict, p: dict, k: torch.Tensor, mask: torch.Tensor, maps=None) -> torch.Tensor:
    model = cfg["model"]
    maps = sens_maps(k, mask, p, model["sens_pools"])
    kernel = normal_kernel(mask, k.dtype)
    r0 = maps.abs().square().sum(dim=1, keepdim=True)  # (b, 1, h, w)
    x_ref = (ifft2c(k) * maps.conj()[:, None]).sum(dim=2)  # (b, t, h, w)

    def net(planes, name):
        return norm_unet(planes, p, f"{name}.unet", model["pools"])

    z = x_ref
    for i in range(model["num_cascades"]):
        out = xf_regularizer(z, net, "cascades")
        v = F.softplus(p["lambda_reg"][i])
        alpha = v / (1 + v)
        z = out * r0 - alpha * normal_op(out, kernel, maps) + alpha * x_ref
    return z.abs()


def flop(cfg: dict) -> float:
    """One volume's forward (``harness/flops.py``): the sens net's 2-D DFT
    and U-Net over the coils (padded to 16), ``x_ref``'s DFTs, the normal
    kernels, and per cascade the temporal DFTs, the two plane U-Nets (padded
    to 16) and one normal apply."""
    from cinebench.harness.flops import dft2_flop, dft_flop, kernel_flop, normal_apply_flop, pad16, unet_flop

    m, t, c, h, w = cfg["model"], cfg["frames"], cfg["coils"], cfg["height"], cfg["width"]
    head = (dft2_flop(c, h, w) + unet_flop(c, (pad16(h), pad16(w)), m["sens_chans"], m["sens_pools"])
            + dft2_flop(t * c, h, w) + kernel_flop(t, h))
    cascade = (2 * dft_flop(1, t, h * w)
               + unet_flop(h, (pad16(w), pad16(t)), m["chans"], m["pools"])
               + unet_flop(w, (pad16(h), pad16(t)), m["chans"], m["pools"])
               + normal_apply_flop(t, c, h, w))
    return head + m["num_cascades"] * cascade
