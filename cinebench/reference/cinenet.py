"""CineNet-XF.

``x = Σ_c conj(S_c) F⁻¹ k_c`` with the maps of the request; each cascade
denoises ``x`` with plain U-Nets on ``[re, im]`` over the XF planes, then
runs ``cg_iters`` conjugate-gradient steps on ``(N + v) x = x_ref + v·x_den``
from ``x_den``, ``v = softplus(λ_i)``, with real inner products over every
element. Output ``|x|``.

Shapes: k-space ``(b, t, c, h, w)`` complex, line mask ``(b, t, 1, h, 1)``,
maps ``(b, 1, c, h, w)`` complex, image ``(b, t, h, w)`` real.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cinebench.reference.fourier import ifft2c, normal_kernel
from cinebench.reference.nets import unet
from cinebench.reference.xf import cg, normal_op, xf_regularizer

DYNAMIC_TYPES = ("XF",)

__all__ = ["forward", "flop"]


def forward(cfg: dict, p: dict, k: torch.Tensor, mask: torch.Tensor,
            maps: torch.Tensor) -> torch.Tensor:
    model = cfg["model"]
    maps = maps[:, 0]
    kernel = normal_kernel(mask, k.dtype)
    x_ref = (ifft2c(k) * maps.conj()[:, None]).sum(dim=2)

    def net(planes, name):
        out = unet(torch.stack([planes.real, planes.imag], dim=1), p, name, model["pools"])
        return torch.complex(out[:, 0], out[:, 1])

    x = x_ref
    for i in range(model["num_cascades"]):
        den = xf_regularizer(x, net, "cascades")
        v = F.softplus(p["lambda_reg"][i])

        def op(z, v=v):
            return normal_op(z, kernel, maps) + v * z

        x = cg(op, x_ref + v * den, den, model["cg_iters"])
    return x.abs()


def flop(cfg: dict) -> float:
    """One volume's forward (``harness/flops.py``): ``x_ref``'s DFTs, the
    normal kernels, and per cascade the temporal DFTs, the two plane U-Nets
    (unpadded) and ``1 + cg_iters`` normal applies."""
    from cinebench.harness.flops import dft2_flop, dft_flop, kernel_flop, normal_apply_flop, unet_flop

    m, t, c, h, w = cfg["model"], cfg["frames"], cfg["coils"], cfg["height"], cfg["width"]
    cascade = (2 * dft_flop(1, t, h * w)
               + unet_flop(h, (w, t), m["chans"], m["pools"])
               + unet_flop(w, (h, t), m["chans"], m["pools"])
               + (1 + m["cg_iters"]) * normal_apply_flop(t, c, h, w))
    return dft2_flop(t * c, h, w) + kernel_flop(t, h) + m["num_cascades"] * cascade
