"""Training steps: the time-averaged SSIM loss, Adam and the step-decay rate.

Loss: output and target center-cropped to their common size; per (sample,
frame) the mean SSIM over a uniform 7x7 window (VALID), ``k1 = 0.01``, ``k2 =
0.03``, covariances scaled by ``49 / 48``, the data range the frame's target
maximum; the loss is the batch mean of ``1 − mean_t SSIM``. Adam (β 0.9,
0.999, ε 1e-8, no weight decay) at ``lr · γ^((s // steps_per_epoch) //
step_size)`` for the ``s``-th step counted from 0.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from cinebench.reference import family


__all__ = ["ssim_loss", "train_steps"]

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def _crop(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    top = (x.shape[-2] - h) // 2
    left = (x.shape[-1] - w) // 2
    return x[..., top:top + h, left:left + w]


def ssim_loss(pred: torch.Tensor, target: torch.Tensor, win: int = 7, k1: float = 0.01,
              k2: float = 0.03) -> torch.Tensor:
    h, w = min(pred.shape[-2], target.shape[-2]), min(pred.shape[-1], target.shape[-1])
    pred, target = _crop(pred, h, w), _crop(target, h, w)
    b, t = pred.shape[:2]
    x = pred.reshape(b * t, 1, h, w)
    y = target.reshape(b * t, 1, h, w)
    kernel = torch.full((1, 1, win, win), 1.0 / (win * win), dtype=x.dtype, device=x.device)

    def mean(a):
        return F.conv2d(a, kernel)

    ux, uy = mean(x), mean(y)
    norm = win * win / (win * win - 1)
    vx = norm * (mean(x * x) - ux * ux)
    vy = norm * (mean(y * y) - uy * uy)
    vxy = norm * (mean(x * y) - ux * uy)
    peak = target.amax(dim=(2, 3)).reshape(b * t, 1, 1, 1)
    c1, c2 = (k1 * peak) ** 2, (k2 * peak) ** 2
    s = (2 * ux * uy + c1) * (2 * vxy + c2) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    ssim = s.mean(dim=(1, 2, 3)).reshape(b, t)
    return (1 - ssim).mean(dim=1).mean()


def train_steps(cfg: dict, params: Dict[str, torch.Tensor], batches: List[dict],
                opt: dict) -> dict:
    """Run ``len(batches)`` steps from ``params`` (left untouched).

    Returns ``losses`` (floats), ``grad_norms`` (the first step's gradient
    norm by parameter name) and ``change_norms`` (the norm of each
    parameter's change over all the steps)."""
    theta = {n: v.detach().clone().requires_grad_(True) for n, v in params.items()}
    m = {n: torch.zeros_like(v) for n, v in theta.items()}
    s = {n: torch.zeros_like(v) for n, v in theta.items()}
    losses, grad_norms = [], {}
    for step, batch in enumerate(batches):
        out = family(cfg).forward(cfg, theta, batch["kspace"], batch["mask"], batch.get("maps"))
        loss = ssim_loss(out, batch["target"])
        grads = torch.autograd.grad(loss, list(theta.values()))
        losses.append(float(loss.detach()))
        lr = opt["lr"] * opt["lr_gamma"] ** ((step // opt["steps_per_epoch"]) // opt["lr_step_size"])
        with torch.no_grad():
            for (n, v), g in zip(theta.items(), grads):
                if step == 0:
                    grad_norms[n] = float(g.norm())
                m[n].mul_(BETA1).add_(g, alpha=1 - BETA1)
                s[n].mul_(BETA2).add_(g * g, alpha=1 - BETA2)
                bc1 = 1 - BETA1 ** (step + 1)
                bc2 = 1 - BETA2 ** (step + 1)
                v.sub_(lr / bc1 * m[n] / (s[n].sqrt() / bc2 ** 0.5 + EPS))
        del out, loss, grads
    change = {n: float((theta[n].detach() - params[n]).norm()) for n in theta}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
