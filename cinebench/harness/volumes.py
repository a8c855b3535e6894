"""Cine volumes made from the seed: the traffic's inputs and targets.

A beating-annulus phantom with smooth complex coil maps and a per-frame
random Cartesian line mask, copied from the port's ``data/synthetic.py``
(``cine_phantom``, ``coil_sensitivities``) and ``data/masks.py``
(``RandomMask``), the reference's defaults. Each volume draws from the seed
its cardiac phase, its coil geometry's rotation, its complex k-space noise and
its mask, so every volume of a pool differs while all have the same sizes.
Fully sampled k-space, the masked k-space and the target (the root sum of
squares of the noisy coil images) are made on the device.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

__all__ = ["cine_phantom", "coil_sensitivities", "random_line_mask", "make_volumes"]


def cine_phantom(t: int, h: int, w: int, phase0: float = 0.0) -> np.ndarray:
    """A beating annulus and static anatomy, ``(t, h, w)`` float32 in [0, 1.2]."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    r = np.sqrt(yy ** 2 + xx ** 2)
    frames = []
    for f in range(t):
        phase = phase0 + 2 * np.pi * f / t
        beat = 0.28 + 0.08 * np.sin(phase)
        ring = np.exp(-(((r - beat) / 0.07) ** 2))
        body = 0.6 * np.exp(-(r / 0.75) ** 4)
        septum = 0.3 * np.exp(-(((yy - 0.1 * np.sin(phase)) / 0.12) ** 2)) * (np.abs(xx) < 0.35)
        frames.append(np.clip(body + ring + septum, 0, 1.2))
    return np.stack(frames).astype(np.float32)


def coil_sensitivities(c: int, h: int, w: int, rotation: float = 0.0) -> np.ndarray:
    """Smooth complex maps ``(c, h, w)``: Gaussian lobes on a ring, smooth
    phases, normalized to a root sum of squares of 1."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    maps = np.zeros((c, h, w), np.complex64)
    for i in range(c):
        ang = rotation + 2 * np.pi * i / c
        cy, cx = 1.2 * np.sin(ang), 1.2 * np.cos(ang)
        mag = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 0.8 ** 2))
        ph = 0.5 * np.sin(ang) * xx + 0.5 * np.cos(ang) * yy + 0.3 * (xx ** 2 - yy ** 2) * np.sin(2 * ang)
        maps[i] = (mag * np.exp(1j * np.pi * ph)).astype(np.complex64)
    rss = np.sqrt((np.abs(maps) ** 2).sum(0, keepdims=True))
    return (maps / np.maximum(rss, 1e-8)).astype(np.complex64)


def random_line_mask(rng: np.random.Generator, t: int, h: int, center_lines: int,
                     acceleration: int) -> np.ndarray:
    """Per-frame random phase-encode lines ``(t, 1, h, 1)``: ``center_lines``
    central rows always, the other ``h / acc − center_lines`` rows drawn
    without replacement from a Gaussian density plus a floor
    (``RandomMask``)."""
    i = np.arange(h)
    pdf = np.exp(-(0.5 / (h / 10.0) ** 2) * (i - h / 2) ** 2) + (h / (2.0 * acceleration)) / h
    n_lines = int(h / acceleration)
    lo, hi = h // 2 - center_lines // 2, h // 2 + center_lines // 2
    if center_lines:
        pdf[lo:hi] = 0
        n_lines -= center_lines
    if n_lines < 0:
        raise ValueError(f"{center_lines} center lines exceed {h}/{acceleration} lines")
    pdf = pdf / pdf.sum()
    mask = np.zeros((t, h), np.float32)
    for f in range(t):
        mask[f, rng.choice(h, n_lines, replace=False, p=pdf)] = 1
    if center_lines:
        mask[:, lo:hi] = 1
    return mask.reshape(t, 1, h, 1)


def _centered_fft2(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    dims = (-2, -1)
    f = torch.fft.ifft2 if inverse else torch.fft.fft2
    return torch.fft.fftshift(f(torch.fft.ifftshift(x, dim=dims), norm="ortho"), dim=dims)


def make_volumes(seed: int, count: int, shape: Dict[str, int], traffic: dict,
                 device) -> List[Dict[str, torch.Tensor]]:
    """``count`` volumes on ``device``: ``kspace`` (masked, complex64
    ``(1, t, c, h, w)``), ``mask`` ``(1, t, 1, h, 1)``, ``maps`` ``(1, 1, c, h,
    w)`` complex64 and ``target`` ``(1, t, h, w)``."""
    t, c, h, w = shape["t"], shape["c"], shape["h"], shape["w"]
    rng = np.random.default_rng([seed % 2 ** 64, 1])
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(2 ** 62)))
    vols = []
    for _ in range(count):
        image = torch.from_numpy(cine_phantom(t, h, w, float(rng.uniform(0, 2 * np.pi))))
        maps = torch.from_numpy(coil_sensitivities(c, h, w, float(rng.uniform(0, 2 * np.pi))))
        mask = torch.from_numpy(random_line_mask(rng, t, h, traffic["center_lines"],
                                                 traffic["acceleration"]))
        image, maps, mask = image.to(device), maps.to(device), mask.to(device)
        full = _centered_fft2(image[:, None] * maps[None], inverse=False)  # (t, c, h, w)
        noise = torch.randn((2, *full.shape), generator=gen, device=device) * traffic["noise"]
        full = full + torch.complex(noise[0], noise[1])
        target = _centered_fft2(full, inverse=True).abs().square().sum(dim=1).sqrt()
        vols.append({"kspace": (full * mask)[None], "mask": mask[None], "maps": maps[None, None],
                     "target": target[None]})
    return vols
