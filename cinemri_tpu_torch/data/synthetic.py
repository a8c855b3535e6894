"""Synthetic cine phantoms for tests, benchmarks, and smoke training.

A numpy copy of ``cinemri_tpu/data/synthetic.py``: the same seed gives the
same volume in both packages. ``h5py`` is imported only to write a file.

The reference assumes an on-disk OCMR-style HDF5 dataset (``hf["y"]`` of
shape (Nt, Nx, Ny, Nc), reconstruction/data/mri_data.py:279-283) and has no
data generator. This module produces physically structured stand-ins — a
"beating" annulus with smooth complex coil sensitivities — so the full
pipeline (ESPIRiT calibration, masking, training, metrics) can run and be
tested hermetically, and can also write them to HDF5 files with the exact
on-disk layout the reference reads.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Sequence

import numpy as np

__all__ = [
    "coil_sensitivities",
    "redundant_coil_sensitivities",
    "cine_phantom",
    "synthetic_volume",
    "write_hdf5_volume",
    "make_synthetic_dataset",
]


def coil_sensitivities(num_coils: int, h: int, w: int, rng=None) -> np.ndarray:
    """Smooth complex coil maps, RSS-normalized to 1 inside the FOV.

    Magnitude: Gaussian lobes centered on a ring around the image (a
    birdcage-ish geometry). Phase: smooth linear+quadratic per coil.
    """
    rng = np.random.default_rng(0) if rng is None else rng
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    maps = np.zeros((num_coils, h, w), np.complex64)
    for c in range(num_coils):
        ang = 2 * np.pi * c / num_coils
        cy, cx = 1.2 * np.sin(ang), 1.2 * np.cos(ang)
        mag = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 0.8 ** 2))
        ph = (
            0.5 * np.sin(ang) * xx
            + 0.5 * np.cos(ang) * yy
            + 0.3 * (xx ** 2 - yy ** 2) * np.sin(2 * ang)
        )
        maps[c] = (mag * np.exp(1j * np.pi * ph)).astype(np.complex64)
    rss = np.sqrt((np.abs(maps) ** 2).sum(0, keepdims=True))
    return (maps / np.maximum(rss, 1e-8)).astype(np.complex64)


def redundant_coil_sensitivities(
    num_coils: int, h: int, w: int, num_modes: int, rng=None, noise: float = 0.0
) -> np.ndarray:
    """Coil maps that are complex mixtures of ``num_modes`` smooth fields.

    Models the redundancy of real receive arrays (overlapping elements
    sample the same few smooth Biot-Savart modes), giving a coil matrix of
    effective rank ~num_modes — the regime SVD coil compression
    (data/compress.py) exists for. ``noise`` adds a small independent
    per-coil component (rank restored, energy still concentrated).
    """
    rng = np.random.default_rng(0) if rng is None else rng
    base = coil_sensitivities(num_modes, h, w, rng)  # (m, h, w), smooth
    mix = (
        rng.standard_normal((num_coils, num_modes))
        + 1j * rng.standard_normal((num_coils, num_modes))
    ).astype(np.complex64) / np.sqrt(num_modes)
    maps = np.einsum("cm,mhw->chw", mix, base)
    if noise > 0:
        extra = coil_sensitivities(num_coils, h, w, rng)
        maps = maps + noise * extra * np.exp(
            1j * rng.uniform(0, 2 * np.pi, (num_coils, 1, 1))
        ).astype(np.complex64)
    rss = np.sqrt((np.abs(maps) ** 2).sum(0, keepdims=True))
    return (maps / np.maximum(rss, 1e-8)).astype(np.complex64)


def cine_phantom(num_frames: int, h: int, w: int) -> np.ndarray:
    """A beating annulus + static anatomy, (t, h, w) float32 in [0, 1]."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    r = np.sqrt(yy ** 2 + xx ** 2)
    frames = []
    for t in range(num_frames):
        phase = 2 * np.pi * t / num_frames
        beat = 0.28 + 0.08 * np.sin(phase)  # systole/diastole radius
        ring = np.exp(-(((r - beat) / 0.07) ** 2))
        body = 0.6 * np.exp(-(r / 0.75) ** 4)
        septum = 0.3 * np.exp(-(((yy - 0.1 * np.sin(phase)) / 0.12) ** 2)) * (
            np.abs(xx) < 0.35
        )
        frames.append(np.clip(body + ring + septum, 0, 1.2))
    return np.stack(frames).astype(np.float32)


def synthetic_volume(
    num_frames: int = 15,
    num_coils: int = 10,
    h: int = 64,
    w: int = 64,
    noise: float = 0.0,
    seed: int = 0,
    coil_modes: int = 0,
    coil_mode_noise: float = 0.02,
) -> Dict[str, np.ndarray]:
    """Fully-sampled multi-coil cine k-space from the phantom.

    Returns dict with ``kspace`` (t, c, h, w) complex64 (centered, ortho),
    ``sens`` (c, h, w), ``image`` (t, h, w) float32.
    """
    rng = np.random.default_rng(seed)
    image = cine_phantom(num_frames, h, w)
    if coil_modes:
        # redundant receive array (rank ~coil_modes): the SVD coil-
        # compression regime — see redundant_coil_sensitivities
        sens = redundant_coil_sensitivities(
            num_coils, h, w, num_modes=coil_modes, rng=rng,
            noise=coil_mode_noise,
        )
    else:
        sens = coil_sensitivities(num_coils, h, w, rng)
    coil_images = image[:, None] * sens[None]  # (t, c, h, w)
    kspace = np.fft.fftshift(
        np.fft.fft2(np.fft.ifftshift(coil_images, axes=(-2, -1)), norm="ortho"),
        axes=(-2, -1),
    ).astype(np.complex64)
    if noise > 0:
        kspace = kspace + noise * (
            rng.standard_normal(kspace.shape) + 1j * rng.standard_normal(kspace.shape)
        ).astype(np.complex64)
    return {"kspace": kspace, "sens": sens, "image": image}


def write_hdf5_volume(
    path: os.PathLike,
    num_frames: int = 18,
    num_coils: int = 10,
    h: int = 64,
    w: int = 64,
    noise: float = 0.0,
    seed: int = 0,
    coil_modes: int = 0,
    coil_mode_noise: float = 0.02,
) -> None:
    """Write one volume in the reference's on-disk layout.

    ``hf["y"]``: (Nt, Nx, Ny, Nc) complex64, scaled so that the dataset's
    hardcoded ×1e6 rescale (mri_data.py:273,283) lands near unit magnitude.
    """
    import h5py

    vol = synthetic_volume(num_frames, num_coils, h, w, noise, seed,
                           coil_modes, coil_mode_noise)
    y = vol["kspace"].transpose(0, 2, 3, 1) / 1e6  # (t, h, w, c)
    with h5py.File(path, "w") as hf:
        hf.create_dataset("y", data=y.astype(np.complex64))


def make_synthetic_dataset(
    root: os.PathLike,
    splits: Sequence[str] = ("train", "valid", "test", "inference"),
    volumes_per_split: int = 2,
    num_frames: int = 18,
    num_coils: int = 10,
    h: int = 64,
    w: int = 64,
    noise: float = 0.0,
    coil_modes: int = 0,
    coil_mode_noise: float = 0.02,
) -> Path:
    """Create a tiny reference-layout dataset tree under ``root``."""
    root = Path(root)
    seed = 0
    for split in splits:
        d = root / split
        d.mkdir(parents=True, exist_ok=True)
        for i in range(volumes_per_split):
            write_hdf5_volume(
                d / f"{split}_vol{i:02d}.h5",
                num_frames=num_frames,
                num_coils=num_coils,
                h=h,
                w=w,
                noise=noise,
                seed=seed,
                coil_modes=coil_modes,
                coil_mode_noise=coil_mode_noise,
            )
            seed += 1
    return root
