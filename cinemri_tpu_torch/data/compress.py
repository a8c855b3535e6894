"""SVD coil compression (software coil channels -> fewer virtual coils).

A numpy copy of ``cinemri_tpu/data/compress.py``.

Beyond-reference capability (the reference always carries every physical
coil): classic single-coil-geometry SVD compression — Buehrer et al., MRM
2007; Zhang et al., MRM 2013 (their single-slice SCC case) — as an opt-in
speed mode. Every coil-linear cost in the framework (per-coil sensitivity
U-Nets, the CG normal operator's coil expand/reduce streams, coil DFT
passes, HBM traffic of (t, c, h, w) intermediates) scales with the coil
count, so compressing 10 physical coils to e.g. 6 virtual ones buys ~40%
on those paths across ALL model variants, at a quality cost governed by
the discarded singular values.

The compression matrix is estimated from the sampled phase-encode rows of
the time-averaged masked k-space (for the protocol's per-frame random
masks that is the always-sampled central calibration band — the same data
the sensitivity models calibrate from), so it is computable at inference
time from the undersampled acquisition alone and is stable across epochs.
Everything downstream of the transform (sensitivity estimation, data
consistency, reconstruction) operates on virtual coils consistently; the
ground-truth target is built from the original physical coils and is
unchanged.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["compression_matrix", "apply_compression", "suggest_num_virtual"]


def suggest_num_virtual(
    kspace: np.ndarray,
    mask: Optional[np.ndarray] = None,
    energy_threshold: float = 0.999,
) -> int:
    """Smallest v whose calibration-region singular energy ≥ the threshold.

    Compression quality is governed by the DISCARDED singular energy of the
    coil array, which depends entirely on array redundancy: a 30-channel
    cardiac array typically compresses to ~10 virtual coils above 0.999,
    while a low-redundancy array may not compress at all (measured: on a
    near-full-rank 4-coil synthetic array, v=3 keeps only 97.9% and costs
    ΔSSIM −0.175 at 150 epochs — BASELINE.md). Call this on a
    representative volume before choosing ``--compress_coils``.
    """
    t, c, h, w = kspace.shape
    tavg = kspace.mean(axis=0)
    if mask is not None:
        rows = np.asarray(mask, bool).all(axis=0).reshape(h)
        if not rows.any():
            rows = np.asarray(mask, bool).any(axis=0).reshape(h)
        tavg = tavg[:, rows, :]
    x = tavg.reshape(c, -1)
    eigvals = np.linalg.eigvalsh(x @ x.conj().T)[::-1]
    energy = np.cumsum(eigvals) / max(eigvals.sum(), 1e-30)
    return int(np.searchsorted(energy, energy_threshold) + 1)


def compression_matrix(
    kspace: np.ndarray,
    num_virtual: int,
    mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Estimate a (c, v) coil-compression matrix with orthonormal columns.

    Args:
        kspace: (t, c, h, w) complex64 (masked) k-space.
        num_virtual: number of virtual coils v (1 <= v <= c).
        mask: optional (t|1, 1, h, 1) sampling mask; calibration uses the
            phase-encode rows sampled in EVERY frame (the central band for
            the reference's mask generators). Without a mask, all rows.

    Returns:
        C (c, v) complex64, ``C^H C = I``; virtual k-space is
        ``einsum('cv,tchw->tvhw', conj(C), k)``. Columns carry a canonical
        phase (largest-magnitude entry real-positive) so the matrix is
        deterministic for a given calibration region.
    """
    t, c, h, w = kspace.shape
    if not 1 <= num_virtual <= c:
        raise ValueError(f"num_virtual must be in [1, {c}], got {num_virtual}")
    tavg = kspace.mean(axis=0)  # (c, h, w)
    if mask is not None:
        rows = np.asarray(mask, bool).all(axis=0).reshape(h)
        if not rows.any():  # no always-sampled band: use every sampled row
            rows = np.asarray(mask, bool).any(axis=0).reshape(h)
        tavg = tavg[:, rows, :]
    x = tavg.reshape(c, -1)
    gram = x @ x.conj().T  # (c, c) Hermitian PSD
    eigvals, eigvecs = np.linalg.eigh(gram)  # ascending
    order = np.argsort(eigvals)[::-1][:num_virtual]
    cmat = eigvecs[:, order]
    # canonical per-column phase -> deterministic across runs/platforms
    anchor = np.take_along_axis(
        cmat, np.abs(cmat).argmax(axis=0, keepdims=True), axis=0
    )[0]
    phase = anchor / np.maximum(np.abs(anchor), 1e-30)
    cmat = cmat * phase.conj()[None, :]
    return np.ascontiguousarray(cmat, dtype=np.complex64)


def apply_compression(kspace: np.ndarray, cmat: np.ndarray) -> np.ndarray:
    """(t, c, h, w) physical-coil k-space -> (t, v, h, w) virtual coils."""
    out = np.einsum("cv,tchw->tvhw", cmat.conj(), kspace)
    return np.ascontiguousarray(out, dtype=np.complex64)
