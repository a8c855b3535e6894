"""ESPIRiT coil-sensitivity calibration (host-side numpy).

Replaces the reference's external BART C toolbox calls
(``bart.bart(2, 'ecalib -r 200', ...)`` at reconstruction/data/mri_data.py:294-298
for target synthesis, and ``'ecalib -r 15'`` at data/transforms.py:425-432 for
CineNet input maps). The reference shells out to native C inside every
``__getitem__`` — the dominant data-path cost (SURVEY §3.4). Here calibration
is a deterministic host-side precompute whose results the dataset caches per
volume (data/dataset.py), so it runs once, not once per epoch per sample.
It deliberately lives on the host: the products (maps, targets) are training
*inputs*, and the eigen-decompositions involved are a poor fit for
accelerator backends without complex support. A C++ implementation of the
same algorithm ships in :mod:`cinemri_tpu_torch.native` for Python-free pipelines.

A numpy copy of ``cinemri_tpu/data/espirit.py``: the complex128 Gram and the
``eigh`` order are kept, so the maps (phase-referenced to coil 0) come out
equal to the JAX package's.

Algorithm (Uecker et al., "ESPIRiT — An Eigenvalue Approach to
Autocalibrating Parallel MRI", MRM 2014), with two structural choices:

  1. **Gram trick.** Instead of the SVD of the tall block-Hankel calibration
     matrix A (``(positions) x (c*k*k)``), take ``eigh`` of the small Gram
     matrix AᴴA; the signal subspace is selected by a 0/1 weight per
     eigenvector (``σ > thresh·σ_max``).
  2. **Autocorrelation FFTs.** The pointwise operator
     ``G(x) = Σ_k V_k(x) V_k(x)ᴴ`` is assembled from the kernel
     autocorrelation ``Q_cc'(Δ) = Σ_δ P[(c,δ+Δ),(c',δ)]`` (support
     ``(2k-1)²``) via c² small inverse FFTs — independent of how many
     kernels are in the signal subspace.

Per-pixel maps are the top eigenvector of G (batched ``eigh``), unit-norm,
phase-referenced to coil 0, hard-cropped where the top eigenvalue is below
``crop`` (defaults ``kernel_size=6``, ``thresh=0.001``, ``crop=0.8`` match
BART ecalib's ``-k/-t/-c``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["espirit_maps", "espirit_maps_multi", "calibration_matrix_gram"]


def _extract_calib(kspace: np.ndarray, calib_size: int) -> np.ndarray:
    """Center-crop the calibration region from (c, h, w) k-space."""
    c, h, w = kspace.shape
    ch = min(calib_size, h)
    cw = min(calib_size, w)
    h0 = (h - ch) // 2
    w0 = (w - cw) // 2
    return kspace[:, h0 : h0 + ch, w0 : w0 + cw]


def calibration_matrix_gram(calib: np.ndarray, k: int) -> np.ndarray:
    """Gram matrix AᴴA of the block-Hankel calibration matrix.

    ``calib``: (c, ch, cw); returns ``(c*k*k, c*k*k)`` Hermitian, with the
    patch axis ordered (coil, dy, dx) — row-major over kernel offsets.
    """
    c, ch, cw = calib.shape
    nh, nw = ch - k + 1, cw - k + 1
    cols = [
        calib[:, dy : dy + nh, dx : dx + nw].reshape(c, nh * nw)
        for dy in range(k)
        for dx in range(k)
    ]
    at = np.stack(cols, axis=1).reshape(c * k * k, nh * nw)
    return at @ at.conj().T


def _autocorrelation(p: np.ndarray, c: int, k: int) -> np.ndarray:
    """Q_cc'(Δ) = Σ_δ P[(c, δ+Δ), (c', δ)]; output (c, c, 2k-1, 2k-1)."""
    pr = p.reshape(c, k, k, c, k, k)
    q = np.zeros((c, c, 2 * k - 1, 2 * k - 1), dtype=p.dtype)
    for dy in range(-k + 1, k):
        ys = slice(max(0, dy), min(k, k + dy))
        yd = slice(max(0, -dy), min(k, k - dy))
        for dx in range(-k + 1, k):
            xs = slice(max(0, dx), min(k, k + dx))
            xd = slice(max(0, -dx), min(k, k - dx))
            block = pr[:, ys, xs, :, yd, xd]  # (c, ny, nx, c, ny, nx)
            # paired (diagonal) offsets: sum over δ with δ+Δ fixed per slice
            q[:, :, dy + k - 1, dx + k - 1] = np.einsum("cyxdyx->cd", block)
    return q


def espirit_maps(
    kspace: np.ndarray,
    calib_size: int = 24,
    kernel_size: int = 6,
    thresh: float = 0.001,
    crop: float = 0.8,
    return_eigenvalues: bool = False,
):
    """Estimate sensitivity maps from (time-averaged) multi-coil k-space.

    Args:
        kspace: ``(c, h, w)`` complex, centered (DC at ``(h//2, w//2)``).
        calib_size: side of the square central calibration region (BART
            ``-r``; the reference uses 200 = full grid for targets, 15 for
            CineNet per-sample maps).
        kernel_size / thresh / crop: BART ``-k`` / ``-t`` / ``-c`` analogues.

    Returns:
        ``(c, h, w)`` complex64 maps (unit-norm per pixel inside the crop
        mask, zero outside); optionally also the ``(h, w)`` top eigenvalue.
    """
    kspace = np.asarray(kspace, np.complex64)
    if kspace.ndim != 3:
        raise ValueError(f"expected (c, h, w) k-space, got {kspace.shape}")
    c, h, w = kspace.shape
    k = int(kernel_size)

    calib = _extract_calib(kspace, int(calib_size)).astype(np.complex128)
    gram = calibration_matrix_gram(calib, k)

    evals, evecs = np.linalg.eigh(gram)  # ascending; evals = σ²
    weights = (evals > (thresh ** 2) * evals[-1]).astype(gram.dtype)
    p = (evecs * weights[None, :]) @ evecs.conj().T  # signal-subspace projector

    q = _autocorrelation(p, c, k)  # (c, c, 2k-1, 2k-1)

    # G_cc'(x) = (1/k²) Σ_Δ Q(Δ) e^{2πiΔ·x/N}: place Q at frequencies Δ mod N
    grid = np.zeros((c, c, h, w), dtype=np.complex128)
    dy = np.arange(-k + 1, k) % h
    dx = np.arange(-k + 1, k) % w
    grid[:, :, dy[:, None], dx[None, :]] = q
    g = np.fft.ifft2(grid, axes=(-2, -1)) * (h * w) / (k * k)
    g = np.fft.fftshift(g, axes=(-2, -1))  # align with centered-image order
    g = np.moveaxis(g, (0, 1), (2, 3))  # (h, w, c, c)
    g = 0.5 * (g + np.conj(np.swapaxes(g, -1, -2)))

    evals_g, evecs_g = np.linalg.eigh(g)  # (h, w, c) asc / (h, w, c, c)
    top_val = evals_g[..., -1].real
    maps = evecs_g[..., -1]  # (h, w, c), unit norm

    phase = np.exp(-1j * np.angle(maps[..., :1]))
    maps = maps * phase
    maps = maps * (top_val[..., None] >= crop)
    maps = np.moveaxis(maps, -1, 0).astype(np.complex64)
    if return_eigenvalues:
        return maps, top_val.astype(np.float32)
    return maps


def espirit_maps_multi(
    kspace: np.ndarray,
    num_maps: int = 2,
    calib_size: int = 24,
    kernel_size: int = 6,
    thresh: float = 0.001,
    crop: float = 0.8,
    return_eigenvalues: bool = False,
):
    """Multi-set ESPIRiT maps for soft-SENSE reconstruction.

    BART's ``ecalib`` emits multiple eigenvector sets by default (``-m``);
    the reference keeps only the first (mri_data.py:294-298). The further
    sets carry signal wherever the pointwise operator has more than one
    eigenvalue near 1 — i.e. where the FOV is aliased — and reconstructing
    with all of them (soft-SENSE, Uecker et al. 2014 §"Soft SENSE") removes
    the aliased-FOV artifacts hard-SENSE models fold into the image. Out of
    reference scope (its volumes are full-FOV) but standard practice; the
    operator pair lives in :func:`cinemri_tpu_torch.physics.soft_sense_expand` /
    ``soft_sense_reduce``.

    Returns ``(m, c, h, w)`` complex64 maps — set 0 equals
    :func:`espirit_maps`'s output — each set phase-referenced to coil 0 and
    hard-cropped where ITS eigenvalue is below ``crop``; optionally also
    the ``(m, h, w)`` eigenvalues.
    """
    kspace = np.asarray(kspace, np.complex64)
    if kspace.ndim != 3:
        raise ValueError(f"expected (c, h, w) k-space, got {kspace.shape}")
    c, h, w = kspace.shape
    if not 1 <= num_maps <= c:
        raise ValueError(f"num_maps must be in [1, {c}], got {num_maps}")
    k = int(kernel_size)

    calib = _extract_calib(kspace, int(calib_size)).astype(np.complex128)
    gram = calibration_matrix_gram(calib, k)
    evals, evecs = np.linalg.eigh(gram)
    weights = (evals > (thresh ** 2) * evals[-1]).astype(gram.dtype)
    p = (evecs * weights[None, :]) @ evecs.conj().T
    q = _autocorrelation(p, c, k)

    grid = np.zeros((c, c, h, w), dtype=np.complex128)
    dy = np.arange(-k + 1, k) % h
    dx = np.arange(-k + 1, k) % w
    grid[:, :, dy[:, None], dx[None, :]] = q
    g = np.fft.ifft2(grid, axes=(-2, -1)) * (h * w) / (k * k)
    g = np.fft.fftshift(g, axes=(-2, -1))
    g = np.moveaxis(g, (0, 1), (2, 3))
    g = 0.5 * (g + np.conj(np.swapaxes(g, -1, -2)))

    evals_g, evecs_g = np.linalg.eigh(g)  # ascending
    m = int(num_maps)
    vals = evals_g[..., : -m - 1 : -1].real  # (h, w, m) descending
    sets = evecs_g[..., : -m - 1 : -1]  # (h, w, c, m) descending

    phase = np.exp(-1j * np.angle(sets[..., :1, :]))
    sets = sets * phase
    sets = sets * (vals[..., None, :] >= crop)
    maps = np.moveaxis(sets, (-1, -2), (0, 1)).astype(np.complex64)  # (m,c,h,w)
    if return_eigenvalues:
        return maps, np.moveaxis(vals, -1, 0).astype(np.float32)
    return maps
