"""Preprocessing transforms and per-model sample construction.

A numpy copy of ``cinemri_tpu/data/transforms.py`` (the port imports nothing
of the JAX package); the same inputs and seeds give the same samples in both
packages. The crops slice, so they take numpy arrays and tensors alike.

Parity target: reference reconstruction/data/transforms.py:32-526. Samples
are plain dicts of numpy arrays in this framework's native-complex layouts
(the reference emits positional tuples of stacked-real torch tensors).

Per-model transforms:
  * :class:`VarNetDataTransform`  (transforms.py:270-349)
  * :class:`CineNetDataTransform` (transforms.py:353-443) — additionally
    estimates per-sample sensitivity maps from the *masked* time-averaged
    k-space with a 15-wide calibration region (the reference calls BART
    ``ecalib -r 15`` here, transforms.py:425-432; we call the numpy
    ESPIRiT of :mod:`cinemri_tpu_torch.data.espirit`).
  * :class:`XPDNetDataTransform`  (transforms.py:447-526) — same fields as
    VarNet's.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from cinemri_tpu_torch.data.masks import MaskFunc

__all__ = [
    "center_crop",
    "center_crop_to_smallest",
    "filtered_crop_center_and_slices",
    "normalize",
    "normalize_instance",
    "apply_mask_np",
    "VarNetDataTransform",
    "CineNetDataTransform",
    "XPDNetDataTransform",
]


def center_crop(data, shape: Tuple[int, int]):
    """Center crop over the last two axes (transforms.py:111-133; also the
    complex variant 136-158 — native complex needs no separate function)."""
    if not (0 < shape[0] <= data.shape[-2] and 0 < shape[1] <= data.shape[-1]):
        raise ValueError("Invalid shapes.")
    h0 = (data.shape[-2] - shape[0]) // 2
    w0 = (data.shape[-1] - shape[1]) // 2
    return data[..., h0 : h0 + shape[0], w0 : w0 + shape[1]]


def center_crop_to_smallest(x, y):
    """Crop both to the smaller of each trailing dim (transforms.py:161-183)."""
    h = min(x.shape[-2], y.shape[-2])
    w = min(x.shape[-1], y.shape[-1])
    return center_crop(x, (h, w)), center_crop(y, (h, w))


def filtered_crop_center_and_slices(
    data: np.ndarray,
    shape: Tuple[int, int],
    n_slices: int,
    filter_size: Sequence[float],
) -> Tuple[np.ndarray, np.ndarray]:
    """Temporal slice selection + center crop + Gaussian smoothing
    (transforms.py:186-220): returns (cropped, gaussian-filtered cropped).
    scipy is imported here, not with the module: importing ``scipy.ndimage``
    runs a subprocess (numpy.testing's CPU probe)."""
    from scipy.ndimage import gaussian_filter

    if not (0 < shape[0] <= data.shape[-2] and 0 < shape[1] <= data.shape[-1]):
        raise ValueError("Invalid shapes.")
    crop = center_crop(data[:n_slices], shape)
    filt = gaussian_filter(crop.real, sigma=filter_size) + 1j * gaussian_filter(
        crop.imag, sigma=filter_size
    )
    return crop, filt.astype(np.complex64)


def normalize(data, mean, stddev, eps=0.0):
    """(data - mean) / (stddev + eps) (transforms.py:223-265)."""
    return (data - mean) / (stddev + eps)


def normalize_instance(data, eps=0.0):
    mean, std = data.mean(), data.std()
    return normalize(data, mean, std, eps), mean, std


def apply_mask_np(
    kspace: np.ndarray,
    mask_func: MaskFunc,
    seed=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Subsample (t, c, h, w) k-space; returns (masked, mask (t|1,1,h,1))."""
    t, _, h, _ = kspace.shape
    mask = mask_func(t, h, seed=seed)
    return (kspace * mask).astype(np.complex64), mask.astype(np.float32)


def _fname_seed(fname: str):
    """Filename-derived seed, same recipe as transforms.py:324."""
    return tuple(map(ord, fname))


class _BaseTransform:
    """``compress_coils > 0`` additionally compresses the masked k-space to
    that many virtual coils (data/compress.py, SVD of the always-sampled
    calibration band) before the sample leaves the transform — every
    downstream consumer (sensitivity estimation, DC, model) then runs on
    the smaller coil dimension. 0 (default) keeps the physical coils —
    the reference's (only) behavior."""

    def __init__(self, mask_func: Optional[MaskFunc] = None, use_seed: bool = True,
                 compress_coils: int = 0):
        self.mask_func = mask_func
        self.use_seed = use_seed
        self.compress_coils = int(compress_coils)

    @property
    def kspace_is_raw_times_mask(self) -> bool:
        """The contract the Trainer's device cache (``train/device_cache.py``)
        relies on: a sample's ``masked_kspace`` is its decoded volume's raw
        k-space times its ``mask`` and nothing else, so it can be rebuilt on
        the device from cached raw k-space and this step's mask. It holds
        when this transform draws the mask and compresses no coils. A
        transform without this attribute takes the host path."""
        return self.mask_func is not None and not self.compress_coils

    # the sample's maps are the same every epoch (CineNet sets it when it
    # caches them), so the device cache may keep them
    sens_maps_are_stable = False

    def _mask(self, kspace: np.ndarray, mask, fname: str, mask_seed=None):
        if self.mask_func is not None:
            if mask_seed is not None:  # parallel-decode deterministic draw
                seed = mask_seed
            else:
                seed = _fname_seed(fname) if self.use_seed else None
            return apply_mask_np(kspace, self.mask_func, seed)
        # pre-masked dataset: reshape the stored mask over the row axis
        # (transforms.py:334-343 — note the reference reshapes over the
        # *last spatial* axis; here the undersampled axis is h, matching
        # the masks its own generators produce)
        h = kspace.shape[-2]
        mask = np.asarray(mask, np.float32).reshape(1, 1, h, 1)
        return kspace.astype(np.complex64), mask

    def _common(self, kspace, mask, target, fname, slice_num, mask_seed=None):
        if target is not None:
            target = np.asarray(target, np.float32)
            max_value = float(target.max())
        else:
            target = np.zeros((1,), np.float32)
            max_value = 0.0
        masked_kspace, mask = self._mask(
            np.asarray(kspace, np.complex64), mask, fname, mask_seed=mask_seed
        )
        if 0 < self.compress_coils < masked_kspace.shape[1]:
            from cinemri_tpu_torch.data.compress import (
                apply_compression,
                compression_matrix,
            )

            cmat = compression_matrix(masked_kspace, self.compress_coils, mask)
            masked_kspace = apply_compression(masked_kspace, cmat)
        return {
            "masked_kspace": masked_kspace,  # (t, c, h, w) complex64
            "mask": mask,  # (t|1, 1, h, 1) float32
            "target": target,  # (t, th, tw) float32
            "fname": fname,
            "slice_num": int(slice_num),
            "max_value": max_value,
            "crop_size": (150, 150),  # transforms.py:325 (visualisation)
        }


class VarNetDataTransform(_BaseTransform):
    def __call__(self, kspace, mask, target, attrs: Dict, fname: str,
                 slice_num: int, mask_seed=None):
        return self._common(kspace, mask, target, fname, slice_num, mask_seed)


class XPDNetDataTransform(_BaseTransform):
    def __call__(self, kspace, mask, target, attrs: Dict, fname: str,
                 slice_num: int, mask_seed=None):
        return self._common(kspace, mask, target, fname, slice_num, mask_seed)


class CineNetDataTransform(_BaseTransform):
    """Adds per-sample ESPIRiT maps from the masked k-space (r=15).

    ``cache_maps=True`` computes the maps once per (filename, slice) and
    reuses them across epochs. The reference recomputes them per sample per
    epoch (transforms.py:425-432, its dominant data-path cost); with an
    always-sampled central band the masked calibration region barely changes
    across epochs, so cached maps are numerically near-identical while
    removing the per-epoch eigendecompositions from the input pipeline.
    Default False for exact reference semantics.

    ``maps_cache_dir`` additionally persists the cached maps as one ``.npz``
    per (filename, slice, mask-config) next to the dataset's decoded-volume
    cache, so the cache survives process restarts and is shared across
    train/test runs of the same configuration.
    """

    def __init__(
        self,
        mask_func: Optional[MaskFunc] = None,
        use_seed: bool = True,
        calib_size: int = 15,
        cache_maps: bool = False,
        maps_cache_dir=None,
        compress_coils: int = 0,
    ):
        super().__init__(mask_func, use_seed, compress_coils)
        self.calib_size = calib_size
        self.cache_maps = cache_maps
        from pathlib import Path

        self.maps_cache_dir = Path(maps_cache_dir) if maps_cache_dir else None
        self._maps_cache: Dict[str, np.ndarray] = {}

    @property
    def sens_maps_are_stable(self) -> bool:
        return self.cache_maps

    def _mask_tag(self) -> str:
        """Mask-config fingerprint for the on-disk key: maps computed under
        one (mask type, accelerations, center config) must not be reused by
        another."""
        mf = self.mask_func
        vtag = f"_v{self.compress_coils}" if self.compress_coils else ""
        if mf is None:
            return "nomask" + vtag
        return (
            f"{type(mf).__name__}_c{'-'.join(str(c) for c in mf.center_fractions)}"
            f"_a{'-'.join(str(a) for a in mf.accelerations)}" + vtag
        )

    def _disk_path(self, fname: str, slice_num: int):
        if self.maps_cache_dir is None:
            return None
        return (
            self.maps_cache_dir
            / f"{fname}.s{slice_num}.r{self.calib_size}.{self._mask_tag()}.maps.npz"
        )

    def __call__(self, kspace, mask, target, attrs: Dict, fname: str,
                 slice_num: int, mask_seed=None):
        from cinemri_tpu_torch.data.espirit import espirit_maps  # lazy import

        sample = self._common(kspace, mask, target, fname, slice_num, mask_seed)
        key = f"{fname}#{slice_num}"
        maps = self._maps_cache.get(key) if self.cache_maps else None
        disk = self._disk_path(fname, slice_num) if self.cache_maps else None
        if maps is None and disk is not None and disk.exists():
            with np.load(disk) as z:
                maps = np.ascontiguousarray(z["maps"])
            self._maps_cache[key] = maps
        if maps is None:
            tavg = sample["masked_kspace"].mean(axis=0)  # (c, h, w)
            maps = np.asarray(espirit_maps(tavg, calib_size=self.calib_size))
            if self.cache_maps:
                self._maps_cache[key] = maps
                if disk is not None:
                    disk.parent.mkdir(parents=True, exist_ok=True)
                    np.savez(disk, maps=maps)
        sample["sens_maps"] = maps[None]  # (1, c, h, w) — broadcast over t
        return sample
