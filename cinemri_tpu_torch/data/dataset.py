"""HDF5 cine dataset with the reference preprocessing chain.

A numpy copy of ``cinemri_tpu/data/dataset.py`` (the port imports nothing of
the JAX package); the same files give the same samples in both packages.
``h5py`` is imported only where a file is read. Parity target: reference reconstruction/data/mri_data.py:168-312
(SliceDataset) and :80-165 (CombinedSliceDataset). Key differences, by
design (SURVEY §3.4 and §7 quirks list):

  * **Sensitivity maps are cached.** The reference runs BART ESPIRiT inside
    every ``__getitem__`` — an O(seconds) native call per sample per epoch,
    its dominant data-path cost. Here the full deterministic preprocess
    (decode → filter/crop → ESPIRiT → target) runs once per volume and is
    cached to ``.npz``; subsequent epochs are a single file read.
  * **Examples are (fname, slice, metadata) records.** The reference stores
    bare Paths (mri_data.py:230-232) but later indexes them like fastMRI
    tuples (``example[0]``, ``ex[2]`` at :249,:258-261 and
    volume_sampler.py:65,81) — latent crashes. Records make
    ``volume_sample_rate``, ``num_cols`` and volume sharding actually work.
  * Dataset constants (×1e6 scale, crops, slice count, filter sigma,
    calibration size) are explicit :class:`PreprocessConfig` fields instead
    of literals buried in ``__getitem__`` (mri_data.py:272-277).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import pickle
import random
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from cinemri_tpu_torch.data.transforms import filtered_crop_center_and_slices, center_crop

logger = logging.getLogger(__name__)

__all__ = ["PreprocessConfig", "SliceDataset", "CombinedSliceDataset"]


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Reference constants from mri_data.py:272-277, made explicit."""

    scaling: float = 1e6
    crop_shape: Tuple[int, int] = (200, 200)
    crop_target: Tuple[int, int] = (180, 180)
    n_slices: int = 15
    filter_size: Tuple[float, float, float, float] = (0.7, 0.0, 0.3, 0.3)
    calib_size: int = 200  # BART `ecalib -r 200` (mri_data.py:296)
    # "numpy" | "native": which ESPIRiT runs the cold calibration pass.
    # "native" is the dependency-free C++ library (cinemri_tpu_torch.native) —
    # the same role BART's C code plays for the reference; cross-validated
    # in tests/test_native.py. Env override: CINEMRI_ESPIRIT_ENGINE.
    espirit_engine: str = "numpy"

    def scaled_to(self, h: int, w: int, t: int) -> "PreprocessConfig":
        """Shrink crops/calibration to fit small (test) volumes."""
        ch = min(self.crop_shape[0], h)
        cw = min(self.crop_shape[1], w)
        margin_h = max(2, ch // 10)
        margin_w = max(2, cw // 10)
        return dataclasses.replace(
            self,
            crop_shape=(ch, cw),
            crop_target=(
                min(self.crop_target[0], ch - margin_h),
                min(self.crop_target[1], cw - margin_w),
            ),
            n_slices=min(self.n_slices, t),
            calib_size=min(self.calib_size, ch, cw),
        )

    def cache_key(self) -> str:
        return hashlib.sha1(repr(self).encode()).hexdigest()[:12]


def _fft2c_np(x: np.ndarray) -> np.ndarray:
    return np.fft.fftshift(
        np.fft.fft2(np.fft.ifftshift(x, axes=(-2, -1)), norm="ortho"), axes=(-2, -1)
    )


def _ifft2c_np(x: np.ndarray) -> np.ndarray:
    return np.fft.fftshift(
        np.fft.ifft2(np.fft.ifftshift(x, axes=(-2, -1)), norm="ortho"), axes=(-2, -1)
    )


def preprocess_volume(
    raw_kspace: np.ndarray, cfg: PreprocessConfig
) -> Dict[str, np.ndarray]:
    """Decode one raw (Nt, Nx, Ny, Nc) k-space volume.

    Mirrors mri_data.py:283-303: scale ×1e6, IFFT to image space, Gaussian
    filter + center crop + temporal slice selection, FFT back, ESPIRiT on
    the time-averaged k-space, target = |Σ img·conj(sens)| center-cropped.
    The unnormalized-FFT-and-rescale dance in the reference is equivalent to
    ortho-normalized centered transforms for these even crop sizes.
    """
    kspace = np.asarray(raw_kspace, np.complex64) * cfg.scaling
    kspace = kspace.transpose(0, 3, 1, 2)  # (t, c, h, w)
    images = _ifft2c_np(kspace)
    _, images_filter = filtered_crop_center_and_slices(
        images, cfg.crop_shape, cfg.n_slices, cfg.filter_size
    )
    kspace = _fft2c_np(images_filter).astype(np.complex64)  # (t, c, h', w')

    tavg = kspace.mean(axis=0)
    engine = os.environ.get("CINEMRI_ESPIRIT_ENGINE", cfg.espirit_engine)
    if engine == "native":
        from cinemri_tpu_torch.native import espirit_maps_native as _espirit
    else:
        from cinemri_tpu_torch.data.espirit import espirit_maps as _espirit  # lazy
    sens = np.asarray(_espirit(tavg, calib_size=cfg.calib_size))  # (c, h', w')

    target = np.abs((images_filter * np.conj(sens)[None]).sum(axis=1)).astype(
        np.float32
    )
    target = center_crop(target, cfg.crop_target)
    return {"kspace": kspace, "sens": sens, "target": target}


@dataclasses.dataclass(frozen=True)
class Example:
    """One dataset record: a volume file plus listing-time metadata."""

    fname: Path
    slice_num: int
    metadata: Dict[str, object]

    # tuple-style access for fastMRI-convention call sites
    def __getitem__(self, i: int):
        return (self.fname, self.slice_num, self.metadata)[i]


class SliceDataset:
    """Reference SliceDataset equivalent over a directory of HDF5 volumes."""

    def __init__(
        self,
        root: Union[str, Path],
        transform: Optional[Callable] = None,
        use_dataset_cache: bool = False,
        sample_rate: Optional[float] = None,
        volume_sample_rate: Optional[float] = None,
        dataset_cache_file: Union[str, Path] = "dataset_cache.pkl",
        num_cols: Optional[Sequence[int]] = None,
        preprocess: Optional[PreprocessConfig] = None,
        maps_cache_dir: Optional[Union[str, Path]] = None,
        ram_cache_volumes: int = 8,
    ):
        """``ram_cache_volumes``: LRU size (in volumes) of an in-process
        decoded-volume cache on top of the on-disk ``.npz`` cache — a warm
        epoch then reads no disk at all (one OCMR-protocol volume is
        ~100 MB decoded; 8 by default, 0 disables)."""
        if sample_rate is not None and volume_sample_rate is not None:
            raise ValueError(
                "either set sample_rate (sample by slices) or volume_sample_rate"
                " (sample by volumes) but not both"
            )
        self.root = Path(root)
        self.transform = transform
        self.preprocess = preprocess or PreprocessConfig()
        self.maps_cache_dir = Path(maps_cache_dir) if maps_cache_dir else None
        self.dataset_cache_file = Path(dataset_cache_file)
        import threading
        from collections import OrderedDict

        self._ram_cache: "OrderedDict[Path, Dict]" = OrderedDict()
        self._ram_cache_volumes = int(ram_cache_volumes)
        self._ram_lock = threading.Lock()  # parallel-decode safety

        sample_rate = 1.0 if sample_rate is None else sample_rate
        volume_sample_rate = 1.0 if volume_sample_rate is None else volume_sample_rate

        cache: Dict = {}
        if use_dataset_cache and self.dataset_cache_file.exists():
            with open(self.dataset_cache_file, "rb") as f:
                cache = pickle.load(f)

        key = str(self.root)
        if cache.get(key) is None or not use_dataset_cache:
            self.examples: List[Example] = [
                Example(f, 0, self._listing_metadata(f))
                for f in sorted(self.root.iterdir())
                if f.is_file()
            ]
            if use_dataset_cache and cache.get(key) is None:
                cache[key] = self.examples
                logger.info("Saving dataset cache to %s.", self.dataset_cache_file)
                self.dataset_cache_file.parent.mkdir(parents=True, exist_ok=True)
                # under a per-process name, then moved into place: processes of
                # one data-parallel run list the same root at the same time
                tmp = self.dataset_cache_file.with_name(
                    f".{self.dataset_cache_file.name}.{os.getpid()}.tmp")
                with open(tmp, "wb") as f:
                    pickle.dump(cache, f)
                os.replace(tmp, self.dataset_cache_file)
        else:
            logger.info("Using dataset cache from %s.", self.dataset_cache_file)
            self.examples = cache[key]

        if sample_rate < 1.0:  # sample by slice (mri_data.py:244-248)
            random.shuffle(self.examples)
            self.examples = self.examples[: round(len(self.examples) * sample_rate)]
        elif volume_sample_rate < 1.0:  # sample by volume (mri_data.py:249-255)
            vol_names = sorted({ex.fname.stem for ex in self.examples})
            random.shuffle(vol_names)
            sampled = set(vol_names[: round(len(vol_names) * volume_sample_rate)])
            self.examples = [ex for ex in self.examples if ex.fname.stem in sampled]

        if num_cols:
            self.examples = [
                ex
                for ex in self.examples
                if ex.metadata["encoding_size"][1] in num_cols
            ]

    @staticmethod
    def _listing_metadata(fname: Path) -> Dict[str, object]:
        import h5py

        try:
            with h5py.File(fname, "r") as hf:
                t, h, w, c = hf["y"].shape
            return {"num_frames": t, "encoding_size": (h, w), "num_coils": c}
        except OSError:
            return {"num_frames": 0, "encoding_size": (0, 0), "num_coils": 0}

    def __len__(self) -> int:
        return len(self.examples)

    def _cache_path(self, fname: Path) -> Optional[Path]:
        if self.maps_cache_dir is None:
            return None
        tag = self.preprocess.cache_key()
        return self.maps_cache_dir / f"{fname.stem}.{tag}.npz"

    def _load_decoded(self, fname: Path) -> Dict[str, np.ndarray]:
        import h5py

        with self._ram_lock:
            if fname in self._ram_cache:
                self._ram_cache.move_to_end(fname)
                return self._ram_cache[fname]
        cpath = self._cache_path(fname)
        if cpath is not None and cpath.exists():
            with np.load(cpath) as z:
                decoded = {k: z[k] for k in ("kspace", "sens", "target")}
            return self._ram_put(fname, decoded)
        with h5py.File(fname, "r") as hf:
            raw = np.asarray(hf["y"], dtype=np.complex64)
        t, h, w, _ = raw.shape
        cfg = self.preprocess.scaled_to(h, w, t)
        decoded = preprocess_volume(raw, cfg)
        if cpath is not None:
            cpath.parent.mkdir(parents=True, exist_ok=True)
            tmp = cpath.with_name(f".{cpath.name}.{os.getpid()}.tmp")
            with open(tmp, "wb") as f:
                np.savez(f, **decoded)
            os.replace(tmp, cpath)
        return self._ram_put(fname, decoded)

    def _ram_put(self, fname: Path, decoded: Dict) -> Dict:
        if self._ram_cache_volumes > 0:
            with self._ram_lock:
                self._ram_cache[fname] = decoded
                while len(self._ram_cache) > self._ram_cache_volumes:
                    self._ram_cache.popitem(last=False)
        return decoded

    def __getitem__(self, i: int):
        return self.load(i)

    def load(self, i: int, mask_seed=None):
        """Decode sample ``i``; ``mask_seed`` (optional) draws its
        undersampling mask from a dedicated seeded RNG instead of the
        transform's sequential stream — what makes parallel decode
        (train.loader ``num_workers>1``) deterministic regardless of
        thread completion order."""
        ex = self.examples[i]
        decoded = self._load_decoded(ex.fname)
        if self.transform is None:
            return (
                decoded["kspace"],
                None,
                decoded["target"],
                {},
                ex.fname.name,
                ex.slice_num,
            )
        kwargs = {} if mask_seed is None else {"mask_seed": mask_seed}
        return self.transform(
            decoded["kspace"], None, decoded["target"], {}, ex.fname.name,
            ex.slice_num, **kwargs,
        )


class CombinedSliceDataset:
    """Concatenation of SliceDatasets (mri_data.py:80-165)."""

    def __init__(
        self,
        roots: Sequence[Path],
        transforms: Optional[Sequence[Optional[Callable]]] = None,
        sample_rates: Optional[Sequence[Optional[float]]] = None,
        volume_sample_rates: Optional[Sequence[Optional[float]]] = None,
        use_dataset_cache: bool = False,
        dataset_cache_file: Union[str, Path] = "dataset_cache.pkl",
        num_cols: Optional[Sequence[int]] = None,
        **kwargs,
    ):
        if sample_rates is not None and volume_sample_rates is not None:
            raise ValueError(
                "either set sample_rates or volume_sample_rates but not both"
            )
        n = len(roots)
        transforms = transforms or [None] * n
        sample_rates = sample_rates or [None] * n
        volume_sample_rates = volume_sample_rates or [None] * n
        if not (len(transforms) == len(sample_rates) == len(volume_sample_rates) == n):
            raise ValueError("Lengths of roots, transforms, sample_rates do not match")

        self.datasets = [
            SliceDataset(
                root=roots[i],
                transform=transforms[i],
                sample_rate=sample_rates[i],
                volume_sample_rate=volume_sample_rates[i],
                use_dataset_cache=use_dataset_cache,
                dataset_cache_file=dataset_cache_file,
                num_cols=num_cols,
                **kwargs,
            )
            for i in range(n)
        ]
        self.examples: List[Example] = [
            ex for ds in self.datasets for ex in ds.examples
        ]

    def __len__(self) -> int:
        return sum(len(ds) for ds in self.datasets)

    def __getitem__(self, i: int):
        return self.load(i)

    def load(self, i: int, mask_seed=None):
        for ds in self.datasets:
            if i < len(ds):
                return ds.load(i, mask_seed=mask_seed)
            i -= len(ds)
        raise IndexError(i)
