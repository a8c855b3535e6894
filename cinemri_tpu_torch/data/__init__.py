"""Data layer: masks, transforms, ESPIRiT calibration, HDF5 datasets.

Counterpart of ``cinemri_tpu/data`` with the same export list. Host-side
numpy and scipy, as in the JAX package; ``h5py`` is imported only where a
file is read or written.
"""

from cinemri_tpu_torch.data.masks import (
    MaskFunc,
    RandomMask,
    EquispacedMask,
    create_mask_for_mask_type,
)
from cinemri_tpu_torch.data.transforms import (
    center_crop,
    center_crop_to_smallest,
    filtered_crop_center_and_slices,
    normalize,
    normalize_instance,
    apply_mask_np,
    VarNetDataTransform,
    CineNetDataTransform,
    XPDNetDataTransform,
)
from cinemri_tpu_torch.data.espirit import espirit_maps
from cinemri_tpu_torch.data.compress import apply_compression, compression_matrix
from cinemri_tpu_torch.data.dataset import (
    PreprocessConfig,
    SliceDataset,
    CombinedSliceDataset,
    preprocess_volume,
)
from cinemri_tpu_torch.data.sharding import volume_shard_indices, data_shard_indices
from cinemri_tpu_torch.data import synthetic

__all__ = [
    "MaskFunc",
    "RandomMask",
    "EquispacedMask",
    "create_mask_for_mask_type",
    "center_crop",
    "center_crop_to_smallest",
    "filtered_crop_center_and_slices",
    "normalize",
    "normalize_instance",
    "apply_mask_np",
    "VarNetDataTransform",
    "CineNetDataTransform",
    "XPDNetDataTransform",
    "espirit_maps",
    "PreprocessConfig",
    "SliceDataset",
    "CombinedSliceDataset",
    "preprocess_volume",
    "volume_shard_indices",
    "data_shard_indices",
    "synthetic",
]
