"""Denoisers of the port: U-Net and its normalized wrapper."""

from cinemri_tpu_torch.models.denoisers.norm_unet import NormUnet  # noqa: F401
from cinemri_tpu_torch.models.denoisers.unet import Unet  # noqa: F401
