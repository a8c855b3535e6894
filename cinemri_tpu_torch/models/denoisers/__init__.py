"""Denoisers of the port: U-Nets (2-D / 3-D) and their normalized
wrappers, MWCNN, XPDNet's k-space CNN and the CRNN blocks, each also on
the space-to-depth layout of ``packed_unet``."""

from cinemri_tpu_torch.models.denoisers.crnn import BCRNN, CRNNCell, FusedSumConv2d  # noqa: F401
from cinemri_tpu_torch.models.denoisers.kspace_cnn import KSpaceCNN  # noqa: F401
from cinemri_tpu_torch.models.denoisers.mwcnn import MWCNN, MWConvBlock  # noqa: F401
from cinemri_tpu_torch.models.denoisers.norm_unet import NormUnet, NormUnet3D  # noqa: F401
from cinemri_tpu_torch.models.denoisers.unet import Unet  # noqa: F401
