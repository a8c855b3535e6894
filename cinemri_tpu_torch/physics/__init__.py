"""MRI encoding-operator algebra on Complex (re, im) pairs, and the
conjugate-gradient solver."""

from cinemri_tpu_torch.physics.cg import conj_grad  # noqa: F401
from cinemri_tpu_torch.physics.operators import (  # noqa: F401
    apply_mask,
    coil_weight,
    get_normal_backend,
    is_line_mask,
    masked_normal_kernel,
    normal_plus_lambda,
    normal_plus_lambda_kernel,
    sens_expand,
    sens_reduce,
    set_normal_backend,
    soft_dc,
    soft_dc_image_kernel,
    soft_sense_expand,
    soft_sense_recon,
    soft_sense_reduce,
    soft_sense_rss,
)
from cinemri_tpu_torch.physics.lowfreq import low_frequency_kspace  # noqa: F401
