"""MRI encoding-operator algebra on Complex (re, im) pairs."""

from cinemri_tpu_torch.physics.operators import (  # noqa: F401
    apply_mask,
    coil_weight,
    get_normal_backend,
    is_line_mask,
    masked_normal_kernel,
    normal_plus_lambda_kernel,
    sens_expand,
    sens_reduce,
    set_normal_backend,
    soft_dc,
    soft_dc_image_kernel,
)
