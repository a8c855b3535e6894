"""Weights from elsewhere into the port.

``import_torch_checkpoint`` loads a trained reference Lightning ``.ckpt``
(the reference's train_test_varnet.py:107-109 artifact) into the port's
state dict, through the JAX package's tree layout (``port``,
``flax_params``); ``flax_params`` also carries JAX-package parameter trees.
"""

from .torch_import import (  # noqa: F401
    build_kwargs_from_hparams,
    check_tree_matches,
    import_torch_checkpoint,
    tree_from_state_dict,
)
from . import port  # noqa: F401
