"""Parallelism (counterpart of ``cinemri_tpu/parallel``): process groups,
device meshes, batch sharding and distributed reductions: the JAX
package's export list without ``batch_sharding`` and ``replicated_sharding``
(``parallel/mesh.py`` says why), with the ambient mesh (``set_mesh``, the
counterpart of ``jax.set_mesh``) and the coil split of a whole tensor
(``coil_shard``). The mesh axes' collectives are ``parallel/autograd.py``."""

from cinemri_tpu_torch.parallel.mesh import (
    make_mesh,
    set_mesh,
    mesh_coordinates,
    mesh_lead,
    coil_shard,
    shard_batch,
    batch_partition_spec,
    ARRAY_KEYS,
)
from cinemri_tpu_torch.parallel.distributed import (
    initialize,
    process_info,
    make_process_sum,
)

__all__ = [
    "make_mesh",
    "set_mesh",
    "mesh_coordinates",
    "mesh_lead",
    "coil_shard",
    "shard_batch",
    "batch_partition_spec",
    "ARRAY_KEYS",
    "initialize",
    "process_info",
    "make_process_sum",
]
