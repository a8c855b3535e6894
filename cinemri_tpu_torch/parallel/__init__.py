"""Parallelism (counterpart of ``cinemri_tpu/parallel``): process groups,
device meshes, batch sharding and distributed reductions: the JAX
package's export list without ``batch_sharding`` and ``replicated_sharding``
(``parallel/mesh.py`` says why)."""

from cinemri_tpu_torch.parallel.mesh import (
    make_mesh,
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
    "shard_batch",
    "batch_partition_spec",
    "ARRAY_KEYS",
    "initialize",
    "process_info",
    "make_process_sum",
]
