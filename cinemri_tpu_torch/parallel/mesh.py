"""Device meshes and batch sharding over processes.

Counterpart of ``cinemri_tpu/parallel/mesh.py``. The reference reaches
distribution through Lightning's DDP over NCCL, one process per GPU
(train_test_varnet.py:148-149,286-297). The port does the same: one device
per process, a ``torch.distributed`` process group over all of them, and a
:class:`~torch.distributed.device_mesh.DeviceMesh` with named dims over the
ranks. The batch axis is sharded over the ``data`` dim (each process loads
and places its own rows), the model is replicated, and the train step
(:func:`cinemri_tpu_torch.train.step.make_train_step`) all-reduces the
gradient once per step.

The JAX package's ``plane`` and ``coil`` axes (sequence and tensor
parallelism of the XT/XF plane batches and the receive coils) are not
ported yet (ROADMAP Queue 1, item 13b): :func:`batch_partition_spec`
refuses a ``coil`` axis, and the train step and the Trainer refuse any mesh
dim but ``data``.

The JAX package's ``batch_sharding`` and ``replicated_sharding`` (the
placements of a batch and of the weights) have no counterpart: with one
device per process, each rank holds its rows and a full copy of the weights
as plain tensors, and nothing in the port needs a DTensor placement.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from cinemri_tpu_torch.parallel.distributed import local_device

__all__ = [
    "make_mesh",
    "shard_batch",
    "batch_partition_spec",
    "ARRAY_KEYS",
]

ARRAY_KEYS = ("masked_kspace", "mask", "target", "sens_maps", "sample_weight")

_ITEM_13B = "ROADMAP Queue 1, item 13b: the plane and coil axes"


def make_mesh(shape: Optional[Dict[str, int]] = None) -> DeviceMesh:
    """A mesh over every rank of the process group (one device each);
    default: all of them on one ``data`` dim. The group must be started
    first (:func:`~cinemri_tpu_torch.parallel.distributed.initialize`). Its
    device type follows the backend: ``cuda`` under NCCL, ``cpu`` under
    gloo (which carries CUDA tensors through the host)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "cinemri_tpu_torch.parallel.initialize first")
    world = dist.get_world_size()
    if shape is None:
        shape = {"data": world}
    names, dims = tuple(shape.keys()), tuple(int(d) for d in shape.values())
    if math.prod(dims) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(dims)} devices, have {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, dims, mesh_dim_names=names)


def _axis_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_partition_spec(
    key: str, shape: Sequence[int], mesh: DeviceMesh, axis: str = "data",
    global_rows: Optional[int] = None,
) -> Tuple:
    """The mesh axis each dim of batch field ``key`` shards over, as the
    JAX package's ``PartitionSpec`` reads as a tuple (trailing ``None``s
    dropped): dim 0 shards over ``axis`` when the global row count
    (``global_rows``, default ``shape[0]``) divides the axis size. The
    ``plane`` axis claims no input dim; a ``coil`` axis is not ported yet."""
    sizes = _axis_sizes(mesh)
    if "coil" in sizes:
        raise NotImplementedError(f"the coil mesh axis is not ported yet ({_ITEM_13B})")
    spec = [None] * len(shape)
    rows = shape[0] if global_rows is None else global_rows
    if axis in sizes and rows % sizes[axis] == 0:
        spec[0] = axis
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def shard_batch(batch: Dict, mesh: Optional[DeviceMesh], axis: str = "data",
                device=None) -> Dict:
    """This process's rows of the host batch fields (:data:`ARRAY_KEYS`,
    numpy) on its device (``device``, default :func:`local_device`); complex
    arrays become :class:`~cinemri_tpu_torch.ops.cplx.Complex` pairs, as in
    the JAX package, so complex dtypes never reach the device.

    On a mesh, each process passes its **local** rows (the shard its Loader
    produced with ``num_replicas=world``), as in the JAX package's
    multi-process path; the global batch is the ranks' rows in rank order.
    The rows must shard over ``axis``: one device per process leaves no
    replicated layout to fall back on.
    """
    from cinemri_tpu_torch.train.device_cache import to_device

    device = local_device(device)
    world = dist.get_world_size() if mesh is not None else 1
    out = {}
    for k in ARRAY_KEYS:
        if k not in batch:
            continue
        v = np.asarray(batch[k])
        if mesh is not None:
            spec = batch_partition_spec(k, v.shape, mesh, axis, global_rows=len(v) * world)
            if spec[:1] != (axis,):
                raise ValueError(f"{k}: {len(v) * world} global rows do not shard over the "
                                 f"{axis!r} axis of mesh {_axis_sizes(mesh)}")
        out[k] = to_device(v, device)[0]
    return out
