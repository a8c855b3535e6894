"""Device meshes and batch sharding over processes.

Counterpart of ``cinemri_tpu/parallel/mesh.py``. The reference reaches
distribution through Lightning's DDP over NCCL, one process per GPU
(train_test_varnet.py:148-149,286-297). The port does the same: one device
per process, a ``torch.distributed`` process group over all of them, and a
:class:`~torch.distributed.device_mesh.DeviceMesh` with named dims over the
ranks, in the JAX package's order ``data x plane x coil``.

  * ``data``: the batch axis. Each process loads and places its own rows,
    the model is replicated, and the train step
    (:func:`cinemri_tpu_torch.train.step.make_train_step`) all-reduces the
    gradient once per step.
  * ``plane`` (sequence parallelism, XT / XF only): every rank of a plane
    group holds the same rows, and each runs the plane nets on its share of
    the ``b·h`` and ``b·w`` rotated-plane batches, then gathers the outputs
    (``models/varnet.py::VarNetCascade._xfyf`` and its CineNet / XPDNet
    counterparts, through :mod:`cinemri_tpu_torch.parallel.autograd`).
  * ``coil`` (tensor parallelism over the receive coils): each rank holds
    its range of the coil dim of ``masked_kspace`` and ``sens_maps``
    (:func:`shard_batch`), runs every per-coil op on it (the DFTs, the
    sensitivity net, the normal-apply kernel with λ = 0) and all-reduces
    each coil sum over the coil group (``physics/operators.py``).

In JAX both axes are sharding constraints that XLA's SPMD partitioner turns
into collectives, and the JAX CLI forces its XLA normal backend on a coil
axis (Pallas is opaque to the partitioner). Here the collectives are
explicit, in autograd, and the normal-apply kernel stays on: each rank runs
it on its own coils. Models name their axes (``plane_axis="plane"``,
``coil_axis="coil"``) and resolve them against the ambient mesh that
:func:`set_mesh` sets, the counterpart of ``jax.set_mesh``.

On the CPU the axes run as gloo processes:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_mesh.py -q -n 1``.
Through the CLI on cards: ``torchrun --nproc_per_node 4 -m
cinemri_tpu_torch.cli.train_test_varnet --num_devices 0 --coil_devices 2
--plane_devices 2 ...``; on one card, ``chip_smoke.py``'s ``[mesh]`` phase
runs two gloo ranks on it.

The JAX package's ``batch_sharding`` and ``replicated_sharding`` (the
placements of a batch and of the weights) have no counterpart: with one
device per process, each rank holds its rows and a full copy of the weights
as plain tensors, and nothing in the port needs a DTensor placement.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from cinemri_tpu_torch.parallel.distributed import local_device

__all__ = [
    "make_mesh",
    "set_mesh",
    "get_mesh",
    "mesh_axis",
    "mesh_coordinates",
    "mesh_lead",
    "partial_by_prefix",
    "MeshAxis",
    "shard_batch",
    "batch_partition_spec",
    "coil_shard",
    "ARRAY_KEYS",
]

ARRAY_KEYS = ("masked_kspace", "mask", "target", "sens_maps", "sample_weight")

# the batch fields with a receive-coil dim, and where (as the JAX package's)
_COIL_DIMS = {"masked_kspace": 2, "sens_maps": 2}

_AMBIENT: list = []


class MeshAxis(NamedTuple):
    """One named dim of the ambient mesh, as this rank sees it: its process
    group, its size and this rank's index along it."""

    name: str
    group: object
    size: int
    index: int


def make_mesh(shape: Optional[Dict[str, int]] = None) -> DeviceMesh:
    """A mesh over every rank of the process group (one device each);
    default: all of them on one ``data`` dim. Ranks fill the dims in row-major
    order, the last dim fastest, as ``np.reshape`` of JAX's device list. The
    group must be started first
    (:func:`~cinemri_tpu_torch.parallel.distributed.initialize`). Its device
    type follows the backend: ``cuda`` under NCCL, ``cpu`` under gloo (which
    carries CUDA tensors through the host)."""
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


@contextlib.contextmanager
def set_mesh(mesh: Optional[DeviceMesh]) -> Iterator[Optional[DeviceMesh]]:
    """Make ``mesh`` the ambient mesh inside the ``with`` block (the
    counterpart of ``jax.set_mesh``): models resolve their ``plane_axis``
    and ``coil_axis`` names against it. ``None`` leaves the ambient mesh as
    it is."""
    if mesh is None:
        yield get_mesh()
        return
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def get_mesh() -> Optional[DeviceMesh]:
    """The ambient mesh, or None outside :func:`set_mesh`."""
    return _AMBIENT[-1] if _AMBIENT else None


def _axis_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axis(name: str, mesh: Optional[DeviceMesh] = None) -> Optional[MeshAxis]:
    """The dim ``name`` of ``mesh`` (default: the ambient mesh). An empty
    name is None: the model runs unsharded on that axis, and so is a dim of
    size 1, which needs no collective. A name the mesh lacks, or any name
    without a mesh, is a ``ValueError``."""
    if not name:
        return None
    mesh = get_mesh() if mesh is None else mesh
    sizes = {} if mesh is None else _axis_sizes(mesh)
    if name not in sizes:
        where = "no mesh is set (parallel.set_mesh)" if mesh is None else f"mesh {sizes}"
        raise ValueError(f"mesh axis {name!r} is not in the ambient mesh: {where}")
    if sizes[name] == 1:
        return None
    return MeshAxis(name, mesh.get_group(name), sizes[name], mesh.get_local_rank(name))


def mesh_coordinates(mesh: DeviceMesh) -> Dict[str, int]:
    """This rank's index along every dim of ``mesh``."""
    return {n: mesh.get_local_rank(n) for n in mesh.mesh_dim_names}


def mesh_lead(mesh: Optional[DeviceMesh], data_axis: str = "data") -> bool:
    """Whether this rank is at index 0 of every dim of ``mesh`` but
    ``data_axis`` (True without a mesh): the one rank of its data group
    that counts and writes what the group's ranks all hold."""
    return mesh is None or all(i == 0 for n, i in mesh_coordinates(mesh).items()
                               if n != data_axis)


def partial_by_prefix(module, axes: Mapping[str, str]) -> Dict[str, Tuple[str, ...]]:
    """A model's ``partial_parameters()`` map: each parameter's mesh axes
    whose ranks each compute only a part of its gradient, the axis of the
    first prefix of ``axes`` (parameter-name prefix -> axis name, ``""``
    for none) that its name starts with."""
    out = {}
    for name, _ in module.named_parameters():
        axis = next((a for prefix, a in axes.items() if name.startswith(prefix)), "")
        out[name] = (axis,) if axis else ()
    return out


def batch_partition_spec(
    key: str, shape: Sequence[int], mesh: DeviceMesh, axis: str = "data",
    global_rows: Optional[int] = None,
) -> Tuple:
    """The mesh axis each dim of batch field ``key`` shards over, as the
    JAX package's ``PartitionSpec`` reads as a tuple (trailing ``None``s
    dropped): dim 0 shards over ``axis`` when the global row count
    (``global_rows``, default ``shape[0]``) divides the axis size, and on a
    mesh with a ``coil`` dim the coil dim of ``masked_kspace`` and
    ``sens_maps`` (dim 2) shards over it when their more than one coils
    divide it. The ``plane`` axis claims no input dim: the plane batches
    exist only inside the model."""
    sizes = _axis_sizes(mesh)
    spec = [None] * len(shape)
    rows = shape[0] if global_rows is None else global_rows
    if axis in sizes and rows % sizes[axis] == 0:
        spec[0] = axis
    coil_dim = _COIL_DIMS.get(key)
    if (coil_dim is not None and "coil" in sizes and len(shape) > coil_dim
            and shape[coil_dim] % sizes["coil"] == 0 and shape[coil_dim] > 1):
        spec[coil_dim] = "coil"
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def coil_shard(x, axis_name: str, dim: int = 2, mesh: Optional[DeviceMesh] = None):
    """This rank's range of the coil dim ``dim`` of ``x`` (a tensor, numpy
    array or Complex pair, given whole) on the mesh axis ``axis_name``: the
    counterpart of ``physics.constrain_coil_axis``, which pins the same
    layout in JAX. ``x`` itself when the name is empty or its axis has one
    rank. A coil count that does not divide the axis raises the JAX
    package's ``ValueError``."""
    ax = mesh_axis(axis_name, mesh)
    if ax is None:
        return x
    shape = tuple((x.re if hasattr(x, "re") else x).shape)
    if shape[dim] % ax.size:
        raise ValueError(
            f"coil dimension of size {shape[dim]} (shape {shape}, "
            f"dim {dim}) does not divide over the {ax.size}-device "
            f"{axis_name!r} mesh axis — pick a coil-axis size that divides "
            "the (possibly --compress_coils-reduced) coil count"
        )
    n = shape[dim] // ax.size
    index = (slice(None),) * dim + (slice(ax.index * n, (ax.index + 1) * n),)
    if hasattr(x, "re"):
        return type(x)(x.re[index], x.im[index])
    return x[index]


def shard_batch(batch: Dict, mesh: Optional[DeviceMesh], axis: str = "data",
                device=None) -> Dict:
    """This process's part of the host batch fields (:data:`ARRAY_KEYS`,
    numpy) on its device (``device``, default :func:`local_device`); complex
    arrays become :class:`~cinemri_tpu_torch.ops.cplx.Complex` pairs, as in
    the JAX package, so complex dtypes never reach the device.

    On a mesh, each process passes its **local** rows (the shard its Loader
    produced with ``num_replicas`` the ``axis`` size and ``rank`` its index
    there), as in the JAX package's multi-process path; the global batch is
    the data groups' rows in order. The rows must shard over ``axis``: one
    device per process leaves no replicated layout to fall back on (a mesh
    without that dim holds the whole batch on every rank). On a
    ``coil`` dim, ``masked_kspace`` and ``sens_maps`` keep this rank's coil
    range (:func:`coil_shard`), so their coils must divide it.
    """
    from cinemri_tpu_torch.train.device_cache import to_device

    device = local_device(device)
    sizes = {} if mesh is None else _axis_sizes(mesh)
    data = sizes.get(axis, 1)
    out = {}
    for k in ARRAY_KEYS:
        if k not in batch:
            continue
        v = np.asarray(batch[k])
        if mesh is not None:
            spec = batch_partition_spec(k, v.shape, mesh, axis, global_rows=len(v) * data)
            if axis in sizes and spec[:1] != (axis,):
                raise ValueError(f"{k}: {len(v) * data} global rows do not shard over the "
                                 f"{axis!r} axis of mesh {_axis_sizes(mesh)}")
            if k in _COIL_DIMS and "coil" in mesh.mesh_dim_names:
                v = coil_shard(v, "coil", _COIL_DIMS[k], mesh)
        out[k] = to_device(np.ascontiguousarray(v), device)[0]
    return out
