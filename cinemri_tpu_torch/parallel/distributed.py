"""Multi-process support on ``torch.distributed``.

Counterpart of ``cinemri_tpu/parallel/distributed.py``. The reference
trains across processes through Lightning DDP over NCCL, one process per
GPU, with rank-aware samplers and metric reduction (SURVEY §2b). Here:

  * :func:`initialize` starts the process group: NCCL when the rank's
    device is CUDA, gloo on the CPU, over TCP at ``host:port`` (or any
    ``torch.distributed`` init URL, e.g. ``file://`` for tests); with no
    arguments, from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``). A no-op at one
    process.
  * :func:`process_info` is ``(rank, world)`` for host-side data sharding
    (``Loader(num_replicas=world, rank=rank)``).
  * :func:`make_process_sum` is the ``DistributedMetricSum`` analogue
    (mri_module.py:22-32): a float64 all-reduce of one host scalar, for
    :class:`~cinemri_tpu_torch.train.metrics_agg.MetricsAggregator`'s
    ``reduce_fn``. The identity on one process.
  * :func:`local_device` names the rank's device.

Every collective the port issues goes through the wrappers here, which
count it in :data:`COLLECTIVES` (calls) and :data:`COLLECTIVE_BYTES` by
kind, as the kernel wrappers count their launches: ``"grad"`` (the train
step's one gradient all-reduce), ``"scalar"`` (the step's and the loop's
scalar all-reduces), ``"metric"`` (:func:`make_process_sum`),
``"broadcast"``, ``"barrier"``, ``"object"``, and the model's own
collectives on the mesh axes (``parallel/autograd.py``): ``"coil"`` (the
coil sums and their backward) and ``"plane"`` (the plane batches' gathers
and their backward). Reset them with ``.clear()``.
"""

from __future__ import annotations

import collections
import datetime
import os
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from cinemri_tpu_torch import resolve_device

__all__ = [
    "initialize",
    "process_info",
    "make_process_sum",
    "local_device",
    "all_reduce_sum",
    "all_gather",
    "broadcast_tensors",
    "barrier",
    "all_gather_object",
    "COLLECTIVES",
    "COLLECTIVE_BYTES",
    "DEFAULT_TIMEOUT",
]

#: collectives issued by this process, by kind: calls and bytes
COLLECTIVES: collections.Counter = collections.Counter()
COLLECTIVE_BYTES: collections.Counter = collections.Counter()

#: how long a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def local_device(device=None, rank: Optional[int] = None) -> torch.device:
    """The device this rank runs on: the CPU when ``device`` asks for it,
    else ``cuda:LOCAL_RANK``. Without ``LOCAL_RANK`` (a launch by
    ``--process_id``), the local rank is the global ``rank`` modulo the
    host's cards, so consecutive ranks take one card each. An explicit
    ``cuda:N`` is kept. Raises without a CUDA device, as
    :func:`~cinemri_tpu_torch.resolve_device` does."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    rank = process_info()[0] if rank is None else rank
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> Tuple[int, int]:
    """Join the process group; returns ``(rank, world)``.

    With ``num_processes > 1``, this is process ``process_id`` of
    ``num_processes``, meeting the others at ``coordinator_address``
    (``host:port`` of process 0's TCP store, or an init URL); without an
    address, at torchrun's ``MASTER_ADDR:MASTER_PORT``. With neither
    (``num_processes`` None or 1, no address), torchrun's environment
    decides, and a run with no ``WORLD_SIZE`` above 1 is a single process:
    nothing is started. ``device`` is the rank's device (:func:`local_device`):
    CUDA takes NCCL, bound to that card; the CPU takes gloo. ``timeout``
    bounds every collective, so a rank that never arrives is an error, not
    a stall. A second call returns the group already joined.
    """
    if dist.is_initialized():
        return process_info()
    num_processes = 1 if num_processes is None else int(num_processes)
    process_id = 0 if process_id is None else int(process_id)
    if not 0 <= process_id < max(num_processes, 1):
        raise ValueError(f"--process_id {process_id} is not in [0, {num_processes}) "
                         f"(--num_processes {num_processes})")
    if num_processes > 1:
        rank, world = process_id, num_processes
        if coordinator_address is not None:
            init_method = (coordinator_address if "://" in coordinator_address
                           else f"tcp://{coordinator_address}")
        elif "MASTER_ADDR" in os.environ:
            init_method = "env://"
        else:
            raise ValueError(
                f"--num_processes {num_processes} needs --coordinator_address host:port "
                "(process 0's address and a free port), or torchrun's MASTER_ADDR/MASTER_PORT")
    elif coordinator_address is None and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        rank, world, init_method = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://"
    else:
        return 0, 1
    dev = local_device(device, rank)
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend, kwargs["device_id"] = "nccl", dev
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=timeout, **kwargs)
    return process_info()


def process_info() -> Tuple[int, int]:
    """``(rank, world)``; ``(0, 1)`` outside a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _collective_device() -> torch.device:
    """Where host scalars go for a collective: the current card under NCCL,
    the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _count(kind: str, nbytes: int) -> None:
    COLLECTIVES[kind] += 1
    COLLECTIVE_BYTES[kind] += int(nbytes)


def all_reduce_sum(tensor: torch.Tensor, kind: str, group=None) -> torch.Tensor:
    """Sum ``tensor`` in place over ``group`` (default: all ranks)."""
    _count(kind, tensor.numel() * tensor.element_size())
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


def all_gather(tensor: torch.Tensor, kind: str, group=None) -> List[torch.Tensor]:
    """Every rank's ``tensor`` of ``group`` (default: all ranks), in the
    group's rank order; all must have one shape."""
    n = dist.get_world_size(group)
    _count(kind, tensor.numel() * tensor.element_size() * n)
    out = [torch.empty_like(tensor) for _ in range(n)]
    dist.all_gather(out, tensor.contiguous(), group=group)
    return out


def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` (one dtype, one device) with rank ``src``'s, as
    one flat broadcast; nothing at one process."""
    tensors = list(tensors)
    if process_info()[1] == 1 or not tensors:
        return
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        _count("broadcast", flat.numel() * flat.element_size())
        dist.broadcast(flat, src=src)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def barrier() -> None:
    """Wait for every rank; nothing at one process."""
    if process_info()[1] == 1:
        return
    _count("barrier", 0)
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_gather_object(obj) -> List:
    """Every rank's picklable ``obj``, in rank order; ``[obj]`` at one
    process."""
    if process_info()[1] == 1:
        return [obj]
    _count("object", 0)
    out: List = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def make_process_sum(mesh=None) -> Callable[[float], float]:
    """Scalar all-reduce-sum across processes (identity on one process).
    With a ``mesh``, the sum runs over its ``data`` group only (none for a
    mesh without that dim): the ranks that differ in their ``plane`` and
    ``coil`` coordinates hold the same volumes, so each volume is counted
    once."""
    if process_info()[1] == 1 or (mesh is not None and "data" not in mesh.mesh_dim_names):
        return lambda x: float(x)
    device = _collective_device()
    group = None if mesh is None else mesh.get_group("data")

    def reduce_fn(x: float) -> float:
        t = torch.tensor([float(x)], dtype=torch.float64, device=device)
        return float(all_reduce_sum(t, "metric", group).item())

    return reduce_fn
