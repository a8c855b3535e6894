"""The mesh axes' collectives, as autograd Functions.

The JAX package has no counterpart: there XLA's SPMD partitioner writes
these collectives from the models' sharding constraints. With one device
per process, the port writes them in the model, in the Megatron pattern:

  * :func:`copy_to_group` where a replicated tensor enters work that each
    rank does on its own part (its coils): the identity forward, and a
    backward that sums the ranks' partial cotangents;
  * :func:`reduce_from_group` where the ranks' partial results become one
    replicated tensor (a coil sum): an all-reduce forward, and the identity
    backward, since everything after it is replicated and each rank already
    holds the whole cotangent (``torch.distributed.nn.functional.all_reduce``
    would all-reduce it again, counting that cotangent n times);
  * :func:`slice_rows` where each rank takes its rows of a replicated batch
    (the plane batches): the backward all-gathers the rows' cotangents, so
    the input's gradient is whole on every rank;
  * :func:`gather_rows`, its inverse: an all-gather forward, and a backward
    that takes the rank's rows.

Each takes any number of tensors and moves them in one collective through
``parallel.distributed``'s counted wrappers, under the axis's name as the
kind (``"coil"``, ``"plane"``). :func:`split_rows` runs a function on the
rank's share of a row batch, whose count need not divide the axis.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from cinemri_tpu_torch.ops.cplx import Complex
from cinemri_tpu_torch.parallel.distributed import all_gather, all_reduce_sum
from cinemri_tpu_torch.parallel.mesh import MeshAxis

__all__ = ["copy_to_group", "reduce_from_group", "slice_rows", "gather_rows", "split_rows"]


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    out, offset = [], 0
    for t in like:
        out.append(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()
    return tuple(out)


def _all_reduce(ax: MeshAxis, tensors) -> Tuple[torch.Tensor, ...]:
    """The group's sum of each of ``tensors``, in one all-reduce."""
    return _unflat(all_reduce_sum(_flat(tensors), ax.name, ax.group), tensors)


def _gather(ax: MeshAxis, tensors) -> Tuple[torch.Tensor, ...]:
    """Each of ``tensors`` (rows on dim 0, one shape on every rank) with
    the group's rows concatenated in rank order, in one all-gather."""
    parts = [_unflat(p, tensors) for p in all_gather(_flat(tensors), ax.name, ax.group)]
    return tuple(torch.cat(ts) for ts in zip(*parts))


def _rows(ax: MeshAxis, tensors) -> Tuple[torch.Tensor, ...]:
    return tuple(t.chunk(ax.size)[ax.index].contiguous() for t in tensors)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, *xs):
        ctx.ax = ax
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + _all_reduce(ctx.ax, gs)


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, *xs):
        return _all_reduce(ax, xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + gs


class _SliceRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, *xs):
        ctx.ax = ax
        return _rows(ax, xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + _gather(ctx.ax, gs)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, *xs):
        ctx.ax = ax
        return _gather(ax, xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + _rows(ctx.ax, gs)


def _apply(fn, ax: Optional[MeshAxis], xs):
    if ax is None:
        return xs
    return fn.apply(ax, *xs)


def copy_to_group(ax: Optional[MeshAxis], *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``xs`` as they are; their gradients summed over ``ax``'s group."""
    return _apply(_CopyToGroup, ax, xs)


def reduce_from_group(ax: Optional[MeshAxis], *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``xs`` summed over ``ax``'s group; their gradients passed through."""
    return _apply(_ReduceFromGroup, ax, xs)


def slice_rows(ax: Optional[MeshAxis], *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """This rank's ``1/size`` of the rows (dim 0) of each of ``xs``, whose
    row count the group size divides; their gradients all-gathered."""
    return _apply(_SliceRows, ax, xs)


def gather_rows(ax: Optional[MeshAxis], *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The group's rows of each of ``xs`` concatenated in rank order; their
    gradients sliced back to this rank's rows."""
    return _apply(_GatherRows, ax, xs)


def split_rows(fn: Callable, ax: Optional[MeshAxis], x):
    """``fn(x)`` with the rows (dim 0) of ``x`` (a tensor or a Complex pair)
    split over ``ax``'s group: each rank runs ``fn`` on its ``ceil(n /
    size)`` rows and the outputs are gathered, in the same row order. ``fn``
    must treat rows one by one (the plane nets normalize each plane by
    itself) and return n rows, a tensor or a Complex pair. A count n the
    group does not divide is padded with copies of the last row, whose
    outputs are dropped: their cotangent is 0, so they add nothing to any
    gradient (JAX's sharding pads an uneven split the same way)."""
    if ax is None:
        return fn(x)
    parts = (x.re, x.im) if isinstance(x, Complex) else (x,)
    n = parts[0].shape[0]
    pad = -n % ax.size
    if pad:
        parts = tuple(torch.cat([p, p[-1:].expand(pad, *p.shape[1:])]) for p in parts)
    parts = slice_rows(ax, *parts)
    out = fn(Complex(*parts) if isinstance(x, Complex) else parts[0])
    cplx = isinstance(out, Complex)
    out = gather_rows(ax, *((out.re, out.im) if cplx else (out,)))
    out = tuple(o[:n] for o in out)
    return Complex(*out) if cplx else out[0]
