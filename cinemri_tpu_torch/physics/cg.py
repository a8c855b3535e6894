"""Conjugate-gradient solver with on-device scalars.

Counterpart of ``cinemri_tpu/physics/cg.py``: a fixed number of CG steps on
``H x = b`` with the inner products taken over the real view of the complex
tensors (:func:`~cinemri_tpu_torch.ops.cplx.real_dot`, summed over every
axis, the batch axis included, so the step sizes are shared across a
batch, as in the reference's flattened ``torch.dot``).

The JAX package runs the loop as a ``lax.fori_loop`` whose step sizes stay
on the device. Here it is a Python loop over ``iters`` steps whose step
sizes α, β and residual norms are 0-d device tensors: nothing is read to
the host, so a CineNet forward makes no host sync in its CG solves.
Autograd differentiates through the loop, as ``jax.grad`` does through the
``fori_loop``.

The last step stops after its ``x`` update: its residual and direction
updates do not reach the result (XLA drops them from the JAX loop as dead
code), and leaving them out also keeps them out of a checkpoint's replay.

CUDA graphs. Each CG step queues about 34 small kernels, and a served
request on the card is paced by the host that queues them. Where nothing
records gradients, a solve can therefore run as CUDA graphs
(:class:`GraphedSolve`): captured once from the eager body, one graph for
each stretch between two operator calls and one for each call (the normal
apply), replayed in order on static buffers. The graphs hold the eager
body's kernels in its order on its layouts, so results are the eager loop's
bits; an operator call's replay keeps its op's profiler record and launch
counts. Whether a solve may take it is decided from its inputs alone
(:func:`graph_blocker`); what a thread's solves hold is kept per key
(:func:`kept`). :data:`GRAPH_CAPTURES` and :data:`GRAPH_REPLAYS` count
captures and replays. No CG step runs on the host in a replay, so no
``cinemri.dc.cg_step`` span opens there.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence

import torch

from torch.utils._python_dispatch import TorchDispatchMode

from cinemri_tpu_torch.instrument import op_call, span
from cinemri_tpu_torch.ops.cplx import Complex, real_dot
from cinemri_tpu_torch.ops.kernels import counted

__all__ = ["conj_grad", "graph_blocker", "layout", "GraphedSolve", "kept", "clear_graphs",
           "GRAPH_CAPTURES", "GRAPH_REPLAYS", "GRAPH_CACHE"]

GRAPH_CAPTURES = 0
GRAPH_REPLAYS = 0
# What :func:`kept` keeps, the least recently used dropped first.
GRAPH_CACHE = 4

_GRAPHS: "OrderedDict[tuple, object]" = OrderedDict()
_LOCK = threading.Lock()
_NO_CALL = contextlib.nullcontext()


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b``, and 0 where ``b == 0``: an exhausted residual gives a zero
    step. The inner ``where`` keeps the division (and its gradient) finite
    on the branch that is not taken."""
    ok = b != 0
    return torch.where(ok, a / torch.where(ok, b, torch.ones_like(b)), torch.zeros_like(a))


def conj_grad(operator: Callable[[Complex], Complex], rhs: Complex, x0: Complex,
              iters: int) -> Complex:
    """Run ``iters`` CG steps on ``operator(x) = rhs`` starting from ``x0``."""
    x = x0
    r = rhs - operator(x0)
    p = r
    rs_old = real_dot(r, r)
    for i in range(iters):
        with span("cinemri.dc.cg_step"):
            d = operator(p)
            alpha = _safe_div(rs_old, real_dot(p, d))
            x = x + alpha * p
            if i == iters - 1:
                break
            r = r - alpha * d
            rs_new = real_dot(r, r)
            beta = _safe_div(rs_new, rs_old)
            p = r + beta * p
            rs_old = rs_new
    return x


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill its span of memory, in any order of its
    dims, without gaps or overlaps: ``torch.empty_like(t)`` then has its
    strides."""
    n = 1
    for size, stride in sorted((d for d in zip(t.shape, t.stride()) if d[0] != 1),
                               key=lambda d: d[1]):
        if stride != n:
            return False
        n *= size
    return t.numel() > 0


def graph_blocker(tensors: Sequence[torch.Tensor], coil_axis: str = "") -> Optional[str]:
    """Why a solve over ``tensors`` may not run as CUDA graphs, or None
    where it may.

    ``"coil axis"``: a ``coil_axis`` puts a collective inside the operator;
    ``"gradient"``: grad mode is on, so autograd would record the solve (a
    train step, a checkpoint's replay; with grad mode off, as in ``no_grad``
    or inference mode, nothing is recorded whatever ``requires_grad`` says);
    ``"trace"``: ``torch.export`` or the compiler traces; ``"layout"``: a
    tensor is empty or has gaps or overlaps (a slice, a broadcast view), so
    a buffer made like it would not have its strides, and the eager loop's
    outputs and sums follow its operands' strides; ``"device"``: a tensor is
    not on the first one's CUDA device; ``"capture"``: the current stream is
    already capturing a graph.
    """
    if coil_axis:
        return "coil axis"
    if torch.is_grad_enabled():
        return "gradient"
    if torch.compiler.is_compiling():
        return "trace"
    if not tensors or not all(_dense(t) for t in tensors):
        return "layout"
    if any(t.device.type != "cuda" or t.device != tensors[0].device for t in tensors):
        return "device"
    if torch.cuda.is_current_stream_capturing():
        return "capture"
    return None


def layout(tensors: Sequence[torch.Tensor]) -> tuple:
    """The device, shapes, strides and dtypes of ``tensors``: what a graph
    captured over buffers made like them depends on."""
    return (tensors[0].device,) + tuple((tuple(t.shape), t.stride(), t.dtype) for t in tensors)


class _OpCalls(TorchDispatchMode):
    """The calls of ops outside ``aten`` and ``prims`` (the port's custom
    ops) made while entered: each op's schema name and all its arguments,
    defaults included, the tensors as meta tensors of their shapes, strides
    and dtypes."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace not in ("aten", "prims"):
            rest = func._schema.arguments[len(args):]
            values = list(args) + [kwargs.get(a.name, a.default_value) for a in rest]
            meta = [torch.empty_strided(v.shape, v.stride(), dtype=v.dtype, device="meta")
                    if torch.is_tensor(v) else v for v in values]
            self.calls.append((func._schema.name, meta))
        return func(*args, **kwargs)


class GraphedSolve:
    """``body(apply, *inputs)`` as CUDA graphs over the static buffers
    ``inputs`` (dense, on one device; made outside inference mode, so that
    served and ``no_grad`` calls both write them): one graph for each
    stretch of ``body`` between two operator calls, and one for each call.

    ``body`` reads no tensor but its arguments, calls its operator only as
    ``apply(z, *extra)``, and leaves its result in its arguments, in place,
    returning views of them, valid until the next call.

    ``solve(operator, *tensors)`` copies each tensor into its buffer (one
    that is the buffer itself is not copied, so a caller copies what does
    not change between calls once) and runs ``body`` with ``apply =
    operator``: the first call eagerly, which also loads every kernel, and
    then captures it on a side stream; later calls replay the graphs in
    order and leave ``operator`` uncalled, so the operator captured must
    read only tensors that stay in place (the body's, and buffers the
    caller refills). The graphs share one private memory pool, which holds
    the intermediates.

    An operator call's graph is replayed inside a host record of the op it
    called (:func:`~cinemri_tpu_torch.instrument.op_call`, where it called
    one), so a trace links its kernels to a call of that op, with the
    operands' shapes, as it does an eager call's; and the launch counts the
    kernel wrappers logged at the capture
    (:func:`~cinemri_tpu_torch.ops.kernels.counted`) are taken again.
    """

    def __init__(self, body: Callable, inputs: List[torch.Tensor]):
        self.inputs = inputs
        self._body = body
        self._pieces = None
        self._out = None

    def fits(self, tensors: Sequence[torch.Tensor]) -> bool:
        """Whether ``tensors`` have the buffers' layouts."""
        return layout(tensors) == layout(self.inputs)

    def __call__(self, operator: Callable, *tensors: torch.Tensor):
        global GRAPH_REPLAYS
        for s, t in zip(self.inputs, tensors):
            if t is not s:
                s.copy_(t)
        if self._pieces is None:
            out = self._body(operator, *self.inputs)
            self._capture(operator)
            return out
        for graph, call, counts in self._pieces:
            with op_call(*call) if call else _NO_CALL:
                graph.replay()
            for fn, args in counts:
                fn(*args)
        GRAPH_REPLAYS += 1
        return self._out

    def _capture(self, operator: Callable) -> None:
        global GRAPH_CAPTURES
        pool, pieces, graph = torch.cuda.graph_pool_handle(), [], None

        def begin():
            nonlocal graph
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")

        def end(call=None, counts=()):
            graph.capture_end()
            pieces.append((graph, call, counts))

        def cut(z: Complex, *extra):
            end()
            begin()
            with _OpCalls() as ops, counted() as counts:
                d = operator(z, *extra)
            end(ops.calls[0] if len(ops.calls) == 1 else None, counts)
            begin()
            return d

        with torch.inference_mode(False), torch.no_grad(), torch.cuda.device(self.inputs[0].device):
            current = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                begin()
                try:
                    self._out = self._body(cut, *self.inputs)
                finally:
                    end()
            current.wait_stream(side)
        self._pieces = pieces
        GRAPH_CAPTURES += 1


def kept(key: tuple, make: Callable):
    """``make()``, made at the first use of ``key`` on the calling thread and
    kept with the :data:`GRAPH_CACHE` most recently used: what graphed
    solves hold (buffers, graphs and their memory pool) is per thread, since
    a buffer holds one call's inputs at a time."""
    full = (threading.get_ident(),) + key
    with _LOCK:
        held = _GRAPHS.pop(full, None)
        if held is None:
            held = make()
        _GRAPHS[full] = held
        while len(_GRAPHS) > GRAPH_CACHE:
            _GRAPHS.popitem(last=False)
    return held


def clear_graphs() -> None:
    """Drop everything :func:`kept` keeps, which frees the buffers and the
    graphs' pools once no caller holds them."""
    with _LOCK:
        _GRAPHS.clear()
