"""Where CineNet's CG data consistency runs as CUDA graphs
(``physics.cg.graph_blocker``, ``physics.cg.GraphedSolve``,
``physics.operators.CGDataConsistency``), on the CPU.

The CPU never takes the graphs, and neither does a recorded gradient or a
coil axis: those tests check that the counters stay at 0. The solve's data
flow (x_ref, K and maps bound once a request, the result left in the
buffers of the denoiser's output, replays, the normal applies' op records)
is then run with a stand-in for the CUDA graph API whose
capture records the aten calls it makes (and then undoes what they wrote,
as a capture computes nothing) and whose replay makes them again into the
recorded outputs, so that on the CPU a replay gives the eager loop's bits as
the card's does. The card itself is ``tests/test_torch_cuda.py``'s.
"""

import contextlib
import threading

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cinemri_tpu_torch.models import build_model
from cinemri_tpu_torch.ops.cplx import Complex
from cinemri_tpu_torch.physics import cg
from cinemri_tpu_torch.physics import operators as TO
from cinemri_tpu_torch.physics.operators import CGDataConsistency, masked_normal_kernel

B, T, C, H, W = 1, 3, 2, 16, 12
SMALL = {"XF": dict(num_cascades=3, cg_iters=2, chans=2, pools=1),
         "XT": dict(num_cascades=2, cg_iters=2, chans=2, pools=1),
         "3D": dict(num_cascades=2, cg_iters=2, chans=2, pools=1),
         "CRNN": dict(num_cascades=2, cg_iters=2, chans=4)}


def _request(seed):
    g = torch.Generator().manual_seed(seed)
    mask = (torch.rand(B, T, 1, H, 1, generator=g) < 0.5).float()
    k = Complex(torch.randn(B, T, C, H, W, generator=g) * mask,
                torch.randn(B, T, C, H, W, generator=g) * mask)
    s = Complex(torch.randn(B, 1, C, H, W, generator=g), torch.randn(B, 1, C, H, W, generator=g))
    return k, mask, s


def _model(dyn, **kw):
    return build_model("cinenet", dyn, device="cpu", generator=torch.Generator().manual_seed(0),
                       **{**SMALL[dyn], **kw})


def _counters():
    return cg.GRAPH_CAPTURES, cg.GRAPH_REPLAYS


@pytest.mark.parametrize("case,why", [
    ("cpu", "device"), ("cpu_inference", "device"), ("grad_mode", "gradient"),
    ("coil_axis", "coil axis"), ("slice", "layout"), ("broadcast", "layout"), ("empty", "layout")])
def test_graph_blocker_names_what_keeps_a_solve_eager(case, why):
    x = torch.randn(2, 3, 4)
    tensors = {"slice": [x[:, :, :2]], "broadcast": [torch.randn(2, 1).expand(2, 5)],
               "empty": [torch.randn(0, 3)]}.get(case, [x, torch.randn(())])
    grad = torch.enable_grad() if case == "grad_mode" else torch.no_grad()
    mode = torch.inference_mode() if case == "cpu_inference" else contextlib.nullcontext()
    with grad, mode:
        assert cg.graph_blocker(tensors, "coil" if case == "coil_axis" else "") == why


@pytest.mark.parametrize("shape,perm,dense", [
    ((1, 3, 1, 16, 12), (0, 1, 2, 3, 4), True), ((1, 12, 1, 16, 3), (0, 4, 2, 3, 1), True),
    ((4, 6), (1, 0), True), ((2, 2, 6), None, False)])
def test_dense_layouts(shape, perm, dense):
    t = torch.randn(shape).permute(*perm) if perm else torch.randn(shape)[..., ::2]
    assert cg._dense(t) == dense
    if dense:
        assert torch.empty_like(t).stride() == t.stride()


@pytest.mark.parametrize("mode", ["inference", "no_grad", "train"])
def test_cpu_forwards_and_steps_take_the_eager_loop(mode):
    model = _model("XF")
    k, mask, s = _request(1)
    before = _counters()
    if mode == "train":
        model(k, mask, s).square().sum().backward()
    else:
        with torch.inference_mode() if mode == "inference" else torch.no_grad():
            assert model(k, mask, s).shape == (B, T, H, W)
    assert _counters() == before and not cg._GRAPHS


def test_coil_axis_binds_nothing(fake_graphs):
    """Even where the CPU counts as a card, a coil axis keeps the request's
    tensors unbound and every solve eager; the direct form binds nothing
    either."""
    k, mask, s = _request(2)
    kern = masked_normal_kernel(mask)
    image = Complex(torch.randn(B, T, 1, H, W), torch.randn(B, T, 1, H, W))
    with torch.no_grad():
        assert CGDataConsistency(image, mask, s, kern, 2)._bound is not None
        dc = CGDataConsistency(image, mask, s, kern, 2, "coil")
        direct = CGDataConsistency(image, mask, s, None, 2)
    assert dc._bound is None and dc.image_ref is image
    assert direct._bound is None and direct.image_ref is image


def _tensors(x):
    return [t for t in (x if isinstance(x, (tuple, list)) else (x,)) if torch.is_tensor(t)]


class _Recorder(TorchDispatchMode):
    """Records each aten call made while entered: op, arguments, results."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.calls.append((func, args, kwargs or {}, out))
        return out


class _Graph:
    """``torch.cuda.CUDAGraph`` on the CPU: a replay makes the captured aten
    calls again and copies each result into the tensor the capture got, as
    a replay writes the addresses the capture recorded."""

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.recorder = _Recorder()
        self.recorder.__enter__()

    def capture_end(self):
        self.recorder.__exit__(None, None, None)

    def replay(self):
        for func, args, kwargs, out in self.recorder.calls:
            for o, r in zip(_tensors(out), _tensors(func(*args, **kwargs))):
                if o is not r:
                    o.copy_(r)


@pytest.fixture
def fake_graphs(monkeypatch):
    """The CUDA graph API on the CPU (:class:`_Graph`; what a capture wrote
    to the solve's buffers is undone after it); streams and devices do
    nothing; the CPU counts as a CUDA device for :func:`cg.graph_blocker`."""
    capture = cg.GraphedSolve._capture

    def capture_nothing(self, operator):
        kept = [t.clone() for t in self.inputs]
        capture(self, operator)
        for t, k in zip(self.inputs, kept):
            t.copy_(k)

    class Stream:
        def wait_stream(self, other):
            pass

    real = cg.graph_blocker

    def blocker(tensors, coil_axis=""):
        why = real(tensors, coil_axis)
        if why == "device" and all(t.device.type == "cpu" for t in tensors):
            return None
        return why

    monkeypatch.setattr(cg.GraphedSolve, "_capture", capture_nothing)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(cg, "graph_blocker", blocker)
    cg.clear_graphs()
    yield
    cg.clear_graphs()


def _eager(model, *args):
    with torch.no_grad():
        return model(*args)


@pytest.mark.parametrize("dyn,kw", [("XF", {}), ("XT", {}), ("3D", {}), ("CRNN", {}),
                                    ("XF", {"kernel_dc": False})])
def test_replayed_forward_is_the_eager_loop(fake_graphs, dyn, kw):
    """Two requests on one model: each served forward (the first captures at
    its first cascade, then replays) equals the eager loop's exactly; the
    second reads its own operands, and the first's image is not touched.
    The direct form stays eager."""
    model = _model(dyn, **kw)
    first, second = _request(3), _request(4)
    with cg_eager():
        want = [_eager(model, *first), _eager(model, *second)]
    n = model.num_cascades
    graphed = kw.get("kernel_dc", True)
    before = _counters()
    with torch.inference_mode():
        got = [model(*first)]
        assert _counters() == ((before[0] + 1, before[1] + n - 1) if graphed else before)
        kept = got[0].clone()
        got.append(model(*second))
    assert _counters() == ((before[0] + 1, before[1] + 2 * n - 1) if graphed else before)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], kept) and not torch.equal(got[0], got[1])


@contextlib.contextmanager
def cg_eager():
    """Every solve eager, as on a CPU without the stand-in."""
    saved = cg.graph_blocker
    cg.graph_blocker = lambda tensors, coil_axis="": "forced"
    try:
        yield
    finally:
        cg.graph_blocker = saved


def test_no_grad_after_inference_and_train_step_after_graphs(fake_graphs):
    """The buffers are made outside inference mode, so a ``no_grad`` call
    after a served one replays on them; a train step after both records its
    gradients through the eager loop (no replay), with the eager loss and
    gradients."""
    model = _model("XF")
    k, mask, s = _request(5)
    with cg_eager():
        want = _eager(model, k, mask, s)
        model(k, mask, s).square().sum().backward()
        grads = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    with torch.inference_mode():
        model(k, mask, s)
    assert torch.equal(_eager(model, k, mask, s), want)
    before = _counters()
    loss = model(k, mask, s).square().sum()
    loss.backward()
    assert _counters() == before
    assert all(torch.equal(p.grad, g) for p, g in zip(model.parameters(), grads))


def test_a_slice_of_channels_stays_eager(fake_graphs):
    """CineNet-2D's denoiser output is a channel slice (not dense): its solves
    run eagerly, and nothing is captured."""
    model = build_model("cinenet", "2D", device="cpu", num_cascades=2, cg_iters=2, chans=2, pools=1)
    before = _counters()
    with torch.inference_mode():
        model(*_request(6))
    assert _counters() == before


def test_threads_serve_on_buffers_of_their_own(fake_graphs):
    """More serving threads than cores, each with its own request, switching
    often: each thread captures and binds its own buffers, so every image is
    its request's eager one (shared buffers would mix the requests). One
    intra-op thread throughout, so the CPU's sums run in one order."""
    import os
    import sys

    model = _model("XF", num_cascades=2)
    n = (os.cpu_count() or 1) + 1
    requests = [_request(10 + i) for i in range(n)]
    got = [None] * n

    def serve(i):
        with torch.inference_mode():
            got[i] = model(*requests[i])

    saved = sys.getswitchinterval(), torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with cg_eager():
            want = [_eager(model, *r) for r in requests]
        sys.setswitchinterval(1e-4)
        threads = [threading.Thread(target=serve, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved[0])
        torch.set_num_threads(saved[1])
    assert not any(t.is_alive() for t in threads)
    assert all(g is not None and torch.equal(g, w) for g, w in zip(got, want))


def test_kept_solves_stay_bounded(fake_graphs):
    """A thread that serves more shapes than :data:`cg.GRAPH_CACHE` keeps
    only the most recent ones' buffers and graphs, and every solve still
    equals the eager one."""
    g = torch.Generator().manual_seed(8)
    sizes = [H + 2 * i for i in range(cg.GRAPH_CACHE + 3)]
    lam = torch.tensor(0.3)
    for h in sizes:
        mask = (torch.rand(B, T, 1, h, 1, generator=g) < 0.5).float()
        s = Complex(torch.randn(B, 1, C, h, W, generator=g), torch.randn(B, 1, C, h, W, generator=g))
        image, x = (Complex(torch.randn(B, T, 1, h, W, generator=g),
                            torch.randn(B, T, 1, h, W, generator=g)) for _ in range(2))
        with torch.no_grad():
            dc = CGDataConsistency(image, mask, s, masked_normal_kernel(mask), 2)
            want = TO.cg_dc(x, lam, image, dc.operator, 2)
            for _ in range(2):  # the capture's call, then a replay
                got = dc(Complex(x.re.clone(), x.im.clone()), lam)
                assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    assert len(cg._GRAPHS) == cg.GRAPH_CACHE
    assert [key[-1][1][0] for key in cg._GRAPHS] == [(B, T, 1, h, W) for h in sizes[-cg.GRAPH_CACHE:]]


def test_replays_keep_the_normal_apply_op_calls(fake_graphs):
    """Under the profiler, a replayed forward still records 1 + cg_iters
    calls of ``cinemri::normal_apply`` a cascade, with the eager calls'
    operand shapes, inside ``cinemri.dc``, and opens no
    ``cinemri.dc.cg_step``: the record a trace links the replayed kernels
    to. (The stand-in's replay makes the op's call again inside its record;
    the card's makes none, and the benchmark's fold counts a call nested in
    one of the same op once, as counted here.)"""
    from torch.profiler import ProfilerActivity, profile

    def outer_calls(prof):
        calls = []
        for e in prof.events():
            parent = e.cpu_parent
            while parent is not None and parent.name != e.name:
                parent = parent.cpu_parent
            if e.name == "cinemri::normal_apply" and parent is None:
                calls.append(e.input_shapes)
        return calls

    model = _model("XF")
    request = _request(9)
    with torch.inference_mode():
        with cg_eager(), profile(activities=[ProfilerActivity.CPU], record_shapes=True) as eager:
            model(*request)
        model(*request)
        replays = cg.GRAPH_REPLAYS
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            model(*request)
    n = model.num_cascades
    assert cg.GRAPH_REPLAYS == replays + n
    assert outer_calls(prof) == outer_calls(eager) and len(outer_calls(eager)) == n * (
        model.cg_iters + 1)
    names = [e.name for e in prof.events()]
    assert names.count("cinemri.dc") == n and "cinemri.dc.cg_step" not in names


def test_a_changed_kernel_setting_takes_a_new_capture(fake_graphs):
    """A solve captured with the plain normal apply is not replayed once the
    kernel backend is set: the next call captures anew and matches the
    eager loop under the setting it runs with."""
    model = _model("XF", num_cascades=2)
    request = _request(12)
    saved = TO.get_normal_backend()
    try:
        for backend in ("torch", "kernel"):
            TO.set_normal_backend(backend)
            with cg_eager():
                want = _eager(model, *request)
            captures = cg.GRAPH_CAPTURES
            with torch.inference_mode():
                got = [model(*request) for _ in range(2)]
            assert cg.GRAPH_CAPTURES == captures + 1
            assert all(torch.equal(g, want) for g in got)
    finally:
        TO.set_normal_backend(saved)
