"""The port's ``plane`` and ``coil`` mesh axes against the JAX package on the
CPU: the counterpart of tests/test_parallel.py's plane and coil cases.

Gloo ranks (one CPU "device" each, one thread each, started from a
``file://`` store under the test's tmp dir) run the port's models with
``plane_axis`` / ``coil_axis`` on a mesh; the JAX package's single-device
jitted run of the same models, from the same weights (carried by
``interop/flax_params.py``) and the same numpy inputs, is the reference.
One module-scoped spawn of 4 ranks runs every 4-device case:

  * ``{plane: 4}`` forwards of VarNet-, CineNet- and XPDNet-XF (:159). The
    volume is 18 x 16, so the ``b·h`` = 18 planes do not divide the axis
    (ranks take 5, 5, 5 and 3 real planes) and the ``b·w`` = 16 do.
  * ``{coil: 4}`` forwards (:256, one coil per rank) of VarNet XF / CRNN,
    CineNet XF, XPDNet XF / CRNN, VarNet-3D and CineNet-2D, and the direct
    k-space path, ``kernel_dc=False`` (:302).
  * Loss and gradients of one step of VarNet-XF on ``{data: 2, coil: 2}``
    (:320) and ``{plane: 2, coil: 2}``, and of XPDNet-CRNN with
    per-iteration k-space nets (``primal_only=False``) on ``{data: 2,
    coil: 2}``; then a second step: every rank's weights bit-identical, the
    collectives counted, a stop flag raised on rank 3 seen by all four. The
    coil batch partition specs of :419, and the metric sum over the data
    group.

A spawn of 8 ranks runs the ``{data: 2, plane: 2, coil: 2}`` gradients
(:368). Tolerances are JAX's own for these cases: forwards rtol 2e-4 /
atol 2e-5, the loss rtol 1e-5, gradients rtol 2e-4 / atol 5e-5.

Data: tests/test_parallel.py's ``_inputs`` (t 3, c 4, a line mask with 7
center lines and line 2, RSS-normalized maps) from ``default_rng(SEED + i)``
for forward case i and ``default_rng(SEED)`` for the gradient cases. A
LeakyReLU or ReLU input at 0 up to f32 rounding takes the other branch's
derivative in another summation order and moves the gradients below it
(ROADMAP Queue 3), so SEED must put none there:
``test_no_activation_input_of_the_gradient_cases_lies_at_zero`` holds
SEED's batch to that for both gradient models, against the same forward in
f64. SEED 0 meets it. Seeds 2, 3 and 5 do not, and at seed 2 it shows: the
XPDNet-CRNN gradients on ``{data: 2, coil: 2}`` miss JAX's tolerance in 69
of the 6912 weights of ``kspace_nets.0.convs.1``, all of output channel 4,
and this test finds a ReLU input of that net's channel 4 at -1.2e-7 in f32
and +1.9e-8 in f64. At seeds 3 and 5 every other case agrees with JAX.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cinemri_tpu.models import build_model as j_build_model
from cinemri_tpu.ops.cplx import from_complex as j_from_complex
from cinemri_tpu.parallel import batch_partition_spec as j_batch_partition_spec
from cinemri_tpu.parallel import make_mesh as j_make_mesh
from cinemri_tpu.train.step import _loss_and_output as j_loss_and_output
from cinemri_tpu.train.step import model_apply_fn as j_model_apply_fn

from cinemri_tpu_torch.interop.flax_params import (
    cinenet_state_dict,
    varnet_rnn_state_dict,
    varnet_state_dict,
    xpdnet_rnn_state_dict,
    xpdnet_state_dict,
)
from cinemri_tpu_torch.models import build_model
from cinemri_tpu_torch.ops import fft as FFT
from cinemri_tpu_torch.ops.cplx import Complex
from cinemri_tpu_torch.physics import operators as OPS
from cinemri_tpu_torch.train.step import _replica_scales

REPO = Path(__file__).resolve().parent.parent
SEED = 0
LR = 1e-3
TINY = dict(num_cascades=1, sens_chans=4, sens_pools=2, chans=4, pools=2)

# (name, mesh, family, dynamic type, kwargs, volume (b, t, c, h, w)), as
# tests/test_parallel.py's plane (:159) and coil (:256, :302) cases. CineNet-XF
# runs its U-Nets over (w, t) planes, and the port's U-Net raises on a t = 3
# at 2 pools where JAX's pools an empty level (ROADMAP Queue 3): t = 4 there.
XPD = dict(sens_chans=4, sens_pools=2, n_scales=2, n_filters_per_scale=(4, 8),
           n_convs_per_scale=(2, 2), n_primal=3)
FORWARDS = [
    ("plane-varnet-XF", {"plane": 4}, "varnet", "XF",
     dict(num_cascades=1, sens_chans=4, sens_pools=2, chans=4, pools=2), (1, 3, 2, 18, 16)),
    ("plane-cinenet-XF", {"plane": 4}, "cinenet", "XF",
     dict(num_cascades=1, cg_iters=2, chans=4, pools=2), (1, 4, 2, 18, 16)),
    ("plane-xpdnet-XF", {"plane": 4}, "xpdnet", "XF", dict(num_cascades=1, **XPD), (1, 3, 2, 18, 16)),
    ("coil-varnet-XF", {"coil": 4}, "varnet", "XF",
     dict(num_cascades=1, sens_chans=4, sens_pools=2, chans=4, pools=2), (1, 3, 4, 16, 16)),
    ("coil-varnet-CRNN", {"coil": 4}, "varnet", "CRNN",
     dict(num_cascades=1, sens_chans=4, sens_pools=2, chans=4), (1, 3, 4, 16, 16)),
    ("coil-cinenet-XF", {"coil": 4}, "cinenet", "XF",
     dict(num_cascades=1, cg_iters=2, chans=4, pools=2), (1, 4, 4, 16, 16)),
    ("coil-xpdnet-XF", {"coil": 4}, "xpdnet", "XF", dict(num_cascades=1, **XPD), (1, 3, 4, 16, 16)),
    ("coil-xpdnet-CRNN", {"coil": 4}, "xpdnet", "CRNN",
     dict(num_cascades=1, sens_chans=4, sens_pools=2, n_primal=3, chans=4), (1, 3, 4, 16, 16)),
    ("coil-varnet-3D", {"coil": 4}, "varnet", "3D",
     dict(num_cascades=1, sens_chans=4, sens_pools=2, chans=4, pools=2), (1, 3, 4, 16, 16)),
    ("coil-cinenet-2D", {"coil": 4}, "cinenet", "2D",
     dict(num_cascades=1, cg_iters=2, chans=4, pools=2), (1, 3, 4, 16, 16)),
    ("coil-varnet-XF-direct", {"coil": 4}, "varnet", "XF",
     dict(num_cascades=2, sens_chans=4, sens_pools=2, chans=4, pools=2, kernel_dc=False),
     (1, 3, 4, 16, 16)),
]
STATE_DICTS = {("varnet", "CRNN"): varnet_rnn_state_dict, ("xpdnet", "CRNN"): xpdnet_rnn_state_dict,
               "varnet": varnet_state_dict, "cinenet": cinenet_state_dict,
               "xpdnet": xpdnet_state_dict}
# the gradient cases: (name, family, dynamic type, kwargs, mesh), VarNet-XF
# (λ, the sens net partial on coil, the plane nets on plane) and
# XPDNet-CRNN with per-iteration k-space nets (the sens net and the k-space
# nets partial on coil, the CRNN trunk whole on every rank)
XPD_DUAL = dict(num_cascades=1, sens_chans=4, sens_pools=2, n_primal=3, chans=4, primal_only=False)
STEP_CASES = {4: [("data2xcoil2", "varnet", "XF", TINY, {"data": 2, "coil": 2}),
                  ("plane2xcoil2", "varnet", "XF", TINY, {"plane": 2, "coil": 2}),
                  ("xpdnet-CRNN-dual-data2xcoil2", "xpdnet", "CRNN", XPD_DUAL,
                   {"data": 2, "coil": 2})],
              8: [("data2xplane2xcoil2", "varnet", "XF", TINY, {"data": 2, "plane": 2, "coil": 2})]}
# tests/test_parallel.py:419's cases at a coil axis of 2: (key, shape, global rows)
SPEC_CASES = [("masked_kspace", (2, 3, 4, 16, 16), None), ("sens_maps", (2, 1, 4, 16, 16), None),
              ("mask", (2, 3, 1, 16, 1), None), ("target", (2, 3, 16, 16), None),
              ("masked_kspace", (2, 3, 3, 16, 16), None), ("masked_kspace", (3, 3, 4, 16, 16), None)]
STOP_RANK = 3


def _inputs(rng, b=1, t=3, c=4, h=16, w=16):
    """tests/test_parallel.py's ``TestCoilParallel._inputs``."""
    k = (rng.standard_normal((b, t, c, h, w)) + 1j * rng.standard_normal((b, t, c, h, w))).astype(np.complex64)
    m = np.zeros((b, t, 1, h, 1), np.float32)
    m[:, :, :, h // 2 - 3: h // 2 + 3] = 1
    m[:, :, :, 2] = 1
    sens = (rng.standard_normal((b, 1, c, h, w)) + 1j * rng.standard_normal((b, 1, c, h, w))).astype(np.complex64)
    sens /= np.sqrt((np.abs(sens) ** 2).sum(2, keepdims=True))
    return k, m, sens


def _pairs(x):
    return (np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag))


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops.cplx import Complex
    from cinemri_tpu_torch.parallel import (batch_partition_spec, coil_shard, initialize, make_mesh,
                                            make_process_sum, mesh_coordinates, set_mesh,
                                            shard_batch)
    from cinemri_tpu_torch.parallel import distributed as D
    from cinemri_tpu_torch.train import create_train_state, make_train_step

    torch.set_num_threads(1)
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    job = torch.load(f"{workdir}/job.pt", weights_only=False)
    initialize(f"file://{workdir}/store", world, rank, device="cpu")
    meshes, out = {}, {}

    def mesh_of(shape):
        key = tuple(shape.items())
        if key not in meshes:
            meshes[key] = make_mesh(shape)
        return meshes[key]

    def axes(shape):
        return {f"{a}_axis": a for a in ("plane", "coil") if a in shape}

    for name, shape, family, dynamic, kw, (k, mask, sens) in job["forwards"]:
        mesh = mesh_of(shape)
        model = build_model(family, dynamic, device="cpu", **kw, **axes(shape))
        model.load_state_dict(job["init"][name])
        part = (lambda x: coil_shard(x, "coil", mesh=mesh)) if "coil" in shape else (lambda x: x)
        args = [part(Complex(*map(torch.from_numpy, k))), torch.from_numpy(mask)]
        if family == "cinenet":
            args.append(part(Complex(*map(torch.from_numpy, sens))))
        with set_mesh(mesh), torch.inference_mode():
            out[name] = model(*args).numpy()

    for name, family, dynamic, kw, shape in job["step_cases"]:
        mesh = mesh_of(shape)
        coords = mesh_coordinates(mesh)
        model = build_model(family, dynamic, device="cpu", **kw, **axes(shape))
        model.load_state_dict(job["init"][name])
        state = create_train_state(model, device="cpu", lr=job["lr"])
        rows = len(job["batch"]["target"]) // shape.get("data", 1)
        i = coords.get("data", 0)
        local = {k: v[i * rows:(i + 1) * rows] for k, v in job["batch"].items()}
        step = make_train_step(mesh=mesh)
        rec = {"loss": [], "stop": [], "collectives": [], "bytes": []}
        for s in range(2):
            D.COLLECTIVES.clear()
            D.COLLECTIVE_BYTES.clear()
            state, aux = step(state, shard_batch(local, mesh, device="cpu"),
                              stop=s == 1 and rank == job["stop_rank"])
            rec["loss"].append(aux["loss"].item())
            rec["stop"].append(bool(aux["stop"]))
            rec["collectives"].append(dict(D.COLLECTIVES))
            rec["bytes"].append(dict(D.COLLECTIVE_BYTES))
            if s == 0:
                rec["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
        rec["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
        rec["partial"] = model.partial_parameters()
        out[name] = rec
        if name == "data2xcoil2":
            out["specs"] = [batch_partition_spec(k, s_, mesh, global_rows=g)
                            for k, s_, g in job["specs"]]
            out["metric_sum"] = make_process_sum(mesh)(coords["data"] + 1.0)
            out["coords"] = coords
    torch.save(out, f"{workdir}/rank{rank}.pt")
""")


def _start_ranks(workdir: Path, world: int):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(workdir)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _wait_ranks(procs, workdir: Path):
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0])
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-4000:]}"
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


def _state_dict(family, dynamic, params):
    fn = STATE_DICTS.get((family, dynamic), STATE_DICTS[family])
    return fn(jax.tree.map(np.asarray, params))


def _step_batch():
    k, m, _ = _inputs(np.random.default_rng(SEED), b=2, c=4)
    return {"masked_kspace": k * m, "mask": m, "target": np.abs(k).mean(axis=2).astype(np.float32)}


def _jax_step(family, dynamic, kw, batch):
    """The JAX package's single-device model, its initial weights and its
    loss function on the whole batch (tests/test_parallel.py:320)."""
    from cinemri_tpu.parallel import shard_batch as j_shard_batch

    model = j_build_model(family, dynamic, **kw)
    arrays = j_shard_batch(batch, None)
    params = model.init(jax.random.PRNGKey(0), arrays["masked_kspace"], arrays["mask"])
    apply = j_model_apply_fn(model)
    return params, lambda p: j_loss_and_output(apply, p, arrays)[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns, started at once, beside the JAX package's runs."""
    forwards, init, jax_fwd = [], {}, {}
    models = []
    for i, (name, shape, family, dynamic, kw, (b, t, c, h, w)) in enumerate(FORWARDS):
        k, m, sens = _inputs(np.random.default_rng(SEED + i), b=b, t=t, c=c, h=h, w=w)
        args = (j_from_complex(k * m), jnp.asarray(m))
        if family == "cinenet":
            args += (j_from_complex(sens),)
        jm = j_build_model(family, dynamic, **kw)
        params = jm.init(jax.random.PRNGKey(0), *args)
        init[name] = _state_dict(family, dynamic, params)
        forwards.append((name, shape, family, dynamic, kw, (_pairs(k * m), m, _pairs(sens))))
        models.append((name, jm, params, args))
    batch = _step_batch()
    steps = {}
    for name, family, dynamic, kw, _ in (c for cases in STEP_CASES.values() for c in cases):
        params, loss_fn = _jax_step(family, dynamic, kw, batch)
        init[name] = _state_dict(family, dynamic, params)
        steps[name] = (family, dynamic, params, loss_fn)
    job = dict(forwards=forwards, init=init, lr=LR, batch=batch, specs=SPEC_CASES,
               stop_rank=STOP_RANK)
    dirs = {}
    procs = {}
    for world in (4, 8):
        dirs[world] = tmp_path_factory.mktemp(f"mesh{world}")
        torch.save(dict(job, step_cases=STEP_CASES[world],
                        forwards=forwards if world == 4 else []), dirs[world] / "job.pt")
        procs[world] = _start_ranks(dirs[world], world)
    for name, jm, params, args in models:  # while the ranks run
        jax_fwd[name] = np.asarray(jax.jit(jm.apply)(params, *args))
    jax_steps = {}
    for name, (family, dynamic, params, loss_fn) in steps.items():
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        jax_steps[name] = (float(loss), _state_dict(family, dynamic, grads))
    ranks = {world: _wait_ranks(procs[world], dirs[world]) for world in (4, 8)}
    return dict(ranks=ranks, jax_fwd=jax_fwd, jax_steps=jax_steps, init=init, batch=batch)


@pytest.mark.parametrize("case", [f[0] for f in FORWARDS])
def test_forward_matches_jax_single_device(runs, case):
    """Every rank's output of the plane- or coil-split model against the JAX
    package's single-device forward, at tests/test_parallel.py's tolerance."""
    want = runs["jax_fwd"][case]
    for out in runs["ranks"][4]:
        assert out[case].shape == want.shape
        np.testing.assert_allclose(out[case], want, rtol=2e-4, atol=2e-5)


def _step_cases():
    return [(world, case[0]) for world, cases in STEP_CASES.items() for case in cases]


@pytest.mark.parametrize("world, mesh", _step_cases())
def test_loss_and_gradients_match_jax(runs, world, mesh):
    """Step 1's loss and summed gradients (tests/test_parallel.py:320, :368)
    on every rank against JAX's single-device value_and_grad."""
    j_loss, j_grads = runs["jax_steps"][mesh]
    for out in runs["ranks"][world]:
        rec = out[mesh]
        np.testing.assert_allclose(rec["loss"][0], j_loss, rtol=1e-5)
        assert rec["grads"].keys() == j_grads.keys()
        for name, g in j_grads.items():
            np.testing.assert_allclose(rec["grads"][name].numpy(), g.numpy(), rtol=2e-4, atol=5e-5,
                                       err_msg=name)


@pytest.mark.parametrize("world, mesh", _step_cases())
def test_weights_bit_identical_after_two_steps(runs, world, mesh):
    ranks = [out[mesh] for out in runs["ranks"][world]]
    for rec in ranks[1:]:
        assert rec["loss"] == ranks[0]["loss"]
        for name, p in ranks[0]["params"].items():
            assert torch.equal(rec["params"][name], p), name


def test_partial_parameters_mark_the_plane_nets_and_the_sens_net(runs):
    """On {data: 2, plane: 2, coil: 2}: the sens net is partial on coil,
    the plane nets on plane, λ on neither, so the step scales λ's gradient
    by 1/4, the sens net's and the plane nets' by 1/2."""
    partial = runs["ranks"][8][0]["data2xplane2xcoil2"]["partial"]
    assert partial["lambda_reg"] == ()
    assert {partial[n] for n in partial if n.startswith("sens_net.")} == {("coil",)}
    assert {partial[n] for n in partial if n.startswith("cascades.")} == {("plane",)}
    assert any(n.startswith("cascades.net_xf.") for n in partial)


def test_xpdnet_crnn_marks_its_sens_net_and_kspace_nets_partial_on_coil(runs):
    """XPDNet-CRNN without primal_only: each rank runs the sens net and the
    per-iteration k-space nets on its coils, the CRNN trunk on the whole
    image, so on {data: 2, coil: 2} the step scales the trunk's gradients
    by 1/2 and the others' by 1."""
    partial = runs["ranks"][4][0]["xpdnet-CRNN-dual-data2xcoil2"]["partial"]
    for name, axes in partial.items():
        on_coils = name.startswith(("sens_net.", "kspace_nets."))
        assert axes == (("coil",) if on_coils else ()), name
    assert any(n.startswith("kspace_nets.0.") for n in partial)
    assert any(n.startswith("trunk.") for n in partial)


def test_a_model_without_partial_parameters_is_refused_on_a_split_axis():
    """The step cannot scale a model's gradients on a plane or coil dim of
    more than one rank unless the model says which are partial there."""

    class Bare(torch.nn.Module):
        coil_axis = "coil"

        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(2))

    model = Bare()
    with pytest.raises(ValueError, match="partial_parameters"):
        _replica_scales(model, list(model.parameters()), {"coil": 2})
    assert _replica_scales(model, list(model.parameters()), {"coil": 1}) == [1.0]


def _activation_inputs(model, args, monkeypatch):
    """``(name, input in f64)`` of every ReLU and LeakyReLU call of one
    forward of ``model``."""
    seen, real = [], {"relu": F.relu, "leaky_relu": F.leaky_relu}

    def record(name):
        def fn(x, *a, **kw):
            seen.append((name, x.detach().to(torch.float64)))
            return real[name](x, *a, **kw)
        return fn

    with monkeypatch.context() as m:
        for name in real:
            m.setattr(F, name, record(name))
        with torch.no_grad():
            model(*args)
    return seen


@pytest.mark.parametrize("name", ["data2xcoil2", "xpdnet-CRNN-dual-data2xcoil2"])
def test_no_activation_input_of_the_gradient_cases_lies_at_zero(runs, name, monkeypatch):
    """SEED's batch keeps every ReLU / LeakyReLU input of the gradient
    models off 0 up to rounding: between the port's f32 forward and the
    same forward in f64 (the f32 DFT matrices promoted), no input changes
    sign, and each lies at least twice its own f32 rounding error from 0.
    An input within rounding of 0 would take the other branch's derivative
    in another summation order (JAX's, or a mesh's) and move the gradients
    below it past the tolerance. The one exception is a ReLU input that is
    0 exactly in both: XPDNet's k-space nets start with zero biases, so a
    conv over k-space lines that are all unmeasured gives 0 in every
    summation order, where both packages take ReLU's derivative as 0. No
    LeakyReLU input is 0 (there the packages' derivatives differ)."""
    family, dynamic, kw = next(c[1:4] for c in STEP_CASES[4] if c[0] == name)
    batch = runs["batch"]
    out = []
    for dtype in (torch.float32, torch.float64):
        model = build_model(family, dynamic, device="cpu", **kw)
        model.load_state_dict(runs["init"][name])
        model.to(dtype)
        args = (Complex(*(torch.from_numpy(a).to(dtype) for a in _pairs(batch["masked_kspace"]))),
                torch.from_numpy(batch["mask"]).to(dtype))
        with monkeypatch.context() as m:
            if dtype == torch.float64:
                f32 = FFT._dft_tensors
                for mod in (FFT, OPS):
                    m.setattr(mod, "_dft_tensors", lambda *a: tuple(w.double() for w in f32(*a)))
            out.append(_activation_inputs(model, args, monkeypatch))
    assert len(out[0]) == len(out[1]) > 0
    for i, ((kind, x32), (_, x64)) in enumerate(zip(*out)):
        exact = (x32 == 0) & (x64 == 0)
        assert kind == "relu" or not exact.any(), f"{kind} call {i}: inputs at exactly 0"
        flips = ((x32 > 0) != (x64 > 0)).nonzero().tolist()
        assert not flips, (f"{kind} call {i} {tuple(x32.shape)}: sign flips at {flips}, f32 "
                           f"{[x32[tuple(f)].item() for f in flips]}, f64 "
                           f"{[x64[tuple(f)].item() for f in flips]}")
        margin = x64[~exact].abs() / (x32 - x64)[~exact].abs()
        assert margin.min().item() >= 2.0, f"{kind} call {i}: margin {margin.min().item()}"


def test_collectives_per_step_at_data2_coil2(runs):
    """VarNet-XF, 1 cascade with remat, kernel DC, on {data: 2, coil: 2}.
    Coil all-reduces: the forward's 4 (the sens net's RSS, R0 = Σ|S|²,
    x_ref = Σ Sᴴ F⁻¹ k, and the cascade's normal apply); the backward's 3
    (the cascade's replay of its normal apply, the cotangent of the
    normal apply's input, and the cotangent of the sens net's RSS, the
    replicated value entering per-coil work); the other coil sums pass their
    cotangents through. Then the one gradient all-reduce and the two scalar
    ones. Bytes: the gradient in f32, the scalars 4 + 8."""
    nbytes = 4 * sum(v.numel() for v in runs["ranks"][4][0]["data2xcoil2"]["params"].values())
    for out in runs["ranks"][4]:
        for calls, sent in zip(out["data2xcoil2"]["collectives"], out["data2xcoil2"]["bytes"]):
            assert calls == {"coil": 7, "grad": 1, "scalar": 2}
            assert sent["grad"] == nbytes and sent["scalar"] == 4 + 8


@pytest.mark.parametrize("mesh", ["data2xcoil2", "plane2xcoil2"])
def test_a_stop_flag_on_one_rank_reaches_all_four(runs, mesh):
    for out in runs["ranks"][4]:
        assert out[mesh]["stop"] == [False, True]


def test_batch_partition_spec_on_a_coil_mesh_matches_jax(runs):
    """tests/test_parallel.py:419's cases on a {data: 2, coil: 2} mesh."""
    jmesh = j_make_mesh({"data": 2, "coil": 2}, devices=jax.devices()[:4])
    want = [tuple(j_batch_partition_spec(k, s, jmesh, global_rows=g)) for k, s, g in SPEC_CASES]
    assert want[0] == ("data", None, "coil") and want[4] == ("data",)
    assert want[5] == (None, None, "coil")
    for out in runs["ranks"][4]:
        assert out["specs"] == want


def test_metric_sums_count_each_volume_once(runs):
    """make_process_sum(mesh) sums over the data group: data index + 1 over
    {data: 2, coil: 2} is 1 + 2, not counted again for each coil rank."""
    coords = [out["coords"] for out in runs["ranks"][4]]
    assert coords == [{"data": d, "coil": c} for d in (0, 1) for c in (0, 1)]
    assert [out["metric_sum"] for out in runs["ranks"][4]] == [3.0] * 4
