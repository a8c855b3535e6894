"""The port's data parallelism (cinemri_tpu_torch.parallel and the
data-parallel train step) against the JAX package on the CPU.

Two gloo processes (one CPU "device" each, started from a ``file://`` store
under the test's tmp dir, so parallel test workers never race for a port)
run the port's data-parallel step of a tiny VarNet-XF on their rows of one
global batch; the JAX package's single-device jitted ``make_train_step`` runs
the whole batch from the same weights (carried by
``interop/flax_params.py``). JAX's own test
(tests/test_parallel.py::test_sharded_step_matches_single_device) shows that
single-device step equals its ``shard_map`` step, and its tolerances hold
here: loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-5.

Data: ``_batch`` of tests/test_parallel.py (t 3, c 2, 16 x 16) from
``default_rng(SEED)``, 4 rows, and 8 for the padded case. A first Adam step
moves each weight by ±lr by the sign of its gradient, so an element whose
gradient lies within f32 summation noise of 0 moves by 2·lr between any two
orders (the port's convolutions and XLA's, or the ranks' split of the sum):
at JAX's test seed, 1234, one weight of 144 does so against JAX. At seed 1259
every first-step gradient element is at least 2.5e-5 of its leaf's largest,
above that noise (ROADMAP Queue 3, on LeakyReLU inputs at 0).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from cinemri_tpu.models import build_model as j_build_model
from cinemri_tpu.parallel import batch_partition_spec as j_batch_partition_spec
from cinemri_tpu.parallel import make_mesh as j_make_mesh
from cinemri_tpu.parallel import shard_batch as j_shard_batch
from cinemri_tpu.train import create_train_state as j_create_train_state
from cinemri_tpu.train import make_optimizer as j_make_optimizer
from cinemri_tpu.train import make_train_step as j_make_train_step

from cinemri_tpu_torch.interop.flax_params import varnet_state_dict
from cinemri_tpu_torch.models import build_model
from cinemri_tpu_torch.ops.cplx import Complex
from cinemri_tpu_torch.parallel import (
    ARRAY_KEYS,
    batch_partition_spec,
    make_mesh,
    make_process_sum,
    process_info,
    shard_batch,
)
from cinemri_tpu_torch.parallel import distributed as D
from cinemri_tpu_torch.train import create_train_state, make_train_step

torch.set_num_threads(2)

TINY = dict(num_cascades=1, sens_chans=4, sens_pools=2, chans=4, pools=2)
T, C, H, W = 3, 2, 16, 16
LR = 1e-3
SEED = 1259
REPO = Path(__file__).resolve().parent.parent

# (key, shape, global_rows) cases of batch_partition_spec on a 2-rank data mesh
SPEC_CASES = [("masked_kspace", (2, 3, 4, 16, 16), None), ("mask", (2, 3, 1, 16, 1), None),
              ("target", (3, 3, 16, 16), None), ("sample_weight", (1,), 4),
              ("sens_maps", (1, 1, 4, 16, 16), 3)]


def _batch(rng, b):
    """tests/test_parallel.py's batch, in numpy."""
    k = (rng.standard_normal((b, T, C, H, W)) + 1j * rng.standard_normal((b, T, C, H, W))).astype(np.complex64)
    m = np.zeros((b, T, 1, H, 1), np.float32)
    m[:, :, :, H // 2 - 2: H // 2 + 2] = 1
    m[:, :, :, 1] = 1
    m[:, :, :, H - 2] = 1
    return {"masked_kspace": k * m, "mask": m, "target": np.abs(k).mean(axis=2).astype(np.float32)}


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.parallel import (batch_partition_spec, initialize, make_mesh,
                                            make_process_sum, process_info, shard_batch)
    from cinemri_tpu_torch.parallel import distributed as D
    from cinemri_tpu_torch.train import create_train_state, make_train_step

    torch.set_num_threads(1)
    rank, workdir = int(sys.argv[1]), sys.argv[2]
    job = torch.load(f"{workdir}/job.pt", weights_only=False)
    initialize(f"file://{workdir}/store", 2, rank, device="cpu")
    out = {"info": process_info(), "sum": make_process_sum()(rank + 1.5)}
    mesh = make_mesh()
    out["mesh"] = (tuple(mesh.mesh_dim_names), tuple(mesh.shape))
    try:
        make_mesh({"data": 4})
    except ValueError as e:
        out["mesh_error"] = str(e)
    out["specs"] = [batch_partition_spec(k, s, mesh, global_rows=g) for k, s, g in job["specs"]]
    step = make_train_step(mesh=mesh)
    for name, run in job["runs"].items():
        model = build_model("varnet", "XF", device="cpu", **job["tiny"])
        model.load_state_dict(run["init"])
        state = create_train_state(model, device="cpu", lr=job["lr"])
        rows = len(run["batch"]["target"]) // 2
        local = {k: v[rank * rows:(rank + 1) * rows] for k, v in run["batch"].items()}
        rec = {"loss": [], "collectives": [], "params": []}
        for _ in range(run["steps"]):
            D.COLLECTIVES.clear()
            D.COLLECTIVE_BYTES.clear()
            state, aux = step(state, shard_batch(local, mesh, device="cpu"))
            rec["loss"].append(aux["loss"].item())
            rec["collectives"].append((dict(D.COLLECTIVES), dict(D.COLLECTIVE_BYTES)))
            rec["params"].append({n: p.detach().clone() for n, p in model.named_parameters()})
        out[name] = rec
    torch.save(out, f"{workdir}/rank{rank}.pt")
""")


def _run_ranks(workdir: Path):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(workdir)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0])
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-4000:]}"
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(2)]


def _jax_run(batch, steps=1):
    """JAX's single-device jitted step on the whole batch: the initial
    params, then per step the loss and params."""
    model = j_build_model("varnet", "XF", **TINY)
    arrays = j_shard_batch(batch, None)
    state = j_create_train_state(model, arrays, j_make_optimizer(lr=LR, steps_per_epoch=1))
    init = state.params
    step = j_make_train_step(donate=False)
    losses, params = [], []
    for _ in range(steps):
        state, aux = step(state, arrays)
        losses.append(float(aux["loss"]))
        params.append(varnet_state_dict(jax.tree.map(np.asarray, state.params)))
    return varnet_state_dict(jax.tree.map(np.asarray, init)), losses, params


def _torch_batch(batch):
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    out = {k: f32(v) for k, v in batch.items() if not np.iscomplexobj(v)}
    out["masked_kspace"] = Complex(f32(batch["masked_kspace"].real), f32(batch["masked_kspace"].imag))
    return out


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Two gloo ranks: the data-parallel step on the global batch of 4 (two
    steps) and on the padded batch of 8 (one step), beside JAX's
    single-device step on the batch of 4 and on the padded batch's 6 real
    rows."""
    workdir = tmp_path_factory.mktemp("dp")
    full = _batch(np.random.default_rng(SEED), 4)
    padded = _batch(np.random.default_rng(SEED), 8)
    padded["sample_weight"] = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    init, j_losses, j_params = _jax_run(full, steps=1)
    init6, j6_losses, j6_params = _jax_run({k: v[:6] for k, v in padded.items()
                                            if k != "sample_weight"})
    torch.save({"tiny": TINY, "lr": LR, "specs": SPEC_CASES, "runs": {
        "full": {"init": init, "batch": full, "steps": 2},
        "padded": {"init": init6, "batch": padded, "steps": 1},
    }}, workdir / "job.pt")
    ranks = _run_ranks(workdir)
    return dict(ranks=ranks, full=full, init=init, jax=(j_losses, j_params),
                jax6=(j6_losses, j6_params))


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo group in this process, torn down after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _assert_params_close(got, want):
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-4, atol=1e-5, err_msg=name)


class TestMesh:
    def test_make_mesh_shapes_match_jax(self, dp):
        """A mesh must cover every device: JAX over its 8 virtual devices,
        the port over its 2 ranks (one device each)."""
        assert j_make_mesh().shape == {"data": 8}
        with pytest.raises(ValueError):
            j_make_mesh({"data": 3})
        for r, out in enumerate(dp["ranks"]):
            assert out["info"] == (r, 2)
            assert out["mesh"] == (("data",), (2,))
            assert "needs 4 devices, have 2" in out["mesh_error"]

    def test_batch_partition_spec_matches_jax(self, dp):
        mesh = j_make_mesh({"data": 2}, devices=jax.devices()[:2])
        want = [tuple(j_batch_partition_spec(k, s, mesh, global_rows=g)) for k, s, g in SPEC_CASES]
        assert want == [("data",), ("data",), (), ("data",), ()]
        for out in dp["ranks"]:
            assert out["specs"] == want

    def test_mesh_at_one_rank_and_the_coil_axis(self, world1):
        """make_mesh() is a data mesh over the one rank; on a coil axis the
        coil dims take JAX's spec (the JAX package's coil mesh at the same
        sizes); the batch lands on the device as Complex pairs."""
        mesh = make_mesh()
        assert tuple(mesh.mesh_dim_names) == ("data",) and tuple(mesh.shape) == (1,)
        with pytest.raises(ValueError, match="needs 2 devices"):
            make_mesh({"data": 2})
        coil = make_mesh({"data": 1, "coil": 1})
        j_coil = j_make_mesh({"data": 1, "coil": 1}, devices=jax.devices()[:1])
        for key, shape in (("masked_kspace", (1, 3, 2, 16, 16)), ("sens_maps", (1, 1, 2, 16, 16)),
                           ("mask", (1, 3, 1, 16, 1))):
            want = tuple(j_batch_partition_spec(key, shape, j_coil))
            assert batch_partition_spec(key, shape, coil) == want
        assert batch_partition_spec("masked_kspace", (1, 3, 2, 16, 16), coil) == (
            "data", None, "coil")
        placed = shard_batch(_batch(np.random.default_rng(0), 2), mesh, device="cpu")
        assert set(placed) == {"masked_kspace", "mask", "target"} <= set(ARRAY_KEYS)
        assert isinstance(placed["masked_kspace"], Complex)
        assert placed["masked_kspace"].re.dtype == torch.float32


class TestDataParallelStep:
    def test_two_ranks_match_jax_single_device(self, dp):
        """Step 1 of the 2-rank step (2 rows each) against JAX's
        single-device step on the 4 rows: loss and updated params."""
        j_losses, j_params = dp["jax"]
        for out in dp["ranks"]:
            np.testing.assert_allclose(out["full"]["loss"][0], j_losses[0], rtol=1e-5)
            _assert_params_close(out["full"]["params"][0], j_params[0])

    def test_ranks_params_bit_identical(self, dp):
        a, b = (out["full"]["params"][-1] for out in dp["ranks"])
        assert a.keys() == b.keys()
        for name in a:
            assert torch.equal(a[name], b[name]), name
        assert dp["ranks"][0]["full"]["loss"] == dp["ranks"][1]["full"]["loss"]

    def test_padded_batch_matches_unpadded(self, dp):
        """Weights [1,1,1,1,1,1,0,0] over 2 ranks (4 rows each) equal the
        unpadded 6-row step (tests/test_parallel.py:586-610)."""
        j_losses, j_params = dp["jax6"]
        for out in dp["ranks"]:
            np.testing.assert_allclose(out["padded"]["loss"][0], j_losses[0], rtol=1e-5)
            _assert_params_close(out["padded"]["params"][0], j_params[0])

    def test_one_gradient_all_reduce_per_step(self, dp):
        nbytes = 4 * sum(v.numel() for v in dp["init"].values())
        for out in dp["ranks"]:
            for calls, sent in out["full"]["collectives"] + out["padded"]["collectives"]:
                assert calls == {"grad": 1, "scalar": 2}
                assert sent == {"grad": nbytes, "scalar": 4 + 8}

    def test_dp_step_at_one_rank_equals_the_plain_step(self, world1):
        """The data-parallel step on a one-rank mesh against the plain step
        from the same weights, two steps: the same losses and weights."""
        batch = _torch_batch(dict(_batch(np.random.default_rng(7), 3),
                                  sample_weight=np.array([1, 1, 0], np.float32)))
        runs = []
        for step in (make_train_step(), make_train_step(mesh=make_mesh())):
            model = build_model("varnet", "XF", device="cpu",
                                generator=torch.Generator().manual_seed(0), **TINY)
            state = create_train_state(model, device="cpu", lr=LR)
            losses = [step(state, batch)[1]["loss"].item() for _ in range(2)]
            runs.append((losses, [p.detach() for p in model.parameters()]))
        (plain_losses, plain), (dp_losses, dp_params) = runs
        assert dp_losses == plain_losses
        for p, q in zip(plain, dp_params):
            assert torch.equal(p, q)


class TestProcessSum:
    def test_world_2_sums_both_ranks(self, dp):
        assert [out["sum"] for out in dp["ranks"]] == [4.0, 4.0]

    def test_world_1_is_the_identity(self, world1):
        assert process_info() == (0, 1)
        assert make_process_sum()(3.5) == 3.5
        D.COLLECTIVES.clear()
        D.broadcast_tensors([torch.ones(3)])
        D.barrier()
        assert D.all_gather_object({"a": 1}) == [{"a": 1}]
        assert not D.COLLECTIVES

    def test_without_a_group(self):
        assert not dist.is_initialized()
        assert process_info() == (0, 1)
        assert make_process_sum()(2.25) == 2.25
