"""Data-parallel training across processes with the port, on the CPU:
the counterpart of tests/test_distributed.py.

Two CPU processes (gloo, one device each) train a tiny VarNet through the
port's CLI and are held against one process with the same global batch:
the ranks end with the same weights, those weights and the epoch metrics
match the one-process run, and the metric sums run for real. A second case
sends SIGTERM to rank 1 in the middle of an epoch: both ranks stop at the
same step, rank 0 writes the one checkpoint, and a two-process resume ends
bit-identical to an uninterrupted two-process run. A third trains volumes of
two shapes at batch 2, whose shards bucket into different batch counts.
A fourth splits each volume's coils over the two processes (``--coil_devices
2``). Then the CLI's checks of the launch and of the mesh axes.
"""

import os
import pickle
import socket
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from cinemri_tpu_torch.cli import common as TC
from cinemri_tpu_torch.data.synthetic import make_synthetic_dataset

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


CLI_WORKER = textwrap.dedent("""
    import pickle, sys
    import torch
    from cinemri_tpu_torch.cli.common import train_test_main

    torch.set_num_threads(1)
    pid, port, workdir, nproc = int(sys.argv[1]), sys.argv[2], sys.argv[3], int(sys.argv[4])
    coil = sys.argv[5:] == ["coil"]  # one volume's 2 virtual coils split over the processes
    args = [
        "--mode", "train", "--epochs", "2", "--lr", "1e-4", "--device", "cpu",
        "--num_cascades", "1", "--chans", "4", "--pools", "2",
        "--sens_chans", "4", "--sens_pools", "2", "--dynamic_type", "2D",
        "--accelerations", "2", "--center_fractions", "6",
        "--use_seed", "1", "--num_workers", "2", "--compute_train_metrics", "1",
        "--path_config", f"{workdir}/dirs_path.yaml", "--maps_cache_dir", f"{workdir}/maps",
    ]
    if coil:
        args += ["--compress_coils", "2", "--num_devices", "1", "--batch_size", "2"]
        if nproc > 1:
            args += ["--coil_devices", str(nproc), "--num_processes", str(nproc),
                     "--coordinator_address", f"localhost:{port}", "--process_id", str(pid)]
    elif nproc > 1:
        args += ["--num_devices", str(nproc), "--batch_size", "1", "--num_processes", str(nproc),
                 "--coordinator_address", f"localhost:{port}", "--process_id", str(pid)]
    else:  # one process, the same global batch
        args += ["--num_devices", "1", "--batch_size", "2"]
    out = train_test_main("varnet", args)
    with open(f"{workdir}/cli_p{pid}_n{nproc}{'_coil' if coil else ''}.pkl", "wb") as f:
        pickle.dump({"params": [p.detach().numpy() for p in out["trainer"].model.parameters()],
                     "history": out["history"]}, f)
""")

FIT_WORKER = textwrap.dedent("""
    import pickle, signal, sys
    import torch
    from cinemri_tpu_torch.data import RandomMask, SliceDataset, VarNetDataTransform
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.parallel import initialize, make_mesh, make_process_sum
    from cinemri_tpu_torch.train import Loader, Trainer, TrainerConfig

    torch.set_num_threads(1)
    rank, workdir, run, ckpt = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    initialize(f"file://{workdir}/store_{run}", 2, rank, device="cpu")

    def loader(split):
        ds = SliceDataset(f"{workdir}/data/{split}",
                          transform=VarNetDataTransform(RandomMask([6], [2]), use_seed=False),
                          maps_cache_dir=f"{workdir}/maps")
        return Loader(ds, batch_size=1, shuffle=split == "train", num_replicas=2, rank=rank,
                      volume_aware=split != "train")

    class SigtermLoader:
        # epoch 1 raises SIGTERM in this process as its first batch is drawn
        def __init__(self, loader):
            self.loader, self.dataset, self.drawn = loader, loader.dataset, 0

        def steps_per_epoch(self, epoch=0):
            return self.loader.steps_per_epoch(epoch)

        def epoch(self, epoch):
            for i, batch in enumerate(self.loader.epoch(epoch)):
                if epoch == 1 and i == 0:
                    signal.raise_signal(signal.SIGTERM)
                self.drawn += epoch == 1
                yield batch

    trainer = Trainer(build_model("varnet", "XF", device="cpu", num_cascades=1, chans=4, pools=2,
                                  sens_chans=4, sens_pools=2),
                      TrainerConfig(epochs=3, lr=1e-3, log_dir=None, compute_train_metrics=True,
                                    ckpt_dir=f"{workdir}/{ckpt}"),
                      train_loader=loader("train"), val_loader=loader("valid"),
                      mesh=make_mesh(), reduce_fn=make_process_sum(), device="cpu")
    if run == "victim" and rank == 1:
        trainer.train_loader = SigtermLoader(trainer.train_loader)
    saves, save = [], torch.save
    torch.save = lambda *a, **k: (saves.append(1), save(*a, **k))
    try:
        trainer.fit(resume=run == "resume")
        code = 0
    except SystemExit as e:
        code = e.code
    torch.save = save
    state = trainer.state
    adam = state.optimizer.adam.state
    out = {"code": code, "step": state.step, "history": trainer.history, "saves": len(saves),
           "drawn": getattr(trainer.train_loader, "drawn", None),
           "params": {n: p.detach().clone() for n, p in state.model.named_parameters()},
           "moments": [{k: v.clone() for k, v in adam[p].items()}
                       for p in state.model.parameters()]}
    with open(f"{workdir}/fit_{run}_r{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
""")


MIXED_WORKER = textwrap.dedent("""
    import datetime, pickle, sys, types
    import torch
    from cinemri_tpu_torch.data import RandomMask, VarNetDataTransform
    from cinemri_tpu_torch.data.synthetic import synthetic_volume
    from cinemri_tpu_torch.data.transforms import center_crop_to_smallest
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.models.init import torch_style_init
    from cinemri_tpu_torch.ops.ssim import ssim_loss
    from cinemri_tpu_torch.parallel import initialize, make_mesh, make_process_sum, shard_batch
    from cinemri_tpu_torch.parallel import distributed as D
    from cinemri_tpu_torch.train import Loader, Trainer, TrainerConfig, create_train_state
    from cinemri_tpu_torch.train.step import global_norm

    # strided shards: rank 0 holds volumes 0, 2, 4, 6 (one shape: 2 batches
    # of 2), rank 1 holds 1, 3, 5, 7 (two shapes: 3 batches, two padded)
    COILS = (2, 3, 2, 2, 2, 2, 2, 2)
    TINY = dict(num_cascades=1, chans=4, pools=2, sens_chans=4, sens_pools=2)
    LR, SEED = 1e-3, 42


    class Mixed:
        def __init__(self):
            tf = VarNetDataTransform(RandomMask([6], [2]), use_seed=True)
            self.samples, self.examples = [], []
            for i, c in enumerate(COILS):
                vol = synthetic_volume(num_frames=4, num_coils=c, h=32, w=32, noise=1e-2, seed=i)
                self.samples.append(tf(vol["kspace"], None, vol["image"], {}, f"vol{i}.h5", 0))
                self.examples.append(types.SimpleNamespace(metadata={"num_coils": c}))

        def __len__(self):
            return len(self.samples)

        def __getitem__(self, i):
            return self.samples[i]


    def loader(rank):
        return Loader(Mixed(), batch_size=2, num_replicas=2, rank=rank, prefetch_size=0)


    def model():
        m = build_model("varnet", "XF", device="cpu", **TINY)
        torch_style_init(m, torch.Generator().manual_seed(SEED))  # as Trainer.init_state
        return m


    def reference():
        \"\"\"One process: step i sums the contributions of both ranks' batch i
        (when the rank has one) over their joint weight, then one Adam step.\"\"\"
        shards = [list(loader(r).epoch(0)) for r in range(2)]
        state = create_train_state(model(), device="cpu", lr=LR, steps_per_epoch=3)
        losses = []
        for i in range(max(map(len, shards))):
            batches = [shard_batch(s[i], None, device="cpu") for s in shards if i < len(s)]
            den = torch.clamp(sum(b["sample_weight"].sum() for b in batches), min=1.0)
            state.optimizer.adam.zero_grad(set_to_none=True)
            total = 0.0
            for b in batches:
                target, out = center_crop_to_smallest(b["target"], state.model(b["masked_kspace"],
                                                                               b["mask"]))
                loss = ssim_loss(out, target, sample_weight=b["sample_weight"], denominator=den)
                loss.backward()
                total += loss.item()
            state.optimizer.step(global_norm(p.grad for p in state.model.parameters()))
            losses.append(total)
        return losses, [p.detach() for p in state.model.parameters()]


    if __name__ == "__main__":
        torch.set_num_threads(1)
        rank, workdir = int(sys.argv[1]), sys.argv[2]
        initialize(f"file://{workdir}/store_mixed", 2, rank, device="cpu",
                   timeout=datetime.timedelta(seconds=60))
        trainer = Trainer(model(), TrainerConfig(epochs=1, lr=LR, seed=SEED, log_dir=None),
                          train_loader=loader(rank), mesh=make_mesh(), reduce_fn=make_process_sum(),
                          device="cpu")
        losses, step = [], trainer._train_step

        def recording(state, batch_, **kw):
            state, aux = step(state, batch_, **kw)
            losses.append(aux["loss"].item())
            return state, aux

        trainer._train_step = recording
        trainer.fit()
        with open(f"{workdir}/mixed_r{rank}.pkl", "wb") as f:
            pickle.dump({"local_steps": trainer.train_loader.steps_per_epoch(), "losses": losses,
                         "step": trainer.state.step, "grad_reduces": D.COLLECTIVES["grad"],
                         "history": trainer.history,
                         "params": [p.detach() for p in trainer.model.parameters()]}, f)
""")


def _run(workdir: Path, script: str, argv_per_rank, name: str):
    """Run ``script`` once per argv list, all at once; the outputs."""
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    path = workdir / f"{name}.py"
    path.write_text(script)
    procs = [subprocess.Popen([sys.executable, str(path), *map(str, argv)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for argv in argv_per_rank]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0])
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"process failed:\n{out[-4000:]}"
    return outs


def _load(path: Path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """train: 6 volumes (3 steps per rank an epoch), valid: 3 (two for rank
    0, one for rank 1: the ranks' evaluation passes differ in length),
    test: 2; 4 frames, 3 coils, 32 x 32."""
    root = tmp_path_factory.mktemp("torchdist")
    for split, n in (("train", 6), ("valid", 3), ("test", 2)):
        make_synthetic_dataset(root / "data", splits=(split,), volumes_per_split=n,
                               num_frames=4, num_coils=3, h=32, w=32)
    (root / "dirs_path.yaml").write_text(
        f"data_path: {root}/data\nlog_path: {root}/logs\nsave_path: {root}/results\n")
    return root


def test_two_process_cli_matches_single_process(workdir):
    """The 2-process CLI run (batch 1 each) against one process at batch 2:
    the ranks' weights equal each other exactly and the one-process run's
    within 5e-3 of max |w| (the JAX test's tolerance); the epoch metrics,
    summed over the processes, are the same on both ranks and match."""
    def two_ranks():
        port = _free_port()
        return _run(workdir, CLI_WORKER, [(r, port, workdir, 2) for r in range(2)], "cli")

    try:
        outs = two_ranks()
    except AssertionError:
        # one retry on a fresh port: another process may have taken the first
        outs = two_ranks()
    one = _run(workdir, CLI_WORKER, [(0, 0, workdir, 1)], "cli")
    assert all("certified data-parallel recipe" in out for out in outs)
    assert "certified data-parallel recipe" not in one[0]

    two, two_r1, single = (_load(workdir / f"cli_p{p}_n{n}.pkl") for p, n in ((0, 2), (1, 2), (0, 1)))
    for a, b in zip(two["params"], two_r1["params"]):
        np.testing.assert_array_equal(a, b)
    assert len(two["params"]) == len(single["params"])
    for a, b in zip(two["params"], single["params"]):
        scale = float(np.abs(b).max()) + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=5e-3)
    for k in ("train_ssim", "train_nmse", "train_loss", "val_ssim", "val_loss"):
        assert two["history"][-1][k] == two_r1["history"][-1][k], k
        assert two["history"][-1][k] == pytest.approx(single["history"][-1][k], rel=1e-3), k


def test_two_process_cli_on_a_coil_axis_matches_single_process(workdir):
    """``--coil_devices 2`` through the CLI: two processes hold the 2
    virtual coils (``--compress_coils 2``) of each batch of 2 volumes, one
    each, against one process with both coils. The ranks' weights are equal
    exactly and the one-process run's within 5e-3 of max |w|; the epoch
    metrics, summed over the data group only, count each volume once: the
    same on both ranks and the one-process run's."""
    def two_ranks():
        port = _free_port()
        return _run(workdir, CLI_WORKER, [(r, port, workdir, 2, "coil") for r in range(2)], "cli")

    try:
        two_ranks()
    except AssertionError:
        two_ranks()  # one retry on a fresh port, as the data-parallel case
    _run(workdir, CLI_WORKER, [(0, 0, workdir, 1, "coil")], "cli")
    two, two_r1, single = (_load(workdir / f"cli_p{p}_n{n}_coil.pkl")
                           for p, n in ((0, 2), (1, 2), (0, 1)))
    for a, b in zip(two["params"], two_r1["params"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(two["params"], single["params"]):
        scale = float(np.abs(b).max()) + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=5e-3)
    for k in ("train_ssim", "train_nmse", "train_loss", "val_ssim", "val_loss"):
        assert two["history"][-1][k] == two_r1["history"][-1][k], k
        assert two["history"][-1][k] == pytest.approx(single["history"][-1][k], rel=1e-3), k


def test_sigterm_on_one_rank_then_resume_is_bit_identical(workdir):
    """SIGTERM on rank 1 as the first batch of epoch 1 is drawn (3 steps
    per rank an epoch): the flag rides step 1's all-reduce and is read a
    step late, so both ranks stop before step 3 and exit with 143; rank 0 wrote epoch 0's checkpoint and
    the preemption save, rank 1 nothing. A two-process resume then ends as
    the uninterrupted two-process run does, bit for bit."""
    _run(workdir, FIT_WORKER, [(r, workdir, "straight", "ckpt_straight") for r in range(2)], "fit")
    _run(workdir, FIT_WORKER, [(r, workdir, "victim", "ckpt_run") for r in range(2)], "fit")
    victims = [_load(workdir / f"fit_victim_r{r}.pkl") for r in range(2)]
    assert [v["code"] for v in victims] == [143, 143]
    assert [v["step"] for v in victims] == [5, 5]
    assert [v["saves"] for v in victims] == [2, 0]
    assert victims[1]["drawn"] == 3  # of 3: the batch after the signal, not taken
    saved = torch.load(workdir / "ckpt_run" / "1.pt", weights_only=False)
    assert (saved["epoch"], saved["epoch_step"], saved["step"]) == (0, 2, 5)
    assert len(saved["train_partial"]) == 2

    _run(workdir, FIT_WORKER, [(r, workdir, "resume", "ckpt_run") for r in range(2)], "fit")
    for r in range(2):
        straight = _load(workdir / f"fit_straight_r{r}.pkl")
        resumed = _load(workdir / f"fit_resume_r{r}.pkl")
        assert resumed["code"] == straight["code"] == 0
        assert resumed["step"] == straight["step"] == 9
        assert resumed["history"] == straight["history"][1:]
        for name, p in straight["params"].items():
            assert torch.equal(p, resumed["params"][name]), name
        for a, b in zip(straight["moments"], resumed["moments"]):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(a[key], b[key]), key
    histories = [_load(workdir / f"fit_straight_r{r}.pkl")["history"] for r in range(2)]
    assert histories[0] == histories[1]


def test_mixed_shapes_at_batch_2_take_the_same_steps_on_every_rank(workdir):
    """Volumes of two coil counts at batch 2: the shape buckets give rank 0
    two batches and rank 1 three, so rank 0 adds one zero-weight step. Both
    ranks take 3 steps and 3 gradient all-reduces and end bit-identical,
    and the losses and weights match one process that sums the contributions
    of each step's real batches (loss rtol 1e-5, weights rtol 1e-4 / atol
    1e-5)."""
    import importlib.util

    _run(workdir, MIXED_WORKER, [(r, workdir) for r in range(2)], "mixed")
    ranks = [_load(workdir / f"mixed_r{r}.pkl") for r in range(2)]
    assert [r["local_steps"] for r in ranks] == [2, 3]
    assert [r["step"] for r in ranks] == [3, 3]
    assert [r["grad_reduces"] for r in ranks] == [3, 3]
    assert ranks[0]["losses"] == ranks[1]["losses"] and ranks[0]["history"] == ranks[1]["history"]
    for p, q in zip(*(r["params"] for r in ranks)):
        assert torch.equal(p, q)
    spec = importlib.util.spec_from_file_location("mixed_worker", workdir / "mixed.py")
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks: the same convolution reduction order
    try:
        losses, params = worker.reference()
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-5)
    for p, q in zip(ranks[0]["params"], params):
        np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=1e-4, atol=1e-5)


def test_single_process_refuses_more_devices():
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2") as exc:
        TC.train_test_main("varnet", ["--num_devices", "2", "--device", "cpu"])
    assert "--num_processes 2 --coordinator_address host:port --process_id i" in str(exc.value)


@pytest.mark.parametrize("flag", ["--coil_devices", "--plane_devices"])
def test_coil_and_plane_axes_name_item_13b(flag):
    """The axes of item 13b, ported: one process with a coil or plane axis
    of 2 is told the torchrun launch of its 2 processes; a plane axis of a
    type without plane batches gets the JAX CLI's ValueError first."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2") as exc:
        TC.train_test_main("varnet", [flag, "2", "--device", "cpu"])
    assert f"{flag} 2" in str(exc.value)
    with pytest.raises(ValueError, match="dynamic_type '2D' has none"):
        TC.train_test_main("varnet", ["--plane_devices", "2", "--dynamic_type", "2D",
                                      "--device", "cpu"])


@pytest.mark.parametrize("n, lr, notice", [(2, "1e-4", True), (1, "1e-4", False),
                                           (2, "3e-4", False)])
def test_data_parallel_lr_notice(n, lr, notice):
    """The JAX package's notice, at the data-parallel size: the default lr
    at more than one device."""
    args = TC.build_parser("varnet").parse_args(["--lr", lr, "--device", "cpu"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        TC._envelope_notices("varnet", args, n)
    texts = [str(w.message) for w in caught]
    assert any("--num_devices 2 at the default --lr 1e-4" in t and "(--lr 2e-04 here)" in t
               for t in texts) == notice
