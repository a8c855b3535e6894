"""The port's training system (cinemri_tpu_torch.train: metrics, aggregator,
loader, checkpoints, device cache, Trainer) against the JAX package on the
CPU, and the port's own behaviour: cache on/off, deferred loss syncs,
resume and preemption, each bit-exact.

Data: synthetic volumes (4 frames, 3 coils, 32x32) written once per module,
read by both packages' datasets; the model is VarNet-XF with 1 cascade,
chans 4, pools 2, sens net 4/2.
"""

import signal
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from cinemri_tpu.data import RandomMask as JRandomMask
from cinemri_tpu.data import SliceDataset as JSliceDataset
from cinemri_tpu.data import VarNetDataTransform as JVarNetDataTransform
from cinemri_tpu.models import build_model as j_build_model
from cinemri_tpu.ops import metrics as JM
from cinemri_tpu.train import CheckpointManager as JCheckpointManager
from cinemri_tpu.train import Loader as JLoader
from cinemri_tpu.train import MetricsAggregator as JMetricsAggregator
from cinemri_tpu.train import Trainer as JTrainer
from cinemri_tpu.train import TrainerConfig as JTrainerConfig

from cinemri_tpu_torch.data import RandomMask, SliceDataset, VarNetDataTransform
from cinemri_tpu_torch.data.synthetic import make_synthetic_dataset
from cinemri_tpu_torch.interop.flax_params import varnet_state_dict
from cinemri_tpu_torch.models import build_model
from cinemri_tpu_torch.ops import metrics as TM
from cinemri_tpu_torch.train import (
    CheckpointManager,
    Loader,
    MetricsAggregator,
    Trainer,
    TrainerConfig,
)
from cinemri_tpu_torch.train.device_cache import DeviceSampleCache

torch.set_num_threads(2)

TINY = dict(num_cascades=1, chans=4, pools=2, sens_chans=4, sens_pools=2)
MASK = ([6], [2])  # 6 center lines of 32 rows, acceleration 2


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """train: 3 volumes (an odd count, so batches of 2 pad), valid: 3."""
    root = tmp_path_factory.mktemp("loopdata")
    return make_synthetic_dataset(root, splits=("train", "valid"), volumes_per_split=3,
                                  num_frames=4, num_coils=3, h=32, w=32)


@pytest.fixture(scope="module")
def maps_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("loopmaps")


def _loader(data_root, maps_dir, split, jax_side=False, transform=None, **kwargs):
    """A loader over ``split`` in either package (use_seed off: masks from
    the transform's stream, reseeded per epoch by the Loader)."""
    ds_cls, tf_cls, mask_cls, loader_cls = (
        (JSliceDataset, JVarNetDataTransform, JRandomMask, JLoader) if jax_side
        else (SliceDataset, VarNetDataTransform, RandomMask, Loader))
    tf = transform or tf_cls(mask_cls(*MASK), use_seed=False)
    ds = ds_cls(data_root / split, transform=tf,
                maps_cache_dir=maps_dir / ("jax" if jax_side else "port"))
    return loader_cls(ds, **kwargs)


def _trainer(data_root, maps_dir, tmp_path=None, val=False, model=None, **cfg):
    cfg = {"epochs": 2, "lr": 1e-3, "log_dir": None, "compute_train_metrics": False, **cfg}
    if tmp_path is not None:
        cfg.setdefault("ckpt_dir", tmp_path / "ckpt")
    return Trainer(model or build_model("varnet", "XF", device="cpu", **TINY), TrainerConfig(**cfg),
                   train_loader=_loader(data_root, maps_dir, "train", shuffle=True),
                   val_loader=_loader(data_root, maps_dir, "valid") if val else None,
                   device="cpu")


def _record_losses(trainer):
    """Per-step train losses of ``trainer``'s fit, in order."""
    losses, step = [], trainer._train_step

    def recording(state, batch):
        state, aux = step(state, batch)
        losses.append(float(aux["loss"]))
        return state, aux

    trainer._train_step = recording
    return losses


def _assert_same_state(a, b):
    """Bit-identical weights, Adam moments and step counts."""
    for (name, p), q in zip(a.state.model.named_parameters(), b.state.model.parameters()):
        assert torch.equal(p, q), name
        sa, sb = a.state.optimizer.adam.state[p], b.state.optimizer.adam.state[q]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[key], sb[key]), (name, key)
    assert a.state.step == b.state.step
    assert a.state.optimizer.scheduler.last_epoch == b.state.optimizer.scheduler.last_epoch


class TestMetrics:
    def test_metrics_match_jax(self, rng):
        gt = rng.random((4, 24, 20)).astype(np.float32)
        pred = (gt + 0.1 * rng.standard_normal(gt.shape)).astype(np.float32)
        for name in ("mse", "nmse", "psnr", "ssim"):
            got, want = getattr(TM, name)(gt, pred), getattr(JM, name)(gt, pred)
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), name
        assert TM.ssim(gt, pred, maxval=2.0) == pytest.approx(JM.ssim(gt, pred, maxval=2.0), rel=1e-6)
        with pytest.raises(ValueError):
            TM.ssim(gt[0], pred[0])

    def test_aggregator_and_csv_match_jax(self, rng, tmp_path):
        """The same batches (a duplicate slice that overwrites, a padding
        entry of weight 0) give the same epoch metrics and SSIMs.csv text."""
        aggs = (JMetricsAggregator(ssim_csv_path=tmp_path / "j" / "SSIMs.csv"),
                MetricsAggregator(ssim_csv_path=tmp_path / "t" / "SSIMs.csv"))
        for names, weights in ((["a", "b"], [1.0, 1.0]), (["a", "c"], [1.0, 0.0]), (["c", "c"], [1, 1])):
            out = rng.random((2, 3, 16, 16)).astype(np.float32)
            tgt = rng.random((2, 3, 16, 16)).astype(np.float32)
            batch = {"fname": names, "slice_num": np.zeros(2, int),
                     "max_value": tgt.reshape(2, -1).max(1), "sample_weight": np.asarray(weights, np.float32)}
            loss = float(rng.random())
            for agg in aggs:
                agg.update_batch(batch, out, tgt, loss=loss)
        want, got = aggs[0].compute(), aggs[1].compute()
        assert got == want
        assert (tmp_path / "t" / "SSIMs.csv").read_text() == (tmp_path / "j" / "SSIMs.csv").read_text()
        restored = MetricsAggregator()
        restored.load_state_dict(aggs[1].state_dict())
        assert restored.compute() == got


class TestLoader:
    @pytest.mark.parametrize("num_workers", [1, 3])
    def test_batches_match_jax(self, data_root, maps_dir, num_workers):
        """Two epochs of batches of 2 over 3 volumes (the last batch padded
        with weight 0), shuffled: identical arrays, order and weights."""
        kw = dict(batch_size=2, shuffle=True, num_workers=num_workers, seed=7)
        port, ref = (_loader(data_root, maps_dir, "train", jax_side=j, **kw) for j in (False, True))
        assert port.steps_per_epoch() == ref.steps_per_epoch() == 2
        for epoch in (0, 1):
            got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                assert g["fname"] == w["fname"]
                for key in g.keys() - {"fname"}:
                    np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            assert [b["sample_weight"].tolist() for b in got] == [[1.0, 1.0], [1.0, 0.0]]
        first, want = port.first_batch(), ref.first_batch()
        assert first["fname"] == want["fname"]
        np.testing.assert_array_equal(first["masked_kspace"], want["masked_kspace"])


class TestCheckpoint:
    def test_retention_matches_orbax(self, tmp_path):
        """The same save sequence (an overwrite of a step, a save without
        metrics) keeps the same steps and picks the same best step, also
        after a restart of the manager."""
        seq = [(0, 0.5), (1, 0.1), (2, 0.2), (3, 0.15), (3, 0.12), (4, 0.9), (5, 0.3), (6, None)]
        jmgr = JCheckpointManager(tmp_path / "j", max_to_keep=2)
        mgr = CheckpointManager(tmp_path / "t", max_to_keep=2)
        for step, v in seq:
            metrics = None if v is None else {"val_loss": v}
            jmgr.save(step, {"w": np.full(2, step, np.float32)}, metrics=metrics)
            mgr.save(step, {"w": torch.full((2,), float(step))}, metrics=metrics)
            assert set(mgr.all_steps()) == set(jmgr._mgr.all_steps()), step
            assert (mgr.best_step, mgr.latest_step) == (jmgr.best_step, jmgr.latest_step), step
        jmgr.wait()
        mgr.wait()
        assert mgr.best_step == 1 and mgr.latest_step == 6 and mgr.all_steps() == [1, 3, 6]
        assert CheckpointManager(tmp_path / "t", 2).best_step == JCheckpointManager(tmp_path / "j", 2).best_step
        assert mgr.restore()["w"].tolist() == [6.0, 6.0]
        assert mgr.restore(step=1)["w"].tolist() == [1.0, 1.0]
        assert not list((tmp_path / "t").glob("*.tmp"))
        with pytest.raises(FileNotFoundError):
            CheckpointManager(tmp_path / "empty").restore()


class TestFitMatchesJax:
    def test_two_epochs_from_carried_weights(self, data_root, maps_dir):
        """Two epochs (3 train steps each, validation on 3 volumes, train
        metrics on) of the port's Trainer from flax weights carried over
        from the JAX Trainer's init, at the reference lr 1e-4: every
        per-step loss within 1e-4 relative, the epoch metrics within 1e-4.
        Loader seeds 1-5 all land within 2.3e-6 here; at lr 1e-3 seeds 1
        and 5 move by 5e-4 from their third step (a LeakyReLU input at 0
        up to rounding, whose slope an Adam step of ±lr carries on; ROADMAP
        Queue 3), so the test keeps the reference lr."""
        kw = dict(epochs=2, lr=1e-4, log_dir=None, ckpt_dir=None, seed=3)
        loaders = {j: dict(train_loader=_loader(data_root, maps_dir, "train", jax_side=j, shuffle=True, seed=3),
                           val_loader=_loader(data_root, maps_dir, "valid", jax_side=j, seed=3))
                   for j in (True, False)}
        jtrainer = JTrainer(j_build_model("varnet", "XF", **TINY), JTrainerConfig(**kw), **loaders[True])
        jtrainer.init_state(loaders[True]["train_loader"].first_batch())
        trainer = Trainer(build_model("varnet", "XF", device="cpu", **TINY), TrainerConfig(**kw),
                          device="cpu", **loaders[False])
        trainer.init_state()
        trainer.state.model.load_state_dict(varnet_state_dict(jax.tree.map(np.asarray, jtrainer.state.params)))
        jlosses, losses = _record_losses(jtrainer), _record_losses(trainer)
        want, got = jtrainer.fit(), trainer.fit()
        assert len(losses) == len(jlosses) == 6
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in g:
                assert g[key] == pytest.approx(w[key], rel=1e-4), key


class TestDeviceCache:
    def test_cache_on_and_off_give_identical_losses(self, data_root, maps_dir):
        runs = []
        for cache in (True, False):
            trainer = _trainer(data_root, maps_dir, val=True, device_data_cache=cache)
            losses = _record_losses(trainer)
            runs.append((losses, trainer.fit(), trainer))
        (on, h_on, t_on), (off, h_off, t_off) = runs
        assert on == off and h_on == h_off
        for p, q in zip(t_on.state.model.parameters(), t_off.state.model.parameters()):
            assert torch.equal(p, q)
        assert t_on._caches["train"].misses == 3 and t_on._caches["train"].hits == 3
        assert t_on._caches["eval"].misses == 3 and t_off._caches is None
        # with the cache, the second epoch sends the masks and weights only
        assert t_on.h2d_bytes < 0.6 * t_off.h2d_bytes

    def test_lru_eviction(self):
        one_mb = np.zeros((256, 1024), np.float32)
        cache = DeviceSampleCache("cpu", budget_bytes=int(2.5 * (1 << 20)))
        for key in ("a", "b", "c"):
            cache.get(key, lambda: {"x": one_mb})
        assert len(cache) == 2 and cache.nbytes == 2 << 20  # "a" evicted
        assert cache.misses == 3 and cache.hits == 0
        cache.get("c", lambda: {"x": one_mb})
        assert cache.hits == 1
        got = cache.get("a", lambda: {"x": one_mb, "z": one_mb.astype(np.complex64), "n": None})
        assert cache.misses == 4 and got["n"] is None and got["z"].re.shape == (256, 1024)
        assert cache.bytes_sent == (4 << 20) + (2 << 20)

    @pytest.mark.parametrize("transform", ["undeclared", "compress_coils"])
    def test_transform_without_the_contract_takes_the_host_path(self, data_root, maps_dir, transform):
        """A transform that does not declare ``kspace_is_raw_times_mask``
        (or declares it false: coil compression) never engages the cache."""
        base = VarNetDataTransform(RandomMask(*MASK), use_seed=False,
                                   compress_coils=2 if transform == "compress_coils" else 0)

        class Undeclared:
            mask_func = base.mask_func

            def __call__(self, *args, **kwargs):
                return base(*args, **kwargs)

        tf = base if transform == "compress_coils" else Undeclared()
        assert not getattr(tf, "kspace_is_raw_times_mask", False)
        trainer = Trainer(build_model("varnet", "XF", device="cpu", **TINY),
                          TrainerConfig(epochs=1, log_dir=None, compute_train_metrics=False),
                          train_loader=_loader(data_root, maps_dir, "train", transform=tf),
                          device="cpu")
        trainer.fit()
        assert trainer._caches["train"].misses == 0 and trainer.h2d_bytes > 0


class TestLoop:
    def test_deferred_loss_syncs_equal_per_step_syncs(self, data_root, maps_dir):
        histories = [_trainer(data_root, maps_dir, log_every_steps=every).fit() for every in (0, 1)]
        assert histories[0] == histories[1]
        assert len(histories[0]) == 2 and np.isfinite(histories[0][-1]["train_loss"])

    def test_resume_equals_uninterrupted_run(self, data_root, maps_dir, tmp_path):
        straight = _trainer(data_root, maps_dir, tmp_path / "a", val=True, epochs=3)
        straight.fit()
        _trainer(data_root, maps_dir, tmp_path / "b", val=True, epochs=2).fit()
        resumed = _trainer(data_root, maps_dir, tmp_path / "b", val=True, epochs=3)
        history = resumed.fit(resume=True)
        assert len(history) == 1 and history[0] == straight.history[-1]
        _assert_same_state(straight, resumed)
        assert torch.equal(straight.rng.get_state(), resumed.rng.get_state())

    def test_restore_best_loads_the_best_weights(self, data_root, maps_dir, tmp_path):
        trainer = _trainer(data_root, maps_dir, tmp_path, val=True, epochs=3, max_checkpoints=1)
        trainer.fit()
        best = trainer.ckpt.best_step
        assert trainer.ckpt.all_steps() == sorted({best, 2})
        fresh = _trainer(data_root, maps_dir, tmp_path)
        fresh.restore_best()
        want = trainer.ckpt.restore(step=best)["model"]
        for name, value in fresh.state.model.state_dict().items():
            assert torch.equal(value, want[name]), name

    @pytest.mark.parametrize("torch_init", [True, False])
    def test_init_state_draws_from_the_seed(self, data_root, maps_dir, torch_init):
        """The same seed draws the same weights; torch-style init is
        uniform in ±1/sqrt(fan_in), lecun_normal (torch_init off) a normal
        truncated at ±2σ with zero biases, as flax's default."""
        weights = []
        for _ in range(2):
            trainer = _trainer(data_root, maps_dir, torch_init=torch_init, seed=5)
            trainer.init_state()
            weights.append(trainer.state.model.state_dict())
        for name, value in weights[0].items():
            assert torch.equal(value, weights[1][name]), name
        conv = trainer.state.model.sens_net.norm_unet.unet.final
        fan_in = conv.weight.shape[1] * conv.weight.shape[2] * conv.weight.shape[3]
        w = conv.weight.detach().abs().max().item() * np.sqrt(fan_in)
        if torch_init:
            assert w <= 1.0 and conv.bias.abs().max().item() > 0
        else:
            assert w <= 2.0 / 0.87962566103423978 and conv.bias.abs().max().item() == 0

    def test_mismatched_fingerprint_raises(self, data_root, maps_dir, tmp_path):
        _trainer(data_root, maps_dir, tmp_path, epochs=1, config_fingerprint="aaaaaaaa").fit()
        other = _trainer(data_root, maps_dir, tmp_path, config_fingerprint="bbbbbbbb")
        with pytest.raises(ValueError, match="fingerprint"):
            other.fit(resume=True)

    @pytest.mark.parametrize("cfg, item", [({"profile_steps": 2}, "item 14"), ({"debug_nans": True}, "item 14")])
    def test_unported_options_raise(self, cfg, item):
        """The options of item 14.2 (instrument/) are ported: the Trainer
        takes them (tests/test_torch_instrument.py runs them)."""
        model = build_model("varnet", "XF", device="cpu", **TINY)
        trainer = Trainer(model, TrainerConfig(**cfg), device="cpu")
        assert all(getattr(trainer.cfg, k) == v for k, v in cfg.items())
        # item 13b is ported: a data x coil mesh is taken, without the device
        # cache, and its rank at coil index 1 writes no SSIMs.csv rows
        coil = SimpleNamespace(mesh_dim_names=("data", "coil"), shape=(1, 2),
                               get_local_rank=lambda name: {"data": 0, "coil": 1}[name])
        trainer = Trainer(model, TrainerConfig(), mesh=coil, device="cpu")
        assert trainer._caches is None and not trainer._lead

    def test_default_device_raises_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(build_model("varnet", "XF", device="cpu", **TINY), TrainerConfig())


class _SigtermLoader:
    """Wraps a Loader; its epoch-1 iterator raises SIGTERM in this process
    once the first batch has been taken, as a preemption would land."""

    def __init__(self, loader):
        self.loader, self.dataset = loader, loader.dataset
        self.drawn = 0  # batches of epoch 1 taken

    def steps_per_epoch(self):
        return self.loader.steps_per_epoch()

    def epoch(self, epoch):
        for i, batch in enumerate(self.loader.epoch(epoch)):
            self.drawn += epoch == 1
            yield batch
            if epoch == 1 and i == 0:
                signal.raise_signal(signal.SIGTERM)


# (loader that takes the SIGTERM, recorded (epoch, epoch_step, step)): 3
# train steps per epoch; in validation every step of epoch 1 is recorded
@pytest.mark.parametrize("where, recorded", [("train", (0, 1, 4)), ("val", (0, 3, 6))])
def test_sigterm_mid_epoch_then_resume_is_bit_identical(data_root, maps_dir, tmp_path,
                                                        where, recorded):
    """In process, no wall-clock wait: SIGTERM after the first batch of
    epoch 1, of training or of its validation, exits with 143 before the
    pass ends and leaves a checkpoint at epoch id 1 recording epoch 0 and
    the steps taken in epoch 1; fit(resume=True) then finishes exactly as
    the uninterrupted run does."""
    kw = dict(val=True, epochs=3, compute_train_metrics=True)
    straight = _trainer(data_root, maps_dir, tmp_path / "straight", **kw)
    straight.fit()

    victim = _trainer(data_root, maps_dir, tmp_path / "run", **kw)
    wrapped = _SigtermLoader(getattr(victim, f"{where}_loader"))
    setattr(victim, f"{where}_loader", wrapped)
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exc:
        victim.fit()
    assert exc.value.code == 143
    assert signal.getsignal(signal.SIGTERM) is before
    assert wrapped.drawn == 2  # of 3: the pass stopped at the batch after the signal
    assert victim.ckpt.latest_step == 1
    saved = victim.ckpt.restore()
    assert (saved["epoch"], saved["epoch_step"], saved["step"]) == recorded

    resumed = _trainer(data_root, maps_dir, tmp_path / "run", **kw)
    history = resumed.fit(resume=True)
    assert [h["epoch"] for h in history] == [1, 2]
    assert history == straight.history[1:]
    _assert_same_state(straight, resumed)
