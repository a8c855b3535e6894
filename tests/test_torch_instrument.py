"""The port's instrumentation (cinemri_tpu_torch.instrument) on the CPU:
the step timer's summary against the JAX package's, the finiteness check,
the NaN switch, the profiler trace and its fold, and the Trainer's
``profile_steps`` and ``debug_nans``."""

import numpy as np
import pytest
import torch

from cinemri_tpu.instrument import StepTimer as JStepTimer

from cinemri_tpu_torch.data import RandomMask, SliceDataset, VarNetDataTransform
from cinemri_tpu_torch.data.synthetic import make_synthetic_dataset
from cinemri_tpu_torch.instrument import StepTimer, assert_finite, enable_nan_checks, opstats, trace
from cinemri_tpu_torch.models import build_model
from cinemri_tpu_torch.ops.cplx import Complex
from cinemri_tpu_torch.train import Loader, Trainer, TrainerConfig

torch.set_num_threads(2)

TINY = dict(num_cascades=1, chans=4, pools=2, sens_chans=4, sens_pools=2)


class TestStepTimer:
    def test_summary_keys_equal_jax(self):
        t, jt = StepTimer(), JStepTimer()
        for timer in (t, jt):
            for _ in range(3):
                with timer.step():
                    torch.ones(64, 64).sum()
        t.start()
        t.stop(sync={"a": torch.ones(2), "b": [torch.zeros(1)]})
        s = t.summary()
        assert s.keys() == jt.summary().keys()
        assert s["count"] == 4 and 0 < s["p50_s"] <= s["max_s"]
        assert StepTimer().summary() == {}


class TestSanitizers:
    def test_assert_finite_names_the_leaf(self):
        assert_finite({"a": torch.ones(3), "b": {"c": np.zeros(2)}, "d": [1.0]})
        with pytest.raises(FloatingPointError, match=r"params\['w'\]\[1\]\.im"):
            assert_finite({"w": [torch.ones(1), Complex(torch.ones(2), torch.tensor([1.0, np.nan]))]},
                          name="params")
        with pytest.raises(FloatingPointError, match=r"batch\['k'\]"):
            assert_finite({"k": np.array([np.inf])}, name="batch")

    def test_nan_checks_raise_forward_and_backward_and_turn_off(self):
        net = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.ReLU())
        bad = torch.tensor([[np.nan, 1.0]])
        assert enable_nan_checks(True) is False
        try:
            with pytest.raises(FloatingPointError, match="output of Linear"):
                net(bad)
            out = net(torch.ones(1, 2))
            with pytest.raises(FloatingPointError, match="non-finite gradient into the output"):
                (out * torch.tensor(np.inf)).sum().backward()
        finally:
            assert enable_nan_checks(False) is True
        assert not torch.isfinite(net(bad)).all()  # off: no check


class TestTrace:
    def test_trace_writes_a_chrome_trace_that_opstats_folds(self, tmp_path):
        with trace(tmp_path / "prof"):
            torch.ones(128, 128).sum()
        files = list((tmp_path / "prof").glob("*.pt.trace.json"))
        assert len(files) == 1
        events = opstats.kernel_events(files[0])  # no device on the CPU: no kernel events
        assert isinstance(events, list) and opstats.fold_by_kind(events) == {}
        with pytest.raises(KeyError), trace(tmp_path / "raised"):
            raise KeyError("a block that raises still writes its trace")
        assert len(list((tmp_path / "raised").glob("*.pt.trace.json"))) == 1


@pytest.fixture(scope="module")
def loader(tmp_path_factory):
    root = tmp_path_factory.mktemp("instrdata")
    make_synthetic_dataset(root, splits=("train",), volumes_per_split=2, num_frames=4,
                           num_coils=3, h=32, w=32)
    ds = SliceDataset(root / "train", transform=VarNetDataTransform(RandomMask([6], [2])),
                      maps_cache_dir=root / "maps")
    return Loader(ds, batch_size=1, shuffle=False)


class TestTrainer:
    def test_profile_steps_write_a_trace_after_the_first_step(self, loader, tmp_path):
        cfg = TrainerConfig(epochs=1, log_dir=tmp_path / "tb", profile_steps=1,
                            compute_train_metrics=False)
        trainer = Trainer(build_model("varnet", "XF", device="cpu", **TINY), cfg,
                          train_loader=loader, device="cpu")
        trainer.fit()
        files = list((tmp_path / "tb" / "profile").glob("*.pt.trace.json"))
        assert len(files) == 1 and files[0].stat().st_size > 0
        assert int(trainer.state.step) == 2

    def test_debug_nans_raises_on_a_nan_input(self, loader):
        class NanLoader:
            dataset = loader.dataset

            def steps_per_epoch(self, epoch=0):
                return 1

            def epoch(self, epoch):
                batch = next(iter(loader.epoch(epoch)))
                batch["masked_kspace"] = batch["masked_kspace"] * np.nan
                yield batch

        cfg = TrainerConfig(epochs=1, debug_nans=True, device_data_cache=False)
        trainer = Trainer(build_model("varnet", "XF", device="cpu", **TINY), cfg,
                          train_loader=NanLoader(), device="cpu")
        with pytest.raises(FloatingPointError, match="non-finite values in the output"):
            trainer.fit()
        assert enable_nan_checks(False) is False  # fit turned the checks off again
