"""The port's instrumentation (cinemri_tpu_torch.instrument) on the CPU:
the step timer's summary against the JAX package's, the finiteness check,
the NaN switch, the program spans in a served request's and a train step's
trace, the profiler trace and its fold, and the Trainer's
``profile_steps`` and ``debug_nans``."""

import contextlib
import json

import numpy as np
import pytest
import torch

from cinemri_tpu.instrument import StepTimer as JStepTimer

from cinemri_tpu_torch.data import RandomMask, SliceDataset, VarNetDataTransform
from cinemri_tpu_torch.data.synthetic import make_synthetic_dataset
from cinemri_tpu_torch.data.masks import RandomMask as TRandomMask
from cinemri_tpu_torch.instrument import (SPANS, StepTimer, assert_finite, enable_nan_checks,
                                          opstats, span, trace)
from cinemri_tpu_torch.models import build_model
from cinemri_tpu_torch.ops.cplx import Complex
from cinemri_tpu_torch.serve import bind_model
from cinemri_tpu_torch.train import Loader, Trainer, TrainerConfig
from cinemri_tpu_torch.train.step import create_train_state, make_train_step

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


def _request(seed: int, maps: bool):
    """A served request's float32 host arrays (k-space, mask[, maps])."""
    rng = np.random.default_rng(seed)
    t, c, h, w = 4, 3, 24, 20
    mask = TRandomMask([4], [2])(t, h, seed=seed)[None].astype(np.float32)
    k = (rng.standard_normal((1, t, c, h, w)) + 1j * rng.standard_normal((1, t, c, h, w))) * mask
    parts = [k.real, k.imag, mask]
    if maps:
        s = rng.standard_normal((1, 1, c, h, w)) + 1j * rng.standard_normal((1, 1, c, h, w))
        parts += [s.real, s.imag]
    return [np.ascontiguousarray(a, dtype=np.float32) for a in parts]


def _spans(log_dir):
    """``[(name, start_us, end_us)]`` of the program spans in the one chrome
    trace under ``log_dir``."""
    (path,) = list(log_dir.glob("*.pt.trace.json"))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("name", "").startswith("cinemri.")]


def _inside(child, parents) -> bool:
    return any(p[1] <= child[1] and child[2] <= p[2] for p in parents)


CASCADES = 2


class TestSpans:
    def test_without_a_profiler_a_span_is_the_one_shared_null_context(self):
        assert isinstance(span("cinemri.dc"), contextlib.nullcontext)
        assert span("cinemri.dc") is span("cinemri.serve")
        assert len(set(SPANS)) == len(SPANS) and all(n.startswith("cinemri.") for n in SPANS)

    def test_a_span_is_a_host_range_like_an_op_not_a_user_annotation(self):
        """So the profiler draws no device range for it, which a fold of
        device events would take for device work."""
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with span("cinemri.dc"):
                torch.ones(8).sum()
        events = {e.name(): e for e in prof.profiler.kineto_results.events()}
        dc = events["cinemri.dc"]
        assert dc.activity_type() == "cpu_op" and not dc.is_user_annotation()
        inner = events["aten::sum"]
        assert dc.start_ns() <= inner.start_ns() <= inner.end_ns() <= dc.end_ns()

    @pytest.mark.parametrize("family", ["varnet", "cinenet"])
    def test_a_served_request_records_its_spans(self, family, tmp_path):
        kw = dict(num_cascades=CASCADES, chans=4, pools=2)
        kw.update(dict(sens_chans=4, sens_pools=2) if family == "varnet" else dict(cg_iters=3))
        serve = bind_model(build_model(family, "XF", device="cpu", **kw), device="cpu")
        request = _request(3, maps=family == "cinenet")
        with trace(tmp_path):
            serve(*request)
        got = _spans(tmp_path)
        by = {n: [s for s in got if s[0] == n] for n in SPANS}
        assert len(by["cinemri.serve"]) == 1 and len(by["cinemri.serve.h2d"]) == 1
        assert len(by["cinemri.regularizer"]) == CASCADES and len(by["cinemri.dc"]) == CASCADES
        assert len(by["cinemri.sens_net"]) == (family == "varnet")
        assert len(by["cinemri.dc.cg_step"]) == (CASCADES * 3 if family == "cinenet" else 0)
        assert not by["cinemri.train.forward"] + by["cinemri.train.backward"]
        for s in got:
            if s[0] != "cinemri.serve":
                assert _inside(s, by["cinemri.serve"]), s
        assert all(_inside(s, by["cinemri.dc"]) for s in by["cinemri.dc.cg_step"])
        assert not any(_inside(s, by["cinemri.dc"]) for s in by["cinemri.regularizer"])

    def test_a_remat_train_step_records_its_phases_and_the_replay_in_the_backward(self, tmp_path):
        model = build_model("varnet", "XF", device="cpu", num_cascades=CASCADES, chans=4, pools=2,
                            sens_chans=4, sens_pools=2)
        assert model.remat
        state, step = create_train_state(model, device="cpu"), make_train_step()
        kre, kim, mask = _request(4, maps=False)
        batch = {"masked_kspace": Complex(torch.from_numpy(kre), torch.from_numpy(kim)),
                 "mask": torch.from_numpy(mask), "target": torch.rand(1, 4, 24, 20)}
        with trace(tmp_path):
            step(state, batch)
        got = _spans(tmp_path)
        by = {n: [s for s in got if s[0] == n] for n in SPANS}
        phases = [by[f"cinemri.train.{p}"] for p in ("forward", "backward", "optimizer")]
        assert [len(p) for p in phases] == [1, 1, 1]
        (fwd,), (bwd,), (opt,) = phases
        assert fwd[2] <= bwd[1] and bwd[2] <= opt[1]
        # each cascade's regularizer once in the forward, once more in the replay
        assert len(by["cinemri.regularizer"]) == 2 * CASCADES
        assert sum(_inside(s, [fwd]) for s in by["cinemri.regularizer"]) == CASCADES
        assert sum(_inside(s, [bwd]) for s in by["cinemri.regularizer"]) == CASCADES
        assert len(by["cinemri.sens_net"]) == 1 and _inside(by["cinemri.sens_net"][0], [fwd])

    def test_a_profiled_forward_gives_the_same_bits(self, tmp_path):
        model = build_model("cinenet", "XF", device="cpu", num_cascades=CASCADES, chans=4, pools=2,
                            cg_iters=2)
        serve = bind_model(model, device="cpu")
        request = _request(5, maps=True)
        plain = serve(*request)
        with trace(tmp_path):
            profiled = serve(*request)
        assert _spans(tmp_path) and torch.equal(plain, profiled)


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::dft_wgmma_kernel<wgmma::Tile<2, 1, (wgmma::Source)1>>"
     "(wgmma::Problem)", "dft_matmul (port kernel)"),
    ("void (anonymous namespace)::dft_kernel_tf32<tf32::Tile<64, 40, 3, 2>, true, 1, 3>"
     "(const float *, const float *, const float *, const float *, float *, float *, long, int, int, int)",
     "dft_matmul (port kernel)"),
    ("void (anonymous namespace)::normal_apply_wgmma_kernel<wgmma::Tile<1, 3, (wgmma::Source)2>>"
     "(wgmma::Problem)", "normal_apply (port kernels)"),
    ("void (anonymous namespace)::normal_apply_reduce_kernel<4>(const float *, const float *)",
     "normal_apply (port kernels)"),
    ("void (anonymous namespace)::normal_apply_bwd_contract_kernel<tf32::Tile<128, 40, 3, 2>, 4, "
     "false, 1>(const float *)", "normal_apply_bwd (port kernels)"),
    ("(anonymous namespace)::normal_apply_fp32_fused_kernel(fp32::Problem)",
     "normal_apply (port kernels)"),
    ("(anonymous namespace)::normal_apply_bwd_fp32_fused_kernel(fp32::Problem)",
     "normal_apply_bwd (port kernels)"),
])
def test_fold_maps_the_port_kernels_to_their_kinds(name, kind):
    """The TF32 modes' Hopper tile (dft_wgmma_kernel, the normal apply's fused
    normal_apply_wgmma_kernel), the fused FP32 tile's kernels
    (``set_fp32_tile('fused')``) and the kernels beside them fold into their
    port kinds, so a profile's tables stay whole at every precision."""
    events = [(name, 0.0, 2000.0), (name, 3000.0, 1000.0)]
    assert opstats.fold_by_kind(events) == {kind: {"ms": 3.0, "count": 2}}


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
