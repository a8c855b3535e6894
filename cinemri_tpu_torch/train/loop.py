"""Training / evaluation orchestration, on one device or data-parallel
over processes.

Counterpart of ``cinemri_tpu/train/loop.py``, which replaces the
reference's Lightning Trainer wiring (train_test_varnet.py:286-297 +
pl_modules): epoch loop, per-volume metric aggregation, TensorBoard scalars
and cine videos, best-checkpoint tracking on ``validation_loss``, resume,
preemption, and the test-time SSIMs.csv artifact.

Batches come from the Loader as numpy and cross to the device here
(:meth:`Trainer._place_batch`). With a mesh
(:func:`~cinemri_tpu_torch.parallel.make_mesh`), each process trains on its
loader's shard (the shard of its ``data`` index) through the parallel step,
and every place where ranks could diverge or wait on each other forever
agrees first, over all ranks: the weights are broadcast from rank 0 after
init and restore; each epoch takes as many steps on every rank as the
longest shard holds (a shard that buckets into fewer batches adds
zero-weight steps); a SIGTERM on any rank rides the step's scalar
all-reduce, read a step late so one step stays queued, so every rank stops
at the same step, and an evaluation pass (whose ranks may hold different
batch counts) agrees once at its end; the metric reductions run in the same
order on every rank; rank 0 alone writes checkpoints and TensorBoard logs.
On ``plane`` and ``coil`` dims the ranks of a group hold the same volumes:
the ``reduce_fn`` sums over the ``data`` group
(``parallel.make_process_sum(mesh)``), and only the ranks at plane and coil
index 0 write ``SSIMs.csv`` rows, so each volume counts once.
``profile_steps`` traces that many train steps with ``instrument.trace``
(the window skips this process's first step, and each traced step ends on
its loss, so the trace holds its device work, under the program spans of
``instrument.SPANS``); ``debug_nans`` turns on
``instrument.enable_nan_checks`` for ``fit`` and ``test``.
"""

from __future__ import annotations

import dataclasses
import signal
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from cinemri_tpu_torch import resolve_device
from cinemri_tpu_torch.instrument import enable_nan_checks, trace
from cinemri_tpu_torch.models.init import lecun_normal_init, torch_style_init
from cinemri_tpu_torch.ops.cplx import Complex
from cinemri_tpu_torch.parallel import distributed as D
from cinemri_tpu_torch.parallel.mesh import mesh_lead, shard_batch
from cinemri_tpu_torch.train.checkpoint import CheckpointManager
from cinemri_tpu_torch.train.device_cache import DeviceSampleCache, to_device
from cinemri_tpu_torch.train.logging import TrainLogger
from cinemri_tpu_torch.train.metrics_agg import MetricsAggregator
from cinemri_tpu_torch.train.step import create_train_state, make_eval_step, make_train_step

__all__ = ["TrainerConfig", "Trainer"]

_PLACED = ("masked_kspace", "mask", "target", "sens_maps", "sample_weight")


@dataclasses.dataclass
class TrainerConfig:
    """Defaults follow the reference train scripts (SURVEY Appendix B) and
    the JAX package's ``TrainerConfig``."""

    epochs: int = 150
    lr: float = 1e-4
    lr_step_size: int = 140
    lr_gamma: float = 0.01
    weight_decay: float = 0.0
    # 0 = the reference recipe (no clipping); opt-in guard against the rare
    # gradient spikes the clip-free recipe admits (BASELINE.md round 5)
    clip_grad_norm: float = 0.0
    seed: int = 42
    ckpt_dir: Optional[Path] = None
    log_dir: Optional[Path] = None
    save_path: Optional[Path] = None  # SSIMs.csv
    compute_train_metrics: bool = True
    num_log_images: int = 1
    max_checkpoints: int = 3
    debug_nans: bool = False  # raise at the first non-finite module output or gradient
    checkpoint_on_preemption: bool = True  # SIGTERM -> save before exiting
    # init_state redraws the model's convs from a generator seeded with
    # ``seed``: the reference's torch reset_parameters statistics, or with
    # False flax's lecun_normal (the JAX package's init without torch_init)
    torch_init: bool = True
    # short hash of the model-defining config (cli.common.config_fingerprint),
    # stored in every checkpoint and checked on restore
    config_fingerprint: str = ""
    # per-step TensorBoard cadence for training_loss/grad_norm; 0 = only the
    # per-epoch aggregate (with compute_train_metrics off, the loss syncs
    # then wait for the end of the epoch)
    log_every_steps: int = 1
    # trace this many training steps (instrument.trace) into profile_dir,
    # starting at this process's second step; fold the trace with
    # instrument.opstats. 0 = off. The reference has no profiler
    profile_steps: int = 0
    profile_dir: Optional[Path] = None  # default: log_dir/"profile"
    # device-resident per-sample constants (train/device_cache.py): a step
    # sends its mask instead of the masked k-space; one cache for the train
    # loader and one for the evaluation loaders, each with this budget, so
    # an evaluation pass never evicts a train sample
    device_data_cache: bool = True
    device_data_cache_gb: float = 4.0


class Trainer:
    """Fits, evaluates and checkpoints ``model`` on ``device`` (CUDA by
    default; raises without a CUDA device, pass ``device="cpu"`` for the
    CPU). With a ``mesh``, one process of a parallel run, on
    ``cuda:LOCAL_RANK`` by default; ``reduce_fn`` then sums host scalars
    over the ``data`` group (``parallel.make_process_sum(mesh)``). A model
    on a mesh with ``plane`` or ``coil`` dims names them (``plane_axis``,
    ``coil_axis``)."""

    def __init__(
        self,
        model,
        config: TrainerConfig,
        train_loader=None,
        val_loader=None,
        test_loader=None,
        mesh=None,
        reduce_fn: Callable[[float], float] = lambda x: x,
        device=None,
    ):
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else D.local_device(device)
        self.model = model.to(self.device)
        self.cfg = config
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.test_loader = test_loader
        self.reduce_fn = reduce_fn
        self.logger = TrainLogger(config.log_dir, enabled=config.log_dir is not None)
        self.ckpt = (
            CheckpointManager(config.ckpt_dir, config.max_checkpoints, "val_loss")
            if config.ckpt_dir is not None
            else None
        )
        self._train_step = make_train_step(mesh=mesh)
        self._eval_step = make_eval_step(mesh)
        self._lead = mesh_lead(mesh)  # writes its data group's SSIMs.csv rows
        self.state = None
        self.rng: Optional[torch.Generator] = None
        self.history: List[Dict[str, float]] = []
        self._caches: Optional[Dict[str, DeviceSampleCache]] = None
        if config.device_data_cache and mesh is None:
            budget = int(config.device_data_cache_gb * (1 << 30))
            self._caches = {split: DeviceSampleCache(self.device, budget)
                            for split in ("train", "eval")}
        self._dataset_paths: Dict[int, Dict[str, Path]] = {}
        self._resume_position = (0, None)  # (steps into the epoch, partial metrics)
        self._preempted = False
        self.h2d_bytes = 0  # host -> device bytes of batch placement, cache misses included

    # ---------------------------------------------------------- device data

    def _put(self, value):
        placed, nbytes = to_device(value, self.device)
        self.h2d_bytes += nbytes
        return placed

    def _place_batch(self, batch, loader, cache: Optional[DeviceSampleCache] = None) -> Dict:
        """The step's tensors of one host batch on the device.

        With a ``cache``, when the loader's transform declares
        ``kspace_is_raw_times_mask`` (``data/transforms.py``) and its dataset
        can give the decoded volume (``_load_decoded``), raw k-space and
        target go to the device once per sample for the whole run and the
        masked k-space is rebuilt there from this step's mask,
        ``k * mask + 0.0`` (mask 0/1: the host transform's values). Maps go
        into the cache only when the transform declares them stable
        (``sens_maps_are_stable``), else with every step. Anything else
        sends the whole batch. Mesh runs place this rank's rows through
        :func:`~cinemri_tpu_torch.parallel.shard_batch`, without the cache,
        as the JAX package does.
        """
        if self.mesh is not None:
            placed = shard_batch(batch, self.mesh, device=self.device)
            self.h2d_bytes += sum(t.nbytes for v in placed.values()
                                  for t in ((v.re, v.im) if isinstance(v, Complex) else (v,)))
            return placed
        ds = getattr(loader, "dataset", None)
        tf = getattr(ds, "transform", None)
        if (
            cache is None
            or not hasattr(ds, "_load_decoded")
            or "masked_kspace" not in batch
            or not getattr(tf, "kspace_is_raw_times_mask", False)
        ):
            return {k: self._put(batch[k]) for k in _PLACED if k in batch}

        paths = self._dataset_paths.get(id(ds))
        if paths is None:
            paths = {ex.fname.name: ex.fname for ex in ds.examples}
            self._dataset_paths[id(ds)] = paths
        maps_cached = "sens_maps" in batch and bool(getattr(tf, "sens_maps_are_stable", False))
        sent = cache.bytes_sent
        entries = [
            cache.get(
                (id(ds), fname, int(batch["slice_num"][i])),
                lambda i=i, fname=fname: {
                    "kspace": ds._load_decoded(paths[fname])["kspace"],
                    "target": batch["target"][i],
                    "sens_maps": batch["sens_maps"][i] if maps_cached else None,
                },
            )
            for i, fname in enumerate(batch["fname"])
        ]
        self.h2d_bytes += cache.bytes_sent - sent
        mask = self._put(batch["mask"])  # the step's only put: a few KB
        out = {
            "masked_kspace": Complex(
                torch.stack([e["kspace"].re for e in entries]) * mask + 0.0,
                torch.stack([e["kspace"].im for e in entries]) * mask + 0.0,
            ),
            "mask": mask,
            "target": torch.stack([e["target"] for e in entries]),
        }
        if "sens_maps" in batch:
            out["sens_maps"] = (
                Complex(torch.stack([e["sens_maps"].re for e in entries]),
                        torch.stack([e["sens_maps"].im for e in entries]))
                if maps_cached else self._put(batch["sens_maps"])
            )
        if "sample_weight" in batch:
            out["sample_weight"] = self._put(batch["sample_weight"])
        return out

    # ------------------------------------------------------------------ setup

    def init_state(self):
        """Draw the initial weights from a generator seeded with
        ``cfg.seed`` (torch-style, or lecun_normal without ``torch_init``)
        and build the optimizer; the generator is kept (and checkpointed)
        as the trainer's randomness. On a mesh every rank draws the same
        weights from the same generator, and rank 0's are broadcast once
        as a guard."""
        steps_per_epoch = 1
        if self.train_loader is not None:
            steps_per_epoch = (self.train_loader.steps_per_epoch() if self.mesh is None
                               else self._agreed_steps(0))
        self.rng = torch.Generator().manual_seed(self.cfg.seed)
        (torch_style_init if self.cfg.torch_init else lecun_normal_init)(self.model, self.rng)
        self.state = create_train_state(
            self.model,
            device=self.device,
            lr=self.cfg.lr,
            lr_step_size=self.cfg.lr_step_size,
            lr_gamma=self.cfg.lr_gamma,
            weight_decay=self.cfg.weight_decay,
            steps_per_epoch=steps_per_epoch,
            clip_grad_norm=self.cfg.clip_grad_norm,
        )
        self._sync_weights()
        return self.state

    def _agreed_steps(self, epoch: int) -> int:
        """The train steps every rank takes in ``epoch``: the most any
        rank's shard holds (``Loader.steps_per_epoch(epoch)``). Shards have
        one length, but each is bucketed by shape into batches, so with
        mixed shapes and a batch above 1 their batch counts can differ."""
        return max(D.all_gather_object(self.train_loader.steps_per_epoch(epoch)))

    def _train_batches(self, epoch: int, steps: Optional[int]):
        """The train loader's batches of ``epoch``, then, up to ``steps``
        (on a mesh), copies of the last with ``sample_weight`` 0: a rank
        whose shard holds fewer batches takes steps that add nothing to the
        loss or the gradient, so every rank makes the same all-reduces."""
        n, last = 0, None
        for last in self.train_loader.epoch(epoch):
            n += 1
            yield last
        if steps is not None and n < steps:
            if last is None:
                raise ValueError(f"epoch {epoch}: this rank's shard holds no batch; the others "
                                 f"hold up to {steps}")
            pad = dict(last, sample_weight=np.zeros(len(last["fname"]), np.float32))
            for _ in range(n, steps):
                yield pad

    def _sync_weights(self):
        if self.mesh is not None:
            D.broadcast_tensors(list(self.state.model.parameters()))

    def _fingerprint(self) -> str:
        return self.cfg.config_fingerprint.ljust(8, "0")[:8]

    def _ckpt_tree(self, epoch: int, epoch_step: int = 0, partial: Optional[Dict] = None):
        """Full resume tree: weights, Adam with its LambdaLR schedule, the
        step count, the last finished epoch, how many steps of the next one
        are in (a preemption save; 0 otherwise) with their train metrics,
        the trainer's generator and the model-config fingerprint. Masks are
        reseeded per epoch by the Loader, so a restored run is bit-continuous."""
        opt = self.state.optimizer
        return {
            "model": self.state.model.state_dict(),
            "optimizer": opt.adam.state_dict(),
            "scheduler": opt.scheduler.state_dict(),
            "step": int(self.state.step),
            "epoch": int(epoch),
            "epoch_step": int(epoch_step),
            "train_partial": partial,
            "rng": self.rng.get_state(),
            "fingerprint": self._fingerprint(),
        }

    def _check_fingerprint(self, restored):
        saved = restored.get("fingerprint", "")
        want = self._fingerprint()
        if saved and self.cfg.config_fingerprint and saved != want:
            raise ValueError(
                f"checkpoint in {self.ckpt.directory} was saved with model "
                f"config fingerprint {saved!r} but this run is {want!r} — "
                "the parameter trees differ; point --path_config at the "
                "matching run or delete the stale checkpoint dir"
            )

    def restore_latest(self) -> int:
        """Restore the newest checkpoint; returns the next epoch index."""
        if self.state is None:
            self.init_state()
        # to the CPU first: load_state_dict copies into the parameters and
        # moves Adam's moments to them, and its step counts stay host scalars
        restored = self.ckpt.restore(map_location="cpu")
        self._check_fingerprint(restored)
        opt = self.state.optimizer
        self.state.model.load_state_dict(restored["model"])
        opt.adam.load_state_dict(restored["optimizer"])
        opt.scheduler.load_state_dict(restored["scheduler"])
        self.state.step = int(restored["step"])
        self.rng.set_state(restored["rng"])
        partial = restored.get("train_partial")
        if isinstance(partial, list):  # one per rank, saved by a data-parallel run
            rank, world = D.process_info()
            if len(partial) != world:
                raise ValueError(f"checkpoint in {self.ckpt.directory} was saved mid-epoch by "
                                 f"{len(partial)} processes; this run has {world}")
            partial = partial[rank]
        self._resume_position = (int(restored.get("epoch_step", 0)), partial)
        self._sync_weights()
        return int(restored["epoch"]) + 1

    def restore_best(self):
        """Load the best checkpoint's weights (the optimizer stays)."""
        if self.state is None:
            self.init_state()
        restored = self.ckpt.restore(step=self.ckpt.best_step, map_location="cpu")
        self._check_fingerprint(restored)
        self.state.model.load_state_dict(restored["model"])
        self._sync_weights()
        return self.state

    # ------------------------------------------------------------------ loops

    def _fetch(self, *parts: torch.Tensor) -> Callable:
        """Start copying ``parts`` to the host; returns the wait for their
        host copies. On the card the copy is queued behind the step and
        waited on by an event, so the next step can be dispatched first."""
        if self.device.type != "cuda":
            return lambda: parts
        host = [torch.empty(p.shape, dtype=p.dtype, pin_memory=True) for p in parts]
        for h, p in zip(host, parts):
            h.copy_(p, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

        def wait():
            done.synchronize()
            return host

        return wait

    def _run_eval(self, loader, epoch: int, split: str, ssim_csv=None) -> Optional[Dict]:
        """The split's metrics, or None when a SIGTERM inside ``fit`` cut
        the pass short (the caller saves and exits). On a mesh the ranks'
        shards may hold different batch counts, so the pass runs to its end
        on every rank and the ranks agree on a SIGTERM once, after it."""
        agg = MetricsAggregator(self.reduce_fn, ssim_csv_path=ssim_csv if self._lead else None)
        cache = self._caches["eval"] if self._caches else None
        step = int(self.state.step)
        logged = 0

        def consume(batch, fetched):
            nonlocal logged
            loss, out, tgt = fetched()
            out, tgt = out.numpy(), tgt.numpy()
            agg.update_batch(batch, out, tgt, loss=float(loss))
            if logged < self.cfg.num_log_images:
                self.logger.cine_video(f"{split}_images_idx_{logged}", tgt[0], out[0], step)
                logged += 1

        # one-step pipeline: batch i+1 is dispatched before batch i's
        # outputs are waited for, so the device runs it while the host
        # computes batch i's metrics
        prev = None
        for batch in loader.epoch(epoch):
            if self._preempted and self.mesh is None:
                return None
            aux = self._eval_step(self.state, self._place_batch(batch, loader, cache))
            fetched = self._fetch(aux["loss"], aux["output"], aux["target"])
            if prev is not None:
                consume(*prev)
            prev = (batch, fetched)
        if prev is not None:
            consume(*prev)
        if self.mesh is not None and self._agreed_stop():
            return None
        metrics = agg.compute()
        self.logger.scalars(
            {f"{split}_metrics/{k}": v for k, v in metrics.items() if k != "loss"}, step
        )
        if "loss" in metrics:
            self.logger.scalars({f"{split}_loss": metrics["loss"]}, step)
        return metrics

    def _on_sigterm(self, signum, frame):
        # only a flag: the loop saves at its next step boundary, never in
        # the middle of an optimizer update
        self._preempted = True

    def _agreed_stop(self) -> bool:
        """Whether any rank has taken a SIGTERM: one scalar all-reduce over
        every rank on a mesh, the local flag otherwise."""
        if self.mesh is None:
            return self._preempted
        flag = torch.full((1,), float(self._preempted), device=self.device)
        return bool(D.all_reduce_sum(flag, "scalar").item() > 0)

    def _stop_before_step(self, stops: List[Callable]) -> bool:
        """Whether to save and exit before the next step: the local flag, or
        on a mesh the flag the ranks agreed on two steps back. ``stops``
        holds the waits for the steps' flags (:meth:`_fetch`); reading one
        a step late keeps the last step queued on the device while the host
        waits, and every rank reads the same flag at the same step."""
        if self.mesh is None:
            return self._preempted
        return len(stops) > 1 and bool(stops.pop(0)()[0])

    def _preempt(self, epoch: int, steps_done: int, agg: MetricsAggregator, pending: List):
        """Save under the interrupted epoch's id with the previous epoch
        recorded and the steps already taken in this one, then exit with
        143 (128 + SIGTERM). ``fit(resume=True)`` skips those steps'
        batches, so it continues exactly where this run stopped; the
        epoch's completion save later overwrites this checkpoint. On a mesh
        the checkpoint holds every rank's partial metrics, and rank 0
        writes it."""
        self._flush(pending, agg)
        partial = agg.state_dict()
        if self.mesh is not None:
            partial = D.all_gather_object(partial)
        self.ckpt.save(epoch, self._ckpt_tree(epoch - 1, steps_done, partial))
        raise SystemExit(143)

    @staticmethod
    def _flush(pending: List, agg: MetricsAggregator):
        """Record deferred loss scalars with one device-to-host copy."""
        if pending:
            values = torch.stack([loss for loss, _ in pending]).tolist()
            for v, (_, n) in zip(values, pending):
                agg.add_loss(v, n)
            pending.clear()

    def fit(self, resume: bool = False) -> List[Dict[str, float]]:
        assert self.train_loader is not None, "fit() needs a train loader"
        start_epoch = 0
        skip, partial = 0, None
        if resume and self.ckpt is not None and self.ckpt.latest_step is not None:
            start_epoch = self.restore_latest()
            skip, partial = self._resume_position
        elif self.state is None:
            self.init_state()

        # preemption safety (SURVEY §5: the reference has no failure
        # handling): SIGTERM saves the current state before exiting
        prev_handler = None
        self._preempted = False
        if (self.cfg.checkpoint_on_preemption and self.ckpt is not None
                and threading.current_thread() is threading.main_thread()):
            prev_handler = signal.signal(signal.SIGTERM, self._on_sigterm)

        cache = self._caches["train"] if self._caches else None
        # max-throughput mode (no per-step logging, no train metrics): loss
        # scalars stay on the device, one copy at the end of the epoch
        defer_loss = not self.cfg.compute_train_metrics and not self.cfg.log_every_steps
        pending: List = []
        # the profiler window skips this process's first step (it builds the
        # kernels and the caches, even on resume)
        prof, prof_left, steps_here = None, max(0, self.cfg.profile_steps), 0
        nan_checks = enable_nan_checks(True) if self.cfg.debug_nans else None
        t0 = time.perf_counter()
        try:
            for epoch in range(start_epoch, self.cfg.epochs):
                agg = MetricsAggregator(self.reduce_fn)
                if partial is not None:
                    agg.load_state_dict(partial)
                done, stops = 0, []
                steps = None if self.mesh is None else self._agreed_steps(epoch)
                for batch in self._train_batches(epoch, steps):
                    if done < skip:  # taken before a preemption
                        done += 1
                        continue
                    if self._stop_before_step(stops):
                        self._preempt(epoch, done, agg, pending)
                    if prof_left and prof is None and steps_here >= 1:
                        prof = trace(self.cfg.profile_dir
                                     or Path(self.cfg.log_dir or ".") / "profile")
                        prof.__enter__()
                    arrays = self._place_batch(batch, self.train_loader, cache)
                    if self.mesh is None:
                        self.state, aux = self._train_step(self.state, arrays)
                    else:
                        self.state, aux = self._train_step(self.state, arrays,
                                                           stop=self._preempted)
                        stops.append(self._fetch(aux["stop"]))
                    done += 1
                    steps_here += 1
                    if prof is not None:
                        float(aux["loss"])  # the step's device work ends inside the window
                        prof_left -= 1
                        if not prof_left:
                            prof.__exit__(None, None, None)
                            prof = None
                    n_real = (int(np.sum(batch["sample_weight"] > 0))
                              if "sample_weight" in batch else len(batch["fname"]))
                    if not n_real:  # a zero-weight step of a short shard
                        continue
                    if defer_loss:
                        pending.append((aux["loss"], n_real))
                        continue
                    loss = float(aux["loss"])
                    step = int(self.state.step)
                    if (self.logger.enabled and self.cfg.log_every_steps
                            and step % self.cfg.log_every_steps == 0):
                        self.logger.scalars(
                            {"training_loss_step": loss, "grad_norm": float(aux["grad_norm"])}, step
                        )
                    if self.cfg.compute_train_metrics:
                        agg.update_batch(batch, aux["output"].cpu().numpy(),
                                         aux["target"].cpu().numpy(), loss=loss)
                    else:
                        agg.add_loss(loss, n_real)
                skip, partial = 0, None
                self._flush(pending, agg)
                epoch_metrics = (
                    agg.compute() if self.cfg.compute_train_metrics else {"loss": agg.loss_value()}
                )
                record = {f"train_{k}": v for k, v in epoch_metrics.items()}
                step = int(self.state.step)
                self.logger.scalars({"training_loss": epoch_metrics.get("loss", 0.0)}, step)
                self.logger.scalars(
                    {f"train_metrics/{k}": v for k, v in epoch_metrics.items() if k != "loss"}, step
                )
                if self.val_loader is not None:
                    val = self._run_eval(self.val_loader, epoch, "val")
                    if val is not None:
                        record.update({f"val_{k}": v for k, v in val.items()})
                        self.logger.scalars({"validation_loss": val.get("loss", 0.0)}, step)
                # a SIGTERM during the epoch's last step or its validation:
                # every step is recorded, so a resume re-runs the validation
                if self._agreed_stop():
                    self._preempt(epoch, done, agg, pending)
                record["epoch"] = epoch
                self.history.append(record)
                if self.ckpt is not None:
                    self.ckpt.save(
                        epoch,
                        self._ckpt_tree(epoch),
                        metrics={"val_loss": record.get("val_loss", record.get("train_loss", 0.0))},
                    )
        finally:
            # a partial window (an error, a preemption) still writes its trace
            if prof is not None:
                prof.__exit__(None, None, None)
            if nan_checks is not None:
                enable_nan_checks(nan_checks)
            self._preempted = False
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
        self.train_time_hours = (time.perf_counter() - t0) / 3600.0
        return self.history

    def test(self, epoch: int = 0) -> Dict[str, float]:
        assert self.test_loader is not None, "test() needs a test loader"
        csv = Path(self.cfg.save_path) / "SSIMs.csv" if self.cfg.save_path is not None else None
        nan_checks = enable_nan_checks(True) if self.cfg.debug_nans else None
        try:
            return self._run_eval(self.test_loader, epoch, "test", ssim_csv=csv)
        finally:
            if nan_checks is not None:
                enable_nan_checks(nan_checks)
