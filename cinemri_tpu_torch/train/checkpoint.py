"""Checkpointing: save / best-tracking / resume with ``torch.save``.

Counterpart of ``cinemri_tpu/train/checkpoint.py`` (orbax there). Parity
target: the reference's Lightning ModelCheckpoint monitoring
``validation_loss`` (min) plus latest-checkpoint resume
(train_test_varnet.py:271-283,59-67). One file per step, ``<step>.pt`` in
the checkpoint directory, written under a temporary name and moved into
place with ``os.replace``: a save is atomic, and a crash mid-save leaves the
previous checkpoints as they were.

Retention keeps **both** the ``max_to_keep`` best-by-monitor checkpoints
*and* the most recent one, plus every step saved without metrics (an
explicit final save). Best-step tracking persists to ``best_steps.json``
in the checkpoint directory so it survives process restarts.

Saves are synchronous: :meth:`CheckpointManager.save` returns once the file
is in place, so :meth:`CheckpointManager.wait` returns at once (the JAX
package's orbax saves are asynchronous; its callers wait).

In a data-parallel run every process calls :meth:`~CheckpointManager.save`
with the same tree (the weights are replicated); rank 0 alone writes the
file and ``best_steps.json`` and prunes, then every rank waits at a barrier,
so a restore on any rank finds the file. The directory must be one that
every process sees.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from cinemri_tpu_torch.parallel.distributed import barrier, process_info

__all__ = ["CheckpointManager"]


class CheckpointManager:
    """Per-step ``torch.save`` files with best+latest retention."""

    def __init__(self, directory: Path, max_to_keep: int = 3, monitor: str = "val_loss"):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.max_to_keep = max_to_keep
        self._metrics_file = self.directory / "best_steps.json"
        self._metrics: Dict[int, float] = {}
        if self._metrics_file.exists():
            self._metrics = {
                int(k): float(v)
                for k, v in json.loads(self._metrics_file.read_text()).items()
            }

    def path(self, step: int) -> Path:
        return self.directory / f"{int(step)}.pt"

    def all_steps(self) -> List[int]:
        return sorted(int(p.stem) for p in self.directory.glob("*.pt") if p.stem.isdigit())

    def _retained(self) -> set:
        """Steps to keep: the max_to_keep best by monitor value + the latest
        + every step saved without metrics."""
        steps = self.all_steps()
        if not steps:
            return set()
        by_metric = sorted(
            (s for s in steps if s in self._metrics), key=lambda s: self._metrics[s]
        )
        keep = set(by_metric[: self.max_to_keep])
        keep.add(max(steps))
        keep.update(s for s in steps if s not in self._metrics)
        return keep

    def _write_metrics(self):
        tmp = self._metrics_file.with_name(self._metrics_file.name + ".tmp")
        tmp.write_text(json.dumps({str(k): v for k, v in self._metrics.items()}))
        os.replace(tmp, self._metrics_file)

    def save(self, step: int, tree: Dict[str, Any], metrics: Optional[Dict] = None):
        """Write ``tree`` as step ``step``, replacing a checkpoint already
        saved at that step (e.g. re-running an epoch after a preemption
        save), then apply the retention. Only rank 0 writes; every rank
        keeps the same best-step record and waits until the file is in
        place."""
        step = int(step)
        if process_info()[0] == 0:
            self._write(step, tree, metrics)
        else:
            self._metrics.pop(step, None)
            if metrics and self.monitor in metrics:
                self._metrics[step] = float(metrics[self.monitor])
        barrier()

    def _write(self, step: int, tree: Dict[str, Any], metrics: Optional[Dict]):
        if self._metrics.pop(step, None) is not None:
            self._write_metrics()
        tmp = self.directory / f".{step}.pt.tmp"
        torch.save(tree, tmp)
        os.replace(tmp, self.path(step))
        if metrics and self.monitor in metrics:
            self._metrics[step] = float(metrics[self.monitor])
            self._write_metrics()
        keep = self._retained()
        for s in self.all_steps():
            if s not in keep:
                self.path(s).unlink()

    def wait(self):
        """Saves are synchronous; nothing is in flight."""

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @property
    def best_step(self) -> Optional[int]:
        """Best retained step by monitor value (min), else the latest."""
        candidates = [s for s in self.all_steps() if s in self._metrics]
        if not candidates:
            return self.latest_step
        return min(candidates, key=lambda s: self._metrics[s])

    def restore(self, step: Optional[int] = None, map_location=None) -> Dict[str, Any]:
        """Load ``step`` (default: the latest); tensors go to ``map_location``."""
        step = self.latest_step if step is None else step
        if step is None or not self.path(step).exists():
            raise FileNotFoundError(f"No checkpoint available in {self.directory}")
        return torch.load(self.path(step), map_location=map_location, weights_only=True)
