"""Per-volume metric aggregation (host-side, numpy).

A copy of ``cinemri_tpu/train/metrics_agg.py``, with one change for
data-parallel runs: :meth:`MetricsAggregator.compute` makes the same
``reduce_fn`` calls in the same order on every process (whether the loss
is reported is itself reduced first, since a process whose shard held no
batch has no losses), and :meth:`~MetricsAggregator.loss_value` reduces its
sums too, so every process reports the global value.

Parity target: reference MriModule's step_end / epoch_end machinery
(reconstruction/pl_modules/mri_module.py:65-493):

  * per (fname, slice): MSE, target-norm MSE, frame-averaged SSIM with the
    volume max as data range;
  * per volume: NMSE = mean(MSE)/mean(‖target‖²), PSNR = 20·log10(max) −
    10·log10(mean MSE), SSIM = mean over slices;
  * epoch value = (Σ over volumes) / (#volumes), where both numerator and
    denominator are all-reduced across workers (the reference's
    ``DistributedMetricSum`` with ``dist_reduce_fx='sum'``,
    mri_module.py:22-32) — here an injectable ``reduce_fn`` summing scalars
    across processes (identity on a single host).

Duplicate (fname, slice) entries overwrite, matching the reference's dict
updates (mri_module.py:160-170).
"""

from __future__ import annotations

import csv
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from cinemri_tpu_torch.ops import metrics as M

__all__ = ["MetricsAggregator"]


def _identity_reduce(x: float) -> float:
    return x


class MetricsAggregator:
    """Collects per-slice stats and computes the epoch-level metrics."""

    def __init__(
        self,
        reduce_fn: Callable[[float], float] = _identity_reduce,
        ssim_csv_path: Optional[Path] = None,
    ):
        self.reduce_fn = reduce_fn
        self.ssim_csv_path = Path(ssim_csv_path) if ssim_csv_path else None
        self.reset()

    def reset(self):
        self.mse_vals: Dict[str, Dict[int, float]] = defaultdict(dict)
        self.target_norms: Dict[str, Dict[int, float]] = defaultdict(dict)
        self.ssim_vals: Dict[str, Dict[int, float]] = defaultdict(dict)
        self.max_vals: Dict[str, float] = {}
        self.losses = []  # (batch-mean loss, real-sample count) pairs

    _STATE = ("mse_vals", "target_norms", "ssim_vals", "max_vals", "losses")

    def state_dict(self) -> Dict:
        """What has been collected, as plain dicts and lists (a preemption
        checkpoint carries it, so a resumed epoch reports what an
        uninterrupted one would)."""
        return {k: (dict(v) if isinstance(v, dict) else list(v))
                for k, v in ((k, getattr(self, k)) for k in self._STATE)}

    def load_state_dict(self, state: Dict):
        self.reset()
        for k in self._STATE[:3]:
            for fname, per_slice in state[k].items():
                getattr(self, k)[fname].update(per_slice)
        self.max_vals.update(state["max_vals"])
        self.losses = [tuple(x) for x in state["losses"]]

    def add_loss(self, loss: float, n_samples: int = 1):
        """Record one step's batch-mean loss, weighted by its real (non-
        padding) sample count, so the epoch loss is a per-sample average
        even with mixed batch sizes (the reference always runs b=1 where
        batch mean == sample mean, mri_module.py:211-213)."""
        self.losses.append((float(loss), int(n_samples)))

    def loss_value(self) -> float:
        """The sample-weighted mean loss over every process's steps."""
        r = self.reduce_fn
        num = r(float(sum(l * n for l, n in self.losses)))
        den = max(r(float(sum(n for _, n in self.losses))), 1.0)
        return float(num / den)

    def update(self, fname: str, slice_num: int, output, target, max_value, loss=None):
        """Record one sample (output/target: (t, h, w) numpy)."""
        output = np.asarray(output, np.float32)
        target = np.asarray(target, np.float32)
        self.mse_vals[fname][slice_num] = M.mse(target, output)
        self.target_norms[fname][slice_num] = M.mse(target, np.zeros_like(target))
        ssim = M.ssim(target, output, maxval=float(max_value))
        self.ssim_vals[fname][slice_num] = ssim
        self.max_vals[fname] = float(max_value)
        if loss is not None:
            self.add_loss(loss, 1)
        if self.ssim_csv_path is not None:
            # per-image SSIM artifact (mri_module.py:408-413)
            self.ssim_csv_path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.ssim_csv_path, "a", newline="") as f:
                csv.writer(f).writerow([ssim])

    def update_batch(self, batch, outputs, targets, loss=None):
        """Record every real sample of a batched step result (padding
        entries — ``sample_weight`` 0 — are skipped so they neither
        duplicate SSIMs.csv rows nor re-enter the per-volume dicts)."""
        fnames = batch["fname"]
        slices = batch["slice_num"]
        maxvals = batch["max_value"]
        weights = batch.get("sample_weight")
        n_real = 0
        for i, fname in enumerate(fnames):
            if weights is not None and float(weights[i]) == 0.0:
                continue
            n_real += 1
            self.update(
                fname,
                int(slices[i]),
                outputs[i],
                targets[i],
                float(maxvals[i]),
            )
        if loss is not None:
            # the step's batch-mean loss, weighted by its real sample count
            # so variable batch sizes average per-sample (ADVICE r2)
            self.add_loss(loss, max(n_real, 1))

    def compute(self) -> Dict[str, float]:
        """Epoch metrics (mri_module.py:180-213 aggregation recipe)."""
        assert (
            self.mse_vals.keys()
            == self.target_norms.keys()
            == self.ssim_vals.keys()
            == self.max_vals.keys()
        )
        nmse = ssim = psnr = 0.0
        local_examples = 0
        for fname in self.mse_vals:
            local_examples += 1
            mse_val = float(np.mean(list(self.mse_vals[fname].values())))
            target_norm = float(np.mean(list(self.target_norms[fname].values())))
            nmse += mse_val / target_norm
            # exact reconstructions (mse 0) legitimately give inf PSNR —
            # matches the reference's skimage psnr; suppress only the warning
            with np.errstate(divide="ignore"):
                psnr += 20 * np.log10(self.max_vals[fname]) - 10 * np.log10(
                    mse_val
                )
            ssim += float(np.mean(list(self.ssim_vals[fname].values())))

        r = self.reduce_fn
        tot_examples = max(r(float(local_examples)), 1.0)
        out = {
            "nmse": r(nmse) / tot_examples,
            "ssim": r(ssim) / tot_examples,
            "psnr": r(psnr) / tot_examples,
        }
        if r(float(len(self.losses))) > 0:  # the same branch on every process
            num = float(sum(l * n for l, n in self.losses))
            den = max(r(float(sum(n for _, n in self.losses))), 1.0)
            out["loss"] = r(num) / den
        return out
