"""Training (counterpart of ``cinemri_tpu/train``): the optimizer, the
train step (single-device or data-parallel) and eval step, the metrics aggregator, checkpoints,
the logger, the loader and the Trainer, with the JAX package's export list
(plus ``Optimizer``)."""

from cinemri_tpu_torch.train.optim import Optimizer, make_optimizer, step_decay_schedule
from cinemri_tpu_torch.train.step import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from cinemri_tpu_torch.train.metrics_agg import MetricsAggregator
from cinemri_tpu_torch.train.checkpoint import CheckpointManager
from cinemri_tpu_torch.train.logging import TrainLogger
from cinemri_tpu_torch.train.loader import Loader, collate
from cinemri_tpu_torch.train.loop import Trainer, TrainerConfig

__all__ = [
    "make_optimizer",
    "step_decay_schedule",
    "Optimizer",
    "TrainState",
    "create_train_state",
    "make_train_step",
    "make_eval_step",
    "MetricsAggregator",
    "CheckpointManager",
    "TrainLogger",
    "Loader",
    "collate",
    "Trainer",
    "TrainerConfig",
]
