"""Training (counterpart of ``cinemri_tpu/train``): the optimizer and the
single-device train and eval steps. The loop, checkpoints, metrics and
loaders come with ROADMAP Queue 1, item 9."""

from cinemri_tpu_torch.train.optim import Optimizer, make_optimizer, step_decay_schedule
from cinemri_tpu_torch.train.step import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "make_optimizer",
    "step_decay_schedule",
    "Optimizer",
    "TrainState",
    "create_train_state",
    "make_train_step",
    "make_eval_step",
]
