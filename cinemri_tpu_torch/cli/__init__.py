"""CLI entry points (counterpart of ``cinemri_tpu/cli``; reference layer L4,
traintest_scripts/). The VarNet family only until ROADMAP Queue 1, items 10
and 11."""

from cinemri_tpu_torch.cli.common import build_parser, train_test_main
from cinemri_tpu_torch.cli.inference import InferenceRunner, zero_filled_recon

__all__ = ["build_parser", "train_test_main", "InferenceRunner", "zero_filled_recon"]
