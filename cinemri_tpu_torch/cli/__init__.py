"""CLI entry points (counterpart of ``cinemri_tpu/cli``; reference layer L4,
traintest_scripts/): ``train_test_varnet``, ``train_test_cinenet``,
``train_test_xpdnet``, ``inference`` and ``visualize``."""

from cinemri_tpu_torch.cli.common import build_parser, train_test_main
from cinemri_tpu_torch.cli.inference import InferenceRunner, zero_filled_recon

__all__ = ["build_parser", "train_test_main", "InferenceRunner", "zero_filled_recon"]
