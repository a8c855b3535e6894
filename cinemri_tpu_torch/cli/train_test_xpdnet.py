"""XPDNet train/test entry point (reference traintest_scripts/xpdnet/train_test_xpdnet.py).

    python -m cinemri_tpu_torch.cli.train_test_xpdnet --mode train --device cpu ...
"""

from cinemri_tpu_torch.cli.common import train_test_main


def run_main(argv=None):
    return train_test_main("xpdnet", argv)


if __name__ == "__main__":
    run_main()
