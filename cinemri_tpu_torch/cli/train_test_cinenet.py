"""CineNet train/test entry point (reference traintest_scripts/cinenet/train_test_cinenet.py).

    python -m cinemri_tpu_torch.cli.train_test_cinenet --mode train --device cpu ...
"""

from cinemri_tpu_torch.cli.common import train_test_main


def run_main(argv=None):
    return train_test_main("cinenet", argv)


if __name__ == "__main__":
    run_main()
