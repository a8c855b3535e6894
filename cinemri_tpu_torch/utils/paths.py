"""Path configuration (reference fetch_dir, mri_data.py:38-77).

A copy of ``cinemri_tpu/utils/paths.py``, with ``yaml`` imported inside
:func:`fetch_dir`. Reads ``data_path`` / ``log_path`` / ``save_path`` from a
``dirs_path.yaml``; writes a template and warns when the file is missing.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Union
from warnings import warn

__all__ = ["fetch_dir", "DEFAULT_CONFIG"]

DEFAULT_CONFIG = {
    "data_path": "/path/to/data",
    "log_path": "logs",
    "save_path": "results",
}


def fetch_dir(
    key: str, data_config_file: Union[str, Path, os.PathLike] = "dirs_path.yaml"
) -> Path:
    import yaml

    data_config_file = Path(data_config_file)
    if not data_config_file.is_file():
        with open(data_config_file, "w") as f:
            yaml.dump(DEFAULT_CONFIG, f)
        warn(
            f"Path config at {data_config_file.resolve()} does not exist. "
            "A template has been created for you. "
            "Please enter the directory paths for your system to have defaults."
        )
        return Path(DEFAULT_CONFIG[key])
    with open(data_config_file, "r") as f:
        return Path(yaml.safe_load(f)[key])
