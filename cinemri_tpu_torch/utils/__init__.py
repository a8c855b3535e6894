"""Shared utilities: the path config and the compile cache
(``utils/compile_cache.py``, the build directory of the port's libraries)."""

from cinemri_tpu_torch.utils.compile_cache import enable_compile_cache, host_fingerprint
from cinemri_tpu_torch.utils.paths import DEFAULT_CONFIG, fetch_dir

__all__ = ["fetch_dir", "DEFAULT_CONFIG", "enable_compile_cache", "host_fingerprint"]
