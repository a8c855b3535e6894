"""Shared utilities: the path config. The JAX package's compile cache has no
counterpart (ROADMAP Queue 1, item 14)."""

from cinemri_tpu_torch.utils.paths import DEFAULT_CONFIG, fetch_dir

__all__ = ["fetch_dir", "DEFAULT_CONFIG"]
