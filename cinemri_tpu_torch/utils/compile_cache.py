"""Persistent build directory of the port's compiled libraries.

Counterpart of ``cinemri_tpu/utils/compile_cache.py``. The JAX package keeps
XLA's executables in a persistent cache; what the port compiles is its
kernel libraries (nvcc, ``ops/kernels/_build.py``) and the C++ ESPIRiT
(g++, ``native/``). Both go into one directory:

  * ``CINEMRI_COMPILE_CACHE`` names its root; the default is the package's
    git-ignored ``cinemri_tpu_torch/_build/``;
  * inside the root, a subdirectory per :func:`host_fingerprint`, so a
    library built with another toolchain or for another host is never
    loaded;
  * ``CINEMRI_COMPILE_CACHE=0`` builds into a fresh temporary directory in
    each process (removed at exit): every library is compiled anew;
  * each library's file name carries a hash of its sources and flags
    (:func:`keyed_name`), so a library is stale exactly when its inputs
    changed, whatever the files' modification times say.

:func:`enable_compile_cache` sets the directory (the CLI calls it at
start-up, where the JAX CLI enables its cache); :func:`build_dir` returns the
directory in use, enabling the default at the first build.
"""

from __future__ import annotations

import atexit
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path
from typing import Iterable, Optional

__all__ = ["enable_compile_cache", "host_fingerprint", "build_dir", "keyed_name", "DEFAULT_ROOT"]

DEFAULT_ROOT = Path(__file__).resolve().parents[1] / "_build"

_DIR: Optional[Path] = None


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return " ".join(sorted(line.split(":", 1)[1].split()))
    except OSError:
        pass
    return platform.processor()


def _nvcc() -> str:
    """The nvcc version (``"none"`` without nvcc) and the flags with its
    target arch (``ops/kernels/_build.py``)."""
    from cinemri_tpu_torch.ops.kernels._build import NVCC_FLAGS, nvcc_path

    try:
        out = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True,
                             timeout=60).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        out = ""
    version = out.strip().splitlines()[-1] if out.strip() else "none"
    return f"{version}|{' '.join(NVCC_FLAGS)}"


@lru_cache(maxsize=None)
def host_fingerprint() -> str:
    """Short hash of what a built library depends on beyond its sources: the
    host CPU's feature flags, the torch and CUDA versions, the nvcc version
    (``"none"`` without nvcc) and the target arch."""
    import torch

    salt = "|".join((_cpu_flags(), torch.__version__, str(torch.version.cuda), _nvcc()))
    return hashlib.sha1(salt.encode()).hexdigest()[:10]


def enable_compile_cache(cache_dir: Path | str | None = None) -> Path:
    """Use ``cache_dir`` (default ``$CINEMRI_COMPILE_CACHE``, else
    :data:`DEFAULT_ROOT`) / :func:`host_fingerprint` as the build directory
    and return it; with ``CINEMRI_COMPILE_CACHE=0`` and no ``cache_dir``, a
    fresh temporary directory of this process."""
    global _DIR
    env = os.environ.get("CINEMRI_COMPILE_CACHE", "")
    if cache_dir is None and env == "0":
        path = Path(tempfile.mkdtemp(prefix="cinemri_build_"))
        atexit.register(shutil.rmtree, path, True)
    else:
        path = Path(cache_dir or env or DEFAULT_ROOT).expanduser() / host_fingerprint()
        path.mkdir(parents=True, exist_ok=True)
    _DIR = path
    return path


def build_dir() -> Path:
    """The build directory in use (:func:`enable_compile_cache`'s default
    the first time)."""
    return _DIR if _DIR is not None else enable_compile_cache()


def keyed_name(stem: str, sources: Iterable[Path], flags: Iterable[str]) -> str:
    """``lib<stem>-<hash>.so``: the hash of the flags and of every source's
    name and bytes."""
    h = hashlib.sha1(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return f"lib{stem}-{h.hexdigest()[:12]}.so"
