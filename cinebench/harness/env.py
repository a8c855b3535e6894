"""The run's environment: cache directories inside the checkout, one host
thread for CPU work, the card, and the guard against JAX and the JAX
package in the process."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

__all__ = ["FORBIDDEN", "CACHE", "THREAD_VARS", "set_cache_dirs", "one_cpu_thread",
           "forbidden_modules", "power_limit"]

# top-level module names that may not be loaded, compared whole: the JAX
# package is cinemri_tpu, and cinemri_tpu_torch (the port) begins with it
FORBIDDEN = ("jax", "jaxlib", "flax", "cinemri_tpu")

CACHE = Path(__file__).resolve().parents[1] / "_cache"


def set_cache_dirs(environ=os.environ) -> Dict[str, str]:
    """Point every build and kernel cache the program or torch may use at a
    fixed directory under ``cinebench/_cache``: the port's nvcc libraries
    (``CINEMRI_COMPILE_CACHE``), and Triton's, torch extensions' and the CUDA
    JIT cache."""
    dirs = {"CINEMRI_COMPILE_CACHE": CACHE / "build", "TRITON_CACHE_DIR": CACHE / "triton",
            "TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions", "CUDA_CACHE_PATH": CACHE / "cuda"}
    for key, path in dirs.items():
        environ[key] = str(path)
    return {k: str(v) for k, v in dirs.items()}


# the CPU thread pools of torch (OpenMP), numpy's BLAS and MKL
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def one_cpu_thread(environ=os.environ) -> None:
    """One thread in each CPU pool, set before torch or numpy is imported
    (and ``torch.set_num_threads(1)`` after): the program does no CPU
    arithmetic in the window, whose host work is one thread issuing the
    card's. On an H100 host of 8 cores CineNet-XF's host-paced volumes/s
    spread by 8.0% over four runs with torch's eight threads, by 2.1% with
    one."""
    for key in THREAD_VARS:
        environ[key] = "1"


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(FORBIDDEN))


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card ("unknown" without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out[0] if out else "unknown"
