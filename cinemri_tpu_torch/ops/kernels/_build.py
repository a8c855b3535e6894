"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface in the build directory of
:mod:`cinemri_tpu_torch.utils.compile_cache` (by default the package's
git-ignored ``_build/<host fingerprint>/``), and loaded with ``ctypes``.
Building happens at the first launch of a kernel, never at import. A
library's file name carries a hash of its sources (the ``.cu`` and every
``csrc/*.cuh``) and of the nvcc flags, so it is rebuilt exactly when one of
them changed.

Counterpart of the probe ``pallas_available`` in
``cinemri_tpu/ops/kernels/dft_pallas.py``: this module answers "is the
library built and loaded", and raises when it cannot be, rather than
letting a caller choose another path.

Every C entry returns ``cudaGetLastError()`` right after its launch;
:func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

from cinemri_tpu_torch.utils.compile_cache import build_dir, keyed_name

__all__ = ["CSRC", "KERNELS", "nvcc_path", "library_path", "build", "load", "check"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

# C entry points of each library: name -> {function: argtypes}. Every
# operand, scalars such as λ included, is a device pointer; ``mode`` is the
# precision (ops/kernels/precision.py MODES: 0 'highest', 1 'high', 2
# 'default'); ``fused`` asks for the normal apply's fused FP32 route at
# 'highest' (ops/kernels/normal_cuda.py set_fp32_tile).
KERNELS: Dict[str, Dict[str, tuple]] = {
    "dft_matmul": {
        # xr, xi, wr, wi, yr, yi, O, N, I, mode, stream
        "cinemri_dft_matmul": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    },
    "normal_apply": {
        # xr, xi, kr, ki, sr, si, lam, outr, outi, scratch yr, yi, zr, zi,
        # b, t, c, h, w, kt, mode, fused, stream
        "cinemri_normal_apply": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _P),
        # the route of a call, which sets its scratch: xr, xi, kr, ki, sr, si,
        # b, t, c, h, w, kt, mode, fused
        "cinemri_normal_apply_route": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I),
    },
    "normal_apply_bwd": {
        # xr, xi, gr, gi, kr, ki, sr, si, lam, xbr, xbi, sbr, sbi, lb,
        # scratch pr, pi, ybr, ybi, zr, zi, khr, khi, b, t, c, h, w, kt,
        # mode, fused, stream
        "cinemri_normal_apply_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _I, _I, _I, _P),
        # xr, xi, gr, gi, kr, ki, sr, si, b, t, c, h, w, kt, mode, fused
        "cinemri_normal_apply_bwd_route": (_P, _P, _P, _P, _P, _P, _P, _P,
                                           _I, _I, _I, _I, _I, _I, _I, _I),
    },
    "fft2_plane": {
        # xr, xi, whr, whi, wwr, wwi, yr, yi, B, h, w, stream
        "cinemri_fft2_plane": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``. Raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (tried $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA kernels of cinemri_tpu_torch are built from csrc/ with nvcc"
    )


def _sources(name: str):
    return [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]


def library_path(name: str) -> Path:
    """Where the library ``name`` of the current sources and flags lives."""
    return build_dir() / keyed_name(name, _sources(name), NVCC_FLAGS)


def build(names: Optional[Iterable[str]] = None, verbose: bool = False,
          force: bool = False) -> Dict[str, dict]:
    """Compile the named libraries (all by default) that are not built yet
    (all of them with ``force``), one ``nvcc`` each, all started together.
    Returns ``{name: {"seconds": s, "log": ptxas output, "hit": bool}}``, a
    hit being a library found built, and raises, with the compiler's output,
    if any build fails."""
    names = list(KERNELS if names is None else names)
    results, procs = {}, {}
    for name in names:
        lib = library_path(name)
        if lib.exists() and not force:
            results[name] = {"seconds": 0.0, "log": "", "hit": True}
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (lib, tmp, time.perf_counter(),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (lib, tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        results[name] = {"seconds": time.perf_counter() - t0, "log": log, "hit": False}
        if proc.returncode != 0:
            failures.append(f"nvcc for csrc/{name}.cu exited {proc.returncode}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)  # atomic: a reader never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if missing or stale."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in KERNELS[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    lib.cinemri_error_string.argtypes = [ctypes.c_int]
    lib.cinemri_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``."""
    if code != 0:
        msg = lib.cinemri_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
