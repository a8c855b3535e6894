"""Native (C++) ESPIRiT calibration library with ctypes bindings.

Counterpart of ``cinemri_tpu/native``. ``espirit.cc`` (a copy of the JAX
package's source) is a dependency-free C++ implementation of the same
algorithm as :mod:`cinemri_tpu_torch.data.espirit`. It is compiled with the
system ``g++`` (``-O2 -shared -fPIC -std=c++17``) at the first call of
:func:`espirit_maps_native`, never at import, into the build directory of
:mod:`cinemri_tpu_torch.utils.compile_cache` (by default the package's
git-ignored ``_build/<host fingerprint>/``, beside the CUDA libraries), under
a name that carries a hash of the source and the flags: a process finds it
there when another built it from the same source. ``BUILDS`` counts the
compiles of this process. ``tests/test_torch_data.py`` holds it against the
numpy implementation.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from cinemri_tpu_torch.utils.compile_cache import build_dir, keyed_name

__all__ = ["espirit_maps_native", "build_library", "library_path", "BUILDS"]

_SRC = Path(__file__).resolve().parent / "espirit.cc"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_handle: Optional[ctypes.CDLL] = None
BUILDS = 0


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    return build_dir() / keyed_name("cinemri_espirit", [_SRC], GXX_FLAGS)


def build_library(force: bool = False) -> Path:
    """Compile ``espirit.cc`` with g++ unless its library is built (always
    with ``force``)."""
    global BUILDS
    lib = library_path()
    if lib.exists() and not force:
        return lib
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ for {_SRC.name} exited {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a reader never sees half a file
    BUILDS += 1
    return lib


def _load() -> ctypes.CDLL:
    global _handle
    if _handle is None:
        lib = ctypes.CDLL(str(build_library()))
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.espirit_maps_f32.argtypes = [
            f32p, f32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float,
            f32p, f32p, f32p,
        ]
        lib.espirit_maps_f32.restype = ctypes.c_int
        _handle = lib
    return _handle


def espirit_maps_native(
    kspace: np.ndarray,
    calib_size: int = 24,
    kernel_size: int = 6,
    thresh: float = 0.001,
    crop: float = 0.8,
    return_eigenvalues: bool = False,
):
    """C++ ESPIRiT with the same signature/semantics as
    :func:`cinemri_tpu_torch.data.espirit.espirit_maps`."""
    kspace = np.asarray(kspace, np.complex64)
    if kspace.ndim != 3:
        raise ValueError(f"expected (c, h, w) k-space, got {kspace.shape}")
    c, h, w = kspace.shape
    lib = _load()

    kre = np.ascontiguousarray(kspace.real, np.float32)
    kim = np.ascontiguousarray(kspace.imag, np.float32)
    mre = np.zeros((c, h, w), np.float32)
    mim = np.zeros((c, h, w), np.float32)
    eig = np.zeros((h, w), np.float32)

    p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    rc = lib.espirit_maps_f32(
        p(kre), p(kim), c, h, w, int(calib_size), int(kernel_size),
        float(thresh), float(crop), p(mre), p(mim), p(eig),
    )
    if rc != 0:
        raise RuntimeError(f"espirit_maps_f32 failed with code {rc}")
    maps = (mre + 1j * mim).astype(np.complex64)
    if return_eigenvalues:
        return maps, eig
    return maps
