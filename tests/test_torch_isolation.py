"""The port imports nothing of JAX, of the JAX package, of h5py, tensorboardX,
yaml or matplotlib (the card's host has none of the last four), and builds or
loads no kernel or native library on import."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import ctypes, importlib, json, pkgutil, subprocess, sys
spawned, dlopened = [], []
class _Spy(subprocess.Popen):
    def __init__(self, args, *a, **k):
        spawned.append(str(args))
        super().__init__(args, *a, **k)
subprocess.Popen = _Spy
class _CDLL(ctypes.CDLL):
    def __init__(self, name, *a, **k):
        if "cinemri" in str(name):  # the port's libraries (torch dlopens its own)
            dlopened.append(str(name))
        super().__init__(name, *a, **k)
ctypes.CDLL = _CDLL
import cinemri_tpu_torch
from cinemri_tpu_torch.ops.kernels import _build
mods = []
for info in pkgutil.walk_packages(cinemri_tpu_torch.__path__, "cinemri_tpu_torch."):
    importlib.import_module(info.name)
    mods.append(info.name)
import cinemri_tpu_torch.native as native
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "cinemri_tpu", "h5py",
                                    "tensorboardX", "yaml", "matplotlib"))
print(json.dumps({"modules": mods, "bad": bad, "loaded": sorted(_build._LIBS),
                  "native_loaded": native._handle is not None, "dlopened": dlopened,
                  "triton": "triton" in sys.modules, "spawned": spawned}))
"""


def test_port_imports_no_jax_and_builds_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                          env=env, cwd=str(ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("cinemri_tpu_torch.ops.kernels.dft_cuda",
                 "cinemri_tpu_torch.ops.kernels.normal_cuda",
                 "cinemri_tpu_torch.serve",
                 "cinemri_tpu_torch.interop.flax_params",
                 "cinemri_tpu_torch.models.varnet",
                 "cinemri_tpu_torch.data.masks",
                 "cinemri_tpu_torch.data.transforms",
                 "cinemri_tpu_torch.ops.ssim",
                 "cinemri_tpu_torch.models.remat",
                 "cinemri_tpu_torch.train.optim",
                 "cinemri_tpu_torch.train.step",
                 "cinemri_tpu_torch.models.cinenet",
                 "cinemri_tpu_torch.physics.cg",
                 "cinemri_tpu_torch.ops.kernels.fft2_cuda",
                 "cinemri_tpu_torch.ops.complex",
                 "cinemri_tpu_torch.native",
                 "cinemri_tpu_torch.data",
                 "cinemri_tpu_torch.data.dataset",
                 "cinemri_tpu_torch.data.espirit",
                 "cinemri_tpu_torch.data.compress",
                 "cinemri_tpu_torch.data.synthetic",
                 "cinemri_tpu_torch.data.sharding",
                 "cinemri_tpu_torch.ops.metrics",
                 "cinemri_tpu_torch.train.metrics_agg",
                 "cinemri_tpu_torch.train.loader",
                 "cinemri_tpu_torch.train.checkpoint",
                 "cinemri_tpu_torch.train.logging",
                 "cinemri_tpu_torch.train.device_cache",
                 "cinemri_tpu_torch.train.loop",
                 "cinemri_tpu_torch.utils.paths",
                 "cinemri_tpu_torch.cli.common",
                 "cinemri_tpu_torch.cli.train_test_varnet",
                 "cinemri_tpu_torch.cli.train_test_cinenet",
                 "cinemri_tpu_torch.cli.train_test_xpdnet",
                 "cinemri_tpu_torch.models.xpdnet",
                 "cinemri_tpu_torch.models.denoisers.mwcnn",
                 "cinemri_tpu_torch.models.denoisers.kspace_cnn",
                 "cinemri_tpu_torch.ops.wavelet",
                 "cinemri_tpu_torch.cli.inference",
                 "cinemri_tpu_torch.cli.visualize",
                 "cinemri_tpu_torch.interop.port",
                 "cinemri_tpu_torch.interop.torch_import",
                 "cinemri_tpu_torch.interop.reference_layout",
                 "cinemri_tpu_torch.instrument",
                 "cinemri_tpu_torch.instrument.opstats",
                 "cinemri_tpu_torch.ops.kernels.precision",
                 "cinemri_tpu_torch.models.denoisers.activations",
                 "cinemri_tpu_torch.models.denoisers.packed_unet",
                 "cinemri_tpu_torch.utils.compile_cache"):
        assert name in out["modules"]
    assert out["bad"] == []  # no JAX, no JAX package, no h5py/tensorboardX/yaml/matplotlib
    assert out["loaded"] == []  # no kernel library loaded
    assert not out["native_loaded"] and out["dlopened"] == []  # no library loaded at all
    assert out["spawned"] == []  # no compiler started: neither nvcc nor g++
    assert not out["triton"]


def _run_without_cuda(script, *args):
    """Run ``script`` as __main__ with no CUDA device visible: its exit code
    and the JAX-package modules it imported."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    code = ("import runpy, sys, json\n"
            f"sys.argv = {[script, *args]!r}\n"
            "try:\n"
            f"    runpy.run_path({script!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    code = e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'cinemri_tpu'))\n"
            "print(json.dumps({'code': code, 'bad': bad}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=str(ROOT), timeout=300)
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stdout


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py exits before any result without a CUDA device, and its
    imports hold no JAX."""
    out, stdout = _run_without_cuda("chip_smoke.py")
    assert out["code"] not in (0, None)
    assert out["bad"] == []
    assert '"ok": true' not in stdout


def test_kernel_ab_imports_no_jax():
    """kernel_ab.py exits before timing anything without a CUDA device, and
    its imports hold no JAX."""
    out, stdout = _run_without_cuda("kernel_ab.py", ".")
    assert out["code"] not in (0, None)
    assert out["bad"] == []
    assert "[ab]" not in stdout


_NO_OPTIONAL = r"""
import importlib.abc, runpy, sys
class _Absent(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("h5py", "tensorboardX", "yaml", "matplotlib", "jax", "cinemri_tpu"):
            raise ImportError(f"{name} is absent on this host")
sys.meta_path.insert(0, _Absent())
import cinemri_tpu_torch.train, cinemri_tpu_torch.cli, cinemri_tpu_torch.utils
sys.argv = ["train_test_varnet", "--help"]
try:
    runpy.run_module("cinemri_tpu_torch.cli.train_test_varnet", run_name="__main__")
except SystemExit as e:
    print("exit", e.code)
"""


def test_training_slice_runs_without_the_optional_libraries():
    """As on the card's host (no h5py, tensorboardX, yaml or matplotlib):
    the Trainer, the CLI and the utils import, and the VarNet entry point
    prints its help."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _NO_OPTIONAL], capture_output=True, text=True,
                          env=env, cwd=str(ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and proc.stdout.strip().endswith("exit 0")
