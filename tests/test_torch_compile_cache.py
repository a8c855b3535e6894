"""The compile cache of the port (``utils/compile_cache.py``) on the CPU.

The C++ ESPIRiT (g++) stands in for the CUDA libraries, which share the
build directory and the keyed names but need nvcc: two processes with one
``CINEMRI_COMPILE_CACHE`` build it once; ``CINEMRI_COMPILE_CACHE=0`` builds
it afresh, in a temporary directory of the process; a new host fingerprint
gets its own directory, and a library's name follows its sources and flags.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

from cinemri_tpu_torch.ops.kernels import _build
from cinemri_tpu_torch.utils import compile_cache

ROOT = Path(__file__).resolve().parent.parent

# builds (or finds) the library in $CINEMRI_COMPILE_CACHE, then, with
# CINEMRI_COMPILE_CACHE=0, in a fresh directory of the process
_PROBE = ("import json, os\n"
          "from cinemri_tpu_torch import native\n"
          "from cinemri_tpu_torch.utils import compile_cache\n"
          "lib = native.build_library()\n"
          "cached = native.BUILDS\n"
          "os.environ['CINEMRI_COMPILE_CACHE'] = '0'\n"
          "compile_cache.enable_compile_cache()\n"
          "fresh = native.build_library()\n"
          "print(json.dumps({'builds': cached, 'lib': str(lib), 'fresh': str(fresh),\n"
          "                  'fresh_builds': native.BUILDS - cached,\n"
          "                  'fingerprint': compile_cache.host_fingerprint()}))\n")


def _build_in_process(cache):
    env = dict(os.environ, CINEMRI_COMPILE_CACHE=cache, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_two_processes_build_once_and_zero_builds_afresh(tmp_path):
    first, second = _build_in_process(str(tmp_path)), _build_in_process(str(tmp_path))
    assert (first["builds"], second["builds"]) == (1, 0)
    lib = Path(first["lib"])
    assert second["lib"] == first["lib"] and lib.exists()
    assert lib.parent == tmp_path / first["fingerprint"]
    for run in (first, second):  # =0: built again, elsewhere, and removed at exit
        assert run["fresh_builds"] == 1 and run["fresh"] != run["lib"]
        assert not Path(run["fresh"]).is_relative_to(tmp_path) and not Path(run["fresh"]).exists()


def test_a_new_fingerprint_gets_its_own_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(compile_cache, "_DIR", None)
    here = compile_cache.enable_compile_cache(tmp_path)
    assert here == tmp_path / compile_cache.host_fingerprint() and here.is_dir()
    monkeypatch.setattr(compile_cache, "host_fingerprint", lambda: "another-host")
    there = compile_cache.enable_compile_cache(tmp_path)
    assert there == tmp_path / "another-host" != here and there.is_dir()
    assert _build.library_path("dft_matmul").parent == there


def test_a_library_name_follows_its_sources_and_flags(tmp_path):
    src = tmp_path / "a.cu"
    src.write_text("int x;")
    name = compile_cache.keyed_name("a", [src], ("-O3",))
    assert name.startswith("liba-") and name.endswith(".so")
    assert compile_cache.keyed_name("a", [src], ("-O2",)) != name
    src.write_text("int y;")
    assert compile_cache.keyed_name("a", [src], ("-O3",)) != name
