"""The run's guards: no JAX and no JAX package in the process, a reference
that imports nothing of the program, caches inside the checkout, and no
result without a card or without the program."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from cinebench.harness import env
from cinebench.tests.tiny import ROOT


@pytest.mark.parametrize("modules,found", [
    ({"cinemri_tpu_torch": 0, "cinemri_tpu_torch.ops": 0, "torch": 0}, []),
    ({"cinemri_tpu": 0}, ["cinemri_tpu"]),
    ({"cinemri_tpu.ops.fft": 0}, ["cinemri_tpu"]),
    ({"jaxlib.xla_client": 0, "jax": 0, "flax.linen": 0}, ["flax", "jax", "jaxlib"]),
    ({"jaxtyping": 0, "cinemri_tpu2": 0}, []),
])
def test_forbidden_modules_compare_whole_top_level_names(modules, found):
    assert env.forbidden_modules(modules) == found


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", sorted((ROOT / "cinebench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"cinemri_tpu_torch", "cinemri_tpu", "jax", "jaxlib", "flax"}


def test_only_the_program_adapter_imports_the_program():
    for path in (ROOT / "cinebench").rglob("*.py"):
        if "tests" in path.parts or path.name == "program.py":
            continue
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "cinemri_tpu_torch" not in tops and "cinemri_tpu" not in tops, path


def test_cpu_pools_get_one_thread():
    environ = {"OMP_NUM_THREADS": "8"}
    env.one_cpu_thread(environ)
    assert environ == {key: "1" for key in env.THREAD_VARS}


def test_caches_lie_inside_the_checkout_at_fixed_paths():
    environ = {}
    dirs = env.set_cache_dirs(environ)
    assert environ == dirs
    for path in dirs.values():
        assert path.startswith(str(ROOT / "cinebench" / "_cache"))


def test_a_tiny_run_loads_no_forbidden_module():
    code = ("import sys, time, torch; sys.path.insert(0, %r)\n"
            "from cinebench.harness import bench, env\n"
            "from cinebench.tests.tiny import tiny_cell, CPU_INFO\n"
            "r = bench.run_cell(tiny_cell('cinenet_xf.serve'), 3, 0.5, False, time.perf_counter(),"
            " torch.device('cpu'), CPU_INFO)\n"
            "print(r['correct'], env.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["True", "[]"]


def _run(cwd):
    return subprocess.run([sys.executable, "cinebench/run.py", "--workload", "varnet_xf.serve",
                           "--seed", "3", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=cwd,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_result_without_a_card():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cinebench", tmp_path / "cinebench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    json.loads((tmp_path / "BENCHMARK.json").read_text())  # the copy is whole
