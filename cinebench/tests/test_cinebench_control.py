"""The control on the card: the reference in the program's place with TF32
convolutions and matmuls comes out not correct under each cell's limits,
where the program comes out correct. At the cells' own sizes, one seed
each (the calibration's readings over a dozen seeds are ``control.py``'s).

    python -m pytest cinebench/tests -m cuda
"""

import json

import pytest

from cinebench import control
from cinebench.harness import bench, env
from cinebench.tests.tiny import ROOT

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name, cuda_device):
    env.set_cache_dirs()
    from cinebench import reference

    reference.full_f32()
    cell = bench.load_cell(name)
    out = bench.loop(cell.traffic["kind"]).readings(cell, 2 ** 31 + 17, cuda_device, False)
    verdicts = control.judged(out, cell.limits)
    assert verdicts["program"], out["program"]
    assert not verdicts["control"], out["control"]
    assert not verdicts.get("fault_state_unchanged", False), out["fault_state_unchanged"]
