"""Traffic loops found by a mix's ``kind``, and files that may state only what
runs: a configuration or a mix holding a key nothing reads, or a precision
the run does not run, is refused when its cell is loaded."""

import json
import shutil

import pytest

from cinebench import control
from cinebench.harness import bench
from cinebench.tests.tiny import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda c: c["name"])
def test_every_cell_loads_with_its_loop(cell):
    loaded = bench.load_cell(cell["name"])
    loop = bench.loop(loaded.traffic["kind"])
    assert loop.RUN_KIND in ("serve", "train")
    assert set(loaded.traffic) - {"kind"} == set(loop.KEYS)
    for name in ("setup", "reference", "run", "readings"):
        assert callable(getattr(loop, name))


def _copy(tmp_path, cell, edit_traffic=None, edit_config=None):
    """A checkout at ``tmp_path`` whose cell ``cell`` has its traffic and
    configuration files edited."""
    bench_dir = tmp_path / "cinebench"
    for sub in ("traffic", "limits", "configs", "loops"):
        shutil.copytree(ROOT / "cinebench" / sub, bench_dir / sub)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    config = next(c for c in MANIFEST["configs"] if c["name"] == entry["config"])
    for path, edit in ((bench_dir / "traffic" / f"{entry['traffic']}.json", edit_traffic),
                       (tmp_path / config["file"], edit_config)):
        if edit:
            path.write_text(json.dumps({**json.loads(path.read_text()), **edit}))
    return bench_dir


@pytest.mark.parametrize("cell,traffic,config", [
    ("varnet_xf.serve", {"clients": 4}, None),
    ("varnet_xf.serve", {"batch": 4}, None),
    ("varnet_xf.train", {"batch": 4}, None),
    ("varnet_xf.serve", {"kind": "serve_open"}, None),
    ("cinenet_xf.serve", None, {"tf32": True}),
    ("cinenet_xf.serve", None, {"activations": "bfloat16"}),
    ("varnet_xf.train", None, {"weight_dtype": "float16"}),
])
def test_a_file_that_states_what_does_not_run_is_refused(tmp_path, monkeypatch, cell, traffic,
                                                         config):
    monkeypatch.setattr(bench, "BENCH", _copy(tmp_path, cell, traffic, config))
    with pytest.raises(SystemExit):
        bench.load_cell(cell, root=tmp_path)


def test_the_unedited_copy_loads(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "BENCH", _copy(tmp_path, "varnet_xf.serve"))
    assert bench.load_cell("varnet_xf.serve", root=tmp_path).traffic["kind"] == "serve_closed"


@pytest.mark.parametrize("values,expected", [
    ({"program": 1e-5, "control": 1e-2, "fault_state_unchanged": 1.0},
     {"program": True, "control": False, "fault_state_unchanged": False}),
    ({"program": 1e-5, "control": 1e-4}, {"program": True, "control": True}),
    ({"program": float("nan"), "control": 1e-2}, {"program": False, "control": False}),
])
def test_control_judges_each_side_by_the_cells_limits(values, expected):
    out = {side: {"gap": v} for side, v in values.items()}
    out["detail"] = {"ignored": 1}
    assert control.judged(out, {"gap": 1e-3}) == expected
