"""BENCHMARK.json against the benchmark contract's form, and its files."""

import json
import re

import pytest

from cinebench.tests.tiny import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"][:2] == ["python3", "cinebench/run.py"]
    assert MANIFEST["paths"] == ["cinebench"]
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51


def test_run_seconds_fits_a_full_check_of_24_cells():
    cells = 24
    total = (2 + 14 * cells) * (MANIFEST["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            yield group, entry["name"]


@pytest.mark.parametrize("group,name", list(_names()))
def test_names_use_allowed_characters(group, name):
    assert NAME.match(name), (group, name)


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (ROOT / "cinebench" / "metrics" / f"{metric['name']}.py").is_file()
    if metric in MANIFEST["end_to_end"]:
        assert set(metric) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]


def test_cells_and_their_files():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    used = set()
    for cell in MANIFEST["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["chips"] == 1 and len(cell["why"]) <= 200
        used.add(cell["config"])
        assert (ROOT / "cinebench" / "traffic" / f"{cell['traffic']}.json").is_file()
        assert (ROOT / "cinebench" / "limits" / f"{cell['name']}.json").is_file()
    assert used == set(configs)
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("cinebench/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == [] and c["source"].startswith("https://")


def test_every_cell_reports_setup_another_e2e_metric_and_a_layer_metric():
    for cell in MANIFEST["workloads"]:
        e2e = [m["name"] for m in MANIFEST["end_to_end"]
               if cell["name"] in m.get("workloads", [cell["name"]])]
        layer = [m for m in MANIFEST["per_layer"] if cell["name"] in m["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:  # the metric it moves is reported in the same cell
            assert m["moves"] in e2e
