"""The benchmark's files: BENCHMARK.json keeps the contract's shape, and
every configuration, traffic mix, cell file, driver and metric reader it
names loads."""
import json
import re

import pytest

from portbench.lib import cells
from portbench.tests.tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
NUMBERS = ("loss_gap", "grad_gap", "grad_median_gap", "change_gap")


def test_top_level_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    texts = [e["why"] for e in BENCH["workloads"] + BENCH["configs"]]
    texts += [m["layer"] for m in BENCH["per_layer"]]
    texts += [c["source"] for c in BENCH["configs"]] + BENCH["command"]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in texts)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        for w in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c = cells.load(ROOT, cell)
    assert c.chips == 1
    assert {"loss_gap", "grad_gap", "change_gap"} <= set(c.checks["limits"])
    assert set(c.checks["limits"]) <= set(NUMBERS)
    assert cells.driver(c).Run is not None
    for m in c.per_layer:
        assert callable(cells.reader(ROOT, m["name"]))
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "peak_mem_gib"}


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    f = ROOT / cfg["file"]
    assert f.parts[len(ROOT.parts)] == "portbench"
    data = json.loads(f.read_text())
    assert data["name"] == cfg["name"]
    assert set(data["reduced"]) == set(cfg["reduced"])
    assert "num_layers" in data["model"]
