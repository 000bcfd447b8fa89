"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's file is the one its ``configs`` entry gives; the
mix is ``portbench/traffic/<traffic>.json``, which names its driver
(``portbench/drivers/<driver>.py``); the cell's own file,
``portbench/workloads/<cell>.json``, holds the limits that decide
``correct`` and the readings they were set from. A per-layer metric's
reader is ``portbench/metrics/<metric>.py``, or, for a name with a dot,
the reader of the part before the first dot. So a later cell,
configuration or metric is files and entries, and no edit.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

PKG = "portbench"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: Path, name: str) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell '{name}' in BENCHMARK.json (have "
                       f"{', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / PKG / "traffic" /
                          f"{w['traffic']}.json").read_text())
    checks = json.loads((root / PKG / "workloads" /
                         f"{name}.json").read_text())
    return Cell(name, int(w["chips"]), config, traffic, checks,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def driver(cell: Cell):
    """The traffic's driver module."""
    return importlib.import_module(f"{PKG}.drivers.{cell.traffic['driver']}")


def reader(root: Path, metric: str):
    """The ``read(ctx)`` function of a per-layer metric."""
    folder = Path(root) / PKG / "metrics"
    path = folder / f"{metric}.py"
    if not path.exists():
        path = folder / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"{PKG}.metrics.{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
