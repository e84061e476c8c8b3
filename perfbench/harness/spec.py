"""Find a cell and its pieces by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix.
The pieces are files of their own under ``perfbench/``:

* ``configs/<config>.json``: the instances, dtype and solver options;
* ``traffic/<mix>.json``: the request loop's parameters, among them the
  ``entry`` the window drives;
* ``entries/<entry>.py``: that entry's request loop (``Entry``);
* ``checks/<cell>.json``: the limits that decide ``correct``;
* ``metrics/<metric>.py``: one metric's reader (``read(ctx)``).

A later change adds a cell, a mix, an entry or a metric as new files.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[1]          # perfbench/
REPO = ROOT.parent
BENCHMARK = REPO / "BENCHMARK.json"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import one file by path, under a private module name."""
    if not path.is_file():
        raise FileNotFoundError(f"no such piece of the benchmark: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    source: str
    kind: str                        # "end_to_end" | "per_layer"
    workloads: Optional[List[str]]
    moves: Optional[str] = None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _metrics(bench: dict, kind: str) -> List[Metric]:
    return [Metric(name=m["name"], unit=m["unit"], source=m["source"],
                   kind=kind,
                   workloads=m.get("workloads"), moves=m.get("moves"))
            for m in bench.get(kind, [])]


def cell_metrics(metrics: List[Metric], cell: str,
                 e2e_names: List[str]) -> List[Metric]:
    """The metrics a cell reports: those that list it, and those with no
    list whose end-to-end metric (itself, or the one it moves) the cell
    reports."""
    out = []
    for m in metrics:
        if m.workloads is not None:
            if cell in m.workloads:
                out.append(m)
        elif m.kind == "end_to_end" or m.moves in e2e_names:
            out.append(m)
    return out


def load_cell(name: str, bench: Optional[dict] = None,
              data: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` (default: ``BENCHMARK.json``) with
    its configuration, traffic and limits read from ``data`` (default
    ``perfbench/``; the CPU tests give tiny ones)."""
    bench = _json(BENCHMARK) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    config = _json(data / "configs" / f"{w['config']}.json")
    traffic = _json(data / "traffic" / f"{w['traffic']}.json")
    checks = _json(data / "checks" / f"{name}.json")
    e2e = cell_metrics(_metrics(bench, "end_to_end"), name, [])
    per_layer = cell_metrics(_metrics(bench, "per_layer"), name,
                             [m.name for m in e2e])
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, checks=checks, end_to_end=e2e,
                per_layer=per_layer)


def entry_class(cell: Cell):
    mod = load_module(ROOT / "entries" / f"{cell.traffic['entry']}.py",
                      f"perfbench_entry_{cell.traffic['entry']}")
    return mod.Entry


def metric_reader(cell: Cell, metric: Metric):
    mod = load_module(ROOT / "metrics" / f"{metric.name}.py",
                      "perfbench_metric_" + metric.name.replace(".", "_"))
    return mod.read
