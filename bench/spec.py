"""What a cell is made of, found by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix and
each metric; every part lives in a file of its own, which this module
finds by that name, so that a cell, a mix or a metric is added as new
files and no existing file changes:

* a configuration: ``bench/configs/<config>.json``;
* a traffic mix: ``bench/traffic/<traffic>.json``;
* a per-layer metric's reader: ``bench/metrics/<metric>.py``;
* a cell's correctness limits: ``bench/limits/<cell>.json``;
* a serving driver: ``bench/drivers/<engine>.py`` (the mix's ``engine``);
* a plain reference: ``bench/reference/<reference>.py`` (the
  configuration's ``reference``).
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict[str, Any]        # the configuration file's content
    traffic: Dict[str, Any]       # the traffic file's content
    limits: Dict[str, Any]        # the cell's correctness limits
    end_to_end: List[Dict[str, Any]]  # the end-to-end metrics this cell reports
    per_layer: List[Dict[str, Any]]   # the per-layer metrics this cell reports
    chips: int


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_module(path: Path) -> ModuleType:
    """A module from its file, under a name of the file's own (metric
    names hold dots, so they are not import paths)."""
    spec = importlib.util.spec_from_file_location(
        "bench_part_" + path.stem.replace(".", "_").replace("-", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(cell_name: str, root: Path = ROOT) -> Cell:
    """The cell's parts, each read from the file its name points to."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no cell {cell_name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfile = root / configs[w["config"]]["file"]
    config = json.loads(cfile.read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{cell_name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, cell_name)]
    pl = [m for m in bench["per_layer"] if _reports(m, cell_name)]
    return Cell(cell_name, config, traffic, limits, e2e, pl, int(w["chips"]))


def metric_reader(name: str) -> ModuleType:
    return load_module(BENCH / "metrics" / f"{name}.py")


def driver(engine: str) -> ModuleType:
    return importlib.import_module(f"bench.drivers.{engine}")


def reference(name: str) -> ModuleType:
    return importlib.import_module(f"bench.reference.{name}")
