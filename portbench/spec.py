"""Finds a cell's pieces by name.

``BENCHMARK.json`` (at the checkout's root) lists the cells and metrics;
each piece sits in a file of its own under ``portbench/``:

* ``configs/<config>.json``: a configuration's sizes, precision, FLOPs per
  unit of work and the program settings that build it;
* ``traffic/<mix>.json``: a traffic mix, with the driver that runs it
  (``drivers/<driver>.py``) and its parameters;
* ``workloads/<cell>.json``: a cell's configuration, mix and the limits of
  the numbers that decide ``correct``;
* ``metrics/<metric>.py``: the reader of a per-layer metric.

A cell reports the end-to-end metrics and per-layer metrics whose
``workloads`` list names it, or that have no such list.
"""
from __future__ import annotations

import copy
import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as fp:
        return json.load(fp)


def merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    """``base`` with ``over``'s keys overlaid, nested dicts merged."""
    out = copy.deepcopy(base)
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return _json(root / "BENCHMARK.json")


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT,
              overrides: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its files read.
    ``overrides`` (``{"config": {...}, "traffic": {...}}``) are overlaid on
    the files: the tests run cells at a size the CPU holds."""
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(entries)}")
    entry = entries[name]
    cell_file = _json(PKG / "workloads" / f"{name}.json")
    if cell_file["config"] != entry["config"]:
        raise ValueError(f"{name}: BENCHMARK.json names config "
                         f"{entry['config']!r}, the cell file "
                         f"{cell_file['config']!r}")
    over = overrides or {}
    config = merge(_json(PKG / "configs" / f"{entry['config']}.json"),
                   over.get("config", {}))
    traffic = merge(_json(PKG / "traffic" / f"{entry['traffic']}.json"),
                    over.get("traffic", {}))
    return Cell(
        name=name, chips=int(entry["chips"]), config=config, traffic=traffic,
        limits=dict(cell_file.get("limits", {})),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def driver(kind: str):
    """The module ``portbench.drivers.<kind>``."""
    return importlib.import_module(f"portbench.drivers.{kind}")


def reader(metric: str) -> Callable:
    """``read(run) -> float | None`` of ``metrics/<metric>.py``."""
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
