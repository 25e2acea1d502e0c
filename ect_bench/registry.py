"""Where the harness finds each piece, by the name ``BENCHMARK.json`` gives
it. Nothing here lists a configuration, traffic mix or metric: a new one is
a new file and a new entry.

* a configuration ``<name>``: ``configs/<name>.json``;
* a traffic mix ``<name>``: ``traffic/<name>.json``, read by
  ``traffic.Loop``;
* a per-layer metric ``<name>``: ``metrics/<name>.py``, whose ``read(trace,
  run)`` returns its number or None.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"


@dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int


def load(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def cells(bench: dict) -> list[Cell]:
    return [Cell(w["name"], w["config"], w["traffic"], int(w["chips"]))
            for w in bench["workloads"]]


def cell(bench: dict, name: str) -> Cell:
    for c in cells(bench):
        if c.name == name:
            return c
    raise KeyError(f"no workload {name!r} in the benchmark")


def _json(root: Path, folder: str, name: str) -> dict:
    path = Path(root) / folder / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{folder[:-1]} {name!r}: no {path}")
    return json.loads(path.read_text())


def config(name: str, root: Path = HERE) -> dict:
    return _json(root, "configs", name)


def traffic(name: str, root: Path = HERE) -> dict:
    return _json(root, "traffic", name)


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell_name`` reports: the end-to-end ones
    without a trace, the per-layer ones with it; a metric with a
    ``workloads`` list only in those cells."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if cell_name in m.get("workloads", [cell_name])]


def reader(name: str, root: Path = HERE):
    """The ``read`` function of per-layer metric ``name``."""
    path = Path(root) / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {name!r}: no {path}")
    spec = importlib.util.spec_from_file_location(
        "ect_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
