"""Everything a cell is, found by name from its own files:

- ``BENCHMARK.json`` at the checkout's root: the cell (its configuration,
  traffic and chips), the metrics and which cells report them;
- the configuration's ``file`` (``configs/<name>.json``): the model's
  sizes, the program's settings, the frozen FLOP counts;
- ``traffic/<traffic>.json``: the loop and its parameters;
- ``limits/<cell>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: one reader a metric, ``read(ctx)`` returning a
  number or None (nothing to read).

A cell or a metric is added by adding files and entries; no file here
changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    end_to_end: bool
    read: Callable[[dict], Optional[float]]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    metrics: List[Metric]

    def metrics_for(self, trace: bool) -> List[Metric]:
        """The end-to-end metrics (``trace`` false) or the per-layer ones."""
        return [m for m in self.metrics if m.end_to_end != trace]


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_reader(path: Path) -> Callable[[dict], Optional[float]]:
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(entry: dict, cell: str, moved: Optional[set] = None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return moved is None or entry["moves"] in moved


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    here = root / "benchmark"
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    traffic = _json(here / "traffic" / f"{w['traffic']}.json")
    limits = _json(here / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, moved)]
    metrics = [Metric(m["name"], m["unit"], kind == "e2e",
                      load_reader(here / "metrics" / f"{m['name']}.py"))
               for kind, entries in (("e2e", e2e), ("layer", layer)) for m in entries]
    return Cell(name, int(w["chips"]), config, traffic, limits, metrics)
