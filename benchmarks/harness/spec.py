"""A cell and everything it names, found by name under the checkout's
root: the configuration (its ``file`` in ``BENCHMARK.json``), the traffic
mix (``benchmarks/mixes/<traffic>.json``), the driver the configuration
names (``benchmarks/drivers/<driver>.py``) and a reader for each metric
(``benchmarks/metrics/<name>.py``). A new configuration, mix or metric is
a new file and an entry in ``BENCHMARK.json``; no existing file changes."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[2]
MIXES = Path("benchmarks") / "mixes"
METRICS = Path("benchmarks") / "metrics"
DRIVERS = Path("benchmarks") / "drivers"


@dataclass
class Cell:
    name: str
    chips: int
    workload: dict
    config_entry: dict
    config: dict
    mix: dict
    #: the end-to-end and the per-layer metrics this cell reports
    end_to_end: list
    per_layer: list
    root: Path


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:  # per-layer: every cell reporting what it moves
        return metric["moves"] in e2e_of_cell
    return True


def load_cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; have {sorted(work)}")
    w = work[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((root / MIXES / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), w, entry, config, mix, e2e,
                per_layer, root)


def reader(cell: Cell, metric: dict) -> ModuleType:
    """The metric's reader module; its ``UNIT`` must be the entry's."""
    mod = load_module(cell.root / METRICS / f"{metric['name']}.py",
                      f"benchmarks_metric_{metric['name']}")
    if mod.UNIT != metric["unit"]:
        raise ValueError(f"{metric['name']}: reader's unit {mod.UNIT!r}, "
                         f"BENCHMARK.json's {metric['unit']!r}")
    return mod


def driver(cell: Cell) -> ModuleType:
    name = cell.config["driver"]
    return load_module(cell.root / DRIVERS / f"{name}.py",
                       f"benchmarks_driver_{name}")
