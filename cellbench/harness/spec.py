"""A cell's files, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells
(``workloads``), their configurations and traffic mixes, and the metrics.
Everything that belongs to one of them is a file of its own under
``cellbench/``:

- ``configs/<config>.json``: the deployment as it is run (the program's
  ``HeatConfig`` fields, the seeded initial condition, the name of its
  plain reference);
- ``mixes/<traffic>.json``: the traffic mix, read by the loop it names;
- ``loops/<loop>.py``: a loop (``setup``, ``window``, ``compare``);
- ``cells/<workload>.json``: the limits of the numbers ``correct`` compares;
- ``metrics/<metric>.py``: the reader of one metric (``read(run)``);
- ``reference/<name>.py``: a configuration's plain reference.

So a later cell, mix or metric is new files and new entries in
``BENCHMARK.json``, and no file that exists changes.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

# the checkout: cellbench/harness/spec.py -> the directory holding cellbench/
ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything found for it by name."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic: str
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    def file(self, *parts: str) -> Path:
        return self.root.joinpath("cellbench", *parts)


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = copy.deepcopy(base)
    for key, value in (over or {}).items():
        out[key] = value
    return out


def reports(metric: dict, workload: str, e2e_names: Optional[set] = None) -> bool:
    """Whether ``workload`` reports ``metric``: the metric's ``workloads``
    list names it, or, without that key, every cell does (an end-to-end
    metric) or every cell that reports the metric it ``moves``."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return e2e_names is None or metric.get("moves") in e2e_names


def resolve(workload: str, root: Path = ROOT,
            overrides: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of ``root``'s BENCHMARK.json, or one named
    ``<config>.<traffic>`` whose files exist. ``overrides``
    (``{"config": {...}, "mix": {...}}``) replaces top-level keys of the
    configuration and the mix, and ``"chips"`` the cards the cell needs:
    a rehearsal at a small size or on fewer cards."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    entry = cells.get(workload)
    if entry is None:
        # a cell not declared (yet): ``<config>.<traffic>``, its chips the
        # mix's ranks; it reports the metrics that name no cells
        config_name, _, traffic = workload.partition(".")
        entry = {"config": config_name, "traffic": traffic, "chips": None}
    base = root / "cellbench"
    config = json.loads((base / "configs" / f"{entry['config']}.json").read_text())
    mix = json.loads((base / "mixes" / f"{entry['traffic']}.json").read_text())
    limits = json.loads((base / "cells" / f"{workload}.json").read_text())
    overrides = overrides or {}
    chips = overrides.get("chips", entry["chips"] or mix.get("ranks", 1))
    e2e = [m for m in bench["end_to_end"] if reports(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, workload, names)]
    return Cell(name=workload, chips=int(chips),
                config_name=entry["config"],
                config=_merge(config, overrides.get("config")),
                traffic=entry["traffic"],
                mix=_merge(mix, overrides.get("mix")), limits=limits,
                end_to_end=e2e, per_layer=per_layer, root=root)


def _load_file(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def loop(cell: Cell):
    """The module of the loop the cell's mix names (``loops/<loop>.py``)."""
    name = cell.mix["loop"]
    return _load_file(cell.file("loops", f"{name}.py"),
                      f"cellbench_loop_{name}")


def reference(cell: Cell):
    """The configuration's plain reference (``reference/<name>.py``)."""
    name = cell.config["reference"]
    return _load_file(cell.file("reference", f"{name}.py"),
                      f"cellbench_reference_{name}")


def readers(cell: Cell, metrics: List[dict]) -> Dict[str, Callable]:
    """``{metric name: read}`` from ``metrics/<name>.py`` for each metric
    the harness does not take itself (``setup_s``)."""
    out = {}
    for m in metrics:
        if m["name"] == "setup_s":
            continue
        mod = _load_file(cell.file("metrics", f"{m['name']}.py"),
                         "cellbench_metric_" + m["name"].replace(".", "_"))
        out[m["name"]] = mod.read
    return out


def peak(card: str, root: Path = ROOT) -> Optional[dict]:
    """The frozen data-sheet peaks of ``card`` (``peaks.json``), or None
    for a card the table does not hold."""
    table = json.loads((root / "cellbench" / "peaks.json").read_text())
    return table.get(card)
