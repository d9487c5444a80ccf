"""`BENCHMARK.json` and the files it names, found by name.

A workload names a configuration and a traffic mix; their files are
`configs/<config>.json` and `traffic/<traffic>.json`, the limits of its
correctness numbers `limits/<workload>.json`, the driver the mix names
`drivers/<driver>.py`, each per-layer metric's reader
`layer_metrics/<metric>.py` and each cost `costs/<name>.py`. Adding a
cell, a mix or a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """The Python file at `path` as a module of its own (its name may
    hold dots, as a metric's does)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One workload of `BENCHMARK.json` with everything its run reads."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the end-to-end metrics this cell reports
    per_layer: list  # the per-layer metrics this cell reports

    @property
    def driver(self) -> ModuleType:
        driver = self.traffic["driver"]
        return load_module(BENCH_DIR / "drivers" / f"{driver}.py")


def _reports(metric: dict, workload: str, reported: Optional[set] = None):
    listed = metric.get("workloads")
    if listed is not None:
        return workload in listed
    return reported is None or metric.get("moves") in reported


def find_cell(workload: str, bench: Optional[dict] = None) -> Cell:
    """The cell named `workload`, with its configuration, traffic, limits
    and the metrics it reports."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = entries[0]
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(BENCH_DIR / "configs" / f"{w['config']}.json"),
        traffic=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH_DIR / "limits" / f"{workload}.json"),
        end_to_end=e2e, per_layer=layer)


def metric_reader(name: str) -> ModuleType:
    return load_module(BENCH_DIR / "layer_metrics" / f"{name}.py")


def cost_module(name: str) -> ModuleType:
    return load_module(BENCH_DIR / "costs" / f"{name}.py")
