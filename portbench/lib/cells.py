"""A cell, found by its name in BENCHMARK.json: its configuration file,
its traffic mix (portbench/traffic/<traffic>.json) and the metrics it
reports, each read by portbench/metrics/<metric>.py. Adding a
configuration, a traffic mix, a metric or a cell adds files and entries;
nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)
TRAFFIC_DIR = os.path.join(BENCH_DIR, "traffic")
METRICS_DIR = os.path.join(BENCH_DIR, "metrics")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: str = REPO_DIR) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(path: str, what: str) -> dict:
    if not os.path.isfile(path):
        raise ValueError(f"no {what} file {path}")
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, bench: dict, root: str = REPO_DIR) -> Cell:
    """The cell `name` of `bench` with its files read."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise ValueError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]), "configuration")
    mix = _load_json(os.path.join(TRAFFIC_DIR, f"{w['traffic']}.json"), "traffic")
    return Cell(name, int(w["chips"]), config, mix,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric_name: str):
    """The `read(run)` function of portbench/metrics/<metric_name>.py."""
    path = os.path.join(METRICS_DIR, f"{metric_name}.py")
    if not os.path.isfile(path):
        raise ValueError(f"no reader for metric {metric_name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric_name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
