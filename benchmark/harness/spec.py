"""A cell of `BENCHMARK.json` and the files it names, found by name:

- `benchmark/configs/<config>.json`: the configuration (the upstream input
  and what the cell changes in it, the working dtype);
- `benchmark/traffic/<traffic>.json`: the traffic (MBE level, driver, the
  geometries' displacement, the batches, the steps compared and traced);
- `benchmark/limits/<cell>.json`: the limits of the numbers the check
  compares, each with the readings it was set from;
- `benchmark/metrics/<metric>.py`: the reader of each per-layer metric.

A later cell, traffic mix, configuration or metric is new files and new
entries in `BENCHMARK.json`: no file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

#: the checkout's root: the folder that holds `benchmark/`
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_DIR = os.path.join(ROOT, "benchmark")


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    limits: dict
    #: the BENCHMARK.json entries of the metrics this cell reports
    end_to_end: list
    per_layer: list


def _json(*parts) -> dict:
    with open(os.path.join(BENCH_DIR, *parts), encoding="utf-8") as fh:
        return json.load(fh)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    """The cell `name` of BENCHMARK.json with its files."""
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as fh:
        bench = json.load(fh)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return Cell(
        name,
        _json("configs", entry["config"] + ".json"),
        _json("traffic", entry["traffic"] + ".json"),
        _json("limits", name + ".json"),
        [m for m in bench["end_to_end"] if _reports(m, name)],
        [m for m in bench["per_layer"] if _reports(m, name)],
    )


def metric_reader(name: str):
    """The `read(run)` function of benchmark/metrics/<name>.py."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
