"""BENCHMARK.json against the benchmark's contract, and every cell, traffic,
configuration, limit and per-layer metric found by name."""

import json
import os
import re

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json"),
              encoding="utf-8") as fh:
        return json.load(fh)


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) < 65536


def test_configs_resolve(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(spec.ROOT, c["file"]), encoding="utf-8") as fh:
            config = json.load(fh)
        # each key the file says it changed from the source is listed
        listed = {r.split(":")[0] for r in config["reduced"] + [
            a for a in config["assumed"] if a.startswith("model.")]}
        assert listed <= set(c["reduced"])
        assert os.path.exists(os.path.join(spec.ROOT, config["input"]))


def test_cells_resolve(bench):
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = spec.load_cell(w["name"])
        assert cell.traffic["batches"] and cell.traffic["level"] >= 1
        for key in ("frag_gap_ha", "total_gap_ha"):
            lim = cell.limits[key]
            assert lim["lower"] < lim["limit"] < lim["upper"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer


def test_metrics_resolve(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert callable(spec.metric_reader(m["name"]))


def test_run_seconds_fits_the_check(bench):
    cells = 24
    runs = 2 + 14 * cells
    seconds = runs * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert 1 <= bench["run_seconds"] <= 51 and seconds <= 43200


def test_readers_without_a_trace_return_nothing():
    from benchmark.harness.cell import RunRecord

    record = RunRecord(0, 0.0, {}, [], None, 0, {})
    for name in ("roofline.eigh", "roofline.fermi_density",
                 "device_idle_share"):
        assert spec.metric_reader(name)(record) is None
