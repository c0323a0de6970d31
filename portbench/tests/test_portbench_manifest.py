"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""
import json
import math
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        return json.load(f)


def test_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24


def test_names_units_and_lines(bench):
    entries = bench["configs"] + bench["workloads"] + bench["end_to_end"] \
        + bench["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key], (e["name"], key)
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[section]]
        assert len(names) == len(set(names)), section
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))


def test_cells_found_by_name(bench):
    from portbench import spec

    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        pairs.add((w["config"], w["traffic"]))
        s = spec.workload(w["name"])
        assert (s["config"], s["traffic"], s["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert os.path.isfile(os.path.join(ROOT, "portbench", "drivers",
                                           s["driver"] + ".py"))
        assert "plan_mismatch" in s["check"]["limits"]
    assert len(pairs) == len(bench["workloads"])
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, math.floor(0.25 * len(bench["workloads"])))


def test_metrics_have_readers_and_cover_every_cell(bench):
    from portbench import spec

    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert callable(spec.reader(m["name"]))
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads")
        for cell in m["workloads"]:
            assert moved is None or cell in moved, (m["name"], cell)
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.add(m["layer"])
        assert callable(spec.reader(m["name"]))
    for w in bench["workloads"]:
        own = [m for m in bench["end_to_end"]
               if "workloads" not in m or w["name"] in m["workloads"]]
        assert len(own) >= 2
        assert any(w["name"] in m["workloads"] for m in bench["per_layer"])


def test_each_kernel_roofline_has_a_step_share_beside_it(bench):
    per = bench["per_layer"]
    for m in per:
        if m["name"].split(".")[0].endswith("_roofline"):
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       and set(m["workloads"]) <= set(o["workloads"])
                       for o in per), m["name"]
