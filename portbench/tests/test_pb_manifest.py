"""BENCHMARK.json against the benchmark's contract: keys, names, units,
lengths, bounds, and every name backed by a file under portbench/."""
import json
import re

import pytest

from portbench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return registry.manifest()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"][:2] == ["python3", "portbench/run.py"]
    assert all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_lines(bench):
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append((section, e["name"]))
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        own = [n for s, n in names if s == section or (s in ("end_to_end", "per_layer")
                                                        and section in ("end_to_end", "per_layer"))]
        assert len(own) == len(set(own))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])


def test_end_to_end_and_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in bench["workloads"]]
    for cell in cells:
        mine = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert registry.metrics_of(cell, "per_layer", bench)


def test_per_layer_entries(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_name_has_its_file(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for c in configs.values():
        data = json.loads((registry.ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/") and data["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        cell = registry.workload(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"] and w["config"] in configs
        assert cell["mode"] in registry.names("modes")
    for m in bench["per_layer"]:
        read, _ = registry.metric_reader(m["name"])
        assert callable(read)
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(configs)
