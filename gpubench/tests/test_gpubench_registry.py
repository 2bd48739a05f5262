"""BENCHMARK.json against the benchmark's contract, and every cell
resolved to its files by name."""
import json
import re

import pytest

from conftest import CELLS
from gpubench.lib import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return registry.load_benchmark()


def test_benchmark_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["gpubench"]
    assert bench["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert "\n" not in w["why"] and "\t" not in w["why"]
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert len(json.dumps(bench)) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(bench, name):
    cell = registry.cell(bench, name)
    config = registry.load_json(registry.config_file(bench, cell["config"]))
    traffic = registry.load_json(registry.traffic_file(cell["traffic"]))
    kind = registry.job_module(traffic["job"])
    for attr in ("Job", "readings", "control", "tiny", "FAULTS"):
        assert hasattr(kind, attr), attr
    assert registry.limits_file(name).is_file()
    e2e = registry.end_to_end(bench, name)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = registry.per_layer(bench, name)
    assert layer
    moved = {m["name"] for m in e2e}
    for m in e2e + layer:
        assert callable(registry.reader(m["name"]))
        assert m.get("moves", m["name"]) in moved | {m["name"]}
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    for key in config["reduced"]:
        assert key in config and key in config["assumed"]


def test_every_config_is_used(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
