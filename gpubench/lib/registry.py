"""Where the harness finds each piece by the names in ``BENCHMARK.json``:
a configuration's file (its ``file`` entry), a traffic mix
(``traffic/<mix>.json``), the job kind that the mix names
(``jobs/<kind>.py``: what one job is, its readings, its control), a
metric's reader (``metrics/<metric>.py``) and a cell's correctness limits
(``limits/<cell>.json``).  Adding a cell, a mix, a job kind or a metric
adds files and entries; nothing here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "gpubench"


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config_file(bench: dict, name: str, root: Path = ROOT) -> Path:
    for c in bench["configs"]:
        if c["name"] == name:
            return root / c["file"]
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic_file(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def job_module(kind: str):
    """The module ``jobs/<kind>.py`` of a traffic file's ``"job"``: its
    ``Job``, ``readings``, ``control``, ``tiny`` and ``FAULTS``."""
    if not kind.isidentifier():
        raise KeyError(f"job kind {kind!r} is not a module name")
    return importlib.import_module(f"gpubench.jobs.{kind}")


def metric_file(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def limits_file(cell_name: str) -> Path:
    return HERE / "limits" / f"{cell_name}.json"


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def end_to_end(bench: dict, cell_name: str) -> list:
    """The end-to-end metrics a cell reports: those without ``workloads``
    and those that list it."""
    return [m for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(bench: dict, cell_name: str) -> list:
    """The per-layer metrics a cell reports: those that list it, and
    those without ``workloads`` whose ``moves`` the cell reports."""
    moved = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def reader(name: str):
    """The ``read(ctx)`` function of the metric file named ``name``."""
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
