"""Shared helpers of the harness's CPU tests: the checkout on sys.path,
the ``card`` marker, the cells of ``BENCHMARK.json`` and tiny copies of
them (each job kind's ``tiny``) that the program's CPU path (its plain
PyTorch version of every kernel) runs in seconds."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where none is found")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")


def tiny_cell(name: str):
    """(bench, cell, tiny config, traffic, limits, job kind's module) of
    the cell ``name``, its configuration cut by the job kind's ``tiny``."""
    from gpubench.lib import registry
    bench = registry.load_benchmark()
    cell = registry.cell(bench, name)
    traffic = registry.load_json(registry.traffic_file(cell["traffic"]))
    kind = registry.job_module(traffic["job"])
    config = kind.tiny(registry.load_json(
        registry.config_file(bench, cell["config"])))
    limits = registry.load_json(registry.limits_file(name))
    return bench, cell, config, traffic, limits, kind


def run_tiny(name: str, seed: int = 2 ** 31 + 11):
    """One run of the tiny cell on the CPU through the harness's own
    ``measure``: set-up, one job, the comparison; returns the result."""
    import torch
    from gpubench import run
    bench, cell, config, traffic, limits, _ = tiny_cell(name)
    return run.measure(bench, cell, config, traffic, limits, seed, 0.0, 0,
                       torch.device("cpu"))


def _cells():
    from gpubench.lib import registry
    return [w["name"] for w in registry.load_benchmark()["workloads"]]


def _faults():
    out = []
    for name in CELLS:
        _, _, _, _, _, kind = tiny_cell(name)
        out += [(name, f) for f in kind.FAULTS]
    return out


# every cell of BENCHMARK.json, and every fault its job kind can have
CELLS = _cells()
FAULTS = _faults()
