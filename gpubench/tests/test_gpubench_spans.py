"""The readers of the program's spans and counters (``lib/spans.py``) on a
hand-made Chrome trace and hand-made program spans, and the trace
window's existing readings unchanged by the program's annotations and the
CUDA runtime's launch events."""
import json
from types import SimpleNamespace

import pytest
import torch

from gpubench.lib import layers, spans
from gpubench.lib.trace import TraceWindow
from vbhem_tpu_torch.utils import profiling

OFFSET = 500.0        # trace us = perf_counter ns / 1e3 + OFFSET


def _x(name, cat, ts, dur, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


KERNELS = [(2000.0, 300.0), (2600.0, 400.0), (3000.0, 500.0),
           (4700.0, 1000.0), (6600.0, 200.0), (7000.0, 1000.0),
           (9000.0, 500.0)]
EVENTS = [_x("gpubench.job", "user_annotation", 1000.0, 10000.0),
          _x("aten::mul", "cpu_op", 1900.0, 200.0),
          _x("aten::_local_scalar_dense", "cpu_op", 3500.0, 1100.0),
          _x("Memcpy DtoH", "gpu_memcpy", 8400.0, 50.0)] + [
    _x("void pair_estep_fused_kernel<float, 2, 5, 2, 2, true>"
       if i == 3 else f"kernel{i}", "kernel", ts, dur, correlation=i)
    for i, (ts, dur) in enumerate(KERNELS)]
# the program's spans on the trace's clock: (name, start_us, end_us,
# parent's index); the root first
SPANS = [("cluster_batched", 1500.0, 10500.0, None),
         ("cluster_batched.starts", 1600.0, 2500.0, 0),
         ("cluster_batched.em", 2500.0, 8500.0, 0),
         ("vbhem_em.iter", 2500.0, 4500.0, 2),
         ("vbhem_em.iter", 4500.0, 6500.0, 2),
         ("vbhem_em.iter", 6500.0, 8500.0, 2),
         ("cluster_batched.rescore", 8600.0, 10000.0, 0),
         ("cluster_batched.select", 10000.0, 10400.0, 0)]
# what the program adds to the trace: its annotations, and the runtime's
# launch of each kernel
ADDED = [_x(n, "user_annotation", a, b - a) for n, a, b, _ in SPANS] + [
    _x("cudaLaunchKernel", "cuda_runtime", ts - 40.0, 8.0, correlation=i)
    for i, (ts, _) in enumerate(KERNELS)]


def _recorder():
    rec = profiling.Recorder()
    for i, (name, a, b, parent) in enumerate(SPANS):
        rec.spans.append(profiling.Span(
            name, int((a - OFFSET) * 1e3), int((b - OFFSET) * 1e3), i + 1,
            None if parent is None else parent + 1, 1))
    rec.counters = {"vbhem_em.lane_iters_active": 30,
                    "vbhem_em.lane_iters_launched": 96}
    return rec


@pytest.fixture
def ctx(monkeypatch):
    rec = _recorder()
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    return SimpleNamespace(trace=TraceWindow(EVENTS + ADDED), traced={},
                           jobs=[])


def test_readers_by_hand(ctx):
    # kernels starting inside the iterations' union 2500-8500: five
    assert spans.em_kernels_per_iter(ctx, "cluster_batched", "vbhem_em",
                                     OFFSET) == pytest.approx(5 / 3)
    # idle inside 2500-8500: 2500-2600, 3500-4700, 5700-6600, 6800-7000,
    # 8000-8400 and 8450-8500
    assert spans.em_idle(ctx, "cluster_batched", "vbhem_em", OFFSET) == \
        pytest.approx(100.0 * 2850.0 / 6000.0)
    # the root's 9000 us less the em span's 6000
    assert spans.outside_em_s(ctx, "cluster_batched") == pytest.approx(3e-3)
    assert spans.lane_occupancy(ctx, "cluster_batched", "vbhem_em") == \
        pytest.approx(31.25)


def test_readers_give_nothing_to_read(ctx, monkeypatch):
    # another root, another engine, spans off the trace's clock, no trace
    for read in (lambda: spans.outside_em_s(ctx, "learn_bank"),
                 lambda: spans.lane_occupancy(ctx, "learn_bank", "vbem_em"),
                 lambda: spans.em_idle(ctx, "cluster_batched", "vbem_em",
                                       OFFSET),
                 lambda: spans.em_kernels_per_iter(
                     ctx, "cluster_batched", "vbhem_em", OFFSET + 1e7)):
        assert read() is None
    # a program without the recorder
    monkeypatch.setattr(spans, "recorder", lambda: None)
    assert spans.outside_em_s(ctx, "cluster_batched") is None
    for read in (spans.lane_occupancy, spans.em_idle,
                 spans.em_kernels_per_iter):
        assert read(ctx, "cluster_batched", "vbhem_em") is None
    assert spans.outside_em_s(SimpleNamespace(trace=None),
                              "cluster_batched") is None


def test_union_and_overlap():
    assert spans.union([(5, 7), (1, 3), (2, 4), (8, 8)]) == [[1, 4], [5, 7]]
    assert spans.overlap([[1, 4], [5, 7]], [(0, 2), (3, 6)]) == 3


def test_existing_readings_unchanged_by_the_added_events():
    plain, more = TraceWindow(EVENTS), TraceWindow(EVENTS + ADDED)
    assert more.busy_s == plain.busy_s
    assert more.gaps == plain.gaps and more.kernels == plain.kernels
    assert more.window_s == plain.window_s
    assert more.breakdown() == plain.breakdown()
    work = {"em_iters": 3}
    for tw in (plain, more):
        c = SimpleNamespace(trace=tw, traced={"work": work}, jobs=[])
        assert layers.kernels_per_iter(c) == pytest.approx(7 / 3)
        assert layers.device_idle(c) == pytest.approx(
            100.0 * (1.0 - 3950.0 / 10000.0))


def test_offset_puts_recorded_spans_on_the_trace_clock(tmp_path):
    """A span recorded under a host-only profiler window lands, through
    ``trace_offset_us``, where the trace put its annotation (within the
    annotation's own cost on a loaded host)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("probe"):
            torch.ones(8).sum()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    ann = next(e for e in events if e.get("name") == "probe"
               and e.get("cat") == "user_annotation")
    s = profiling.RECORDER.spans[-1]
    assert s.name == "probe" and s.parent is None
    off = spans.trace_offset_us()
    assert abs(s.start_ns / 1e3 + off - float(ann["ts"])) < 2000.0
    assert abs(s.end_ns / 1e3 + off - float(ann["ts"]) - float(ann["dur"])) \
        < 2000.0
