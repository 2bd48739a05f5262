"""The traced window's arithmetic on a hand-made Chrome trace."""
import pytest

from gpubench.lib import layers
from gpubench.lib.trace import TraceWindow
from types import SimpleNamespace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _x("gpubench.job", "user_annotation", 1000.0, 1000.0),
    _x("aten::mul", "cpu_op", 1000.0, 150.0),
    _x("aten::sum", "cpu_op", 1500.0, 300.0),
    _x("void pair_estep_fused_kernel<float, 2, 5, 2, 2, true>", "kernel",
       1100.0, 200.0),
    _x("void fb_resident_kernel<double, 2>", "kernel", 1250.0, 100.0),
    _x("Memcpy DtoH", "gpu_memcpy", 1600.0, 100.0),
    _x("late kernel", "kernel", 2100.0, 50.0),      # after the window
]


def test_busy_idle_and_gaps():
    tw = TraceWindow(EVENTS)
    assert tw.window_s == pytest.approx(1e-3)
    # device busy 1100-1350 and 1600-1700 inside the window 1000-2000
    assert tw.busy_s == pytest.approx(350e-6)
    assert [(a, b) for a, b in tw.gaps] == [(1000.0, 1100.0),
                                            (1350.0, 1600.0),
                                            (1700.0, 2000.0)]
    bd = tw.breakdown()
    assert bd["device_ops"][0][0].startswith("void pair_estep_fused_kernel")
    # each gap named by the host operation running at its middle
    assert dict(bd["idle_gaps"]) == pytest.approx(
        {"aten::mul": 100e-6, "host, between operations": 550e-6})
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    ctx = SimpleNamespace(trace=tw, traced=None, jobs=[])
    assert layers.device_idle(ctx) == pytest.approx(65.0)


def test_window_needs_its_span():
    with pytest.raises(ValueError):
        TraceWindow(EVENTS[1:])


def test_b2_roofline_counts_the_runs_dtype_only():
    tw = TraceWindow(EVENTS + [
        _x("void fb_resident_kernel<float, 2>", "kernel", 1400.0, 100.0)])
    work = {"subjects": 8192, "restarts": 20, "n": 25, "t": 50, "d": 2,
            "k": 2, "itemsize": 4, "em_iters": 1}
    ctx = SimpleNamespace(trace=tw, traced={"work": work}, jobs=[])
    # one float32 launch of 100 us against a bound of 1.0314 ms
    assert layers.b2_roofline(ctx) == pytest.approx(100.0 * 1.0314 / 0.1,
                                                    rel=1e-4)
