"""The traced job: one job under ``torch.profiler``, read back from its
Chrome trace into device intervals, kernels by name, the busy and idle
time of the window and the longest idle gaps by what the host was doing.
"""
from __future__ import annotations

import bisect
import json
import tempfile
from pathlib import Path

import torch

WINDOW_SPAN = "gpubench.job"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class TraceWindow:
    """What the per-layer readers read of one traced job.

    ``kernels``: [(name, start_us, dur_us)] of every kernel in the window;
    ``window_s``: the job's span on the host; ``busy_s``: the union of the
    device's kernel, copy and set intervals within it."""

    def __init__(self, events: list):
        span = [e for e in events if e.get("name") == WINDOW_SPAN
                and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
        if not span:
            raise ValueError(f"the trace has no {WINDOW_SPAN} span")
        t0 = float(span[0]["ts"])
        t1 = t0 + float(span[0]["dur"])
        self.window_s = (t1 - t0) / 1e6
        dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events if e.get("cat") in DEVICE_CATS
                     and e.get("ph") == "X")
        self.kernels = [(e["name"], float(e["ts"]), float(e["dur"]))
                        for e in events if e.get("cat") == "kernel"
                        and e.get("ph") == "X"]
        merged = []
        for a, b in dev:
            a, b = max(a, t0), min(b, t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) / 1e6
        ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in events
                     if e.get("cat") == "cpu_op" and e.get("ph") == "X")
        self._ops, self._starts = ops, [o[0] for o in ops]
        edges = [t0] + [x for ab in merged for x in ab] + [t1]
        self.gaps = [(edges[i], edges[i + 1])
                     for i in range(0, len(edges), 2)
                     if edges[i + 1] > edges[i]]

    def host_at(self, t: float) -> str:
        """The innermost host operation running at time ``t`` (us)."""
        i = bisect.bisect_right(self._starts, t)
        for j in range(i - 1, max(-1, i - 200), -1):
            start, end, name = self._ops[j]
            if end >= t:
                return name
        return "host, between operations"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        summed by what the host was doing, each at most ``top``
        [name, seconds]."""
        by_op, by_gap = {}, {}
        for name, _, dur in self.kernels:
            by_op[name] = by_op.get(name, 0.0) + dur / 1e6
        for a, b in self.gaps:
            key = self.host_at(0.5 * (a + b))
            by_gap[key] = by_gap.get(key, 0.0) + (b - a) / 1e6

        def head(d):
            return [[k[:160], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": head(by_op), "idle_gaps": head(by_gap)}

    def kernel_time_s(self, match) -> tuple:
        """(count, seconds) of the kernels whose name ``match`` accepts."""
        durs = [dur for name, _, dur in self.kernels if match(name)]
        return len(durs), sum(durs) / 1e6


def traced(fn):
    """Run ``fn`` under the profiler inside a span named WINDOW_SPAN;
    returns (fn's result, TraceWindow).  The trace is written to a
    temporary directory under TMPDIR and read back."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            out = fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return out, TraceWindow(events)
