"""Readers of the program's own spans and counters, for the per-layer
metric files under ``metrics/``.

While a profiler window records, the program records too
(``vbhem_tpu_torch.utils.profiling``): its recorder keeps the spans and
counters of its last root span, so after the traced job it holds the
job's ``cluster_batched`` or ``learn_bank`` call, each span timed by
``time.perf_counter_ns``.  A program without that recorder, or a recorder
that does not hold the root asked for, gives no reading.

The spans are put on the trace's clock (``lib/trace.TraceWindow``) by
one offset, read from a short profiler window of the reader's own: a
``record_function`` span whose trace time lies between two
``perf_counter_ns`` readings.  The trace window keeps
each kernel's device start, not its launch; every EM iteration ends on
its ``done`` check, whose sync waits for the kernels the iteration
launched, so those kernels start inside its span.  Only a loop's first
iteration may also hold kernels queued before the loop that had not
started yet.
"""
from __future__ import annotations

import bisect
import json
import tempfile
import time
from pathlib import Path

import torch

ANCHOR = "gpubench.anchor"
_offset_us = []


def recorder():
    """The program's recorder, or None where the program has none."""
    try:
        from vbhem_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "RECORDER", None)


def root_tree(ctx, root: str):
    """(the root span named ``root``, the spans of its tree, the recorder)
    of the traced job, or None."""
    rec = recorder()
    if ctx.trace is None or rec is None:
        return None
    roots = [s for s in rec.spans if s.parent is None and s.name == root]
    if len(roots) != 1:
        return None
    top = roots[0]
    return top, [s for s in rec.spans if s.root == top.id], rec


def union(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint [a, b]."""
    out = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(xs, ys) -> float:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def trace_offset_us() -> float:
    """What to add to ``perf_counter_ns() / 1e3`` for the profiler trace's
    clock (us): from the narrowest of a few ANCHOR spans of a host-only
    profiler window, each bracketed by two ``perf_counter_ns`` readings.
    Read once a process."""
    if not _offset_us:
        brackets = []
        acts = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            for i in range(8):
                t0 = time.perf_counter_ns()
                with torch.profiler.record_function(f"{ANCHOR}.{i}"):
                    t1 = time.perf_counter_ns()
                brackets.append((t0, t1))
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "anchor.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        ts = {e["name"]: float(e["ts"]) for e in events
              if str(e.get("name", "")).startswith(ANCHOR + ".")
              and e.get("ph") == "X"}
        i = min(range(len(brackets)),
                key=lambda i: brackets[i][1] - brackets[i][0])
        mid = 0.5 * (brackets[i][0] + brackets[i][1]) / 1e3
        _offset_us.append(ts[f"{ANCHOR}.{i}"] - mid)
    return _offset_us[0]


def em_loop(ctx, root: str, engine: str, offset_us=None):
    """The traced job's ``<engine>.iter`` spans on the trace's clock: (the
    union of them, as [[start_us, end_us]], their number, the kernels
    that start inside them), or None where there are none, or no kernel
    starts inside them (they are then not on the trace's clock)."""
    tree = root_tree(ctx, root)
    if tree is None:
        return None
    its = [s for s in tree[1] if s.name == f"{engine}.iter"]
    if not its:
        return None
    off = trace_offset_us() if offset_us is None else offset_us
    spans = union((s.start_ns / 1e3 + off, s.end_ns / 1e3 + off)
                  for s in its)
    starts = sorted(start for _, start, _ in ctx.trace.kernels)
    n = sum(bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)
            for a, b in spans)
    return (spans, len(its), n) if n else None


def lane_occupancy(ctx, root: str, engine: str):
    """100 x the lanes' own EM iterations (``<engine>.lane_iters_active``)
    over the lane-iterations the loop ran (``.lane_iters_launched``) in
    the traced job."""
    tree = root_tree(ctx, root)
    if tree is None:
        return None
    counters = tree[2].counters
    launched = counters.get(f"{engine}.lane_iters_launched", 0)
    if launched <= 0:
        return None
    return 100.0 * counters.get(f"{engine}.lane_iters_active", 0) / launched


def em_kernels_per_iter(ctx, root: str, engine: str, offset_us=None):
    """Device kernels that start inside an ``<engine>.iter`` span, over
    the number of those spans."""
    loop = em_loop(ctx, root, engine, offset_us)
    return None if loop is None else loop[2] / loop[1]


def em_idle(ctx, root: str, engine: str, offset_us=None):
    """Share (%) of the union of the ``<engine>.iter`` spans with no
    kernel, copy or set running on the device."""
    loop = em_loop(ctx, root, engine, offset_us)
    if loop is None:
        return None
    spans = loop[0]
    return 100.0 * overlap(spans, ctx.trace.gaps) / sum(b - a
                                                        for a, b in spans)


def outside_em_s(ctx, root: str):
    """Seconds of the traced job's root span outside the union of its
    ``<root>.em`` spans."""
    tree = root_tree(ctx, root)
    if tree is None:
        return None
    top, spans = tree[0], tree[1]
    em = union((max(s.start_ns, top.start_ns), min(s.end_ns, top.end_ns))
               for s in spans if s.name == f"{root}.em")
    if not em:
        return None
    return (top.end_ns - top.start_ns - sum(b - a for a, b in em)) / 1e9
