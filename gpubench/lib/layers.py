"""Readers shared by the per-layer metric files under ``metrics/``: each
takes the run's context (the measured or traced jobs' records, the trace
window) and returns a number, or None where the run has nothing to read.

A job record holds ``work`` (the job's shapes and EM iterations, from the
program's ``info``), ``counters`` (the program's kernel launch counters,
increments over the job), ``seconds`` and ``peak_bytes``.
"""
from __future__ import annotations

import re

from . import bounds

B1 = "pair_estep_fused_kernel"
B2 = "fb_resident_kernel"


def _is_double(name: str) -> bool:
    return "double" in name or re.search(r"kernelId", name) is not None


def em_iters(ctx, counter: str, exact: bool):
    """EM iterations per job (each one launch of the kernel ``counter``),
    cross-checked with that counter: equal (``exact``) or at least as
    many launches; a job that fails the check gives no reading."""
    if not ctx.jobs:
        return None
    for job in ctx.jobs:
        n, it = job["counters"][counter], job["work"]["em_iters"]
        if (n != it) if exact else (n < it):
            return None
    return sum(j["work"]["em_iters"] for j in ctx.jobs) / len(ctx.jobs)


def kernels_per_iter(ctx):
    """Device kernels in the traced window over its EM iterations."""
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.traced["work"]["em_iters"]


def device_idle(ctx):
    """Share (%) of the traced window with no kernel, copy or set running."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def peak_gib(ctx):
    """The largest device memory any job allocated at once (GiB)."""
    if not ctx.jobs:
        return None
    return max(j["peak_bytes"] for j in ctx.jobs) / 2 ** 30


def b1_roofline(ctx):
    """B1's share (%) of its bound over the traced job's launches: each
    chunk's launches at the bound of its lanes, each at its own cell's S,
    against B1's device time in the trace."""
    if ctx.trace is None:
        return None
    w = ctx.traced["work"]
    n, secs = ctx.trace.kernel_time_s(lambda name: B1 in name)
    if n == 0 or n != w["em_iters"]:
        return None
    cells = w["lane_cells"]
    step = w["chunk"] or len(cells)
    chunks = [cells[a:a + step] for a in range(0, len(cells), step)]
    bound_ms = sum(
        it * bounds.b1_bound_live(w["kb"], chunks[c % len(chunks)],
                                  w["kmax"], w["sb"], w["smax"], w["d"],
                                  w["tau"], w["itemsize"])["bound_ms"]
        for c, it in enumerate(w["chunk_iters"]))
    return 100.0 * bound_ms / 1e3 / secs


def b2_roofline(ctx):
    """B2's share (%) of its bound over the traced job's EM launches (the
    fused entry in the run's dtype, one a lane EM iteration), each at the
    bound of the full bank of lanes with every step valid (the traffic's
    sequences all have T steps), against their device time."""
    if ctx.trace is None:
        return None
    w = ctx.traced["work"]
    n, secs = ctx.trace.kernel_time_s(
        lambda name: B2 in name and not _is_double(name))
    if n == 0 or n != w["em_iters"]:
        return None
    lanes = (w["subjects"], w["restarts"])
    one = bounds.b2_fused_bound(lanes, w["n"], w["t"], w["k"], w["d"],
                                w["itemsize"],
                                lanes[0] * lanes[1] * w["n"] * w["t"])
    return 100.0 * n * one["bound_ms"] / 1e3 / secs
