"""Tracing and profiling helpers: the counterpart of
:mod:`vbhem_tpu.utils.profiling`, the replacement for the reference's
`tic/toc` instrumentation (`hem_h3m_c_step.m:33,508`,
`vbhem_h3m_cluster.m:377-385`).

  * :class:`PhaseTimer`: named wall-clock phases; ``block_on`` waits for
    the CUDA devices of the given tensors, so the card's work is counted
    in the phase that queued it.
  * :func:`device_trace`: a ``torch.profiler`` window (host and, where
    there is a card, device activity) exported as a Chrome trace.

Unlike the JAX module, nothing here swallows an error: a profiler that
cannot start raises.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict

import torch


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in ``tree`` (a tensor, or lists,
    tuples, dicts and NamedTuples of them)."""
    if torch.is_tensor(tree):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*[_cuda_devices(t) for t in tree])
    return set()


def block_until_ready(tree):
    """Wait until the work queued on the CUDA devices of ``tree``'s tensors
    has finished; returns ``tree``."""
    for dev in _cuda_devices(tree):
        torch.cuda.synchronize(dev)
    return tree


class PhaseTimer:
    """Accumulating named phase timer.

    >>> pt = PhaseTimer()
    >>> with pt.phase("e_step", block_on=out):     # doctest: +SKIP
    ...     out = e_step(...)
    >>> print(pt.summary())                        # doctest: +SKIP

    ``block_on`` is read when the phase ends, so it may name the tensors
    the phase fills (a list or dict to which the block appends)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = []
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:24s} {t:9.3f}s  x{self.counts[name]:<5d}"
                         f" {100.0 * t / total:5.1f}%")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str, name: str = "trace.json"):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is available) and write a Chrome trace to
    ``logdir/name`` (open it in chrome://tracing or Perfetto).  Yields
    the profiler, whose ``key_averages()`` summarize the window."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / name))
