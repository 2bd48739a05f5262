"""Tracing and profiling helpers: the counterpart of
:mod:`vbhem_tpu.utils.profiling`, the replacement for the reference's
`tic/toc` instrumentation (`hem_h3m_c_step.m:33,508`,
`vbhem_h3m_cluster.m:377-385`).

  * The recorder: :func:`span` (a named, nested phase of the program) and
    :func:`count` (a named counter), kept in memory by :data:`RECORDER`
    while recording is on: inside :func:`recording`, and while a
    ``torch.profiler`` window records.  Off, a span or counter site costs
    one boolean test: no torch call, no device sync, no allocation.
  * :class:`PhaseTimer`: named wall-clock phases, a summary over the spans
    of a recorder; ``block_on`` waits for the CUDA devices of the given
    tensors, so the card's work is counted in the phase that queued it.
  * :func:`device_trace`: a ``torch.profiler`` window (host and, where
    there is a card, device activity) exported as a Chrome trace, the
    only exporter: while it records, every span is also a
    ``record_function`` annotation on the trace's clock.

Unlike the JAX module, nothing here swallows an error: a profiler that
cannot start raises.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import torch
# its ``_is_profiler_enabled`` is the flag PyTorch sets while a profiler
# window records, and reads for its own fast checks
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()
_forced = 0                      # depth of open ``recording()`` blocks
_ids = itertools.count(1)


class Span(NamedTuple):
    """One closed span: times from ``time.perf_counter_ns``; ``root`` is
    the id of the outermost span it was opened in (its own id for a
    root), which serves as the request id."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    root: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Recorder:
    """Spans and counters in memory.  With ``last_root_only`` a root span
    (one opened with no span open) clears what the recorder held, so it
    keeps the spans and counters of the last root span."""

    def __init__(self, last_root_only: bool = False):
        self.last_root_only = last_root_only
        self.spans: list = []
        self.counters: Dict[str, int] = {}
        self._open: list = []            # (id, root) of the open spans

    def clear(self):
        self.spans, self.counters = [], {}

    def span(self, name: str) -> "_Open":
        """A context manager that records the span ``name``."""
        return _Open(self, name)


class _Open:
    __slots__ = ("rec", "name", "id", "parent", "root", "t0", "annotation")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        if rec._open:
            self.parent, self.root = rec._open[-1]
        else:
            self.parent = None
            if rec.last_root_only:
                rec.clear()
        self.id = next(_ids)
        if self.parent is None:
            self.root = self.id
        rec._open.append((self.id, self.root))
        self.annotation = None
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = _autograd_profiler.record_function(self.name)
            self.annotation.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        rec = self.rec
        rec._open.pop()
        rec.spans.append(Span(self.name, self.t0, t1, self.id, self.parent,
                              self.root))
        return False


# The program's recorder: the spans and counters of the last root span
# recorded.
RECORDER = Recorder(last_root_only=True)


def active() -> bool:
    """Whether spans and counters are being recorded."""
    return bool(_forced or _autograd_profiler._is_profiler_enabled)


def span(name: str):
    """A context manager for the program phase ``name``: recorded by
    :data:`RECORDER` while recording is on, and then also a
    ``record_function`` annotation while a profiler window records."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return RECORDER.span(name)


def count(name: str, n: int):
    """Add ``n`` to the counter ``name`` while recording is on."""
    if _forced or _autograd_profiler._is_profiler_enabled:
        RECORDER.counters[name] = RECORDER.counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record spans and counters in the block; yields :data:`RECORDER`,
    emptied on entry."""
    global _forced
    RECORDER.clear()
    _forced += 1
    try:
        yield RECORDER
    finally:
        _forced -= 1


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
    """Accumulating named phase timer: a summary over the spans of
    ``recorder`` (its own by default; :data:`RECORDER` for the phases the
    program recorded in its last root span).

    >>> pt = PhaseTimer()
    >>> with pt.phase("e_step", block_on=out):     # doctest: +SKIP
    ...     out = e_step(...)
    >>> print(pt.summary())                        # doctest: +SKIP

    ``block_on`` is read when the phase ends, so it may name the tensors
    the phase fills (a list or dict to which the block appends)."""

    def __init__(self, recorder: Optional[Recorder] = None):
        self.recorder = Recorder() if recorder is None else recorder

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        with self.recorder.span(name):
            try:
                yield
            finally:
                if block_on is not None:
                    block_until_ready(block_on)

    @property
    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in self.recorder.spans:
            out[s.name] = out.get(s.name, 0.0) + s.seconds
        return out

    @property
    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self.recorder.spans:
            out[s.name] = out.get(s.name, 0) + 1
        return out

    def summary(self) -> str:
        totals, counts = self.totals, self.counts
        total = sum(totals.values()) or 1.0
        lines = []
        for name, t in sorted(totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:24s} {t:9.3f}s  x{counts[name]:<5d}"
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
