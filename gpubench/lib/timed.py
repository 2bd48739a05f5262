"""One call of the program timed to the end of its device work, with the
program's kernel launch counters read around it."""
from __future__ import annotations

import time

import torch


def counters() -> dict:
    """The program's kernel launch counters (module globals it keeps)."""
    from vbhem_tpu_torch.ops import fb_cuda, pair_estep_cuda
    return {"B1": pair_estep_cuda.LAUNCHES,
            "B3": pair_estep_cuda.BWD_FWD_LAUNCHES,
            "B2": fb_cuda.LAUNCHES, "B2_fused": fb_cuda.FUSED_LAUNCHES}


def timed(fn):
    """Run ``fn`` to the end of its device work: (result, seconds, peak
    bytes allocated during it, counter increments)."""
    card = torch.cuda.is_available()
    before = counters()
    if card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    if card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if card else 0
    after = counters()
    return out, seconds, peak, {k: after[k] - before[k] for k in after}


def cfg_value(v):
    """A configuration file's value as the program's config takes it."""
    return tuple(v) if isinstance(v, list) else v
