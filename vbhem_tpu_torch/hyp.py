"""Hyperparameter helpers of :mod:`vbhem_tpu.hyp` that the port needs so
far.  Hyperparameter learning itself is not ported yet (ROADMAP.md queue
A, 'hyperparameter learning')."""
from __future__ import annotations

import numpy as np


def unique_ll(lls, min_diff: float = 1e-5) -> np.ndarray:
    """Indices of unique restart solutions by LL, best first
    (`src/util/uniqueLL.m:41-80`): two LLs are duplicates when their
    relative difference is below 2 * min_diff * 10; non-finite LLs are
    dropped."""
    lls = np.asarray(lls, dtype=np.float64)
    order = np.argsort(-lls)
    thresh = 2.0 * min_diff * 10.0
    kept: list = []
    for i in order:
        if not np.isfinite(lls[i]):
            continue
        dup = any(abs(lls[i] - lls[j])
                  / max(abs(lls[j]), 1e-300) < thresh for j in kept)
        if not dup:
            kept.append(int(i))
    return np.asarray(kept, dtype=np.int64)
