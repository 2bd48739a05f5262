"""Float64 re-evaluation of the VBEM bound of many lanes at once: the
counterpart of :func:`vbhem_tpu.models.rescore.vbem_rescore_lanes`.

When compute is float32, the restarts, the K and the bank's lanes are
picked on the float64 bound of each lane's solution (`vbhmm.py:518-543`,
`batch.py:125-152` of the JAX package).  The JAX package evaluates it on
the host in NumPy, one lane at a time, because the TPU has no float64.
Here it is this package's own E-step, statistics and bound run in float64
on the lanes' device, all lanes in one pass (on the card, the float64
instantiation of kernel B2's fused E-step).  The VBHEM grid rescoring is
not ported yet (ROADMAP.md queue A, 'f64 rescoring').
"""
from __future__ import annotations

import math

import torch

from ..containers import HMMPosterior, SeqBatch, tree_map
from . import vbhmm


def vbem_rescore_lanes(batch: SeqBatch, posts: HMMPosterior,
                       hyps: vbhmm.VBHyps) -> torch.Tensor:
    """The 8-term VBEM bound (`vbhmm_em_lb.m:120-257`) in float64 of every
    lane of ``posts`` (lanes [*X, *L] over the data's axes X, as in
    :mod:`.vbhmm`), with one set of hyperparameters.  A lane whose bound is
    NaN scores -inf.  Returns float64 [*X, *L] on the lanes' device."""
    vbhmm.check_lengths(batch)
    f64 = torch.float64
    b = SeqBatch(x=batch.x.to(f64), lengths=batch.lengths)
    p = tree_map(lambda a: a.to(f64), posts)
    h = tree_map(lambda a: a.to(f64), hyps)
    fb = vbhmm.e_step(b, p)
    stats = vbhmm.suff_stats(b, fb)
    ll = vbhmm.elbo(b, p, fb, stats, h)
    return torch.where(torch.isnan(ll), torch.full_like(ll, -math.inf), ll)
