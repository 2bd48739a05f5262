"""VBEM over a bank of subjects: the counterpart of
:mod:`vbhem_tpu.models.batch` (`src/hmm/vbhmm_learn_batch.m:56-78`).

:func:`learn_bank` learns one HMM per subject with the whole bank in one
EM loop: subjects x restarts are the lanes [S, L] of one
:func:`.vbhmm.vbem_em`, so each EM iteration is one launch of kernel B2
over every sequence of every lane.  Hyperparameter learning is not ported
yet (ROADMAP.md queue A, item A4).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..config import VBConfig
from ..containers import SeqBatch, tree_map
from . import vbhmm
from .rescore import vbem_rescore_lanes


def learn_bank(gen: torch.Generator, batches: Sequence[SeqBatch], k: int,
               config: VBConfig = VBConfig()):
    """Learn one K-state HMM per subject, the whole bank batched.

    Every subject's batch must have the same shape (pad sequences to a
    common T and count); otherwise this raises ValueError, and
    :func:`learn_batch` learns them one by one.  Restarts start from
    random GMM fits (`vbhmm_init.m:25-91`).  In float32 each subject's
    restart is picked on its float64 bound.  Returns (list of VBHMMResult,
    info dict with ``model_em_iters``, the EM iterations the bank ran)."""
    if config.learn_hyps:
        raise NotImplementedError(vbhmm._HYPS_NOT_PORTED)
    shapes = {(tuple(b.x.shape), tuple(b.lengths.shape)) for b in batches}
    if len(shapes) != 1:
        raise ValueError(f"learn_bank needs subjects of one shape, got "
                         f"{sorted(shapes)}; use learn_batch")
    n_subj = len(batches)
    bank = SeqBatch(x=torch.stack([b.x for b in batches]),
                    lengths=torch.stack([b.lengths for b in batches]))
    dtype, dev = bank.x.dtype, bank.x.device
    hyps0 = vbhmm.VBHyps.from_config(config, bank.x.shape[-1], dtype, dev)
    numtrials = 1 if k == 1 else config.numtrials

    post0 = vbhmm.random_init(gen, bank, k, hyps0, config.covar_type,
                              lanes=(numtrials,))
    states = vbhmm.vbem_em(bank, post0, hyps0, max_iter=config.max_iter,
                           min_diff=config.min_diff,
                           covar_type=config.covar_type)  # lanes [S, L]
    if dtype == torch.float32:
        # per-subject restart selection on float64 bounds
        best = torch.argmax(vbem_rescore_lanes(bank, states.post, hyps0),
                            dim=1)
    else:
        best = torch.argmax(states.ll, dim=1)
    subj = torch.arange(n_subj, device=dev)
    final = tree_map(lambda a: a[subj, best], states)
    res = vbhmm.finalize(bank, final)
    if config.sortclusters:
        res = vbhmm.standardize(res, config.sortclusters)
    info = {"model_em_iters": int(torch.max(states.it))}
    return [tree_map(lambda a, i=i: a[i], res)
            for i in range(n_subj)], info


def learn_batch(gen: torch.Generator, batches: Sequence[SeqBatch], k: int,
                config: VBConfig = VBConfig(),
                learn_hyps_batch: bool = False):
    """Learn one HMM per subject with :func:`.vbhmm.learn`, one subject at
    a time.  A hyperparameter vector shared by all subjects
    (``learn_hyps_batch``) is not ported yet.  Returns (results, {})."""
    if learn_hyps_batch:
        raise NotImplementedError(
            "learn_hyps_batch=True is not ported yet: ROADMAP.md queue A "
            "item 'hyperparameter learning' (A4)")
    return [vbhmm.learn(gen, b, k, config)[0] for b in batches], {}
