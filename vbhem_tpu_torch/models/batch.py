"""VBEM over a bank of subjects: the counterpart of
:mod:`vbhem_tpu.models.batch` (`src/hmm/vbhmm_learn_batch.m:56-78`).

:func:`learn_bank` learns one HMM per subject with the whole bank in one
EM loop: subjects x restarts are the lanes [S, L] of one
:func:`.vbhmm.vbem_em`, so each EM iteration is one launch of kernel B2
over every sequence of every lane.  With ``config.learn_hyps`` every
subject's unique restart solutions are hyp-optimized together as lanes of
one L-BFGS (:func:`.vbhmm.learn_hyps_lanes`).  :func:`learn_batch` learns
subjects one at a time, or (``learn_hyps_batch``) one hyperparameter set
shared by all subjects (`vbhmm_learn_batch.m:107-457`).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import hyp as hypmod
from ..config import VBConfig
from ..containers import SeqBatch, tree_map
from ..utils import profiling
from . import vbhmm
from .rescore import vbem_rescore_lanes


def learn_bank(gen: torch.Generator, batches: Sequence[SeqBatch], k: int,
               config: VBConfig = VBConfig()):
    """Learn one K-state HMM per subject, the whole bank batched.

    Every subject's batch must have the same shape (pad sequences to a
    common T and count); otherwise this raises ValueError, and
    :func:`learn_batch` learns them one by one.  Restarts start from
    random GMM fits (`vbhmm_init.m:25-91`).  In float32 each subject's
    restart is picked on its float64 bound.

    With ``config.learn_hyps`` (`vbhmm_learn.m:498-552` per subject): one
    lane per (subject, uniqueLL survivor), each subject padded with its
    best survivor to min(max_hyp_solutions, restarts) lanes, the lanes'
    data gathered per lane, one batched L-BFGS over all of them, the
    rerun, the fallback of degraded and degenerate lanes, and each
    subject's best lane (on its float64 bound in float32); the kept
    lanes' hyps in ``info['learned_hyps']`` (leaves [S] and [S, D]).

    Returns (list of VBHMMResult, info dict with ``model_em_iters``, the
    EM iterations the restarts ran, and with hyps on the stage's counts
    under 'hyp_*' keys, see :func:`.vbhmm.learn_hyps_lanes`)."""
    with profiling.span("learn_bank"):
        return _learn_bank(gen, batches, k, config)


def _learn_bank(gen, batches, k, config):
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

    with profiling.span("learn_bank.starts"):
        post0 = vbhmm.random_init(gen, bank, k, hyps0, config.covar_type,
                                  lanes=(numtrials,))
    with profiling.span("learn_bank.em"):
        states = vbhmm.vbem_em(bank, post0, hyps0, max_iter=config.max_iter,
                               min_diff=config.min_diff,
                               covar_type=config.covar_type)  # lanes [S, L]
    info = {"model_em_iters": int(torch.max(states.it))}
    subj = torch.arange(n_subj, device=dev)
    if config.learn_hyps:
        final = _learn_bank_hyps(bank, states, hyps0, numtrials, config, info)
    else:
        with profiling.span("learn_bank.pick"):
            if dtype == torch.float32:
                # per-subject restart selection on float64 bounds
                best = torch.argmax(
                    vbem_rescore_lanes(bank, states.post, hyps0), dim=1)
            else:
                best = torch.argmax(states.ll, dim=1)
            final = tree_map(lambda a: a[subj, best], states)
    with profiling.span("learn_bank.finalize"):
        res = vbhmm.finalize(bank, final)
        if config.sortclusters:
            res = vbhmm.standardize(res, config.sortclusters)
    with profiling.span("learn_bank.split"):
        return [tree_map(lambda a, i=i: a[i], res)
                for i in range(n_subj)], info


def _learn_bank_hyps(bank: SeqBatch, states, hyps0, numtrials: int,
                     config: VBConfig, info: dict):
    """The hyp stage of :func:`learn_bank`: returns the kept lane of every
    subject (lanes [S]) and fills ``info``."""
    lls = states.ll.detach().cpu().double().numpy()      # [S, trials]
    cap = numtrials if config.max_hyp_solutions is None \
        else config.max_hyp_solutions
    n_lane = min(cap, numtrials)
    lane_subj, lane_trial = [], []
    for si in range(lls.shape[0]):
        uniq = hypmod.unique_ll(lls[si], config.min_diff)[:n_lane]
        if len(uniq) == 0:
            uniq = np.asarray([int(np.argmax(lls[si]))])
        uniq = np.concatenate([uniq, np.full((n_lane - len(uniq),),
                                             uniq[0])])
        lane_subj.extend([si] * n_lane)
        lane_trial.extend(int(t) for t in uniq)
    dev = bank.x.device
    si_idx = torch.as_tensor(lane_subj, device=dev)
    ti_idx = torch.as_tensor(lane_trial, device=dev)
    lane_data = SeqBatch(x=bank.x[si_idx], lengths=bank.lengths[si_idx])
    sts, hyps_b = vbhmm.learn_hyps_lanes(
        lane_data, states, (si_idx, ti_idx), hyps0, config,
        per_lane_data=True, info=info)
    if bank.x.dtype == torch.float32:
        # per-subject lane selection on float64 bounds
        lane_ll = vbem_rescore_lanes(lane_data, sts.post, hyps_b)
        info["lane_ll_f64"] = lane_ll.cpu().numpy()
    else:
        lane_ll = sts.ll
    # each subject's n_lane lanes are consecutive
    best = torch.argmax(lane_ll.reshape(-1, n_lane), dim=1)
    picks = torch.arange(len(best), device=dev) * n_lane + best
    info["learned_hyps"] = tree_map(lambda a: a[picks], hyps_b)
    return tree_map(lambda a: a[picks], sts)


def learn_batch(gen: torch.Generator, batches: Sequence[SeqBatch], k: int,
                config: VBConfig = VBConfig(),
                learn_hyps_batch: bool = False, keep_inits: int = 3):
    """Learn one HMM per subject with :func:`.vbhmm.learn`, one subject at
    a time; returns (results, {}).

    With ``learn_hyps_batch`` (reference `vbopt.learn_hyps_batch`,
    `vbhmm_learn_batch.m:107-457`): every subject's restarts run under the
    config's hyps and its ``keep_inits`` best unique solutions are kept;
    one hyperparameter set shared by all subjects is optimized (SciPy's
    L-BFGS-B, :func:`..hyp.optimize_hyps`) over the summed best-solution
    bounds divided by the subject count, each evaluation one EM over every
    (subject, kept solution) lane; then every subject refits from its kept
    solutions under the shared hyps and keeps its best.  Returns (results,
    info with 'learned_hyps' and the optimizer's info).  Subjects of
    different shapes fall back to per-subject learning with untied hyps."""
    if not learn_hyps_batch:
        return [vbhmm.learn(gen, b, k, config)[0] for b in batches], {}

    dim = batches[0].x.shape[-1]
    dtype, dev = batches[0].x.dtype, batches[0].x.device
    hyps0 = vbhmm.VBHyps.from_config(config, dim, dtype, dev)
    # 1) per-subject restarts under the base hyps; keep the top unique
    #    solutions (`vbhmm_learn_batch.m:107-117`)
    kept = []
    for b in batches:
        states = vbhmm.fit_single_k(gen, b, k, config, hyps0)
        uniq = hypmod.unique_ll(states.ll.detach().cpu().numpy(),
                                config.min_diff)[:keep_inits]
        idx = list(uniq) + [int(uniq[0])] * (keep_inits - len(uniq))
        kept.append(tree_map(
            lambda a: a[torch.as_tensor(idx, device=dev)], states.post))

    if len({(tuple(b.x.shape), tuple(b.lengths.shape))
            for b in batches}) != 1:
        # heterogeneous subjects: per-subject hyp learning, untied
        return ([vbhmm.learn(gen, b, k, config)[0] for b in batches],
                {"note": "heterogeneous shapes: untied hyps"})

    bank = SeqBatch(x=torch.stack([b.x for b in batches]),
                    lengths=torch.stack([b.lengths for b in batches]))
    posts = tree_map(lambda *xs: torch.stack(xs), *kept)   # lanes [S, M]
    specs = hypmod.vb_specs(dim, config.bounds, config.learn_hyps_keys)

    def neg_total(hyps):
        with torch.no_grad():
            st = vbhmm.vbem_em(bank, posts, tree_map(torch.Tensor.detach,
                                                      hyps),
                               max_iter=config.max_iter,
                               min_diff=config.min_diff,
                               covar_type=config.covar_type)
            post = st.post
            fb = vbhmm.e_step(bank, post)
            stats = vbhmm.suff_stats(bank, fb)
        lls = vbhmm.elbo(bank, post, fb, stats, hyps)   # [S, M]
        # each subject by its best solution, normalized by the subject
        # count (`vbhmm_learn_batch.m:455-457`)
        return -torch.sum(torch.max(lls, dim=1).values) / len(batches)

    hyps_opt, opt_info = hypmod.optimize_hyps(neg_total, hyps0, specs)

    # 3) per-subject refits from the kept solutions under the shared hyps
    sts = vbhmm.vbem_em(bank, posts, hyps_opt, max_iter=config.max_iter,
                        min_diff=config.min_diff,
                        covar_type=config.covar_type)
    best = torch.argmax(sts.ll, dim=1)
    subj = torch.arange(len(batches), device=dev)
    res = vbhmm.finalize(bank, tree_map(lambda a: a[subj, best], sts))
    if config.sortclusters:
        res = vbhmm.standardize(res, config.sortclusters)
    results = [tree_map(lambda a, i=i: a[i], res)
               for i in range(len(batches))]
    return results, {"learned_hyps": hyps_opt, **opt_info}
