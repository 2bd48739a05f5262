"""The synthetic ground-truth benchmark's two stages and its model
selection: per-subject VBEM (``learn_subject_hmms``), VBHEM over the
padded (K, S) grid, the VHEM baseline over a (K, S) grid with AIC/BIC,
and DIC over the learned VBHEM grid — the counterpart of
``RecoveryScore``, ``default_vb_config``, ``default_vbhem_config``,
``learn_subject_hmms``, ``run_vbhem``, ``run_vhem``, ``run_vhem_grid`` and
``run_vbhem_dic`` in :mod:`vbhem_tpu.experiments.synthetic` (its dataset
sampling is not ported yet: ROADMAP.md queue A, item A6).

Parity map: `Synthetic_experiment/exprmt1_demo.m:114-148` (VHEM grid) and
the recovery scoring of `evaluate_vbhem_jounarl.m` (Rand index, purity,
K and S selected).  Everything here runs on the device of the bank it
is given; randomness comes from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config import HEMConfig, VBConfig, VBHEMConfig
from ..models import vbhem, vbhmm, vhem
from ..utils.metrics import purity, rand_index


class RecoveryScore(NamedTuple):
    rand_index: float
    purity: float
    best_k: int
    best_s: int
    # hard labels of the selected model (for the Dunn index,
    # `evaluate_vbhem_jounarl.m:107-113`)
    labels: Optional[object] = None
    # per-surviving-cluster pruned state counts
    # (`evaluate_vbhem_jounarl.m:92-105`); None for methods without
    # per-cluster state selection
    s_list: Optional[object] = None


def _labels(res) -> np.ndarray:
    return res.label.detach().cpu().numpy()


def _bank(results):
    """The point-estimate base bank of ``results``, on their device."""
    return vbhem.h3m_from_results(results, use_post=False,
                                  device=results[0].model.mean.device)


def default_vb_config() -> VBConfig:
    """VBEM settings of `exprmt1_demo.m:28-47` (S=2, default hyps with
    the synthetic data's m0 and W0), as the JAX package sets them:
    ``learn_hyps`` on (`exprmt1_demo.m:38`), with the uniqueLL survivors
    that get hyp-optimized capped at 5 per subject (the reference
    optimizes every survivor)."""
    return VBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=20,
                    learn_hyps=True, max_hyp_solutions=5,
                    hyp_max_steps=50)


def default_vbhem_config(trials: int = 50) -> VBHEMConfig:
    """VBHEM settings of `exprmt1_demo.m:66-79`, as the JAX package sets
    them: ``learn_hyps`` on (the reference default,
    `vbhem_h3m_cluster.m:188`), with the same 5-survivor cap per grid cell
    as the VBEM stage."""
    return VBHEMConfig(alpha0=1e6, m0=(1.5, 1.5), w0=1.0, nv=100,
                       tau=50, trials=trials, initmode="baseem",
                       learn_hyps=True, max_hyp_solutions=5,
                       hyp_max_steps=50)


def learn_subject_hmms(gen: torch.Generator, ds, s: int = 2,
                       config: Optional[VBConfig] = None,
                       info: Optional[dict] = None):
    """Per-subject VBEM (`exprmt1_demo.m:47`, vbhmm_learn_batch): ``ds`` is
    a sequence of ``SeqBatch`` (one per subject) or has them as
    ``.batches``.  Subjects of one shape are learned as one bank
    (:func:`..models.batch.learn_bank`: all subjects' restarts in one EM
    loop, every subject's hyp optimization in one lane-batched L-BFGS);
    otherwise one at a time.  Returns the list of results; ``info``, if
    given, receives the bank's info (``learn_bank``'s keys)."""
    from ..models import batch as batch_mod
    config = config or default_vb_config()
    batches = list(getattr(ds, "batches", ds))
    shapes = {(tuple(b.x.shape), tuple(b.lengths.shape)) for b in batches}
    if len(shapes) == 1:
        results, bank_info = batch_mod.learn_bank(gen, batches, s, config)
        if info is not None:
            info.update(bank_info)
        return results
    return [vbhmm.learn(gen, b, s, config)[0] for b in batches]


def run_vbhem(gen: torch.Generator, results, labels, k_grid=range(1, 7),
              s_grid=range(1, 6), config: Optional[VBHEMConfig] = None):
    """VBHEM over the (K, S) grid and its recovery scoring
    (`exprmt1_demo.m:64-108` + `evaluate_vbhem_jounarl.m:86-118`), on the
    padded grid (:func:`..models.vbhem.cluster_batched`, with the grid's
    hyp optimization where ``config.learn_hyps``, as at the default
    settings), on the device of ``results``.  As the reference scores it, K, S and the labels come
    after ``vbh3m_remove_empty``: K the surviving clusters, S each
    surviving HMM's pruned state count (`evaluate_vbhem_jounarl.m:92-105`).
    Returns (result, info, RecoveryScore)."""
    config = config or default_vbhem_config()
    base = vbhem.h3m_from_results(results, use_post=config.use_post,
                                  covar_type=config.covar_type,
                                  device=results[0].post.alpha.device)
    res, info = vbhem.cluster_batched(gen, base, list(k_grid),
                                      list(s_grid), config)
    res, hmm_list = vbhem.vbh3m_remove_empty(res)
    lab = _labels(res)
    s_list = [int(h.model.prior.shape[0]) for h in hmm_list]
    return res, info, RecoveryScore(
        rand_index=rand_index(lab, labels)[0], purity=purity(lab, labels),
        best_k=len(hmm_list), best_s=int(np.median(s_list)), labels=lab,
        s_list=s_list)


def run_vhem(gen: torch.Generator, results, labels, k: int = 2, s: int = 2,
             config: Optional[HEMConfig] = None):
    """VHEM baseline on the same bank (`exprmt1_demo.m:114-148`)."""
    config = config or HEMConfig(trials=20, nv=100, tau=10)
    res = vhem.cluster(gen, _bank(results), k, s, config)
    lab = _labels(res)
    return res, RecoveryScore(rand_index=rand_index(lab, labels)[0],
                              purity=purity(lab, labels), best_k=k,
                              best_s=s, labels=lab)


def _vhem_expected_ll(res, nv: float) -> float:
    """log_ests of the VHEM AIC/BIC criteria
    (`evaluate_vbhem_jounarl.m:180-182`): the expected data
    log-likelihood reconstructed from the soft assignments Z and the
    per-pair lower bounds,
      sum_ij Z_ij (log omega_j - log Z_ij + Nv * L_elbo_ij)
    with omega_j = (1/Kb) sum_i Z_ij.  On the host in float64: the 1e-50 /
    1e-300 floors underflow to 0 in float32."""
    z = res.z.detach().cpu().double().numpy()
    ll_elbo = res.ll_elbo.detach().cpu().double().numpy()
    omega = z.sum(axis=0) / z.shape[0]
    return float(np.sum(z * (np.log(omega + 1e-300)[None, :]
                             - np.log(z + 1e-50) + nv * ll_elbo)))


def _num_params(k: int, s: int, d: int) -> int:
    """Free parameters of a K-cluster, S-state, D-dim H3M
    (`evaluate_vbhem_jounarl.m:180,215`)."""
    return (k - 1) + k * ((s - 1) + s * (s - 1) + s * 2 * d)


def run_vhem_grid(gen: torch.Generator, results, labels, k_grid=range(1, 7),
                  s_grid=range(1, 6),
                  config: Optional[HEMConfig] = None) -> Dict:
    """VHEM over the (K, S) grid with AIC/BIC model selection
    (`exprmt1_demo.m:114-148` + `evaluate_vbhem_jounarl.m:160-239`).

    Beside the JAX package's keys, ``em_iters`` maps each cell to the EM
    iterations its ``cluster`` call ran (one pair E-step each)."""
    config = config or HEMConfig(trials=20, nv=100, tau=10)
    base = _bank(results)
    kb = len(results)
    d = results[0].model.mean.shape[-1]
    n_bic = config.nv * kb * config.tau

    ks, ss = list(k_grid), list(s_grid)
    cells, em_iters = {}, {}
    aic = np.full((len(ks), len(ss)), np.inf)
    bic = np.full((len(ks), len(ss)), np.inf)
    for ki, k in enumerate(ks):
        for si, s in enumerate(ss):
            # identity shortcut disabled: its placeholder LogL/Z are not
            # comparable with trained cells' expected LL
            info = {}
            res = vhem.cluster(gen, base, k, s, config,
                               allow_identity_shortcut=False, info=info)
            cells[(k, s)] = res
            em_iters[(k, s)] = info["em_iters"]
            log_ests = _vhem_expected_ll(res, config.nv)
            aic[ki, si] = 2 * (k * s * (s + 2 * d) - 1) - 2 * log_ests
            bic[ki, si] = (np.log(n_bic) * _num_params(k, s, d)
                           - 2 * log_ests)

    out = {"cells": cells, "aic": aic, "bic": bic, "k_grid": ks,
           "s_grid": ss, "em_iters": em_iters}
    for crit, grid in (("aic", aic), ("bic", bic)):
        ki, si = np.unravel_index(np.argmin(grid), grid.shape)
        res = cells[(ks[ki], ss[si])]
        lab = _labels(res)
        # reference scoring (`evaluate_vbhem_jounarl.m:470-477`):
        # K_select = clusters with members, S_select = per nonempty
        # cluster the count of states with emit_vcounts > 1e-3
        sizes = np.bincount(lab, minlength=ks[ki])
        nonempty = np.where(sizes > 0)[0]
        ec = res.emit_counts.detach().cpu().numpy()
        s_list = [int((ec[j] > 1e-3).sum()) for j in nonempty]
        out[crit + "_score"] = RecoveryScore(
            rand_index=rand_index(lab, labels)[0],
            purity=purity(lab, labels), best_k=len(nonempty),
            best_s=int(np.median(s_list)), labels=lab, s_list=s_list)
    return out


def run_vbhem_dic(info: Dict, base, tau: int, labels) -> Dict:
    """DIC model selection over the learned VBHEM grid cells
    (`myDIC.m`; min-DIC selection of `evaluate_vbhem_jounarl.m:124-152`),
    on the vb path (synthetic=False), as the reference's own synthetic
    evaluation calls it (`evaluate_vbhem_jounarl.m:148`)."""
    from ..models.dic import dic
    ks = sorted({k for k, _ in info["model_all"]})
    ss = sorted({s for _, s in info["model_all"]})
    dics = np.full((len(ks), len(ss)), np.inf)
    for ki, k in enumerate(ks):
        for si, s in enumerate(ss):
            if (k, s) in info["model_all"]:
                _, dval = dic(base, info["model_all"][(k, s)], tau)
                dics[ki, si] = dval
    ki, si = np.unravel_index(np.argmin(dics), dics.shape)
    # the reference prunes the DIC-selected cell before scoring
    # (`evaluate_vbhem_jounarl.m:516-533`)
    res, hmm_list = vbhem.vbh3m_remove_empty(
        info["model_all"][(ks[ki], ss[si])])
    lab = _labels(res)
    s_list = [int(h.model.prior.shape[0]) for h in hmm_list]
    return {"dic": dics, "score": RecoveryScore(
        rand_index=rand_index(lab, labels)[0], purity=purity(lab, labels),
        best_k=len(hmm_list), best_s=int(np.median(s_list)),
        labels=lab, s_list=s_list)}
