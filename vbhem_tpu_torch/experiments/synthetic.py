"""The synthetic ground-truth benchmark: data generation, the
multi-method pipeline and its model selection — the counterpart of
:mod:`vbhem_tpu.experiments.synthetic`: the ground truth and its sampling
(``gt_hmms``, ``sample_dataset``), per-subject VBEM
(``learn_subject_hmms``), VBHEM over the padded (K, S) grid
(``run_vbhem``), the VHEM baseline over a (K, S) grid with AIC/BIC, DIC
over the learned VBHEM grid, CCFD (``run_ccfd``) and PPK spectral
clustering over a (K, S) grid with AIC/BIC (``run_ppk_grid``).

Parity map: `Synthetic_experiment/exprmt1_sampledata.m` (ground truth:
2 HMMs x 2 states, shared Gaussians at (0,0)/(3,3) with identity
covariance, transition matrices [.6 .4;.4 .6] vs [.4 .6;.6 .4];
datasets of 2 clusters x 20 HMMs x 25 seqs x T=50 plus N(0, 0.1)
noise), `exprmt1_demo.m` (VBEM -> VBHEM grid -> VHEM -> CCFD -> PPK) and
the recovery scoring of `evaluate_vbhem_jounarl.m` (Rand index, purity,
K and S selected).  Everything here runs on the device of the bank it is
given; randomness comes from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import HEMConfig, VBConfig, VBHEMConfig
from ..containers import HMM, SeqBatch, resolve_device
from ..models import hmm_tools, vbhem, vbhmm, vhem
from ..utils.metrics import purity, rand_index


def gt_hmms(dtype=torch.float64, device="cuda"):
    """The two ground-truth HMMs (`exprmt1_sampledata.m:21-43`), on
    ``device`` (the card unless the caller names another)."""
    device = resolve_device(device)

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)
    mean = t([[0.0, 0.0], [3.0, 3.0]])
    cov = torch.eye(2, dtype=dtype, device=device).expand(2, 2, 2).clone()
    prior = t([0.5, 0.5])
    h1 = HMM(prior=prior, trans=t([[0.6, 0.4], [0.4, 0.6]]), mean=mean,
             cov=cov)
    h2 = HMM(prior=prior, trans=t([[0.4, 0.6], [0.6, 0.4]]), mean=mean,
             cov=cov)
    return h1, h2


class SyntheticDataset(NamedTuple):
    batches: List[SeqBatch]     # one per subject (HMM)
    labels: np.ndarray          # [Kb] ground-truth cluster of each subject


def sample_dataset(gen: torch.Generator, n_per_cluster: int = 20,
                   n_seqs: int = 25, t: int = 50, noise: float = 0.1,
                   dtype=torch.float64, device="cuda") -> SyntheticDataset:
    """Sample one dataset (`exprmt1_sampledata.m:51-87`): for each
    ground-truth HMM in turn, ``n_per_cluster`` subjects of ``n_seqs``
    sequences of length ``t``, plus N(0, noise^2) noise.

    Every draw comes from ``gen`` in that order (per subject: the chain,
    the emission noise, the added noise), on the generator's device, and
    the data is built on the CPU and then moved to ``device`` (the card
    unless the caller names another).  With a CPU generator a seed gives
    the same dataset on any device.  The JAX package derives each
    subject's key by ``fold_in``; ``jax.random`` and torch cannot match
    bit for bit, so the draws differ from the JAX package's."""
    device = resolve_device(device)
    batches, labels = [], []
    for gi, h in enumerate(gt_hmms(dtype, device="cpu")):
        for _ in range(n_per_cluster):
            _, x = hmm_tools.sample(gen, h, t=t, n=n_seqs)
            x = x + noise * torch.randn(x.shape, generator=gen,
                                        device=gen.device,
                                        dtype=dtype).to(x.device)
            batches.append(SeqBatch(
                x=x.to(device),
                lengths=torch.full((n_seqs,), t, dtype=torch.int32,
                                   device=device)))
            labels.append(gi)
    return SyntheticDataset(batches=batches, labels=np.asarray(labels))


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


def run_ccfd(gen: Optional[torch.Generator], results, labels,
             ds: Optional[SyntheticDataset] = None,
             n_samples: int = 100) -> Dict:
    """CCFD density-peak clustering on symmetric-KL distances
    (`exprmt1_demo.m:155-178`).  K is selected automatically by the
    outlier detection, S is the subject-HMM state count."""
    from ..models import ccfd as ccfd_mod
    hmms = [r.model for r in results]
    data = ds.batches if ds is not None else None
    res = ccfd_mod.ccfd(gen, hmms, data=data, n_samples=n_samples)
    lab = res.label
    s = results[0].model.mean.shape[0]
    return {"result": res, "score": RecoveryScore(
        rand_index=rand_index(lab, labels)[0], purity=purity(lab, labels),
        best_k=int(lab.max()) + 1, best_s=s, labels=lab)}


def run_ppk_grid(gen: torch.Generator, banks_by_s: Dict[int, list],
                 ds: SyntheticDataset, labels, k_grid=range(1, 7)) -> Dict:
    """PPK spectral clustering over the (K, S) grid with AIC/BIC selection
    from the held-in data log-likelihood
    (`exprmt1_demo.m:180-258` + `evaluate_vbhem_jounarl.m:239-296`).

    Each bank's log-likelihood table of every sequence under every bank
    HMM is one :func:`..models.hmm_tools.loglik` call (the reference loops
    center HMMs x subjects, `exprmt1_demo.m:236-251`); the cells'
    spectral clusterings draw their k-means seeds from ``gen`` in grid
    order (S outer, K inner)."""
    from ..models import ppk as ppk_mod
    ks = list(k_grid)
    ss = sorted(banks_by_s)
    d = banks_by_s[ss[0]][0].model.mean.shape[-1]
    lengths = [b.lengths.detach().cpu().numpy() for b in ds.batches]
    n_obs = int(sum(ln.sum() for ln in lengths))

    all_batch = SeqBatch(x=torch.cat([b.x for b in ds.batches], dim=0),
                         lengths=torch.cat([b.lengths for b in ds.batches],
                                           dim=0))

    def bank_ll_table(hmms):
        hb = vbhem.h3m_from_hmms(list(hmms),
                                 device=all_batch.x.device).hmm
        return hmm_tools.loglik(all_batch, hb).detach().cpu().numpy()

    cells, ll_grid = {}, np.full((len(ks), len(ss)), -np.inf)
    for si, s in enumerate(ss):
        hmms = [r.model for r in banks_by_s[s]]
        gram = ppk_mod.gram_matrix(hmms)
        ll_table = bank_ll_table(hmms)                 # [n_hmms, n_seqs]
        for ki, k in enumerate(ks):
            assign, centers, u = ppk_mod.spectral_cluster(gen, gram, k)
            # cluster centers: the input HMM nearest each spectral centroid
            center_idx = np.zeros((k,), np.int64)
            for j in range(k):
                members = np.where(assign == j)[0]
                pool = members if len(members) else np.arange(len(hmms))
                d2 = ((u[pool] - centers[j]) ** 2).sum(axis=1)
                center_idx[j] = pool[int(np.argmin(d2))]
            weight = np.array([(assign == j).mean() for j in range(k)])
            # data log-likelihood under the mixture of center HMMs
            # (exprmt1_demo.m:236-251)
            lls = ll_table[center_idx].T             # [n_seqs, K]
            mix = np.log(weight + 1e-300)[None, :] + lls
            mx = mix.max(axis=1)
            ll = float(np.sum(mx + np.log(
                np.exp(mix - mx[:, None]).sum(axis=1))))
            cells[(k, s)] = {"label": assign, "center_idx": center_idx,
                             "ll": ll}
            ll_grid[ki, si] = ll

    out = {"cells": cells, "ll": ll_grid, "k_grid": ks, "s_grid": ss}
    for crit in ("aic", "bic"):
        grid = np.full_like(ll_grid, np.inf)
        for ki, k in enumerate(ks):
            for si, s in enumerate(ss):
                pars = _num_params(k, s, d)
                pen = 2 * pars if crit == "aic" else np.log(n_obs) * pars
                grid[ki, si] = -2 * ll_grid[ki, si] + pen
        ki, si = np.unravel_index(np.argmin(grid), grid.shape)
        lab = cells[(ks[ki], ss[si])]["label"]
        out[crit] = grid
        out[crit + "_score"] = RecoveryScore(
            rand_index=rand_index(lab, labels)[0],
            purity=purity(lab, labels), best_k=ks[ki], best_s=ss[si],
            labels=lab)
    return out
