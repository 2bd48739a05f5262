"""Grouped VBEM: per-group priors and transitions with shared Gaussian
emissions, the reference's `usegroups` mode (`vbhmm_em.m:62-91, 159-183,
355-363` and the per-group forward-backward of `vbhmm_fb.m:81-93`): the
counterpart of :mod:`vbhem_tpu.models.vbhmm_groups`.

Used where the trials of one subject come from conditions (different
stimuli) whose dynamics differ while the ROIs are shared.  ``group_map``
[N] assigns each sequence to a group 0..G-1.

Restart lanes lead every posterior field, as in :mod:`.vbhmm`:
``alpha [*L, G, K]``, ``epsilon [*L, G, K, K]``, the shared ``niw``
[*L, K, ...]; the data (one ``SeqBatch``) is shared by the lanes.  The
E-step gathers each sequence's group scores, log_pz1 [*L, N, K] and
log_trans [*L, N, K, K], and runs kernel B2 with those per-sequence
scores (``fb_cuda.e_step_auto``: the fused entry where it takes the
shape, else entry 1 on log_rho formed in PyTorch; the plain version on
the CPU).  :func:`vbem_em` runs all lanes with a per-lane ``done`` mask.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import hyp as hypmod
from ..config import VBConfig
from ..containers import HMMPosterior, NIW, SeqBatch, tree_map
from ..ops.fb import FBStats
from ..ops.fb_cuda import e_step_auto
from ..utils.numeric import (block_cast, e_log_det_lambda, e_log_dirichlet,
                             lane_hyp, log_dirichlet_const, log_wishart_b,
                             logdet_psd, tiny)
from . import vbhmm
from .lanes import lane_where, run_lanes, settle, start, within
from .vbhmm import SuffStats, VBHyps


class GroupedPosterior(NamedTuple):
    alpha: torch.Tensor    # [..., G, K]
    epsilon: torch.Tensor  # [..., G, K, K]
    niw: NIW               # shared across groups: [..., K, ...]

    @property
    def num_groups(self) -> int:
        return self.alpha.shape[-2]

    @property
    def num_states(self) -> int:
        return self.alpha.shape[-1]


class GroupedStats(NamedTuple):
    shared: SuffStats       # pooled statistics of the shared emissions
    nk1_g: torch.Tensor     # [..., G, K] per-group initial counts
    m_g: torch.Tensor       # [..., G, K, K] per-group transition counts


def _group_rows(a: torch.Tensor, group_map: torch.Tensor,
                axis: int) -> torch.Tensor:
    """Each sequence's row of ``a`` along its group ``axis``: [..., G, ...]
    -> [..., N, ...]."""
    return torch.index_select(a, a.dim() + axis, group_map)


def e_step(batch: SeqBatch, post: GroupedPosterior,
           group_map: torch.Tensor) -> FBStats:
    """Every lane's E-step with each sequence under its group's dynamics:
    per-sequence scores log_pz1 [..., N, K] and log_trans [..., N, K, K],
    then kernel B2 on the card (``e_step_auto``), the plain version on
    the CPU.  Every sequence must have a step."""
    x, mask = vbhmm._views(batch, post.alpha.shape[:-2])
    log_pz1 = _group_rows(e_log_dirichlet(post.alpha), group_map, -2)
    log_trans = _group_rows(e_log_dirichlet(post.epsilon), group_map, -3)
    return e_step_auto(x, mask, log_pz1, log_trans, post.niw)


def grouped_stats(batch: SeqBatch, fb: FBStats, group_map: torch.Tensor,
                  n_groups: int) -> GroupedStats:
    """The pooled statistics of the shared emissions and each group's
    initial and transition counts."""
    one_hot = torch.nn.functional.one_hot(group_map, n_groups).to(
        fb.gamma.dtype)                                      # [N, G]
    nk1_g = torch.einsum("ng,...nk->...gk", one_hot, fb.gamma[..., 0, :])
    m_g = torch.einsum("ng,...nkl->...gkl", one_hot, fb.xi_sum)
    return GroupedStats(shared=vbhmm.suff_stats(batch, fb), nk1_g=nk1_g,
                        m_g=m_g)


def m_step(stats: GroupedStats, hyps: VBHyps,
           covar_type: str = "full") -> GroupedPosterior:
    """Per-group Dirichlet updates and the shared NIW update
    (`vbhmm_em.m:355-363` + `:365-408`).  ``hyps`` is one set or one per
    lane."""
    shared = vbhmm.m_step(stats.shared, hyps, covar_type)
    alpha = lane_hyp(hyps.alpha0, 0, 2) + stats.nk1_g \
        + tiny(stats.nk1_g.dtype)
    epsilon = lane_hyp(hyps.epsilon0, 0, 3) + stats.m_g
    return GroupedPosterior(alpha=alpha, epsilon=epsilon, niw=shared.niw)


def elbo(batch: SeqBatch, post: GroupedPosterior, fb: FBStats,
         stats: GroupedStats, hyps: VBHyps) -> torch.Tensor:
    """The grouped bound, one value per lane: Dirichlet terms summed over
    the groups, NIW terms shared (`vbhmm_em_lb.m`, usegroups branches).
    ``hyps`` is one set or one per lane.  As in :func:`.vbhmm.elbo`, every
    term but the E-step's sums lt63 and lt64 is evaluated in float64 and
    the sum is rounded to the run's dtype."""
    dtype = fb.gamma.dtype
    g, k = post.alpha.shape[-2:]
    d = batch.x.shape[-1]
    lt63 = torch.sum(fb.gamma * fb.log_rho, dim=(-3, -2, -1))
    lt64 = torch.sum(fb.phi_norm, dim=-1)
    post, stats, hyps = block_cast((post, stats, hyps), torch.float64)
    niw = post.niw
    two_pi = 2.0 * math.pi
    sh = stats.shared

    log_lam = e_log_det_lambda(niw.v, niw.w)                 # [..., K]
    log_pi = e_log_dirichlet(post.alpha)                     # [..., G, K]
    log_a = e_log_dirichlet(post.epsilon)                    # [..., G, K, K]
    beta0 = lane_hyp(hyps.beta0, 0, 1)

    logdet_w0inv = torch.sum(torch.log(hyps.w0inv_diag), dim=-1)
    log_c_alpha0 = (torch.lgamma(k * hyps.alpha0)
                    - k * torch.lgamma(hyps.alpha0))
    log_c_eps0 = (torch.lgamma(k * hyps.epsilon0)
                  - k * torch.lgamma(hyps.epsilon0))
    log_b0 = log_wishart_b(logdet_w0inv, hyps.v0, d)

    tr_sw = torch.sum(sh.s * niw.w.transpose(-1, -2), dim=(-2, -1))
    xbar_w_xbar = vbhmm._quad(sh.xbar - niw.m, niw.w)
    m_w_m = vbhmm._quad(niw.m - lane_hyp(hyps.m0, 1, 1), niw.w)
    tr_w0inv_w = torch.sum(lane_hyp(hyps.w0inv_diag, 1, 1) * torch.diagonal(
        niw.w, dim1=-2, dim2=-1), dim=-1)

    lt1 = 0.5 * torch.sum(sh.nk * (log_lam - d / niw.beta - niw.v * tr_sw
                                   - niw.v * xbar_w_xbar
                                   - d * math.log(two_pi)), dim=-1)
    lt2a = torch.sum(stats.nk1_g * log_pi, dim=(-2, -1))
    lt2b = torch.sum(stats.m_g * log_a, dim=(-3, -2, -1))
    lt3 = g * log_c_alpha0 + (hyps.alpha0 - 1.0) * torch.sum(
        log_pi, dim=(-2, -1))
    lt4 = g * k * log_c_eps0 + (hyps.epsilon0 - 1.0) * torch.sum(
        log_a, dim=(-3, -2, -1))
    lt51 = 0.5 * torch.sum(d * torch.log(beta0 / two_pi) + log_lam
                           - d * beta0 / niw.beta
                           - beta0 * niw.v * m_w_m, dim=-1)
    lt52 = (k * log_b0 + 0.5 * (hyps.v0 - d - 1.0) * torch.sum(log_lam, -1)
            - 0.5 * torch.sum(niw.v * tr_w0inv_w, dim=-1))
    lt6 = lt2a + lt2b + lt63 - lt64
    lt7 = (torch.sum((post.alpha - 1.0) * log_pi, dim=(-2, -1))
           + torch.sum(log_dirichlet_const(post.alpha), dim=-1)
           + torch.sum((post.epsilon - 1.0) * log_a, dim=(-3, -2, -1))
           + torch.sum(log_dirichlet_const(post.epsilon), dim=(-2, -1)))
    log_bk = log_wishart_b(-logdet_psd(niw.w), niw.v, d)
    h_ent = torch.sum(-log_bk - 0.5 * (niw.v - d - 1.0) * log_lam
                      + 0.5 * niw.v * d, dim=-1)
    lt8 = (0.5 * torch.sum(log_lam + d * torch.log(niw.beta / two_pi),
                           dim=-1) - 0.5 * d * k - h_ent)
    return (lt1 + lt2a + lt2b + lt3 + lt4 + lt51 + lt52 - lt6 - lt7
            - lt8).to(dtype)


class GroupedEMState(NamedTuple):
    post: GroupedPosterior
    ll: torch.Tensor       # [...]
    it: torch.Tensor       # [...] int64
    gamma: torch.Tensor    # [..., N, T, K]
    stats: GroupedStats
    done: torch.Tensor     # [...] bool


def vbem_em(batch: SeqBatch, init_post: GroupedPosterior, hyps: VBHyps,
            group_map: torch.Tensor, max_iter: int = 100,
            min_diff: float = 1e-5,
            covar_type: str = "full") -> GroupedEMState:
    """The grouped EM loop over every lane of ``init_post``, with the
    control flow of :func:`.vbhmm.vbem_em`: E-step, statistics, bound,
    convergence check, M-step (still applied on the converging
    iteration); a NaN bound becomes -inf and keeps the old posterior; a
    lane is done once it converged, went unstable or reached
    ``max_iter``, and is frozen from then on."""
    vbhmm.check_lengths(batch)
    n_groups = init_post.num_groups
    converged = within(min_diff)

    def body(st: GroupedEMState) -> GroupedEMState:
        fb = e_step(batch, st.post, group_map)
        stats = grouped_stats(batch, fb, group_map, n_groups)
        ll, unstable, done = settle(elbo(batch, st.post, fb, stats, hyps),
                                    st.ll, st.it, max_iter, converged)
        return GroupedEMState(
            post=lane_where(unstable, st.post, m_step(stats, hyps,
                                                      covar_type)),
            ll=ll, it=st.it + 1, gamma=fb.gamma, stats=stats, done=done)

    ll0, it0, done0 = start(init_post.alpha.shape[:-2], batch.x.dtype,
                            batch.x.device)
    return run_lanes("grouped_em", body, GroupedEMState(
        post=init_post, ll=ll0, it=it0, gamma=None, stats=None, done=done0))


def from_ungrouped(post: HMMPosterior, n_groups: int) -> GroupedPosterior:
    """Tile an ungrouped posterior (any lanes) into G groups
    (`vbhmm_em.m:76-87`)."""
    a = post.alpha.unsqueeze(-2)
    e = post.epsilon.unsqueeze(-3)
    return GroupedPosterior(
        alpha=a.expand(a.shape[:-2] + (n_groups,) + a.shape[-1:]).contiguous(),
        epsilon=e.expand(e.shape[:-3] + (n_groups,)
                         + e.shape[-2:]).contiguous(),
        niw=post.niw)


def split_groups(post: GroupedPosterior) -> list:
    """Per-group ungrouped posteriors (`vbhmm_group2ind.m`)."""
    return [HMMPosterior(alpha=post.alpha[..., g, :],
                         epsilon=post.epsilon[..., g, :, :], niw=post.niw)
            for g in range(post.num_groups)]


def permute(post: GroupedPosterior, perm) -> GroupedPosterior:
    """One state permutation ``perm`` [K] applied to every group and to
    the shared emissions (`vbhmm_permute.m` group-wise,
    `vbhmm_standardize.m:31-38`)."""
    perm = torch.as_tensor(perm, device=post.alpha.device)
    niw = post.niw
    return GroupedPosterior(
        alpha=post.alpha[..., perm],
        epsilon=post.epsilon[..., perm, :][..., perm],
        niw=NIW(beta=niw.beta[..., perm], v=niw.v[..., perm],
                m=niw.m[..., perm, :], w=niw.w[..., perm, :, :]))


# ---------------------------------------------------------------------------
# front-end: restarts, selection over K and hyp learning for grouped data
# (the reference runs usegroups through the whole vbhmm_learn path,
# `vbhmm_learn.m:232-654` + `vbhmm_em.m:62-91`)
# ---------------------------------------------------------------------------

class GroupedResult(NamedTuple):
    """A learned grouped model: shared emissions, per-group dynamics."""
    post: GroupedPosterior
    ll: torch.Tensor
    counts: torch.Tensor     # [K] pooled state counts
    group_posts: list        # per-group HMMPosterior (vbhmm_group2ind)
    group_models: list       # per-group point-estimate HMM


def _finalize(st: GroupedEMState) -> GroupedResult:
    posts = split_groups(st.post)
    return GroupedResult(post=st.post, ll=st.ll, counts=st.stats.shared.nk,
                         group_posts=posts,
                         group_models=[p.to_point() for p in posts])


def neg_elbo_objective(batch: SeqBatch, init_posts: GroupedPosterior,
                       group_map: torch.Tensor, config: VBConfig,
                       stats: Optional[dict] = None):
    """The hyp objective over lanes: ``fun(hyps, lanes) -> -elbo [k]``
    re-runs the grouped EM from ``init_posts[lanes]`` under the hyps
    (detached), then takes the bound at the fixed point with the
    posterior, the E-step (kernel B2 on the card) and the statistics held
    fixed, so autograd reaches only the prior terms.  ``stats`` counts
    the EM iterations ('em_iters') and the E-steps outside EM
    ('e_steps')."""
    n_groups = init_posts.num_groups

    def fun(hyps, lanes):
        p0 = tree_map(lambda a: a[lanes], init_posts)
        with torch.no_grad():
            st = vbem_em(batch, p0, tree_map(torch.Tensor.detach, hyps),
                         group_map, max_iter=config.max_iter,
                         min_diff=config.min_diff,
                         covar_type=config.covar_type)
            fb = e_step(batch, st.post, group_map)
            gs = grouped_stats(batch, fb, group_map, n_groups)
        hypmod.tally(stats, "em_iters", int(torch.max(st.it)))
        hypmod.tally(stats, "e_steps", 1)
        return -elbo(batch, st.post, fb, gs, hyps)
    return fun


def _learn_hyps(batch, states, group_map, hyps0, config, info):
    """The hyp stage of :func:`learn_grouped`: every unique restart
    solution (at most ``max_hyp_solutions``, padded to a multiple of 4 by
    the best one) hyp-optimized by the lane-batched L-BFGS of
    :mod:`..hyp`, re-run under its hyps, then the degraded and degenerate
    lanes reverted with their hyps (:func:`..hyp.revert_lanes`).  Returns
    (final states, hyps per lane)."""
    uniq = hypmod.unique_ll(states.ll.detach().cpu().numpy(),
                            config.min_diff)
    if config.max_hyp_solutions is not None:
        uniq = uniq[:config.max_hyp_solutions]
    if len(uniq) == 0:
        uniq = np.asarray([int(torch.argmax(states.ll))])
    idx = torch.as_tensor(hypmod.pad_lanes(uniq, bucket=4),
                          device=states.ll.device)
    pre = tree_map(lambda a: a[idx], states)
    stats = {}
    specs = hypmod.vb_specs(batch.x.shape[-1], config.bounds,
                            config.learn_hyps_keys)
    fun = neg_elbo_objective(batch, pre.post, group_map, config, stats)
    hyps_b, _, steps = hypmod.optimize_hyps_batched(
        fun, hyps0, specs, int(idx.shape[0]),
        max_steps=config.hyp_max_steps, stats=stats)
    stats["steps"] = steps.cpu().numpy()
    sts = vbem_em(batch, pre.post, hyps_b, group_map,
                  max_iter=config.max_iter, min_diff=config.min_diff,
                  covar_type=config.covar_type)
    hypmod.tally(stats, "em_iters", int(torch.max(sts.it)))
    sts, hyps_b, stage = hypmod.revert_lanes(sts, pre, hyps_b, hyps0, stats,
                                             config.verbose - 1)
    info.update(stage)
    return sts, hyps_b


def learn_grouped(gen: torch.Generator, batch: SeqBatch, k, group_map,
                  n_groups: int, config: Optional[VBConfig] = None,
                  hyps: Optional[VBHyps] = None):
    """Grouped VBEM front-end: random restarts as lanes (the 'random'
    GMM start of :func:`.vbhmm.random_init`, tiled into the groups),
    selection over K by ``LL + lgamma(K+1)``, optional empirical-Bayes
    hyp learning and the state order standardized by the pooled emission
    counts: the `vbhmm_learn` pipeline for `usegroups` data
    (`vbhmm_em.m:62-91`).

    ``k`` is an int or a sequence of ints; ``group_map`` [N] gives each
    sequence's group.  With ``config.learn_hyps`` every unique restart
    solution is hyp-optimized (:func:`_learn_hyps`) and the best lane
    kept, its hyps in ``info['learned_hyps']`` and the stage's counts
    under 'hyp_*' keys.  ``info['em_iters']`` counts the EM iterations
    of the restarts (the slowest lane's).  Returns (GroupedResult, info
    dict)."""
    config = config or VBConfig()
    group_map = torch.as_tensor(group_map, device=batch.x.device)
    if isinstance(k, (list, tuple, range)):
        ks = list(k)
        results, infos, lls = [], [], []
        for kk in ks:
            res, inf = learn_grouped(gen, batch, int(kk), group_map,
                                     n_groups, config, hyps)
            results.append(res)
            infos.append(inf)
            lls.append(float(res.ll))
        corrected = np.asarray(lls) + np.asarray(
            [math.lgamma(kk + 1) for kk in ks])
        best = int(np.argmax(corrected))
        info = {"model_ll": corrected, "model_k": ks,
                "model_best_k": ks[best], "model_all": results,
                "model_infos": infos}
        return results[best], info

    kk = int(k)
    hyps0 = hyps if hyps is not None else VBHyps.from_config(
        config, batch.x.shape[-1], batch.x.dtype, batch.x.device)
    numtrials = 1 if kk == 1 else config.numtrials
    p0 = vbhmm.random_init(gen, batch, kk, hyps0, config.covar_type,
                           lanes=(numtrials,))
    states = vbem_em(batch, from_ungrouped(p0, n_groups), hyps0, group_map,
                     max_iter=config.max_iter, min_diff=config.min_diff,
                     covar_type=config.covar_type)
    info = {"model_best_k": kk, "vbopt": config,
            "em_iters": int(torch.max(states.it))}
    if config.learn_hyps:
        states, hyps_b = _learn_hyps(batch, states, group_map, hyps0,
                                     config, info)
        best = int(torch.argmax(states.ll))
        info["learned_hyps"] = tree_map(lambda a: a[best], hyps_b)
    else:
        best = int(torch.argmax(states.ll))
    st = tree_map(lambda a: a[best], states)

    if config.sortclusters:
        # shared emissions: one permutation for every group, by the pooled
        # emission counts (mode 'e'; the reference recurses the chosen
        # mode into each group HMM, `vbhmm_standardize.m:31-38`)
        perm = torch.argsort(-st.stats.shared.nk, stable=True)
        new_post = permute(st.post, perm)
        fb = e_step(batch, new_post, group_map)
        st = st._replace(post=new_post, gamma=fb.gamma,
                         stats=grouped_stats(batch, fb, group_map, n_groups))
    return _finalize(st), info
