"""VBEM learning of Gaussian-emission HMMs: the PyTorch counterpart of
:mod:`vbhem_tpu.models.vbhmm` (`src/hmm/vbhmm_learn.m`, `vbhmm_em.m`,
`vbhmm_em_lb.m`, `vbhmm_init.m`).

Where the JAX package vmaps restart trials (and, in ``batch.learn_bank``,
subjects), the posterior here carries explicit leading lane axes
``[*lanes, K, ...]``.  The data's own leading axes are a prefix of the
lanes: one subject's ``SeqBatch`` (x [N, T, D]) serves lanes [L], and a
stacked bank (x [S, N, T, D]) serves lanes [S, L].  :func:`vbem_em` runs
every lane together with a per-lane ``done`` mask and freezes a lane once
it is done, as ``jax.vmap`` of ``lax.while_loop`` does.  The E-step
(expected log emissions and the forward-backward) is kernel B2
(``ops/fb_cuda.py``) on the card, its fused entry where the shape allows,
and its plain PyTorch version on the CPU.

Randomness comes from an explicit ``torch.Generator``; its draws differ
from ``jax.random``'s, so restarts are comparable only in distribution.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import VBConfig
from ..containers import (HMMPosterior, NIW, SeqBatch, VBHMMResult,
                          resolve_device, tree_map)
from .. import hyp as hypmod
from ..ops.fb import FBStats
from ..ops.fb_cuda import e_step_auto
from ..ops.gmm import GMM, fit_gmm, fit_gmm_split
from .lanes import lane_where, run_lanes, settle, start, within
from ..utils.numeric import (block_cast, e_log_det_lambda, e_log_dirichlet,
                             inv_psd, lane_contract, lane_hyp,
                             log_dirichlet_const, log_wishart_b, logdet_psd,
                             sym, tiny)

class VBHyps(NamedTuple):
    """Prior hyperparameters (the learnable set of `get_hypinfo.m`)."""
    alpha0: torch.Tensor    # scalar
    epsilon0: torch.Tensor  # scalar
    beta0: torch.Tensor     # scalar
    v0: torch.Tensor        # scalar
    m0: torch.Tensor        # [D]
    w0: torch.Tensor        # [D] diagonal of W0

    @property
    def w0inv_diag(self) -> torch.Tensor:
        return 1.0 / self.w0

    @classmethod
    def from_config(cls, config: VBConfig, dim: int, dtype=torch.float64,
                    device="cuda"):
        """Hyperparameters of ``config`` as 0-d / [D] tensors on ``device``
        (the card unless the caller names another)."""
        device = resolve_device(device)
        w0 = config.w0
        w0 = tuple(w0) if isinstance(w0, (tuple, list)) else (w0,) * dim

        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        return cls(alpha0=t(config.alpha0), epsilon0=t(config.epsilon0),
                   beta0=t(config.beta0), v0=t(config.v0),
                   m0=t(config.default_mu0(dim)), w0=t(w0))


class SuffStats(NamedTuple):
    """Masked sufficient statistics of the E-step (`vbhmm_em.m:158-246`)."""
    nk1: torch.Tensor      # [..., K] initial-state counts (no floor)
    nk: torch.Tensor       # [..., K] state counts (floored)
    m_trans: torch.Tensor  # [..., K, K] transition counts
    xbar: torch.Tensor     # [..., K, D] weighted means
    s: torch.Tensor        # [..., K, D, D] weighted scatter


def _views(batch: SeqBatch, lanes) -> tuple:
    """x [*X, 1.., N, T, D] and mask [*X, 1.., N, T]: the data with a unit
    axis for every lane axis after its own leading axes X."""
    nx = batch.x.dim() - 3
    extra = (1,) * (len(lanes) - nx)
    x = batch.x.reshape(batch.x.shape[:nx] + extra + batch.x.shape[nx:])
    mask = batch.mask
    return x, mask.reshape(mask.shape[:nx] + extra + mask.shape[nx:])


# ---------------------------------------------------------------------------
# E-step, statistics, M-step, bound
# ---------------------------------------------------------------------------

def check_lengths(batch: SeqBatch):
    """Raise unless every subject (each of the data's leading axes) has at
    least one step.  A sequence of length 0 beside real ones is allowed: it
    is a padded trial of a ragged bank, and the E-step gives it zero
    responsibilities, statistics and bound.  One host sync; the EM loops
    call it once, not once per E-step."""
    if not bool(torch.all(batch.total >= 1)):
        raise ValueError("every subject must have at least one step "
                         "(sum of lengths >= 1): a subject of empty "
                         "sequences has no data")


def e_step(batch: SeqBatch, post: HMMPosterior) -> FBStats:
    """Expected log emissions and the scaled forward-backward of every
    lane (`vbhmm_fb.m`): kernel B2 on the card (its fused entry where the
    shape allows), the plain version on the CPU.  A sequence of length 0
    contributes nothing; every subject must have a step (see
    :func:`check_lengths`)."""
    x, mask = _views(batch, post.alpha.shape[:-1])
    return e_step_auto(x, mask, e_log_dirichlet(post.alpha),
                       e_log_dirichlet(post.epsilon), post.niw)


def suff_stats(batch: SeqBatch, fb: FBStats) -> SuffStats:
    """Masked statistics of every lane, by matmuls over the flattened
    (sequence, step) axis (`vbhmm_em.m:158-246`).

    The moments are taken about each subject's mean point, and the means
    shifted back: the scatter is E[x x^T] - xbar xbar^T, and for data far
    from the origin (fixations in pixels) float32 rounding of that
    difference moved the EM's bound by more than its stopping tolerance,
    so float32 runs stopped tens of iterations before float64 ones."""
    dtype = batch.x.dtype
    x, mask = _views(batch, fb.gamma.shape[:-3])
    d = x.shape[-1]
    gamma = fb.gamma                                   # [..., N, T, K] masked
    nk1 = torch.sum(gamma[..., 0, :], dim=-2)
    nk = torch.sum(gamma, dim=(-3, -2)) + tiny(dtype)
    m_trans = torch.sum(fb.xi_sum, dim=-3)
    nx = batch.x.dim() - 3
    w = mask.to(dtype)[..., None]
    center = torch.sum(x * w, dim=(-3, -2), keepdim=True) / torch.clamp(
        torch.sum(w, dim=(-3, -2), keepdim=True), min=1.0)
    g2 = gamma.flatten(-3, -2)                         # [..., N*T, K]
    x2 = (x - center).flatten(-3, -2)                  # [*X, 1.., N*T, D]
    xbar = lane_contract(g2, x2, nx) / nk[..., None]
    xx = (x2[..., :, None] * x2[..., None, :]).flatten(-2)
    m2 = lane_contract(g2, xx, nx).unflatten(-1, (d, d)) \
        / nk[..., None, None]
    s = sym(m2 - xbar[..., :, None] * xbar[..., None, :])
    center = center.reshape(center.shape[:nx] + (1,) * (xbar.dim() - nx - 1)
                            + (d,))
    return SuffStats(nk1=nk1, nk=nk, m_trans=m_trans, xbar=xbar + center,
                     s=s)


def _quad(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a^T W a over the last axis: a [..., D], w [..., D, D] -> [...].
    Elementwise: in float64 a batched matmul of [D, D] by [D, 1] is
    cuBLAS's gemv, 0.47 ms a VBEM bound at full width on an H100."""
    return torch.sum(a[..., :, None] * w * a[..., None, :], dim=(-2, -1))


def m_step(stats: SuffStats, hyps: VBHyps,
           covar_type: str = "full") -> HMMPosterior:
    """Conjugate Dirichlet / NIW updates (`vbhmm_em.m:352-408`).
    ``covar_type='diag'`` keeps the Wishart scales diagonal
    (`vbhem_mstep_component.m:55-63`).  ``hyps`` is one set (0-d and [D]
    leaves) or one per lane ([*lanes] and [*lanes, D], the lanes of
    ``stats``)."""
    dtype = stats.xbar.dtype
    d = stats.xbar.shape[-1]
    eye = torch.eye(d, dtype=dtype, device=stats.xbar.device)
    beta0 = lane_hyp(hyps.beta0, 0, 1)                 # against [..., K]
    m0 = lane_hyp(hyps.m0, 1, 1)                       # against [..., K, D]
    alpha = lane_hyp(hyps.alpha0, 0, 1) + stats.nk1 + tiny(dtype)
    epsilon = lane_hyp(hyps.epsilon0, 0, 2) + stats.m_trans
    beta = beta0 + stats.nk
    v = lane_hyp(hyps.v0, 0, 1) + stats.nk + 1.0
    m = (lane_hyp(hyps.beta0, 0, 2) * m0 + stats.nk[..., None] * stats.xbar) \
        / beta[..., None]
    mult1 = beta0 * stats.nk / (beta0 + stats.nk)
    diff3 = stats.xbar - m0
    w0inv = lane_hyp(torch.diag_embed(hyps.w0inv_diag.to(dtype)), 2, 1)
    s = stats.s * eye if covar_type == "diag" else stats.s
    winv = (w0inv + stats.nk[..., None, None] * s
            + mult1[..., None, None] * diff3[..., :, None]
            * diff3[..., None, :])
    w = inv_psd(winv)
    if covar_type == "diag":
        w = w * eye
    return HMMPosterior(alpha=alpha, epsilon=epsilon,
                        niw=NIW(beta=beta, v=v, m=m, w=w))


def elbo(batch: SeqBatch, post: HMMPosterior, fb: FBStats,
         stats: SuffStats, hyps: VBHyps) -> torch.Tensor:
    """The 8-term variational lower bound (`vbhmm_em_lb.m:120-257`), one
    value per lane: [...], in the run's dtype.  ``hyps`` is one set or one
    per lane, as in :func:`m_step`.

    Every term but the E-step's sums lt63 and lt64, which stay in the
    run's dtype, is evaluated in float64 from ``post``, ``stats`` and
    ``hyps`` cast in one block: the Dirichlet and Normal-Wishart terms
    scale with the hyperparameters, and in float32 their rounding
    outgrows the stopping test's tolerance under learned ones, as in
    :func:`.vbhem.elbo`.  The sum is rounded to the run's dtype."""
    dtype = fb.gamma.dtype
    k = post.num_states
    d = batch.x.shape[-1]
    # Lt6's E-step sums: E[log q(Z)] from the FB normalizer
    # (vbhmm_em_lb.m:203-221)
    lt63 = torch.sum(fb.gamma * fb.log_rho, dim=(-3, -2, -1))
    lt64 = torch.sum(fb.phi_norm, dim=-1)
    post, stats, hyps = block_cast((post, stats, hyps), torch.float64)
    niw = post.niw
    two_pi = 2.0 * math.pi

    log_lam = e_log_det_lambda(niw.v, niw.w)               # [..., K]
    log_pi = e_log_dirichlet(post.alpha)                   # [..., K]
    log_a = e_log_dirichlet(post.epsilon)                  # [..., K, K]

    logdet_w0inv = torch.sum(torch.log(hyps.w0inv_diag), dim=-1)
    log_c_alpha0 = torch.lgamma(k * hyps.alpha0) - k * torch.lgamma(hyps.alpha0)
    log_c_eps0 = (torch.lgamma(k * hyps.epsilon0)
                  - k * torch.lgamma(hyps.epsilon0))
    log_b0 = log_wishart_b(logdet_w0inv, hyps.v0, d)
    beta0 = lane_hyp(hyps.beta0, 0, 1)                 # against [..., K]

    # per-state quadratic/trace statistics (vbhmm_em_lb.m:106-118)
    tr_sw = torch.sum(stats.s * niw.w.transpose(-1, -2), dim=(-2, -1))
    xbar_w_xbar = _quad(stats.xbar - niw.m, niw.w)
    m_w_m = _quad(niw.m - lane_hyp(hyps.m0, 1, 1), niw.w)
    tr_w0inv_w = torch.sum(lane_hyp(hyps.w0inv_diag, 1, 1) * torch.diagonal(
        niw.w, dim1=-2, dim2=-1), dim=-1)

    # Lt1: E[log p(X|Z, mu, Lambda)], Bishop 10.71
    lt1 = 0.5 * torch.sum(stats.nk * (log_lam - d / niw.beta - niw.v * tr_sw
                                      - niw.v * xbar_w_xbar
                                      - d * math.log(two_pi)), dim=-1)
    # Lt2: E[log p(Z|pi, A)], Bishop 10.72
    lt2a = torch.sum(stats.nk1 * log_pi, dim=-1)
    lt2b = torch.sum(stats.m_trans * log_a, dim=(-2, -1))
    lt2 = lt2a + lt2b
    # Lt3 / Lt4: E[log p(pi)], E[log p(A)], Bishop 10.73
    lt3 = log_c_alpha0 + (hyps.alpha0 - 1.0) * torch.sum(log_pi, dim=-1)
    lt4 = k * log_c_eps0 + (hyps.epsilon0 - 1.0) * torch.sum(log_a,
                                                            dim=(-2, -1))
    # Lt5: E[log p(mu, Lambda)], Bishop 10.74
    lt51 = 0.5 * torch.sum(d * torch.log(beta0 / two_pi) + log_lam
                           - d * beta0 / niw.beta
                           - beta0 * niw.v * m_w_m, dim=-1)
    lt52 = (k * log_b0 + 0.5 * (hyps.v0 - d - 1.0) * torch.sum(log_lam, -1)
            - 0.5 * torch.sum(niw.v * tr_w0inv_w, dim=-1))
    lt5 = lt51 + lt52
    # Lt6: E[log q(Z)]
    lt6 = lt2a + lt2b + lt63 - lt64
    # Lt7: E[log q(pi, A)], Bishop 10.76
    lt71 = (torch.sum((post.alpha - 1.0) * log_pi, dim=-1)
            + log_dirichlet_const(post.alpha))
    lt72 = torch.sum(torch.sum((post.epsilon - 1.0) * log_a, dim=-1)
                     + log_dirichlet_const(post.epsilon), dim=-1)
    lt7 = lt71 + lt72
    # Lt8: E[log q(mu, Lambda)], Bishop 10.77
    log_bk = log_wishart_b(-logdet_psd(niw.w), niw.v, d)
    h_ent = torch.sum(-log_bk - 0.5 * (niw.v - d - 1.0) * log_lam
                      + 0.5 * niw.v * d, dim=-1)
    lt8 = 0.5 * torch.sum(log_lam + d * torch.log(niw.beta / two_pi),
                          dim=-1) - 0.5 * d * k - h_ent

    return (lt1 + lt2 + lt3 + lt4 + lt5 - lt6 - lt7 - lt8).to(dtype)


# ---------------------------------------------------------------------------
# EM loop
# ---------------------------------------------------------------------------

class EMState(NamedTuple):
    post: HMMPosterior
    ll: torch.Tensor          # [...]
    last_ll: torch.Tensor     # [...]
    it: torch.Tensor          # [...] int64
    gamma: torch.Tensor       # [..., N, T, K]
    stats: SuffStats
    done: torch.Tensor        # [...] bool


def _iteration(batch, post, hyps, covar_type="full"):
    """One EM iteration on every lane: (new posterior, ELBO of ``post``,
    gamma, stats)."""
    fb = e_step(batch, post)
    stats = suff_stats(batch, fb)
    ll = elbo(batch, post, fb, stats, hyps)
    return m_step(stats, hyps, covar_type), ll, fb.gamma, stats


def vbem_em(batch: SeqBatch, init_post: HMMPosterior, hyps: VBHyps,
            max_iter: int = 100, min_diff: float = 1e-5,
            covar_type: str = "full") -> EMState:
    """The VBEM loop (`vbhmm_em.m:112-414`) over every lane of
    ``init_post`` at once.

    Each iteration is {E-step, ELBO, convergence check, M-step}; the
    M-step still applies on the converging iteration (the reference's
    `break` sits after it, `vbhmm_em.m:411-413`), so the returned
    posterior is post-M while ``ll``/``gamma``/``stats`` are pre-M.  A NaN
    ELBO becomes -inf and keeps the old posterior (`vbhmm_em.m:312-330`).
    A lane is done once it converged, went unstable or reached
    ``max_iter``; from then on it is frozen, as under ``jax.vmap`` of
    ``lax.while_loop``."""
    check_lengths(batch)
    converged = within(min_diff)

    def body(st: EMState) -> EMState:
        new_post, ll, gamma, stats = _iteration(batch, st.post, hyps,
                                                covar_type)
        ll, unstable, done = settle(ll, st.ll, st.it, max_iter, converged)
        return EMState(post=lane_where(unstable, st.post, new_post), ll=ll,
                       last_ll=st.ll, it=st.it + 1, gamma=gamma, stats=stats,
                       done=done)

    ll0, it0, done0 = start(init_post.alpha.shape[:-1], batch.x.dtype,
                            batch.x.device)
    return run_lanes("vbem_em", body, EMState(
        post=init_post, ll=ll0, last_ll=ll0, it=it0, gamma=None, stats=None,
        done=done0))


def em_trace(batch: SeqBatch, init_post: HMMPosterior, hyps: VBHyps,
             n_iter: int = 50):
    """Run exactly ``n_iter`` VBEM iterations recording the ELBO of each
    (`vbhmm_em.m:287-301`).  Returns (final posterior, ll [n_iter, ...])."""
    check_lengths(batch)
    post, lls = init_post, []
    for _ in range(n_iter):
        post, ll, _, _ = _iteration(batch, post, hyps)
        lls.append(ll)
    return post, torch.stack(lls)


# ---------------------------------------------------------------------------
# initializers (vbhmm_init.m)
# ---------------------------------------------------------------------------

def init_from_gmm(weight: torch.Tensor, mean: torch.Tensor,
                  cov: torch.Tensor, n_total, hyps: VBHyps,
                  covar_type: str = "full") -> HMMPosterior:
    """GMM -> initial variational parameters (`vbhmm_init.m:163-199`).
    weight [..., K], mean [..., K, D], cov [..., K, D, D]; ``n_total``
    (observations) broadcasts against the lanes [...]."""
    k, d = mean.shape[-2:]
    dtype = mean.dtype
    eye = torch.eye(d, dtype=dtype, device=mean.device)
    n_total = torch.as_tensor(n_total, dtype=dtype, device=mean.device)
    nk = n_total[..., None] * weight                     # occupancy guess
    nk2 = torch.broadcast_to(n_total[..., None] / k, weight.shape)
    alpha = hyps.alpha0 + nk2
    epsilon = hyps.epsilon0 + torch.broadcast_to(
        nk2[..., None, :], weight.shape + (k,))
    beta = hyps.beta0 + nk
    v = hyps.v0 + nk + 1.0
    m = (hyps.beta0 * hyps.m0 + nk[..., None] * mean) / beta[..., None]
    mult1 = hyps.beta0 * nk / (hyps.beta0 + nk)
    diff3 = mean - hyps.m0
    w0inv = torch.diag(hyps.w0inv_diag.to(dtype))
    if covar_type == "diag":
        cov = cov * eye
    winv = (w0inv + nk[..., None, None] * cov
            + mult1[..., None, None] * diff3[..., :, None]
            * diff3[..., None, :])
    w = inv_psd(winv)
    if covar_type == "diag":
        w = w * eye
    return HMMPosterior(alpha=alpha, epsilon=epsilon,
                        niw=NIW(beta=beta, v=v, m=m, w=w))


def _pooled(batch: SeqBatch):
    """Every batch's observations as one point set: x [*X, N*T, D] and
    weights [*X, N*T] (0 for padding)."""
    x = batch.x.flatten(-3, -2)
    return x, batch.mask.flatten(-2).to(x.dtype)


def _from_gmm(batch, g: GMM, hyps, covar_type, n_lanes):
    n_total = batch.total.to(batch.x.dtype)
    n_total = n_total.reshape(n_total.shape + (1,) * n_lanes)
    return init_from_gmm(g.weight, g.mean, g.cov, n_total, hyps, covar_type)


def random_init(gen: torch.Generator, batch: SeqBatch, k: int,
                hyps: VBHyps, covar_type: str = "full",
                lanes=()) -> HMMPosterior:
    """'random' initmode (`vbhmm_init.m:25-91`): a GMM fit on the pooled
    data from a random-sample start, one per restart lane; padded steps and
    empty sequences get zero weight and seed no start.  The result has
    axes [*X, *lanes]."""
    x, w = _pooled(batch)
    g = fit_gmm(gen, x, k, weights=w, lanes=lanes)
    return _from_gmm(batch, g, hyps, covar_type, len(tuple(lanes)))


def split_init(batch: SeqBatch, k: int, hyps: VBHyps,
               covar_type: str = "full") -> HMMPosterior:
    """'split' initmode (`vbhmm_init.m:104-111`): the deterministic
    component-splitting GMM on the pooled data, then the same GMM ->
    posterior conversion as 'random'."""
    x, w = _pooled(batch)
    return _from_gmm(batch, fit_gmm_split(x, k, weights=w), hyps,
                     covar_type, 0)


def fit_single_k(gen: torch.Generator, batch: SeqBatch, k: int,
                 config: VBConfig, hyps: Optional[VBHyps] = None,
                 init_post: Optional[HMMPosterior] = None) -> EMState:
    """Restarts for one K (`vbhmm_learn.m:454-480`) as a lane axis after
    the data's axes: returns the EMState with lanes [*X, trials].  K=1, a
    given ``init_post`` and the deterministic 'split' run one trial."""
    if hyps is None:
        hyps = VBHyps.from_config(config, batch.x.shape[-1], batch.x.dtype,
                                  batch.x.device)
    nx = batch.x.dim() - 3
    if init_post is None and config.initmode == "split":
        init_post = split_init(batch, k, hyps, config.covar_type)
    if init_post is not None:
        post0 = tree_map(lambda a: a.unsqueeze(nx), init_post)
    else:
        numtrials = 1 if k == 1 else config.numtrials
        post0 = random_init(gen, batch, k, hyps, config.covar_type,
                            lanes=(numtrials,))
    return vbem_em(batch, post0, hyps, max_iter=config.max_iter,
                   min_diff=config.min_diff, covar_type=config.covar_type)


def select_best_trial(states: EMState) -> EMState:
    best = int(torch.argmax(states.ll))
    return tree_map(lambda a: a[best], states)


def finalize(batch: SeqBatch, st: EMState) -> VBHMMResult:
    """Package EM solutions (any lanes) as results (`vbhmm_em.m:424-492`)."""
    post = st.post
    return VBHMMResult(
        post=post, model=post.to_point(), ll=st.ll, gamma=st.gamma,
        counts_n1=st.stats.nk1, counts=st.stats.nk,
        trans_counts=st.stats.m_trans,
        state_mask=torch.ones_like(post.alpha, dtype=torch.bool))


def neg_elbo_objective(batch: SeqBatch, init_posts: HMMPosterior,
                       config: VBConfig, per_lane_data: bool = False,
                       stats: Optional[dict] = None):
    """The hyp objective over lanes (`vbhmm_em_hyp.m:166-200`):
    ``fun(hyps, lanes) -> -elbo [k]`` re-runs EM from the initial
    posteriors ``init_posts[lanes]`` under the hyps (detached), then takes
    the bound at the fixed point with the posterior, the E-step (kernel B2
    on the card) and the statistics held fixed, so autograd reaches only
    the prior terms, as the JAX package's ``stop_gradient`` does.  The
    data is shared by every lane, or (``per_lane_data``) has the lanes as
    its leading axis.  ``stats`` counts the EM iterations ('em_iters', the
    slowest lane's per run) and the E-steps outside EM ('e_steps')."""
    def fun(hyps, lanes):
        b = tree_map(lambda a: a[lanes], batch) if per_lane_data else batch
        p0 = tree_map(lambda a: a[lanes], init_posts)
        with torch.no_grad():
            st = vbem_em(b, p0, tree_map(torch.Tensor.detach, hyps),
                         max_iter=config.max_iter, min_diff=config.min_diff,
                         covar_type=config.covar_type)
            post = st.post
            fb = e_step(b, post)
            stats_ = suff_stats(b, fb)
        hypmod.tally(stats, "em_iters", int(torch.max(st.it)))
        hypmod.tally(stats, "e_steps", 1)
        return -elbo(b, post, fb, stats_, hyps)
    return fun


def optimize_solution_hyps(batch: SeqBatch, init_post: HMMPosterior,
                           hyps0: VBHyps, config: VBConfig):
    """Empirical-Bayes hyp optimization for one solution (`vbhmm_em_hyp.m`):
    SciPy's L-BFGS-B over the transformed hyps, each objective evaluation
    an EM run from the same initial posterior.  Returns (optimized hyps,
    final EMState, info)."""
    specs = hypmod.vb_specs(batch.x.shape[-1], config.bounds,
                            config.learn_hyps_keys)
    posts = tree_map(lambda a: a[None], init_post)
    fun = neg_elbo_objective(batch, posts, config)
    one = torch.zeros(1, dtype=torch.int64, device=batch.x.device)
    hyps_opt, info = hypmod.optimize_hyps(
        lambda h: fun(tree_map(lambda a: a[None], h), one)[0], hyps0, specs)
    st = vbem_em(batch, init_post, hyps_opt, max_iter=config.max_iter,
                 min_diff=config.min_diff, covar_type=config.covar_type)
    return hyps_opt, st, info


def optimize_solution_hyps_batched(batch: SeqBatch, init_posts: HMMPosterior,
                                   hyps0: VBHyps, config: VBConfig,
                                   per_lane_data: bool = False,
                                   stats: Optional[dict] = None):
    """Hyp-optimize a bank of solutions together: one L-BFGS per lane of
    ``init_posts`` (leading lane axis), every probe of every lane still
    searching one EM over those lanes (`vbhmm_learn.m:498-552`, a parfor
    there).  The data is shared, or per lane (``per_lane_data``).  Then
    every lane re-runs EM from its start under its learned hyps.  Returns
    (hyps with a lane axis, final EMStates with a lane axis); ``stats``
    receives the optimizer's counts (:func:`..hyp.lbfgs_box`), its steps
    per lane ('steps') and the EM iterations of the objective and the
    rerun ('em_iters', 'e_steps')."""
    specs = hypmod.vb_specs(batch.x.shape[-1], config.bounds,
                            config.learn_hyps_keys)
    n = init_posts.alpha.shape[0]
    fun = neg_elbo_objective(batch, init_posts, config, per_lane_data, stats)
    hyps_b, _, steps = hypmod.optimize_hyps_batched(
        fun, hyps0, specs, n, max_steps=config.hyp_max_steps, stats=stats)
    if stats is not None:
        stats["steps"] = steps.cpu().numpy()
    sts = vbem_em(batch, init_posts, hyps_b, max_iter=config.max_iter,
                  min_diff=config.min_diff, covar_type=config.covar_type)
    hypmod.tally(stats, "em_iters", int(torch.max(sts.it)))
    return hyps_b, sts


def learn_hyps_lanes(batch: SeqBatch, states: EMState, idx, hyps0: VBHyps,
                     config: VBConfig, per_lane_data: bool = False,
                     info: Optional[dict] = None):
    """The hyp stage shared by :func:`learn` and ``batch.learn_bank``:
    the restart solutions ``states[idx]`` (``idx`` indexes the leading
    lane axis, or is a tuple of index arrays) hyp-optimized together, then
    the lanes whose bound degraded or went degenerate reverted with their
    hyps (:func:`..hyp.revert_lanes`; `vbhmm_learn.m:567-571` made a
    rejection).  Returns (final states, hyps per lane); ``info``, if
    given, receives the stage's counts under 'hyp_*' keys."""
    stats = {}
    pre = tree_map(lambda a: a[idx], states)
    hyps_b, sts = optimize_solution_hyps_batched(
        batch, pre.post, hyps0, config, per_lane_data, stats)
    sts, hyps_b, stage = hypmod.revert_lanes(sts, pre, hyps_b, hyps0, stats,
                                             config.verbose - 1)
    if info is not None:
        info.update(stage)
    return sts, hyps_b


def learn(gen: torch.Generator, batch: SeqBatch, k,
          config: VBConfig = VBConfig(), hyps: Optional[VBHyps] = None,
          initgmm=None, inithmm: Optional[HMMPosterior] = None):
    """Learn an HMM with restarts and optional model selection over K
    (`vbhmm_learn.m:232-654`).

    ``k`` may be an int or a sequence of ints; with a sequence each K runs
    the full single-K path and the winner maximizes ``LL + lgamma(K+1)``
    (`vbhmm_learn.m:391`).  In float32 the restarts and the K are compared
    on their float64 bound (:func:`..rescore.vbem_rescore_lanes`).  With
    ``config.learn_hyps`` every unique restart solution is hyp-optimized
    (:func:`learn_hyps_lanes`) and the best lane kept, its hyps in
    ``info['learned_hyps']``.
    ``initgmm`` (a (prior, mean, cov) triple or a GMM) and ``inithmm`` (a
    posterior) drive the 'initgmm' / 'inithmm' initmodes
    (`vbhmm_init.m:93-120, 154-161`); 'split' runs the component-splitting
    GMM.  Returns (VBHMMResult, info dict)."""
    if isinstance(k, (list, tuple, range)):
        ks = list(k)
        results, sub_infos, lls = [], [], []
        for kk in ks:
            res, sub_info = learn(gen, batch, int(kk), config, hyps,
                                  initgmm=initgmm, inithmm=inithmm)
            results.append(res)
            sub_infos.append(sub_info)
            lls.append(sub_info.get("ll_f64", float(res.ll)))
        corrected = np.asarray(lls) + np.array(
            [math.lgamma(kk + 1) for kk in ks])
        best = int(np.argmax(corrected))
        info = {"model_ll": corrected, "model_k": ks,
                "model_best_k": ks[best], "model_all": results,
                "model_infos": sub_infos, "vbopt": config,
                "version": _version()}
        if "learned_hyps" in sub_infos[best]:
            info["learned_hyps"] = sub_infos[best]["learned_hyps"]
        return results[best], info

    dtype, dev = batch.x.dtype, batch.x.device
    if hyps is None:
        hyps = VBHyps.from_config(config, batch.x.shape[-1], dtype, dev)
    init_post = None
    if config.initmode == "initgmm" or initgmm is not None:
        if initgmm is None:
            raise ValueError("initmode='initgmm' needs the initgmm arg")
        gw, gm, gc = (initgmm.weight, initgmm.mean, initgmm.cov) \
            if hasattr(initgmm, "weight") else initgmm
        init_post = init_from_gmm(
            *[torch.as_tensor(a, dtype=dtype, device=dev)
              for a in (gw, gm, gc)], batch.total.to(dtype), hyps,
            config.covar_type)
    elif config.initmode == "inithmm" or inithmm is not None:
        if inithmm is None:
            raise ValueError("initmode='inithmm' needs the inithmm arg")
        init_post = inithmm

    states = fit_single_k(gen, batch, int(k), config, hyps,
                          init_post=init_post)
    info = {"model_best_k": int(k), "vbopt": config, "version": _version()}
    if config.keep_suboptimal:
        # every uniqueLL restart solution (`vbhmm_learn.m:417,600`)
        info["suboptimal"] = [
            finalize(batch, tree_map(lambda a, i=int(i): a[i], states))
            for i in hypmod.unique_ll(states.ll.cpu().numpy(),
                                      config.min_diff)]
    if config.learn_hyps:
        # hyp-optimize every unique restart solution by LL
        # (`vbhmm_learn.m:484-552`) together, then keep the best lane
        uniq = hypmod.unique_ll(states.ll.detach().cpu().numpy(),
                                config.min_diff)
        if config.max_hyp_solutions is not None:
            uniq = uniq[:config.max_hyp_solutions]
        if len(uniq) == 0:
            uniq = np.asarray([int(torch.argmax(states.ll))])
        # the JAX package's lane bucket; duplicate lanes change nothing
        idx = torch.as_tensor(hypmod.pad_lanes(uniq, bucket=4), device=dev)
        states, hyps = learn_hyps_lanes(batch, states, idx, hyps, config,
                                        info=info)
    if dtype == torch.float32:
        # f32 bounds can carry selection-flipping artifacts: pick the
        # restart (or hyp-optimized lane) on its float64 bound
        from .rescore import vbem_rescore_lanes
        ll64 = vbem_rescore_lanes(batch, states.post, hyps)
        best = int(torch.argmax(ll64))
        info["ll_f64"] = float(ll64[best])
    else:
        best = int(torch.argmax(states.ll))
    st = tree_map(lambda a: a[best], states)
    if config.learn_hyps:
        info["learned_hyps"] = tree_map(lambda a: a[best], hyps)
    res = finalize(batch, st)
    if config.sortclusters:
        res = standardize(res, config.sortclusters)
    return res, info


# ---------------------------------------------------------------------------
# state standardization / permutation / pruning (vbhmm_standardize.m,
# vbhmm_permute.m, vbhmm_remove_empty.m)
# ---------------------------------------------------------------------------

def _version() -> str:
    from .. import __version__
    return __version__


def _take(a: torch.Tensor, perm: torch.Tensor, axis: int) -> torch.Tensor:
    """Reorder ``a`` along ``axis`` (negative) by ``perm``: [K] for every
    lane, or [*L, K] per lane where ``a``'s leading axes are L."""
    if perm.dim() == 1:
        return a.index_select(a.dim() + axis, perm)
    nl = perm.dim() - 1
    shape = [1] * a.dim()
    shape[:nl] = perm.shape[:-1]
    shape[a.dim() + axis] = perm.shape[-1]
    idx = perm.reshape(shape).expand(a.shape)
    return torch.gather(a, a.dim() + axis, idx)


def permute(res: VBHMMResult, perm) -> VBHMMResult:
    """Apply a state permutation ([K], or [*L, K] per lane of a batched
    result) to every field (`vbhmm_permute.m`)."""
    perm = torch.as_tensor(perm, device=res.post.alpha.device)

    def one(a, *axes):
        for ax in axes:
            a = _take(a, perm, ax)
        return a

    post = res.post
    new_post = HMMPosterior(
        alpha=one(post.alpha, -1), epsilon=one(post.epsilon, -2, -1),
        niw=NIW(beta=one(post.niw.beta, -1), v=one(post.niw.v, -1),
                m=one(post.niw.m, -2), w=one(post.niw.w, -3)))
    return VBHMMResult(
        post=new_post, model=new_post.to_point(), ll=res.ll,
        gamma=one(res.gamma, -1),
        counts_n1=one(res.counts_n1, -1), counts=one(res.counts, -1),
        trans_counts=one(res.trans_counts, -2, -1),
        state_mask=None if res.state_mask is None
        else one(res.state_mask, -1))


def _most_likely_path_order(prior: np.ndarray, trans: np.ndarray):
    """Greedy argmax walk ordering 'f' (`vbhmm_standardize.m:73-93`) of
    every lane: start at the most probable initial state, then follow the
    most probable transition to an unvisited state.  prior [..., K],
    trans [..., K, K] -> [..., K]."""
    k = prior.shape[-1]
    p = prior.reshape(-1, k)
    a = trans.reshape(-1, k, k)
    rows = np.arange(p.shape[0])
    order = [np.argmax(p, axis=-1)]
    visited = np.zeros(p.shape, bool)
    visited[rows, order[0]] = True
    for _ in range(k - 1):
        row = np.where(visited, -np.inf, a[rows, order[-1]])
        nxt = np.argmax(row, axis=-1)
        visited[rows, nxt] = True
        order.append(nxt)
    return np.stack(order, axis=-1).reshape(prior.shape)


def standardize(res: VBHMMResult, mode: str = "f") -> VBHMMResult:
    """Canonical state ordering (`vbhmm_standardize.m`) of one result or
    of every lane of a batched one: 'e' by emission count, 'p' by prior,
    'f' by most-likely greedy path, 's' by steady-state probability,
    'l'/'r' left-to-right / right-to-left by emission mean x."""
    def host(t):
        return t.detach().cpu().numpy()

    if mode == "e":
        perm = np.argsort(-host(res.counts), axis=-1, kind="stable")
    elif mode == "p":
        perm = np.argsort(-host(res.model.prior), axis=-1, kind="stable")
    elif mode == "f":
        perm = _most_likely_path_order(host(res.model.prior),
                                       host(res.model.trans))
    elif mode == "s":
        perm = np.argsort(-host(steady_state(res.model.trans)), axis=-1,
                          kind="stable")
    elif mode in ("l", "r"):
        mx = host(res.model.mean)[..., 0]
        perm = np.argsort(mx if mode == "l" else -mx, axis=-1, kind="stable")
    else:
        raise ValueError(f"unknown standardize mode {mode!r}")
    return permute(res, perm)


def remove_empty(res: VBHMMResult, thresh: float = 1.0):
    """Prune states with soft count below ``thresh``
    (`vbhmm_remove_empty.m`) from one result.  Returns (result, kept_idx,
    removed_idx); shapes shrink, so this runs between pipeline stages."""
    counts = res.counts.detach().cpu().numpy()
    keep = np.where(counts >= thresh)[0]
    removed = np.where(counts < thresh)[0]
    if len(removed) == 0:
        return res, keep, removed
    perm = torch.as_tensor(keep, device=res.counts.device)
    post = res.post
    new_post = HMMPosterior(
        alpha=post.alpha[perm], epsilon=post.epsilon[perm][:, perm],
        niw=NIW(beta=post.niw.beta[perm], v=post.niw.v[perm],
                m=post.niw.m[perm], w=post.niw.w[perm]))
    gamma = res.gamma[..., perm]
    gsum = torch.sum(gamma, dim=-1, keepdim=True)
    gamma = gamma / torch.where(gsum == 0, torch.ones_like(gsum), gsum)
    out = VBHMMResult(
        post=new_post, model=new_post.to_point(), ll=res.ll, gamma=gamma,
        counts_n1=res.counts_n1[perm], counts=res.counts[perm],
        trans_counts=res.trans_counts[perm][:, perm],
        state_mask=torch.ones_like(new_post.alpha, dtype=torch.bool))
    return out, keep, removed


def steady_state(trans: torch.Tensor) -> torch.Tensor:
    """Stationary distribution p = A^T p (`vbhmm_prob_steadystate.m`), by
    least squares with the sum-to-one row; trans [..., K, K] -> [..., K]."""
    k = trans.shape[-1]
    eye = torch.eye(k, dtype=trans.dtype, device=trans.device)
    ones = torch.ones(trans.shape[:-2] + (1, k), dtype=trans.dtype,
                      device=trans.device)
    a = torch.cat([trans.transpose(-1, -2) - eye, ones], dim=-2)
    b = torch.zeros(trans.shape[:-2] + (k + 1, 1), dtype=trans.dtype,
                    device=trans.device)
    b[..., k, 0] = 1.0
    return torch.linalg.lstsq(a, b).solution[..., 0]
