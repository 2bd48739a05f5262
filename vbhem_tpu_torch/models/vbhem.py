"""VBHEM: clustering a bank of HMMs into K reduced cluster-center HMMs
with S states each, without touching raw data — the PyTorch counterpart
of :mod:`vbhem_tpu.models.vbhem` (the five initializers of
`vbhemhmm_init.m` and the front-ends' 'auto', restart trials, the EM
loop, (K, S) selection and pruning; and the padded (K, S) grid,
:func:`cluster_batched`, whose cells and trials are the lanes of one
masked EM loop).

Where the JAX package vmaps restart trials, the reduced posterior here
carries an explicit leading lane axis [L, Kr, ...]; every function of the
EM iteration accepts any number of leading lane axes, and the pair E-step
kernel folds L*Kr into one launch.  :func:`vbhem_em` runs all lanes
together with a per-lane ``done`` mask and freezes a lane once it is
done, as ``jax.vmap`` of ``lax.while_loop`` does.

Randomness comes from an explicit ``torch.Generator``; its draws differ
from ``jax.random``'s, so restarts are comparable only in distribution.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import hyp as hypmod
from ..config import VBHEMConfig
from ..containers import (H3M, HMM, H3MPosterior, HMMPosterior, NIW,
                          VBHMMResult, resolve_device, tree_map)
from ..ops.pair_estep import PairStats
from ..ops import pair_estep_cuda
from ..ops.pair_estep_cuda import pair_estep_fused_auto
from ..ops.gmm import (fit_gmm_from_means, mix_hier_em,
                       sample_without_replacement)
from ..ops import gmm_cuda, kmeans_cuda
from ..ops.kmeans import kmeans_pp_from_uniforms
from ..utils import profiling
from ..utils.numeric import (block_cast, e_log_det_lambda, e_log_dirichlet,
                             inv_psd, lane_hyp, log_wishart_b, logdet_psd,
                             masked_e_log_dirichlet,
                             masked_log_dirichlet_const, sym, tiny)
from . import vbhmm
from .lanes import (chunk_slices, in_chunks, lane_where, run_lanes, settle,
                    start, within)


class VBHEMHyps(NamedTuple):
    """Prior hyperparameters of the reduced model (the learnable set of
    `vbhem_get_hypinfo.m`)."""
    alpha0: torch.Tensor
    eta0: torch.Tensor
    epsilon0: torch.Tensor
    lambda0: torch.Tensor
    v0: torch.Tensor
    m0: torch.Tensor   # [D]
    w0: torch.Tensor   # [D] diagonal of W0

    @property
    def w0inv_diag(self) -> torch.Tensor:
        return 1.0 / self.w0

    @classmethod
    def from_config(cls, config: VBHEMConfig, dim: int,
                    dtype=torch.float64, device="cuda"):
        """Hyperparameters of ``config`` as 0-d / [D] tensors on ``device``
        (the card unless the caller names another)."""
        device = resolve_device(device)
        w0 = config.w0
        w0 = tuple(w0) if isinstance(w0, (tuple, list)) else (w0,) * dim

        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        return cls(alpha0=t(config.alpha0), eta0=t(config.eta0),
                   epsilon0=t(config.epsilon0), lambda0=t(config.lambda0),
                   v0=t(config.v0), m0=t(config.default_m0(dim)), w0=t(w0))


# ---------------------------------------------------------------------------
# base bank construction (hmms_to_h3m_hem.m)
# ---------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _bank(prior, trans, mean, cov, mask, device) -> H3M:
    k_b = prior.shape[0]
    omega = np.full((k_b,), 1.0 / k_b, prior.dtype)

    def t(x):
        return torch.as_tensor(x, device=device)

    return H3M(omega=t(omega),
               hmm=HMM(prior=t(prior), trans=t(trans), mean=t(mean),
                       cov=t(cov)),
               state_mask=t(mask))


def h3m_from_results(results: Sequence[VBHMMResult], use_post: bool = True,
                     s_max: Optional[int] = None, dtype=None,
                     covar_type: str = "full", device="cuda") -> H3M:
    """Convert learned VBHMMs into a dense padded base H3M on ``device``
    (the card unless the caller names another).

    With ``use_post`` (`vbhem_h3m_cluster.m:210`), point estimates are
    replaced by posterior expectations (`hmms_to_h3m_hem.m:43-92`):
      prior = exp(E[log pi]),  A = exp(E[log A])   (sub-normalized)
      cov   = ((beta + 1) / beta) * E[Sigma]
    Padded states get zero prior/transition mass and identity covariance
    (inert through the pair recursions).  ``dtype`` is a numpy dtype.

    A bank whose HMMs all have the same state count (what ``learn_bank``
    returns) is stacked and converted on the device in one pass; a ragged
    bank is padded on the host, one HMM at a time."""
    device = resolve_device(device)
    ss = [int(r.post.alpha.shape[-1]) for r in results]
    if len(set(ss)) == 1 and s_max in (None, ss[0]) and all(
            torch.is_tensor(r.post.alpha) for r in results):
        return _bank_uniform(results, use_post, dtype, covar_type, device)
    k_b = len(results)
    d = _np(results[0].post.niw.m).shape[-1]
    sm = s_max if s_max is not None else max(ss)
    dt = dtype or _np(results[0].post.niw.m).dtype

    prior = np.zeros((k_b, sm), dt)
    trans = np.zeros((k_b, sm, sm), dt)
    mean = np.zeros((k_b, sm, d), dt)
    cov = np.tile(np.eye(d, dtype=dt), (k_b, sm, 1, 1))
    mask = np.zeros((k_b, sm), bool)
    for i, r in enumerate(results):
        s = ss[i]
        mask[i, :s] = True
        if use_post:
            prior[i, :s] = np.exp(_np(e_log_dirichlet(r.post.alpha)))
            trans[i, :s, :s] = np.exp(_np(e_log_dirichlet(r.post.epsilon)))
            beta = _np(r.post.niw.beta)
            cov[i, :s] = _np(r.post.niw.expected_cov()) * \
                ((beta + 1.0) / beta)[:, None, None]
        else:
            prior[i, :s] = _np(r.model.prior)
            trans[i, :s, :s] = _np(r.model.trans)
            cov[i, :s] = _np(r.model.cov)
        mean[i, :s] = _np(r.post.niw.m if use_post else r.model.mean)
    if covar_type == "diag":
        cov = cov * np.eye(d, dtype=dt)
    return _bank(prior, trans, mean, cov, mask, device)


def _bank_uniform(results, use_post, dtype, covar_type, device) -> H3M:
    """:func:`h3m_from_results` for HMMs of one state count, on the
    device: each field of every result is stacked once."""
    def stack(get):
        return torch.stack([get(r) for r in results]).to(device)

    if use_post:
        post = HMMPosterior(*[stack(lambda r, f=f: getattr(r.post, f))
                              for f in ("alpha", "epsilon")],
                            niw=NIW(*[stack(lambda r, f=f: getattr(
                                r.post.niw, f)) for f in NIW._fields]))
        beta = post.niw.beta
        prior = torch.exp(e_log_dirichlet(post.alpha))
        trans = torch.exp(e_log_dirichlet(post.epsilon))
        mean = post.niw.m
        cov = post.niw.expected_cov() * ((beta + 1.0) / beta)[..., None, None]
    else:
        prior, trans, mean, cov = (stack(lambda r, f=f: getattr(r.model, f))
                                   for f in HMM._fields)
    if covar_type == "diag":
        cov = cov * torch.eye(cov.shape[-1], dtype=cov.dtype,
                              device=cov.device)
    if dtype is not None:
        tdt = torch.from_numpy(np.zeros(0, dtype)).dtype
        prior, trans, mean, cov = (x.to(tdt) for x in (prior, trans, mean,
                                                        cov))
    k_b, s = prior.shape
    return H3M(omega=torch.full((k_b,), 1.0 / k_b, dtype=prior.dtype,
                                device=device),
               hmm=HMM(prior=prior, trans=trans, mean=mean, cov=cov),
               state_mask=torch.ones((k_b, s), dtype=torch.bool,
                                     device=device))


def h3m_from_hmms(hmms: Sequence[HMM], s_max: Optional[int] = None,
                  device="cuda") -> H3M:
    """Build a base H3M from plain point-estimate HMMs, on ``device`` (the
    card unless the caller names another)."""
    device = resolve_device(device)
    k_b = len(hmms)
    d = hmms[0].dim
    ss = [h.num_states for h in hmms]
    sm = s_max if s_max is not None else max(ss)
    dt = _np(hmms[0].mean).dtype
    prior = np.zeros((k_b, sm), dt)
    trans = np.zeros((k_b, sm, sm), dt)
    mean = np.zeros((k_b, sm, d), dt)
    cov = np.tile(np.eye(d, dtype=dt), (k_b, sm, 1, 1))
    mask = np.zeros((k_b, sm), bool)
    for i, h in enumerate(hmms):
        s = ss[i]
        mask[i, :s] = True
        prior[i, :s] = _np(h.prior)
        trans[i, :s, :s] = _np(h.trans)
        mean[i, :s] = _np(h.mean)
        cov[i, :s] = _np(h.cov)
    return _bank(prior, trans, mean, cov, mask, device)


# ---------------------------------------------------------------------------
# E-step
# ---------------------------------------------------------------------------

class ReducedExpectations(NamedTuple):
    log_omega: torch.Tensor  # [..., Kr]      E[log omega]
    log_pi: torch.Tensor     # [..., Kr, Sr]  E[log pi]
    log_a: torch.Tensor      # [..., Kr, Sr, Sr]
    log_lam: torch.Tensor    # [..., Kr, Sr]  E[log |Lambda|]


def reduced_expectations(post: H3MPosterior,
                         cmask: Optional[torch.Tensor] = None,
                         smask: Optional[torch.Tensor] = None
                         ) -> ReducedExpectations:
    """Digamma expectations of the reduced model
    (`vbhem_h3m_c_step_fc.m:118-165, 270-273`).  With cmask [..., Kr] and
    smask [..., Sr] (bool, broadcasting against the posterior's lanes) the
    model is PADDED (`vbhem_tpu.models.vbhem.reduced_expectations_masked`):
    normalizers run over active entries only, and masked entries carry
    -1e30, finite, so every downstream exp() is exactly 0."""
    if cmask is None:
        return ReducedExpectations(
            log_omega=e_log_dirichlet(post.alpha),
            log_pi=e_log_dirichlet(post.eta),
            log_a=e_log_dirichlet(post.epsilon),
            log_lam=e_log_det_lambda(post.niw.v, post.niw.w))
    return ReducedExpectations(
        log_omega=masked_e_log_dirichlet(post.alpha, cmask),
        log_pi=masked_e_log_dirichlet(post.eta, smask[..., None, :]),
        log_a=masked_e_log_dirichlet(post.epsilon,
                                     smask[..., None, None, :]),
        log_lam=e_log_det_lambda(post.niw.v, post.niw.w))


def e_step(base: H3M, post: H3MPosterior, exps: ReducedExpectations,
           tau: int) -> PairStats:
    """Pair E-step over the full [Kb, Kr] grid of every lane
    (`vbhem_h3m_c_step_fc.m:168-268`): the fused CUDA kernel on the card,
    the plain PyTorch version on the CPU."""
    return pair_estep_fused_auto(
        base.hmm.prior, base.hmm.trans, base.hmm.mean, base.hmm.cov,
        exps.log_pi, exps.log_a, post.niw.m, post.niw.w, post.niw.v,
        post.niw.beta, exps.log_lam, tau)


def _all_reduce_sum(tensors, group) -> list:
    """Sum each tensor over the ranks of ``group`` in one collective (one
    flat buffer); every rank gets the same bits back."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [part.reshape(t.shape) for part, t in
            zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]


def soft_assignments(tilde_n: torch.Tensor, log_omega: torch.Tensor,
                     ll_elbo: torch.Tensor, group=None):
    """hat_Z softmax weighted by virtual counts
    (`vbhem_h3m_c_step_fc.m:275-283`).  tilde_n [Kb], log_omega [..., Kr],
    ll_elbo [..., Kb, Kr].

    The softmax over clusters is row-local; only the cluster masses Nj
    reduce over the base axis: with ``group`` (a ``torch.distributed``
    process group over which the Kb axis is sharded) they are summed over
    its ranks before ``tiny`` is added, once."""
    dtype = ll_elbo.dtype
    log_z = tilde_n[:, None] * (log_omega[..., None, :] + ll_elbo)
    # normalized exponentials, not exp(log_z - logsumexp(log_z)): log_z is
    # tilde_n times the bound (1e4 and more), where one float32 rounding
    # of the logsumexp scales a row by up to 1e-3, and lt1 = sum z_ni *
    # ll_elbo then carries that error times the bound (PERF.md §6)
    hat_z = torch.softmax(log_z, dim=-1)
    hat_z = hat_z + tiny(dtype)
    z_ni = hat_z * tilde_n[:, None]
    nj = torch.sum(z_ni, dim=-2)
    if group is not None:
        dist.all_reduce(nj, group=group)
    nj = nj + tiny(dtype)
    return hat_z, z_ni, nj


# ---------------------------------------------------------------------------
# M-step (vbhem_compute_Statistics.m + vbhem_mstep_component.m)
# ---------------------------------------------------------------------------

class ClusterStats(NamedTuple):
    nj: torch.Tensor          # [..., Kr]
    nj_rho1: torch.Tensor     # [..., Kr, Sr]
    nj_rho2rho: torch.Tensor  # [..., Kr, Sr, Sr]
    nj_rho: torch.Tensor      # [..., Kr, Sr]
    y_bar: torch.Tensor       # [..., Kr, Sr, D]
    s_plus_c: torch.Tensor    # [..., Kr, Sr, D, D]


def aggregate_stats(base: H3M, pair: PairStats, z_ni: torch.Tensor,
                    nj: torch.Tensor, group=None) -> ClusterStats:
    """Z-weighted reduction of pair statistics over the base axis.  The
    emission statistics are linear images of ``sum_t_nu`` against cached
    base moments (`vbhem_hmm_bwd_fwd_fast.m:350-384` merged with
    `vbhem_compute_Statistics.m:33-78`).  With ``group`` (the Kb axis
    sharded over its ranks) the five raw sums are summed over the ranks,
    in one collective, before ``tiny``, the division and ``sym``."""
    dtype = z_ni.dtype
    mean_b, cov_b = base.hmm.mean, base.hmm.cov
    nj_rho1 = torch.einsum("...ij,...ijr->...jr", z_ni, pair.nu_1)
    nj_rho2rho = torch.einsum("...ij,...ijrs->...jrs", z_ni, pair.sum_xi)
    # second moment cache: mu mu^T + Sigma per base state
    m2_b = mean_b[..., :, None] * mean_b[..., None, :] + cov_b  # [Kb,Sb,D,D]
    emit_pr = torch.sum(pair.sum_t_nu, dim=-1)                 # [..,Kb,Kr,Sr]
    nj_rho = torch.einsum("...ij,...ijr->...jr", z_ni, emit_pr)
    w_stn = z_ni[..., None, None] * pair.sum_t_nu              # [..,i,j,r,b]
    y_sum = torch.einsum("...ijrb,ibd->...jrd", w_stn, mean_b)
    m2_sum = torch.einsum("...ijrb,ibde->...jrde", w_stn, m2_b)
    if group is not None:
        nj_rho1, nj_rho2rho, nj_rho, y_sum, m2_sum = _all_reduce_sum(
            (nj_rho1, nj_rho2rho, nj_rho, y_sum, m2_sum), group)
    nj_rho = nj_rho + tiny(dtype)
    y_bar = y_sum / nj_rho[..., None]
    s_plus_c = sym(m2_sum / nj_rho[..., None, None]
                   - y_bar[..., :, None] * y_bar[..., None, :])
    if nj_rho1.shape[-1] == 1:
        # degenerate transition counts (`vbhem_compute_Statistics.m:80-82`)
        nj_rho2rho = torch.full_like(nj_rho2rho, 1e-12)
    return ClusterStats(nj=nj, nj_rho1=nj_rho1, nj_rho2rho=nj_rho2rho,
                        nj_rho=nj_rho, y_bar=y_bar, s_plus_c=s_plus_c)


def m_step(stats: ClusterStats, hyps: VBHEMHyps,
           covar_type: str = "full") -> H3MPosterior:
    """Conjugate natural-parameter updates (`vbhem_mstep_component.m:42-72`
    + the alpha update of `vbhem_h3m_c_step_fc.m:394-397`).  With
    ``covar_type='diag'`` the scatter enters as diag(S_plus_C) and the
    Wishart scale is kept as a diagonal matrix.  ``hyps`` is one set (0-d
    and [D] leaves) or one per lane ([*lanes] and [*lanes, D], the lanes
    of ``stats``)."""
    dtype = stats.y_bar.dtype
    lam0 = lane_hyp(hyps.lambda0, 0, 2)                    # against [..,Kr,Sr]
    m0 = lane_hyp(hyps.m0, 1, 2)                           # [.., 1, 1, D]
    alpha = lane_hyp(hyps.alpha0, 0, 1) + stats.nj
    eta = lane_hyp(hyps.eta0, 0, 2) + stats.nj_rho1
    epsilon = lane_hyp(hyps.epsilon0, 0, 3) + stats.nj_rho2rho
    lam = lam0 + stats.nj_rho
    v = lane_hyp(hyps.v0, 0, 2) + stats.nj_rho + 1.0
    m = (lane_hyp(hyps.lambda0, 0, 3) * m0
         + stats.nj_rho[..., None] * stats.y_bar) / lam[..., None]
    mult1 = lam0 * stats.nj_rho / lam
    diff3 = stats.y_bar - m0                                   # [..,Kr,Sr,D]
    w0inv = lane_hyp(torch.diag_embed(hyps.w0inv_diag.to(dtype)), 2, 2)
    d = stats.y_bar.shape[-1]
    eye = torch.eye(d, dtype=dtype, device=stats.y_bar.device)
    s_pc = stats.s_plus_c
    if covar_type == "diag":
        s_pc = s_pc * eye
    winv = (w0inv + stats.nj_rho[..., None, None] * s_pc
            + mult1[..., None, None] * diff3[..., :, None] * diff3[..., None, :])
    w = inv_psd(winv)
    if covar_type == "diag":
        w = w * eye
    return H3MPosterior(alpha=alpha, eta=eta, epsilon=epsilon,
                        niw=NIW(beta=lam, v=v, m=m, w=w))


# ---------------------------------------------------------------------------
# ELBO (vbhemh3m_lb.m)
# ---------------------------------------------------------------------------

def wide_expectations(post: H3MPosterior,
                      cmask: Optional[torch.Tensor] = None,
                      smask: Optional[torch.Tensor] = None):
    """The reduced expectations for both readers of an EM iteration:
    (the posterior in float64, its expectations in float64, those
    expectations in the posterior's dtype).  The bound (:func:`elbo`)
    takes the first two, the E-step and the soft assignments the last.
    In a float64 run all three are the posterior and one set of
    expectations; in float32 the posterior is cast in one block and the
    E-step gets the float64 expectations rounded."""
    dtype = post.alpha.dtype
    post_w, = block_cast((post,), torch.float64)
    exps_w = reduced_expectations(post_w, cmask, smask)
    exps, = block_cast((exps_w,), dtype)
    return post_w, exps_w, exps


def elbo(post: H3MPosterior, exps: ReducedExpectations, pair: PairStats,
         hat_z: torch.Tensor, z_ni: torch.Tensor, nj: torch.Tensor,
         hyps: VBHEMHyps, cmask: Optional[torch.Tensor] = None,
         smask: Optional[torch.Tensor] = None, return_terms: bool = False,
         group=None):
    """The 10-term VBHEM lower bound (`vbhemh3m_lb.m:88-186`), one value
    per lane: [...], in the dtype of ``hat_z`` (the run's).  With cmask
    [..., Kr] and smask [..., Sr] (bool) it
    is the bound over the ACTIVE sub-grid of each padded lane, equal to
    the bound of the unpadded (K, S) model
    (`vbhem_tpu.models.vbhem.elbo_masked`); without them every entry is
    active.  Every sum multiplies by the mask before it meets a masked
    -1e30 expectation, as the JAX package does: (mask * count) * log_a is
    0 * -1e30, while count * -1e30 first can overflow float32 to -inf and
    then 0 * inf is NaN.  With ``return_terms`` also the dict of the ten
    terms (lt1..lt10 in `vbhemh3m_lb.m` order, before their signs), in
    float64.  ``hyps`` is one set or one per lane, as in :func:`m_step`.
    With ``group`` (the Kb axis sharded over its ranks) lt1 and lt7, the
    only terms that sum over Kb, are summed over the ranks in one
    collective; every other term is computed alike on every rank from the
    same posterior and the reduced Nj.

    Every term but lt1 and lt7 is evaluated in float64 whatever the run's
    dtype: those terms scale with the hyperparameters and concentrations
    (lgamma(S eps0) - S lgamma(eps0), (eps0 - 1) sum E[log A], the
    posterior's Dirichlet constants, the Normal-Wishart constants), and
    under learned hyperparameters (eps0 up to e^30) their float32 rounding
    is thousands of nats, more than the EM stopping test's tolerance.
    ``post``, ``nj`` and ``hyps`` are cast in one block; ``exps`` are used
    as given in float64 (:func:`wide_expectations`), else recomputed from
    the cast posterior.  lt1 and lt7, the data terms over [..., Kb, Kr],
    stay in the run's dtype (their float32 rounding, about 1e-7 of the
    bound, is far below the stopping test's 1e-5).  The sum of the terms
    is rounded to the run's dtype."""
    dtype = hat_z.dtype
    wd = torch.float64
    ks = (-2, -1)           # the (Kr, Sr) axes of each lane
    if cmask is None:
        cmask = torch.ones(post.alpha.shape, dtype=torch.bool,
                           device=hat_z.device)
        smask = torch.ones(post.alpha.shape[:-1] + (post.num_states,),
                           dtype=torch.bool, device=hat_z.device)
    cmd = cmask.to(dtype)[..., None, :]                      # [.., 1, Kr]
    lt1 = torch.sum(cmd * z_ni * pair.ll_elbo, dim=ks)
    lt7 = torch.sum(cmd * hat_z * torch.log(hat_z), dim=ks)
    if group is not None:
        lt1, lt7 = _all_reduce_sum((lt1, lt7), group)

    post, nj, hyps = block_cast((post, nj, hyps), wd)
    if exps.log_a.dtype != wd:
        exps = reduced_expectations(post, cmask, smask)
    d = post.niw.dim
    niw = post.niw
    two_pi = 2.0 * math.pi
    cm = cmask.to(wd)                                         # [..., Kr]
    sm = smask.to(wd)                                         # [..., Sr]
    cs = cm[..., :, None] * sm[..., None, :]                  # [..,Kr,Sr]
    css = cs[..., :, :, None] * sm[..., None, None, :]        # [..,Kr,Sr,Sr]
    kr_a = torch.sum(cm, dim=-1)
    sr_a = torch.sum(sm, dim=-1)

    logdet_w0inv = torch.sum(torch.log(hyps.w0inv_diag), dim=-1)
    log_c_alpha0 = (torch.lgamma(kr_a * hyps.alpha0)
                    - kr_a * torch.lgamma(hyps.alpha0))
    log_c_eta0 = torch.lgamma(sr_a * hyps.eta0) - sr_a * torch.lgamma(hyps.eta0)
    log_c_eps0 = (torch.lgamma(sr_a * hyps.epsilon0)
                  - sr_a * torch.lgamma(hyps.epsilon0))
    log_b0 = log_wishart_b(logdet_w0inv, hyps.v0, d)

    lt2 = torch.sum(cm * nj * exps.log_omega, dim=-1)
    lt3 = kr_a * log_c_eta0 + (hyps.eta0 - 1.0) * torch.sum(
        cs * exps.log_pi, dim=ks)
    lt4 = kr_a * sr_a * log_c_eps0 + (hyps.epsilon0 - 1.0) * torch.sum(
        css * exps.log_a, dim=(-3, -2, -1))

    # Lt5: E[log p(mu, Lambda)] over all active (j, k)
    dm = niw.m - lane_hyp(hyps.m0, 1, 2)                       # [..,Kr,Sr,D]
    m_w_m = torch.einsum("...d,...de,...e->...", dm, niw.w, dm)
    w0inv_diag = lane_hyp(hyps.w0inv_diag, 1, 2)
    tr_w0inv_w = torch.sum(w0inv_diag * torch.diagonal(niw.w, dim1=-2,
                                                       dim2=-1), dim=-1)
    lam0 = lane_hyp(hyps.lambda0, 0, 2)                        # [.., 1, 1]
    const2 = d * torch.log(lam0 / two_pi)
    lt51 = 0.5 * torch.sum(cs * (const2 + exps.log_lam
                                 - d * lam0 / niw.beta
                                 - lam0 * niw.v * m_w_m), dim=ks)
    lt52 = (kr_a * sr_a * log_b0
            + 0.5 * (hyps.v0 - d - 1.0) * torch.sum(cs * exps.log_lam,
                                                     dim=ks)
            - 0.5 * torch.sum(cs * niw.v * tr_w0inv_w, dim=ks))
    lt5 = lt51 + lt52

    lt6 = log_c_alpha0 + (hyps.alpha0 - 1.0) * torch.sum(
        cm * exps.log_omega, dim=-1)
    lt8 = (masked_log_dirichlet_const(post.alpha, cmask)
           + torch.sum(cm * (post.alpha - 1.0) * exps.log_omega, dim=-1))
    lt9 = (torch.sum(cm * masked_log_dirichlet_const(
               post.eta, smask[..., None, :]), dim=-1)
           + torch.sum(cs * (post.eta - 1.0) * exps.log_pi, dim=ks)
           + torch.sum(cs * masked_log_dirichlet_const(
               post.epsilon, smask[..., None, None, :]), dim=ks)
           + torch.sum(css * (post.epsilon - 1.0) * exps.log_a,
                       dim=(-3, -2, -1)))

    log_bk = log_wishart_b(-logdet_psd(niw.w), niw.v, d)       # [..,Kr,Sr]
    h_ent = torch.sum(cs * (-log_bk - 0.5 * (niw.v - d - 1.0) * exps.log_lam
                            + 0.5 * niw.v * d), dim=ks)
    lt10 = (0.5 * torch.sum(cs * (exps.log_lam
                                  + d * torch.log(niw.beta / two_pi)),
                            dim=ks)
            - 0.5 * d * kr_a * sr_a - h_ent)

    total = (lt1 + lt2 + lt3 + lt4 + lt5 + lt6 - lt7 - lt8 - lt9
             - lt10).to(dtype)
    if return_terms:
        terms = (lt1, lt2, lt3, lt4, lt5, lt6, lt7, lt8, lt9, lt10)
        return total, {f"lt{i}": t for i, t in enumerate(terms, 1)}
    return total


# ---------------------------------------------------------------------------
# EM loop (vbhem_h3m_c_step_fc.m)
# ---------------------------------------------------------------------------

def _project_diag(post: H3MPosterior) -> H3MPosterior:
    """Constrain a posterior's Wishart scales to diagonal matrices."""
    eye = torch.eye(post.niw.dim, dtype=post.niw.w.dtype,
                    device=post.niw.w.device)
    return post._replace(niw=post.niw._replace(w=post.niw.w * eye))


class VBHEMState(NamedTuple):
    post: H3MPosterior
    ll: torch.Tensor          # [...]
    last_ll: torch.Tensor     # [...]
    it: torch.Tensor          # [...] int64
    hat_z: torch.Tensor       # [..., Kb, Kr]
    ll_elbo: torch.Tensor     # [..., Kb, Kr]
    stats: ClusterStats
    done: torch.Tensor        # [...] bool


def _em_iteration(base: H3M, post: H3MPosterior, hyps: VBHEMHyps,
                  tilde_n: torch.Tensor, tau: int, covar_type: str = "full",
                  masks=None, group=None):
    """One EM iteration on every lane: returns (new posterior, ELBO of
    ``post``, pair ll_elbo, hat_z, stats).  ``masks`` (cmask, smask)
    confines each lane to its active sub-grid (the padded grid); with
    ``group`` ``base`` is this rank's shard of a bank sharded over the
    group's ranks, and the statistics and the ELBO are summed over them."""
    masks = masks or (None, None)
    post_w, exps_w, exps = wide_expectations(post, *masks)
    pair = e_step(base, post, exps, tau)
    hat_z, z_ni, nj = soft_assignments(tilde_n, exps.log_omega, pair.ll_elbo,
                                       group)
    ll = elbo(post_w, exps_w, pair, hat_z, z_ni, nj, hyps, *masks,
              group=group)
    stats = aggregate_stats(base, pair, z_ni, nj, group)
    return m_step(stats, hyps, covar_type), ll, pair.ll_elbo, hat_z, stats


def vbhem_em(base: H3M, init_post: H3MPosterior, hyps: VBHEMHyps,
             nv: int, tau: int, max_iter: int = 200,
             min_diff: float = 1e-5, covar_type: str = "full",
             cmask: Optional[torch.Tensor] = None,
             smask: Optional[torch.Tensor] = None, group=None,
             kb_total: Optional[int] = None) -> VBHEMState:
    """The VBHEM EM loop (`vbhem_h3m_c_step_fc.m:115-433`) over every lane
    of ``init_post`` at once.  With ``cmask`` [..., Kr] and ``smask``
    [..., Sr] (bool, the lanes leading; each lane its own) it is
    :func:`vbhem_em_masked`: every lane's mass stays on its active
    (K, S) sub-grid.

    Virtual counts: tilde_N_i = Nv * Kb * omega_i.  Per iteration:
    expectations, pair E-step, hat_Z, ELBO, convergence check, M-step —
    the M-step still applies on the converging iteration, and a NaN ELBO
    becomes -inf and keeps the old posterior.  A lane is done once it
    converged (``|(ll - last)/last| <= min_diff`` after its first
    iteration), went unstable or reached ``max_iter``; from then on it is
    frozen, as under ``jax.vmap`` of ``lax.while_loop``.

    When the base axis is sharded over the ranks of ``group`` (a
    ``torch.distributed`` process group; :mod:`..parallel.spmd`), ``base``
    is this rank's contiguous block of the bank and ``kb_total`` the whole
    bank's Kb: tilde_N = Nv * kb_total * omega, the shard's ``omega`` a
    slice of the whole one, not renormalized.  The statistics and the
    ELBO's sums over Kb are summed over the ranks; hat_z and ll_elbo stay
    the shard's rows.  ``group=None`` is the unsharded loop."""
    kb = kb_total if kb_total is not None else base.num_hmms
    tilde_n = (nv * kb) * base.omega
    if covar_type == "diag":
        init_post = _project_diag(init_post)
    if (cmask is None) != (smask is None):
        raise ValueError("cmask and smask go together")
    converged = within(min_diff)

    def body(st: VBHEMState) -> VBHEMState:
        new_post, ll, ll_elbo, hat_z, stats = _em_iteration(
            base, st.post, hyps, tilde_n, tau, covar_type, (cmask, smask),
            group)
        ll, unstable, done = settle(ll, st.ll, st.it, max_iter, converged)
        return VBHEMState(post=lane_where(unstable, st.post, new_post), ll=ll,
                          last_ll=st.ll, it=st.it + 1, hat_z=hat_z,
                          ll_elbo=ll_elbo, stats=stats, done=done)

    ll0, it0, done0 = start(init_post.alpha.shape[:-1], base.hmm.mean.dtype,
                            base.hmm.mean.device)
    # Under ``group`` every rank of the group must run the same
    # iterations, or a collective waits for ever: ``done`` is a function of
    # the bounds and ``it`` alone (:func:`.lanes.settle`), ``ll`` is the same
    # bits on every rank because its sums over Kb come out of the
    # all-reduce and every other term is computed the same way on every
    # rank from the same posterior, so the ranks leave the loop together.
    return run_lanes("vbhem_em", body, VBHEMState(
        post=init_post, ll=ll0, last_ll=ll0, it=it0, hat_z=None,
        ll_elbo=None, stats=None, done=done0))


def vbhem_em_masked(base: H3M, init_post: H3MPosterior, hyps: VBHEMHyps,
                    nv: int, tau: int, cmask: torch.Tensor,
                    smask: torch.Tensor, max_iter: int = 200,
                    min_diff: float = 1e-5, covar_type: str = "full",
                    group=None, kb_total: Optional[int] = None
                    ) -> VBHEMState:
    """:func:`vbhem_em` over PADDED (Kmax, Smax) lanes: the cluster and
    state masks cmask [..., Kmax], smask [..., Smax] confine every lane's
    mass to its active sub-grid, so every (K, S) cell of the grid runs in
    the same loop (`vbhem_tpu.models.vbhem.vbhem_em_masked`).  ``group``
    and ``kb_total`` shard the base axis, as in :func:`vbhem_em`."""
    return vbhem_em(base, init_post, hyps, nv, tau, max_iter=max_iter,
                    min_diff=min_diff, covar_type=covar_type, cmask=cmask,
                    smask=smask, group=group, kb_total=kb_total)


def em_trace(base: H3M, init_post: H3MPosterior, hyps: VBHEMHyps,
             nv: int, tau: int, n_iter: int = 50):
    """Run exactly ``n_iter`` EM iterations recording the ELBO before each
    M-step (the reference's `LogLs` history).  Returns (final posterior,
    ll_history [n_iter, ...])."""
    tilde_n = (nv * base.num_hmms) * base.omega
    post, lls = init_post, []
    for _ in range(n_iter):
        post, ll, _, _, _ = _em_iteration(base, post, hyps, tilde_n, tau)
        lls.append(ll)
    return post, torch.stack(lls)


# ---------------------------------------------------------------------------
# initializers (vbhemhmm_init.m)
# ---------------------------------------------------------------------------

def _emission_w_from_cov(cov: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """W = inv((v - D - 1) * Sigma) (`vbhemhmm_init.m:86`)."""
    d = cov.shape[-1]
    return inv_psd((v[..., None, None] - d - 1.0) * cov)


def _rand(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """U(0, 1) draws on the generator's device."""
    return torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)


def draw_baseem(gen: torch.Generator, base: H3M, kr: int, sr: int,
                lanes: tuple = ()) -> dict:
    """The draws of 'baseem' for ``lanes``, on the generator's device: the
    base HMM [*L, Kr, Sr] and a uniform that picks its state, and the
    uniforms of the cluster weights [*L, Kr]."""
    shp = tuple(lanes) + (kr, sr)
    return {"rand_b": torch.randint(0, base.num_hmms, shp, generator=gen,
                                    device=gen.device),
            "u_state": _rand(gen, shp, torch.float64),
            "u_omega": _rand(gen, tuple(lanes) + (kr,),
                             base.hmm.mean.dtype)}


def baseem_from_draws(base: H3M, kr: int, sr: int, hyps: VBHEMHyps, nv: int,
                      rand_b: torch.Tensor, u_state: torch.Tensor,
                      u_omega: torch.Tensor) -> H3MPosterior:
    """'baseem' from the draws of :func:`draw_baseem`."""
    dtype = base.hmm.mean.dtype
    dev = base.hmm.mean.device
    kb, sb_max = base.state_mask.shape
    nv_total = nv * kb
    nlr = nv_total / kr
    shp = tuple(rand_b.shape)
    rand_b = rand_b.to(dev)
    # random valid state of the chosen base HMM
    n_states = torch.sum(base.state_mask, dim=-1)              # [Kb]
    rand_g = torch.floor(u_state.to(dev) * n_states[rand_b]).to(torch.int64)
    rand_g = torch.clamp(rand_g, max=sb_max - 1)

    v = torch.full(shp, float(hyps.v0) + nlr / sr + 1.0, dtype=dtype,
                   device=dev)
    lam = torch.full(shp, float(hyps.lambda0) + nlr / sr, dtype=dtype,
                     device=dev)
    m = base.hmm.mean[rand_b, rand_g]                      # [..,Kr,Sr,D]
    w = _emission_w_from_cov(base.hmm.cov[rand_b, rand_g], v)

    eta = torch.full(shp, 1.0 / sr, dtype=dtype, device=dev) * nlr \
        + hyps.eta0
    epsilon = torch.full(shp + (sr,), 1.0 / sr, dtype=dtype,
                         device=dev) * nlr / sr + hyps.epsilon0
    omega = u_omega.to(dev)
    omega = omega / torch.sum(omega, dim=-1, keepdim=True)
    alpha = hyps.alpha0 + omega * nv_total
    return H3MPosterior(alpha=alpha, eta=eta, epsilon=epsilon,
                        niw=NIW(beta=lam, v=v, m=m, w=w))


def init_baseem(gen: torch.Generator, base: H3M, kr: int, sr: int,
                hyps: VBHEMHyps, nv: int, lanes: tuple = ()) -> H3MPosterior:
    """'baseem' initializer (`vbhemhmm_init.m:58-100`): each reduced
    emission copies a random base emission; priors/transitions uniform
    (initopt mode 'u'); cluster weights random.  Draws on the generator's
    device, then moves to the bank's.  ``lanes`` draws that many
    independent starts at once, as leading axes."""
    return baseem_from_draws(base, kr, sr, hyps, nv,
                             **draw_baseem(gen, base, kr, sr, lanes))


def _pool(base: H3M):
    """The bank's states as one pool: means [M, D], covariances
    [M, D, D] and the valid-state weights [M] (1 real, 0 padded), M =
    Kb * Sb."""
    kb, sb = base.state_mask.shape
    d = base.hmm.mean.shape[-1]
    return (base.hmm.mean.reshape(kb * sb, d),
            base.hmm.cov.reshape(kb * sb, d, d),
            base.state_mask.reshape(-1).to(base.hmm.mean.dtype))


def long_run_weights(base: H3M) -> torch.Tensor:
    """Long-run state weights p A^50 of every base HMM over the pool,
    masked and normalized to sum 1 (makeGMMweights mode '0',
    `vbhemhmm_init.m:310-325`): [Kb * Sb]."""
    p = base.hmm.prior
    for _ in range(50):
        p = torch.einsum("ib,ibc->ic", p, base.hmm.trans)
    w = (p * base.state_mask).reshape(-1)
    return w / torch.sum(w)


def _random_dynamics(u_prior: torch.Tensor, u_trans: torch.Tensor):
    """Random initial and transition probabilities (initopt mode 'r')
    from uniform draws [..., Kr, Sr] and [..., Kr, Sr, Sr]."""
    return (u_prior / torch.sum(u_prior, dim=-1, keepdim=True),
            u_trans / torch.sum(u_trans, dim=-1, keepdim=True))


def _dirichlets(hyps: VBHEMHyps, counts: torch.Tensor, prior, trans):
    """(alpha, eta, epsilon) of the initializers that spread a cluster's
    virtual count ``counts`` [..., Kr] over random dynamics."""
    return (hyps.alpha0 + counts,
            prior * counts[..., None] + hyps.eta0,
            trans * counts[..., None, None] + hyps.epsilon0)


def wtkmeans_assign(base: H3M, seeds: torch.Tensor) -> torch.Tensor:
    """The first stage of 'wtkmeans' (`vbhemhmm_init.m:326-350`) from its
    kmeans++ seeds [*L, Kr, D]: plain k-means of the base emission means
    over the valid states (the reference's seeded `kmeans`), then the
    energy-adjusted weighted k-means of `my_weighted_kmeans.m` under the
    long-run state weights; on the card each is one launch of
    ``csrc/kmeans.cu`` (:mod:`~vbhem_tpu_torch.ops.kmeans_cuda`).
    Returns each pool state's cluster [*L, M]."""
    means, _, valid = _pool(base)
    _, init_c = kmeans_cuda.kmeans_auto(means, seeds, weights=valid)
    assign, _ = kmeans_cuda.weighted_kmeans_energy_auto(
        means, long_run_weights(base), init_c)
    return assign


def wtkmeans_cluster_weights(base: H3M, assign: torch.Tensor,
                             kr: int) -> torch.Tensor:
    """The point weights of each cluster's k-means into Sr centers: its
    valid member states, or every valid state where it has none (its
    centers are then replaced by the global ones).  [*L, Kr, M]."""
    _, _, valid = _pool(base)
    member = (assign[..., None, :] == torch.arange(
        kr, device=assign.device)[:, None]).to(valid.dtype) * valid
    has = torch.sum(member, dim=-1, keepdim=True) > 0
    return torch.where(has, member, valid)


def wtkmeans_from_draws(base: H3M, kr: int, sr: int, hyps: VBHEMHyps,
                        nv: int, assign: torch.Tensor,
                        global_seeds: torch.Tensor,
                        cluster_seeds: torch.Tensor, u_prior: torch.Tensor,
                        u_trans: torch.Tensor) -> H3MPosterior:
    """The rest of 'wtkmeans' (`vbhemhmm_init.m:351-425`) from its draws:
    the clusters of :func:`wtkmeans_assign`, the kmeans++ seeds of the
    global k-means into Sr centers [*L, Sr, D] and of each cluster's
    [*L, Kr, Sr, D] (weighted by :func:`wtkmeans_cluster_weights`), and
    uniform draws for the random dynamics.  On the card the global and the
    per-cluster k-means are one launch of ``csrc/kmeans.cu`` each, a
    (lane, cluster) a block.  Every W comes from the first base HMM's
    first state covariance, the reference's recipe (`:411-419`)."""
    means, covs, valid = _pool(base)
    dtype, dev = means.dtype, means.device
    kb = base.num_hmms
    d = means.shape[-1]
    lanes = tuple(assign.shape[:-1])
    shp = lanes + (kr, sr)
    nj_virt = nv * kb / kr
    _, global_c = kmeans_cuda.kmeans_auto(
        means, global_seeds, weights=valid)                  # [*L, Sr, D]
    wts = wtkmeans_cluster_weights(base, assign, kr)
    _, centers = kmeans_cuda.kmeans_auto(
        means, cluster_seeds, weights=wts)                   # [*L,Kr,Sr,D]
    has = torch.any((assign[..., None, :] == torch.arange(
        kr, device=dev)[:, None]) & (valid > 0), dim=-1)      # [*L, Kr]
    centers = torch.where(has[..., None, None], centers,
                          global_c[..., None, :, :])
    v = torch.full(shp, float(hyps.v0) + nj_virt / sr + 1.0, dtype=dtype,
                   device=dev)
    lam = torch.full(shp, float(hyps.lambda0) + nj_virt / sr, dtype=dtype,
                     device=dev)
    w = _emission_w_from_cov(covs[0].expand(shp + (d, d)), v)
    prior, trans = _random_dynamics(u_prior, u_trans)
    counts = torch.full(lanes + (kr,), nj_virt, dtype=dtype, device=dev)
    alpha, eta, epsilon = _dirichlets(hyps, counts, prior, trans)
    return H3MPosterior(alpha=alpha, eta=eta, epsilon=epsilon,
                        niw=NIW(beta=lam, v=v, m=centers, w=w))


def draw_wtkmeans(gen: torch.Generator, base: H3M, kr: int, sr: int,
                  lanes: tuple = ()) -> dict:
    """The draws of 'wtkmeans' for ``lanes``, on the generator's device:
    the kmeans++ uniforms of the Kr cluster seeds [*L, Kr], of the global
    Sr centers [*L, Sr] and of each cluster's [*L, Kr, Sr]
    (:func:`~vbhem_tpu_torch.ops.kmeans.kmeans_pp_from_uniforms`), and
    the uniforms of the random dynamics."""
    lanes = tuple(lanes)
    dtype = base.hmm.mean.dtype
    return {"u_assign": _rand(gen, lanes + (kr,), torch.float64),
            "u_global": _rand(gen, lanes + (sr,), torch.float64),
            "u_cluster": _rand(gen, lanes + (kr, sr), torch.float64),
            "u_prior": _rand(gen, lanes + (kr, sr), dtype),
            "u_trans": _rand(gen, lanes + (kr, sr, sr), dtype)}


def wtkmeans_from_uniforms(base: H3M, kr: int, sr: int, hyps: VBHEMHyps,
                           nv: int, u_assign: torch.Tensor,
                           u_global: torch.Tensor, u_cluster: torch.Tensor,
                           u_prior: torch.Tensor,
                           u_trans: torch.Tensor) -> H3MPosterior:
    """'wtkmeans' from the draws of :func:`draw_wtkmeans`: the seeds
    from their uniforms, then :func:`wtkmeans_assign` and
    :func:`wtkmeans_from_draws`.  While profiling records, the Lloyd
    kernels' iterations are read back once at the end
    (:func:`~vbhem_tpu_torch.ops.kmeans_cuda.count_iterations`)."""
    means, _, valid = _pool(base)
    dev = means.device
    assign = wtkmeans_assign(base, kmeans_pp_from_uniforms(
        means, kr, valid, u_assign))
    post = wtkmeans_from_draws(
        base, kr, sr, hyps, nv, assign,
        kmeans_pp_from_uniforms(means, sr, valid, u_global),
        kmeans_pp_from_uniforms(
            means, sr, wtkmeans_cluster_weights(base, assign, kr),
            u_cluster),
        u_prior.to(dev), u_trans.to(dev))
    if profiling.active():
        kmeans_cuda.count_iterations()
    return post


def init_wtkmeans(gen: torch.Generator, base: H3M, kr: int, sr: int,
                  hyps: VBHEMHyps, nv: int, lanes: tuple = ()) -> H3MPosterior:
    """'wtkmeans' initializer (`vbhemhmm_init.m:294-425`): weighted
    k-means of the base emission means into Kr clusters (weights = the
    long-run state probabilities), then k-means of each cluster's members
    into Sr states; random priors and transitions (initopt mode 'r').
    One k-means per lane and cluster, all lanes at once."""
    return wtkmeans_from_uniforms(base, kr, sr, hyps, nv,
                                  **draw_wtkmeans(gen, base, kr, sr, lanes))


def random_labels(gen: torch.Generator, kb: int, kr: int, lanes: tuple = (),
                  device="cpu") -> torch.Tensor:
    """A random partition of the Kb base HMMs into Kr clusters per lane,
    every cluster non-empty where Kb >= Kr (the reference's
    resample-until loop, `vbhemhmm_init.m:880-900`): the first Kr HMMs of
    a random permutation get distinct labels, the rest uniform ones.
    [*lanes, Kb], on ``device``."""
    lanes = tuple(lanes)
    perm = torch.argsort(torch.rand(lanes + (kb,), generator=gen,
                                    device=gen.device), dim=-1)
    lab = torch.randint(0, kr, lanes + (kb,), generator=gen,
                        device=gen.device)
    npin = min(kr, kb)
    lab.scatter_(-1, perm[..., :npin],
                 torch.arange(npin, device=gen.device).expand(
                     lanes + (npin,)).contiguous())
    return lab.to(device)


def _random_pools(base: H3M, labels: torch.Tensor, kr: int):
    """Each cluster's pool for its GMM: the pooled base means [*L, Kr,
    M, D] (a broadcast view) and the weights of the cluster's valid member
    states [*L, Kr, M]."""
    means, _, valid = _pool(base)
    kb, sb = base.state_mask.shape
    lanes = tuple(labels.shape[:-1])
    member = labels.repeat_interleave(sb, dim=-1)           # [*L, M]
    w = (member[..., None, :] == torch.arange(
        kr, device=labels.device)[:, None]).to(means.dtype) * valid
    return means.expand(lanes + (kr,) + means.shape), w


def random_conversion(base: H3M, kr: int, sr: int, hyps: VBHEMHyps, nv: int,
                      labels: torch.Tensor, mix) -> H3MPosterior:
    """The hyper-space conversion of 'random' (`vbhemhmm_init.m:983-1030`)
    from the partition ``labels`` [*L, Kb] and each cluster's GMM ``mix``
    (weight [*L, Kr, Sr], mean [.., D], cov [.., D, D]): member masses
    N_i = Nv * omega_b, Nj_rho = N_j * mix.weight, the posterior mean
    m = (lambda0 m0 + Nj_rho ybar) / lambda and
    W = inv(W0^-1 + Nj_rho Sigma + lambda0 Nj_rho / (lambda0 + Nj_rho)
    (ybar - m0)(ybar - m0)^T)."""
    dtype = mix.mean.dtype
    n_i = nv * base.omega                                   # [Kb]
    one_hot = (labels[..., None] == torch.arange(
        kr, device=labels.device)).to(dtype)                # [*L, Kb, Kr]
    n_j = torch.sum(one_hot * n_i[:, None], dim=-2)         # [*L, Kr]
    nj_rho = n_j[..., None] * mix.weight                    # [*L, Kr, Sr]
    lam = hyps.lambda0 + nj_rho
    v = hyps.v0 + nj_rho + 1.0
    ybar = mix.mean
    m = (hyps.lambda0 * hyps.m0 + nj_rho[..., None] * ybar) / lam[..., None]
    mult1 = hyps.lambda0 * nj_rho / (hyps.lambda0 + nj_rho)
    diff = ybar - hyps.m0
    w_inv = (torch.diag(hyps.w0inv_diag.to(dtype))
             + nj_rho[..., None, None] * mix.cov
             + mult1[..., None, None] * diff[..., :, None]
             * diff[..., None, :])
    shp = nj_rho.shape
    eta = hyps.eta0 + torch.broadcast_to((n_j / sr)[..., None], shp)
    epsilon = hyps.epsilon0 + torch.broadcast_to(
        (n_j / sr)[..., None, None], shp + (sr,))
    return H3MPosterior(alpha=hyps.alpha0 + n_j, eta=eta, epsilon=epsilon,
                        niw=NIW(beta=lam, v=v, m=m.contiguous(),
                                w=inv_psd(w_inv)))


def random_from_draws(base: H3M, kr: int, sr: int, hyps: VBHEMHyps, nv: int,
                      labels: torch.Tensor,
                      mean0: torch.Tensor) -> H3MPosterior:
    """'random' from its draws: the partition ``labels`` [*L, Kb] and each
    cluster's GMM start means [*L, Kr, Sr, D]."""
    x, w = _random_pools(base, labels, kr)
    return random_conversion(base, kr, sr, hyps, nv, labels,
                             fit_gmm_from_means(x, mean0, w))


def draw_random(gen: torch.Generator, base: H3M, kr: int, sr: int,
                lanes: tuple = ()) -> dict:
    """The draws of 'random' for ``lanes``, on the generator's device: the
    partition (:func:`random_labels`, [*L, Kb]) and the uniforms of each
    cluster's GMM start [*L, Kr, Sr]."""
    lanes = tuple(lanes)
    return {"labels": random_labels(gen, base.num_hmms, kr, lanes,
                                    gen.device),
            "u_start": _rand(gen, lanes + (kr, sr), torch.float64)}


def random_from_uniforms(base: H3M, kr: int, sr: int, hyps: VBHEMHyps,
                         nv: int, labels: torch.Tensor,
                         u_start: torch.Tensor) -> H3MPosterior:
    """'random' from the draws of :func:`draw_random`: each cluster's Sr
    start means drawn from its member states in proportion to their
    weights, without replacement
    (:func:`~vbhem_tpu_torch.ops.gmm.sample_without_replacement`, the
    start of ``fit_gmm(start_weighted=True)``), the GMM fit from them and
    the conversion of :func:`random_conversion`."""
    means = _pool(base)[0]
    labels = labels.to(means.device)
    x, w = _random_pools(base, labels, kr)
    mean0 = means[sample_without_replacement(w, u_start.to(means.device))]
    return random_conversion(base, kr, sr, hyps, nv, labels,
                             fit_gmm_from_means(x, mean0, w))


def init_random(gen: torch.Generator, base: H3M, kr: int, sr: int,
                hyps: VBHEMHyps, nv: int, lanes: tuple = ()) -> H3MPosterior:
    """'random' initializer (`vbhemhmm_init.m:874-1038`): a random
    partition of the base HMMs into clusters (:func:`random_labels`), an
    Sr-component GMM fit on each cluster's member emission means, its
    start means drawn in proportion to the member weights, then the
    conversion of :func:`random_conversion`.

    As in the JAX package, the reference's small-pool edge cases (Sr == 1
    a single Gaussian, Nd <= Sr iid-variance padding, `:911-928`) are
    absorbed by the always-ridged weighted EM fit."""
    return random_from_uniforms(base, kr, sr, hyps, nv,
                                **draw_random(gen, base, kr, sr, lanes))


def _gmm_new_post(base: H3M, kr: int, sr: int, hyps: VBHEMHyps, nv: int,
                  mean: torch.Tensor, cov: torch.Tensor,
                  u_omega: torch.Tensor, u_prior: torch.Tensor,
                  u_trans: torch.Tensor) -> H3MPosterior:
    """The conversion shared by 'gmmNew' and 'gmmNew2'
    (`vbhemhmm_init.m:258-291`): the reduced Gaussians mean [*L, Kr, Sr,
    D] and cov [.., D, D] as every cluster's emissions, random cluster
    weights and dynamics, converted to hyperparameter space through the
    virtual counts Nsj = omega_j * Nv * Kb."""
    omega = u_omega / torch.sum(u_omega, dim=-1, keepdim=True)
    nsj = omega * (nv * base.num_hmms)                      # [*L, Kr]
    nsj_rho = torch.broadcast_to(nsj[..., None] / sr, nsj.shape + (sr,))
    v = hyps.v0 + nsj_rho + 1.0
    lam = hyps.lambda0 + nsj_rho
    prior, trans = _random_dynamics(u_prior, u_trans)
    alpha, eta, epsilon = _dirichlets(hyps, nsj, prior, trans)
    return H3MPosterior(alpha=alpha, eta=eta, epsilon=epsilon,
                        niw=NIW(beta=lam, v=v, m=mean.contiguous(),
                                w=_emission_w_from_cov(cov, v)))


def gmmnew_from_draws(base: H3M, kr: int, sr: int, hyps: VBHEMHyps, nv: int,
                      seeds: torch.Tensor, u_omega: torch.Tensor,
                      u_prior: torch.Tensor,
                      u_trans: torch.Tensor) -> H3MPosterior:
    """'gmmNew' from its draws: the kmeans++ seeds [*L, Sr, D] of the
    mixture-hierarchies EM that reduces the pooled base Gaussians to Sr
    shared components, and uniform draws for omega and the dynamics."""
    means, covs, valid = _pool(base)
    red, _ = mix_hier_em(None, means, covs, valid, sr, nv=nv, seeds=seeds)
    lanes = tuple(seeds.shape[:-2])
    d = means.shape[-1]
    return _gmm_new_post(
        base, kr, sr, hyps, nv,
        red.mean[..., None, :, :].expand(lanes + (kr, sr, d)),
        red.cov[..., None, :, :, :].expand(lanes + (kr, sr, d, d)),
        u_omega, u_prior, u_trans)


def _draw_dynamics(gen: torch.Generator, base: H3M, kr: int, sr: int,
                   lanes: tuple) -> dict:
    """The uniforms of the cluster weights and the random dynamics of
    'gmmNew' and 'gmmNew2'."""
    dtype = base.hmm.mean.dtype
    return {"u_omega": _rand(gen, lanes + (kr,), dtype),
            "u_prior": _rand(gen, lanes + (kr, sr), dtype),
            "u_trans": _rand(gen, lanes + (kr, sr, sr), dtype)}


def draw_gmmNew(gen: torch.Generator, base: H3M, kr: int, sr: int,
                lanes: tuple = ()) -> dict:
    """The draws of 'gmmNew' for ``lanes``, on the generator's device: the
    kmeans++ uniforms of the reduction's Sr seeds [*L, Sr], and the
    uniforms of omega and the dynamics."""
    lanes = tuple(lanes)
    return {"u_seeds": _rand(gen, lanes + (sr,), torch.float64),
            **_draw_dynamics(gen, base, kr, sr, lanes)}


def gmmnew_from_uniforms(base: H3M, kr: int, sr: int, hyps: VBHEMHyps,
                         nv: int, u_seeds: torch.Tensor,
                         u_omega: torch.Tensor, u_prior: torch.Tensor,
                         u_trans: torch.Tensor) -> H3MPosterior:
    """'gmmNew' from the draws of :func:`draw_gmmNew`."""
    means, _, valid = _pool(base)
    dev = means.device
    return gmmnew_from_draws(
        base, kr, sr, hyps, nv,
        kmeans_pp_from_uniforms(means, sr, valid, u_seeds),
        u_omega.to(dev), u_prior.to(dev), u_trans.to(dev))


def init_gmmNew(gen: torch.Generator, base: H3M, kr: int, sr: int,
                hyps: VBHEMHyps, nv: int, lanes: tuple = ()) -> H3MPosterior:
    """'gmmNew' initializer (`vbhemhmm_init.m:103-291`): pool all base
    emission Gaussians, reduce them to Sr components with
    mixture-hierarchies EM (`GMM_MixHierEM.m`) and use them as every
    cluster's emissions; priors, transitions and cluster weights random."""
    return gmmnew_from_uniforms(base, kr, sr, hyps, nv,
                                **draw_gmmNew(gen, base, kr, sr, lanes))


def gmmnew2_from_draws(base: H3M, kr: int, sr: int, hyps: VBHEMHyps,
                       nv: int, seeds: torch.Tensor, use: torch.Tensor,
                       u_omega: torch.Tensor, u_prior: torch.Tensor,
                       u_trans: torch.Tensor) -> H3MPosterior:
    """'gmmNew2' from its draws: the kmeans++ seeds [*L, Kr*Sr, D] of the
    reduction to Kr*Sr components, the permutation ``use`` [*L, Kr*Sr]
    that deals them out in blocks of Sr, and uniform draws for omega and
    the dynamics."""
    means, covs, valid = _pool(base)
    red, _ = mix_hier_em(None, means, covs, valid, kr * sr, nv=nv,
                         seeds=seeds)
    lanes = tuple(seeds.shape[:-2])
    d = means.shape[-1]
    idx = use.reshape(lanes + (kr * sr,))
    mean = torch.gather(red.mean, -2, idx[..., None].expand(
        lanes + (kr * sr, d))).reshape(lanes + (kr, sr, d))
    cov = torch.gather(red.cov, -3, idx[..., None, None].expand(
        lanes + (kr * sr, d, d))).reshape(lanes + (kr, sr, d, d))
    return _gmm_new_post(base, kr, sr, hyps, nv, mean, cov, u_omega, u_prior,
                         u_trans)


def draw_gmmNew2(gen: torch.Generator, base: H3M, kr: int, sr: int,
                 lanes: tuple = ()) -> dict:
    """The draws of 'gmmNew2' for ``lanes``, on the generator's device:
    the kmeans++ uniforms of the reduction's Kr*Sr seeds [*L, Kr*Sr], the
    permutation that deals the reduced Gaussians out [*L, Kr*Sr], and the
    uniforms of omega and the dynamics."""
    lanes = tuple(lanes)
    return {"u_seeds": _rand(gen, lanes + (kr * sr,), torch.float64),
            "use": torch.argsort(_rand(gen, lanes + (kr * sr,),
                                       torch.float32), dim=-1),
            **_draw_dynamics(gen, base, kr, sr, lanes)}


def gmmnew2_from_uniforms(base: H3M, kr: int, sr: int, hyps: VBHEMHyps,
                          nv: int, u_seeds: torch.Tensor, use: torch.Tensor,
                          u_omega: torch.Tensor, u_prior: torch.Tensor,
                          u_trans: torch.Tensor) -> H3MPosterior:
    """'gmmNew2' from the draws of :func:`draw_gmmNew2`."""
    means, _, valid = _pool(base)
    dev = means.device
    return gmmnew2_from_draws(
        base, kr, sr, hyps, nv,
        kmeans_pp_from_uniforms(means, kr * sr, valid, u_seeds),
        use.to(dev), u_omega.to(dev), u_prior.to(dev), u_trans.to(dev))


def init_gmmNew2(gen: torch.Generator, base: H3M, kr: int, sr: int,
                 hyps: VBHEMHyps, nv: int, lanes: tuple = ()) -> H3MPosterior:
    """'gmmNew2' (`vbhemhmm_init.m:103-291`, the tmpK = Sr*Kr branch): like
    'gmmNew', but the pooled bank is reduced to Kr*Sr components and each
    cluster gets its own random block of Sr of them."""
    return gmmnew2_from_uniforms(base, kr, sr, hyps, nv,
                                 **draw_gmmNew2(gen, base, kr, sr, lanes))


_INITIALIZERS = {
    "baseem": init_baseem,
    "gmmNew": init_gmmNew,
    "gmmNew2": init_gmmNew2,
    "wtkmeans": init_wtkmeans,
    "random": init_random,
}
# each mode's draws and the function that makes its posteriors from them
_DRAWS = {
    "baseem": (draw_baseem, baseem_from_draws),
    "gmmNew": (draw_gmmNew, gmmnew_from_uniforms),
    "gmmNew2": (draw_gmmNew2, gmmnew2_from_uniforms),
    "wtkmeans": (draw_wtkmeans, wtkmeans_from_uniforms),
    "random": (draw_random, random_from_uniforms),
}
# the modes 'auto' tries in each cell (`vbhem_h3m_cluster.m:363-399`)
AUTO_MODES = ("baseem", "gmmNew", "wtkmeans")


def resolve_initmode(mode: str) -> str:
    """Validate an initmode for a single-mode fitting entry point
    (:func:`fit_single_ks`, :func:`fit_grid_batched`).

    'auto' (try baseem, gmmNew and wtkmeans, keep the best,
    `vbhem_h3m_cluster.m:363-399`) is implemented by the front-ends
    :func:`cluster` and :func:`cluster_batched`, which run the single-mode
    workers once per mode; here it is a ValueError, as is an unknown
    mode."""
    if mode == "auto":
        raise ValueError(
            "initmode='auto' is a front-end (cluster/cluster_batched) "
            "feature; this single-mode entry point needs an explicit "
            "initmode from " + str(sorted(_INITIALIZERS)))
    if mode not in _INITIALIZERS:
        raise ValueError(f"unknown initmode {mode!r}; expected one of "
                         f"{sorted(_INITIALIZERS)} (or 'auto' via the "
                         f"cluster front-ends)")
    return mode


def front_end_modes(mode: str) -> list:
    """The single modes a front-end runs for ``mode``: AUTO_MODES for
    'auto', else the mode itself (validated)."""
    if mode == "auto":
        return list(AUTO_MODES)
    return [resolve_initmode(mode)]


def draw_lanes(mode: str, gen: torch.Generator, base: H3M, kr: int, sr: int,
               hyps: VBHEMHyps, nv: int, n: int,
               chunk: Optional[int] = None) -> H3MPosterior:
    """``n`` initial posteriors of ``mode`` on a leading lane axis: every
    lane's draws made at once (they are a few numbers a lane, the
    partition for 'random'), then turned into posteriors ``chunk`` lanes
    at a time (all at once for None).  The chunking changes nothing but
    memory: each lane's start is the same for every ``chunk``."""
    draw, consume = _DRAWS[resolve_initmode(mode)]
    draws = draw(gen, base, kr, sr, (n,))
    return in_chunks(lambda sl: consume(
        base, kr, sr, hyps, nv, **{k: v[sl] for k, v in draws.items()}),
        n, chunk)


# ---------------------------------------------------------------------------
# trials + (K,S) sweep (vbhem_h3m_c.m / vbhem_h3m_cluster.m)
# ---------------------------------------------------------------------------

class VBHEMResult(NamedTuple):
    """Final packaged model (`form_outputH3M.m`)."""
    post: H3MPosterior
    h3m: H3M                  # point-estimate form
    ll: torch.Tensor
    hat_z: torch.Tensor       # [Kb, Kr]
    ll_elbo: torch.Tensor     # [Kb, Kr]
    nj: torch.Tensor          # [Kr]
    label: torch.Tensor       # [Kb] hard assignments
    counts_n1: torch.Tensor   # [Kr, Sr]
    counts: torch.Tensor      # [Kr, Sr]
    trans_counts: torch.Tensor  # [Kr, Sr, Sr]

    @property
    def groups(self):
        lab = self.label.cpu().numpy()
        return [list(np.where(lab == j)[0]) for j in range(self.nj.shape[-1])]


def finalize(st: VBHEMState) -> VBHEMResult:
    return VBHEMResult(
        post=st.post, h3m=st.post.to_h3m(), ll=st.ll, hat_z=st.hat_z,
        ll_elbo=st.ll_elbo, nj=st.stats.nj,
        label=torch.argmax(st.hat_z, dim=-1),
        counts_n1=st.stats.nj_rho1, counts=st.stats.nj_rho,
        trans_counts=st.stats.nj_rho2rho)


def fit_single_ks(gen: torch.Generator, base: H3M, kr: int, sr: int,
                  config: VBHEMConfig, hyps: Optional[VBHEMHyps] = None,
                  initmode: Optional[str] = None) -> VBHEMState:
    """Random restarts for one (K, S) cell (`vbhem_h3m_c.m:28-76`): the
    ``config.trials`` restarts of one initmode ('auto' is a ValueError
    here, see :func:`resolve_initmode`) are the lanes of one
    :func:`vbhem_em`, drawn at once (:func:`draw_lanes`).
    Returns the VBHEMState with a leading trial axis."""
    dtype = base.hmm.mean.dtype
    if hyps is None:
        hyps = VBHEMHyps.from_config(config, base.hmm.mean.shape[-1], dtype,
                                     base.hmm.mean.device)
    mode = resolve_initmode(initmode or config.initmode)
    post0 = draw_lanes(mode, gen, base, kr, sr, hyps, config.nv,
                       config.trials)
    return vbhem_em(base, post0, hyps, nv=config.nv, tau=config.tau,
                    max_iter=config.max_iter, min_diff=config.min_diff,
                    covar_type=config.covar_type)


def stack_lanes(posts: Sequence[H3MPosterior]) -> H3MPosterior:
    """Stack posteriors on a new leading lane axis."""
    return tree_map(lambda *xs: torch.stack(xs), *posts)


def select_best_trial(states: VBHEMState) -> VBHEMState:
    best = int(torch.argmax(states.ll))
    return tree_map(lambda a: a[best], states)


def em_lanes(base: H3M, posts: H3MPosterior, hyps: VBHEMHyps,
             config: VBHEMConfig, cmask=None, smask=None,
             stats: Optional[dict] = None) -> VBHEMState:
    """:func:`vbhem_em` (masked where ``cmask``/``smask`` [n, ...] are
    given) over the lanes of ``posts``, each lane under its own hyps or
    all under one set, in the lane chunks :func:`lane_chunk` sizes for the
    posterior's (K, S) (one chunk on the CPU); lanes are independent, so
    chunking changes nothing but memory.  ``stats`` counts the EM
    iterations ('em_iters', each chunk's slowest lane)."""
    def run(sl):
        st = vbhem_em(base, tree_map(lambda a: a[sl], posts),
                      hypmod.lane_slice(hyps, sl), nv=config.nv,
                      tau=config.tau, max_iter=config.max_iter,
                      min_diff=config.min_diff, covar_type=config.covar_type,
                      cmask=None if cmask is None else cmask[sl],
                      smask=None if smask is None else smask[sl])
        hypmod.tally(stats, "em_iters", int(torch.max(st.it)))
        return st
    n = posts.alpha.shape[0]
    return in_chunks(run, n, lane_chunk(base, *posts.eta.shape[-2:],
                                        config.tau, n))


def neg_elbo_objective(base: H3M, init_posts: H3MPosterior,
                       config: VBHEMConfig, cmask=None, smask=None,
                       stats: Optional[dict] = None):
    """The hyp objective over lanes (`vbhem_h3m_c_hyp.m:105-137`):
    ``fun(hyps, lanes) -> -elbo [k]`` re-runs the (masked) EM from
    ``init_posts[lanes]`` under the hyps (detached), in lane chunks, then
    takes the bound at the fixed point with the posterior, the pair
    E-step (kernel B1 on the card) and the soft assignments held fixed,
    so autograd reaches only the prior terms, as the JAX package's
    ``stop_gradient`` does.  ``stats`` counts the EM iterations
    ('em_iters') and the E-steps outside EM ('e_steps')."""
    tilde_n = (config.nv * base.num_hmms) * base.omega

    def fun(hyps, lanes):
        posts = tree_map(lambda a: a[lanes], init_posts)
        cm = None if cmask is None else cmask[lanes]
        sm = None if smask is None else smask[lanes]

        def run(sl):
            h = hypmod.lane_slice(hyps, sl)
            masks = (None, None) if cm is None else (cm[sl], sm[sl])
            with torch.no_grad():
                st = vbhem_em(base, tree_map(lambda a: a[sl], posts),
                              tree_map(torch.Tensor.detach, h),
                              nv=config.nv, tau=config.tau,
                              max_iter=config.max_iter,
                              min_diff=config.min_diff,
                              covar_type=config.covar_type, cmask=masks[0],
                              smask=masks[1])
                post_w, exps_w, exps = wide_expectations(st.post, *masks)
                pair = e_step(base, st.post, exps, config.tau)
                hat_z, z_ni, nj = soft_assignments(tilde_n, exps.log_omega,
                                                   pair.ll_elbo)
            hypmod.tally(stats, "em_iters", int(torch.max(st.it)))
            hypmod.tally(stats, "e_steps", 1)
            return -elbo(post_w, exps_w, pair, hat_z, z_ni, nj, h, *masks)
        n = posts.alpha.shape[0]
        return in_chunks(run, n, lane_chunk(base, *posts.eta.shape[-2:],
                                            config.tau, n))
    return fun


def optimize_solution_hyps(base: H3M, init_post: H3MPosterior,
                           hyps0: VBHEMHyps, config: VBHEMConfig):
    """Empirical-Bayes hyp optimization for one VBHEM solution
    (`vbhem_h3m_c_hyp.m`): SciPy's L-BFGS-B, each objective evaluation the
    EM re-run from the same initial posterior (the reference's 'inith3m'
    restart, `vbhem_h3m_c_hyp.m:105-137`).  Returns (optimized hyps, final
    VBHEMState, info)."""
    specs = hypmod.vbhem_specs(base.hmm.mean.shape[-1], config.bounds,
                               config.learn_hyps_keys)
    fun = neg_elbo_objective(base, tree_map(lambda a: a[None], init_post),
                             config)
    one = torch.zeros(1, dtype=torch.int64, device=base.hmm.mean.device)
    hyps_opt, info = hypmod.optimize_hyps(
        lambda h: fun(tree_map(lambda a: a[None], h), one)[0], hyps0, specs)
    st = vbhem_em(base, init_post, hyps_opt, nv=config.nv, tau=config.tau,
                  max_iter=config.max_iter, min_diff=config.min_diff,
                  covar_type=config.covar_type)
    return hyps_opt, st, info


def optimize_solution_hyps_batched(base: H3M, init_posts: H3MPosterior,
                                   hyps0: VBHEMHyps, config: VBHEMConfig,
                                   cmask=None, smask=None,
                                   stats: Optional[dict] = None):
    """Hyp-optimize a bank of solutions (leading lane axis on
    ``init_posts``; with ``cmask``/``smask`` [n, ...] padded lanes of the
    grid) together: one L-BFGS per lane, every probe of every lane still
    searching one (chunked) EM over those lanes (`vbhem_h3m_c.m:96-160`, a
    parfor there); then every lane re-runs EM from its start under its
    learned hyps.  Returns (hyps with a lane axis, final VBHEMStates with
    a lane axis); ``stats`` receives the optimizer's counts, its steps per
    lane ('steps') and the EM iterations ('em_iters', 'e_steps')."""
    specs = hypmod.vbhem_specs(base.hmm.mean.shape[-1], config.bounds,
                               config.learn_hyps_keys)
    fun = neg_elbo_objective(base, init_posts, config, cmask, smask, stats)
    hyps_b, _, steps = hypmod.optimize_hyps_batched(
        fun, hyps0, specs, init_posts.alpha.shape[0],
        max_steps=config.hyp_max_steps, stats=stats)
    if stats is not None:
        stats["steps"] = steps.cpu().numpy()
    sts = em_lanes(base, init_posts, hyps_b, config, cmask, smask, stats)
    return hyps_b, sts


def hyp_lanes(base: H3M, states: VBHEMState, idx, hyps0: VBHEMHyps,
              config: VBHEMConfig, cmask=None, smask=None):
    """The hyp stage shared by :func:`cluster` (one cell) and
    :func:`optimize_hyps_grid_batched` (every cell): the restart solutions
    ``states[idx]`` (``idx`` indexes the leading lane axes) hyp-optimized
    together, on the masked EM where ``cmask``/``smask`` give each lane's
    cell, then the lanes whose bound degraded or went degenerate reverted
    with their hyps (:func:`..hyp.revert_lanes`, `vbhem_h3m_c.m:175-180`
    made a rejection).  Returns (final states, hyps per lane, the stage's
    counts under 'hyp_*' keys)."""
    stats = {}
    pre = tree_map(lambda a: a[idx], states)
    hyps_b, sts = optimize_solution_hyps_batched(base, pre.post, hyps0,
                                                 config, cmask, smask, stats)
    return hypmod.revert_lanes(sts, pre, hyps_b, hyps0, stats,
                               config.verbose)


def cluster(gen: torch.Generator, base: H3M, k, s,
            config: VBHEMConfig = VBHEMConfig(),
            hyps: Optional[VBHEMHyps] = None):
    """(K, S) model-selection sweep (`vbhem_h3m_cluster.m:253-354`).

    ``k``/``s`` may be ints or sequences.  Grid cells are scored by
    ``LL + lgamma(K+1) + lgamma(S+1)`` and selected by the reference's
    two-stage rule (:func:`_two_stage_select`).  The default initmode
    'auto' runs the cell's restarts once per mode of AUTO_MODES (baseem,
    gmmNew, wtkmeans) and keeps the best solution
    (`vbhem_h3m_cluster.m:363-399`); ``info['model_initmode']`` names the
    mode each cell kept.  On the card 'wtkmeans' (alone or in 'auto')
    takes K and S up to 8 and D up to 4, its k-means kernels' range: a
    grid beyond it is refused before anything is drawn
    (:func:`~vbhem_tpu_torch.ops.kmeans_cuda.check_grid`); so is 'random'
    past its GMM kernel's S up to 8 and D up to 4
    (:func:`~vbhem_tpu_torch.ops.gmm_cuda.check_fit`).

    With ``config.learn_hyps`` every mode's unique restart solutions are
    hyp-optimized together (:func:`optimize_solution_hyps_batched`), the
    degraded and degenerate lanes revert, and the cell keeps its best
    lane over the modes; ``info['model_hyps']`` holds each cell's kept
    hyps and ``info['hyp_stages']`` the kept mode's counts.
    ``info['model_em_iters']`` counts each cell's EM iterations, the
    slowest restart's per mode, summed over the modes.  Returns
    (VBHEMResult, info dict)."""
    modes = front_end_modes(config.initmode)
    ks = list(k) if isinstance(k, (list, tuple, range)) else [int(k)]
    ss = list(s) if isinstance(s, (list, tuple, range)) else [int(s)]
    dim = base.hmm.mean.shape[-1]
    if "wtkmeans" in modes:
        kmeans_cuda.check_grid(base.hmm.mean.device, max(ks), max(ss), dim)
    if "random" in modes:
        gmm_cuda.check_fit(base.hmm.mean.device, max(ss), dim)
    hyps0 = hyps if hyps is not None else VBHEMHyps.from_config(
        config, dim, base.hmm.mean.dtype, base.hmm.mean.device)

    results, em_iters, cell_hyps, stages, kept = {}, {}, {}, {}, {}
    scores = np.full((len(ks), len(ss)), -np.inf)
    for ki, kk in enumerate(ks):
        for si, sv in enumerate(ss):
            best = None
            em_iters[(kk, sv)] = 0
            for mode in modes:
                states = fit_single_ks(gen, base, kk, sv, config, hyps0,
                                       initmode=mode)
                # the lanes run together until the slowest is done
                em_iters[(kk, sv)] += int(torch.max(states.it))
                h, stage = hyps0, None
                if config.learn_hyps:
                    st, h, stage = _cell_hyps(base, states, hyps0, config)
                else:
                    st = select_best_trial(states)
                ll = float(st.ll)
                # every trial unstable: coalesce to -inf, keep the state
                # so finalize() has a model to package
                ll = ll if np.isfinite(ll) else -np.inf
                if best is None or ll > best[0]:
                    best = (ll, st, h, stage, mode)
            ll, st, cell_hyps[(kk, sv)], stage, kept[(kk, sv)] = best
            if config.learn_hyps:
                stages[(kk, sv)] = stage
            results[(kk, sv)] = finalize(st)
            scores[ki, si] = ll + math.lgamma(kk + 1) + math.lgamma(sv + 1)

    best_k, best_s, model_ll_k, s_star = _two_stage_select(scores, ks, ss)
    from .. import __version__
    info = {"model_ll": scores, "model_ll_k": model_ll_k,
            "model_best_s_per_k": s_star, "model_k": ks, "model_s": ss,
            "model_best_k": best_k, "model_best_s": best_s,
            "model_all": results, "model_em_iters": em_iters,
            "model_hyps": cell_hyps, "model_initmode": kept,
            "vbhemopt": config, "version": __version__}
    if config.learn_hyps:
        info["hyp_stages"] = stages
    return results[(best_k, best_s)], info


def _cell_hyps(base: H3M, states: VBHEMState, hyps0: VBHEMHyps,
               config: VBHEMConfig):
    """The hyp stage of one :func:`cluster` cell (`vbhem_h3m_c.m:96-160`):
    its unique restart solutions (at most ``max_hyp_solutions``, padded
    to a multiple of 4 by the best one) through :func:`hyp_lanes`.
    Returns (the best lane's state, its hyps, the stage's counts)."""
    uniq = hypmod.unique_ll(states.ll.detach().cpu().numpy(),
                            config.min_diff)
    if config.max_hyp_solutions is not None:
        uniq = uniq[:config.max_hyp_solutions]
    if len(uniq) == 0:
        uniq = np.asarray([int(torch.argmax(states.ll))])
    idx = torch.as_tensor(hypmod.pad_lanes(uniq, bucket=4),
                          device=states.ll.device)
    sts, hyps_b, stage = hyp_lanes(base, states, idx, hyps0, config)
    best = int(torch.argmax(sts.ll))
    return (tree_map(lambda a: a[best], sts),
            tree_map(lambda a: a[best], hyps_b), stage)


def _two_stage_select(scores, ks, ss):
    """The reference's (K,S) selection rule (`vbhem_h3m_cluster.m:261-345`):
    per K pick S* maximizing LL + lgamma(S+1); then pick K maximizing the
    per-K winner's raw LL + lgamma(K+1).  ``scores`` is the [nK, nS] grid
    of LL + lgamma(K+1) + lgamma(S+1).
    Returns (best_k, best_s, model_ll_k, s_star_per_k)."""
    scores = np.asarray(scores)
    s_star = np.argmax(scores, axis=1)                       # [nK]
    s_corr = np.asarray([math.lgamma(s + 1) for s in ss])
    model_ll_k = scores[np.arange(len(ks)), s_star] - s_corr[s_star]
    if not np.isfinite(model_ll_k).any():
        return ks[0], ss[0], model_ll_k, [ss[i] for i in s_star]
    bi = int(np.argmax(model_ll_k))
    return ks[bi], ss[s_star[bi]], model_ll_k, [ss[i] for i in s_star]


# ---------------------------------------------------------------------------
# the padded (K, S) grid as one masked EM loop (vbhem_tpu: fit_grid_batched,
# cluster_batched)
# ---------------------------------------------------------------------------

# Share of the card's free memory that one lane chunk of the grid may fill
# (:func:`lane_chunk`); the rest is headroom for what the reckoning of
# :func:`grid_lane_bytes` leaves out.
GRID_MEMORY_SHARE = 0.5


def grid_lane_bytes(kb: int, sb: int, kmax: int, smax: int, tau: int,
                    itemsize: int, lanes: int, sms: int = pair_estep_cuda.SMS
                    ) -> int:
    """Device bytes one lane of the padded grid takes during an EM
    iteration, when ``lanes`` lanes run together, reckoned from the pair
    E-step's launch at the padded shape (P = Kb * Kmax pairs a lane):

      * kernel B1's outputs, 1 + Smax + Smax^2 + Smax * Sb values a pair;
      * B1's scratch, (tau - 1) * Sb * Smax values a pair, where
        ``pair_estep_cuda.design`` takes the scratch design for the
        launch (0 in the resident and checkpointed designs, which keep
        the state in shared memory: the padded grid's launches take the
        checkpointed one);
      * the EM iteration's plain tensors of that size: the assignment
        logits, hat_z and z_ni, the state's copies of hat_z and ll_elbo
        under the lane freeze, the count and moment contractions of
        ``aggregate_stats`` (the weighted sum_t_nu, Smax * Sb a pair, and
        the layouts its einsums copy), 12 + Smax + Smax^2 + 3 Smax * Sb
        values a pair in all."""
    pairs = kb * kmax
    values = 1 + smax + smax * smax + smax * sb
    des = pair_estep_cuda.design(sb, smax, tau, itemsize, pairs * lanes, sms)
    if des.kind == "scratch":
        values += (tau - 1) * sb * smax
    values += 12 + smax + smax * smax + 3 * smax * sb
    return pairs * values * itemsize


def lane_chunk(base: H3M, kmax: int, smax: int, tau: int,
               n_lanes: int) -> Optional[int]:
    """The default ``trial_chunk`` of :func:`fit_grid_batched`: how many
    of the grid's ``n_lanes`` (cell, trial) lanes run together, so that
    their bytes (:func:`grid_lane_bytes`) fill at most GRID_MEMORY_SHARE of
    the card's free memory (``torch.cuda.mem_get_info``), and their
    L*Kmax stays within the kernels' launch grid; the fewest chunks that
    does, made equal (1920 lanes of which 1909 fit run as two chunks of
    960, not 1909 and 11).  None (no chunking) where everything fits, and
    on the CPU."""
    dev = base.hmm.mean.device
    if dev.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    kb, sb = base.state_mask.shape
    per = grid_lane_bytes(kb, sb, kmax, smax, tau,
                          base.hmm.mean.element_size(), n_lanes,
                          torch.cuda.get_device_properties(dev)
                          .multi_processor_count)
    lanes = max(1, int(free * GRID_MEMORY_SHARE) // per)
    lanes = min(lanes, pair_estep_cuda.MAX_GRID_Y // kmax)
    if lanes >= n_lanes:
        return None
    return -(-n_lanes // -(-n_lanes // lanes))


def grid_cells(ks, ss, device):
    """The (K, S) cells of a grid in K-major order, with each cell's
    cluster and state masks at the padded (max K, max S): (cells,
    cmasks [n_cells, Kmax], smasks [n_cells, Smax])."""
    ks, ss = list(ks), list(ss)
    cells = [(k, s) for k in ks for s in ss]
    cmasks = (torch.arange(max(ks), device=device)
              < torch.tensor([k for k, _ in cells], device=device)[:, None])
    smasks = (torch.arange(max(ss), device=device)
              < torch.tensor([s for _, s in cells], device=device)[:, None])
    return cells, cmasks, smasks


def fit_grid_batched(gen: torch.Generator, base: H3M, ks, ss,
                     config: VBHEMConfig, hyps: VBHEMHyps,
                     initmode: Optional[str] = None,
                     trial_chunk: Optional[int] = None):
    """The whole (K, S) x trials sweep of one initmode as the lanes of one
    masked EM loop.

    Every cell is padded to (max K, max S) with cluster and state masks;
    (cell, trial) pairs are flattened into lanes, each with its own masks,
    and their initial posteriors drawn at the padded size in cell-major
    order, up front, in the EM's lane chunks.  ``trial_chunk`` lanes (a
    count of flattened lanes, as in the JAX package) run together, one
    chunk after another; None takes :func:`lane_chunk`'s default from the
    card's memory (no chunking on the CPU).  Chunking changes nothing but
    memory and time: each lane's arithmetic is the same.  'auto' is a
    ValueError here (:func:`cluster_batched` runs it mode by mode).

    Returns (VBHEMState with leading [n_cells, trials] axes, cells list,
    cmasks [n_cells, Kmax], smasks [n_cells, Smax])."""
    dev = base.hmm.mean.device
    cells, cmasks, smasks = grid_cells(ks, ss, dev)
    kmax, smax = cmasks.shape[1], smasks.shape[1]
    mode = resolve_initmode(initmode or config.initmode)

    n_cells, trials = len(cells), config.trials
    n_lanes = n_cells * trials
    if trial_chunk is None:
        trial_chunk = lane_chunk(base, kmax, smax, config.tau, n_lanes)
    with profiling.span("cluster_batched.starts"):
        post0 = draw_lanes(mode, gen, base, kmax, smax, hyps, config.nv,
                           n_lanes, trial_chunk)
    ci = torch.arange(n_cells, device=dev).repeat_interleave(trials)
    cm, sm = cmasks[ci], smasks[ci]

    def run(sl):
        with profiling.span("cluster_batched.em"):
            return vbhem_em_masked(
                base, tree_map(lambda x: x[sl], post0), hyps, nv=config.nv,
                tau=config.tau, cmask=cm[sl], smask=sm[sl],
                max_iter=config.max_iter, min_diff=config.min_diff,
                covar_type=config.covar_type)
    states = in_chunks(run, n_lanes, trial_chunk)
    states = tree_map(lambda x: x.reshape((n_cells, trials) + x.shape[1:]),
                      states)
    return states, cells, cmasks, smasks


def chunk_iterations(it: torch.Tensor, chunk: Optional[int]) -> list:
    """The EM iterations each lane chunk ran (its slowest lane's), from the
    lanes' iteration counts ``it`` in lane order; one pair E-step each."""
    flat = it.reshape(-1).cpu()
    return [int(flat[sl].max()) for sl in chunk_slices(flat.numel(), chunk)]


def optimize_hyps_grid_batched(base: H3M, states: VBHEMState, cells,
                               cmasks: torch.Tensor, smasks: torch.Tensor,
                               config: VBHEMConfig, hyps0: VBHEMHyps,
                               info: Optional[dict] = None):
    """Hyp-optimize every cell's uniqueLL survivors across the whole padded
    (K, S) grid together (`vbhem_tpu.models.vbhem.optimize_hyps_grid_batched`;
    the reference nests the grid recursion and a parfor over unique
    solutions, `vbhem_h3m_cluster.m:261-354` + `vbhem_h3m_c.m:96-160`).

    One lane per (cell, survivor), at most ``max_hyp_solutions`` a cell,
    the lane count padded to a multiple of 16 by the first lane; each lane
    keeps its cell's masks and runs the masked EM.  The lanes share one
    lane-batched L-BFGS (:func:`optimize_solution_hyps_batched`: every
    evaluation one EM over the lanes still probing, in the lane chunks
    that :func:`lane_chunk` sizes from the card's memory), then re-run
    under their learned hyps; degraded and degenerate lanes revert to
    their pre-optimization state and hyps.  Returns (final VBHEMStates
    with a lane axis, the lanes' cell indices, hyps with a lane axis);
    ``info``, if given, receives the stage's counts (:func:`hyp_lanes`)."""
    lls = states.ll.detach().cpu().double().numpy()     # [n_cells, trials]
    lanes = []
    for ci in range(len(cells)):
        uniq = hypmod.unique_ll(lls[ci], config.min_diff)
        if config.max_hyp_solutions is not None:
            uniq = uniq[:config.max_hyp_solutions]
        if len(uniq) == 0:
            uniq = [int(np.argmax(lls[ci]))]
        lanes.extend((ci, int(t)) for t in uniq)
    while len(lanes) % 16:
        lanes.append(lanes[0])
    dev = states.ll.device
    ci_idx = torch.as_tensor([c for c, _ in lanes], device=dev)
    tr_idx = torch.as_tensor([t for _, t in lanes], device=dev)
    sts, hyps_b, stage = hyp_lanes(base, states, (ci_idx, tr_idx), hyps0,
                                   config, cmasks[ci_idx], smasks[ci_idx])
    if info is not None:
        info.update(stage)
    return sts, np.asarray([c for c, _ in lanes]), hyps_b


def cluster_batched(gen: torch.Generator, base: H3M, k, s,
                    config: VBHEMConfig = VBHEMConfig(),
                    hyps: Optional[VBHEMHyps] = None):
    """(K, S) model selection over the padded grid (:func:`fit_grid_batched`:
    every cell and trial a lane of one masked EM loop).  The same
    selection rule and return contract as :func:`cluster`
    (`vbhem_tpu.models.vbhem.cluster_batched`): each cell's best trial,
    sliced down to its (K, S), scored by LL + lgamma(K+1) + lgamma(S+1)
    and selected by :func:`_two_stage_select`.

    The default initmode 'auto' runs the sweep once per mode of
    AUTO_MODES and concatenates the restarts along the trials axis before
    the hyp stage and the selection (the reference keeps the best mode
    per cell, `vbhem_h3m_cluster.m:363-399`; the best over the union of
    the modes' trials is the same winner, only uniqueLL then sees every
    mode's solutions together).  'wtkmeans' on the card takes the grids
    :func:`cluster` describes.

    With ``config.learn_hyps`` the cells' unique restart solutions are
    hyp-optimized as lanes of one L-BFGS over the whole grid
    (:func:`optimize_hyps_grid_batched`) and each cell keeps its best lane
    and that lane's learned hyps (``info['model_hyps']``); the stage's
    counts are in ``info['hyp']`` ('hyp_*' keys, :func:`hyp_lanes`).

    On a float32 bank every finite cell winner is re-evaluated in float64
    under its cell's hyps (:func:`.rescore.elbo_f64`, one launch of kernel
    B3's float64 body on the card) and selection uses those scores:
    ``info['model_ll']`` holds them, ``model_ll_device`` the float32 ones.
    Beside the JAX package's keys, ``info`` has ``model_em_iters`` (each
    cell's slowest trial, summed over the modes), ``grid_trial_chunk``
    (the lanes per chunk, None for one chunk) and ``grid_chunk_iters``
    (the EM iterations, one pair E-step each, of every chunk of the
    restarts, mode after mode)."""
    with profiling.span("cluster_batched"):
        return _cluster_batched(gen, base, k, s, config, hyps)


def _cluster_batched(gen, base, k, s, config, hyps):
    from . import rescore as rescore_mod
    modes = front_end_modes(config.initmode)
    ks = list(k) if isinstance(k, (list, tuple, range)) else [int(k)]
    ss = list(s) if isinstance(s, (list, tuple, range)) else [int(s)]
    dim = base.hmm.mean.shape[-1]
    dtype = base.hmm.mean.dtype
    if "wtkmeans" in modes:
        kmeans_cuda.check_grid(base.hmm.mean.device, max(ks), max(ss), dim)
    if "random" in modes:
        gmm_cuda.check_fit(base.hmm.mean.device, max(ss), dim)
    hyps0 = hyps if hyps is not None else VBHEMHyps.from_config(
        config, dim, dtype, base.hmm.mean.device)

    n_lanes = len(ks) * len(ss) * config.trials
    chunk = lane_chunk(base, max(ks), max(ss), config.tau, n_lanes)
    per_mode, chunk_iters = [], []
    for mode in modes:
        st_m, cells, cmasks, smasks = fit_grid_batched(
            gen, base, ks, ss, config, hyps0, initmode=mode,
            trial_chunk=chunk)
        chunk_iters += chunk_iterations(st_m.it, chunk)
        per_mode.append(st_m)
    states = per_mode[0] if len(per_mode) == 1 else tree_map(
        lambda *xs: torch.cat(xs, dim=1), *per_mode)
    del per_mode
    # each cell's EM iterations: its slowest trial per mode
    its = sum(p.cpu().numpy().max(axis=1) for p in states.it.split(
        config.trials, dim=1))
    hyp_stats = {}
    if config.learn_hyps:
        sts, lane_cell, hyps_lanes = optimize_hyps_grid_batched(
            base, states, cells, cmasks, smasks, config, hyps0, hyp_stats)
        lane_ll = sts.ll.double().cpu().numpy()

        def cell_state(ci):
            lanes = np.flatnonzero(lane_cell == ci)
            best = int(lanes[int(np.argmax(lane_ll[lanes]))])
            return (tree_map(lambda a: a[best], sts),
                    tree_map(lambda a: a[best], hyps_lanes))
    else:
        best_trial = states.ll.double().cpu().numpy().argmax(axis=1)

        def cell_state(ci):
            return (tree_map(lambda a: a[ci, int(best_trial[ci])], states),
                    hyps0)

    with profiling.span("cluster_batched.rescore"):
        rescore_f64 = dtype == torch.float32
        scores = np.full((len(ks), len(ss)), -np.inf)
        scores_device = np.full((len(ks), len(ss)), -np.inf)
        results, em_iters, cell_hyps = {}, {}, {}
        for ci, (kk, sv) in enumerate(cells):
            st, cell_hyps[(kk, sv)] = cell_state(ci)
            em_iters[(kk, sv)] = int(its[ci])
            p = st.post
            post = H3MPosterior(
                alpha=p.alpha[:kk].clone(), eta=p.eta[:kk, :sv].clone(),
                epsilon=p.epsilon[:kk, :sv, :sv].clone(),
                niw=NIW(beta=p.niw.beta[:kk, :sv].clone(),
                        v=p.niw.v[:kk, :sv].clone(),
                        m=p.niw.m[:kk, :sv].clone(),
                        w=p.niw.w[:kk, :sv].clone()))
            hat_z = st.hat_z[:, :kk].clone()
            stats = st.stats
            results[(kk, sv)] = VBHEMResult(
                post=post, h3m=post.to_h3m(), ll=st.ll.clone(), hat_z=hat_z,
                ll_elbo=st.ll_elbo[:, :kk].clone(), nj=stats.nj[:kk].clone(),
                label=torch.argmax(hat_z, dim=-1),
                counts_n1=stats.nj_rho1[:kk, :sv].clone(),
                counts=stats.nj_rho[:kk, :sv].clone(),
                trans_counts=stats.nj_rho2rho[:kk, :sv, :sv].clone())
            ki, si = ks.index(kk), ss.index(sv)
            corr = math.lgamma(kk + 1) + math.lgamma(sv + 1)
            ll = float(st.ll)
            scores_device[ki, si] = ll + corr
            if rescore_f64 and np.isfinite(ll):
                scores[ki, si] = rescore_mod.elbo_f64(
                    base, post, cell_hyps[(kk, sv)], config.nv,
                    config.tau) + corr
            else:
                scores[ki, si] = scores_device[ki, si]
    del states

    with profiling.span("cluster_batched.select"):
        best_k, best_s, model_ll_k, s_star = _two_stage_select(scores, ks, ss)
        from .. import __version__
        info = {"model_ll": scores, "model_ll_device": scores_device,
                "model_ll_k": model_ll_k, "model_best_s_per_k": s_star,
                "model_k": ks, "model_s": ss,
                "model_best_k": best_k, "model_best_s": best_s,
                "model_all": results, "model_hyps": cell_hyps,
                "model_em_iters": em_iters, "grid_trial_chunk": chunk,
                "grid_chunk_iters": chunk_iters,
                "vbhemopt": config, "version": __version__}
        if config.learn_hyps:
            info["hyp"] = hyp_stats
    return results[(best_k, best_s)], info


def to_hmm_list(res: VBHEMResult, state_thresh: float = 1e-3):
    """Reduced H3M -> list of per-cluster point-estimate HMMs with
    low-count states pruned (`convert_h3m2hmms.m` + the per-HMM pruning
    of `vbh3m_remove_empty.m:63-76`).  Host-side (ragged shapes)."""
    out = []
    counts = res.counts.cpu().numpy()
    for j in range(res.h3m.omega.shape[-1]):
        keep = np.where(counts[j] >= state_thresh)[0]
        if len(keep) == 0:
            keep = np.asarray([int(np.argmax(counts[j]))])
        p = res.h3m.hmm.prior[j].cpu().numpy()[keep]
        a = res.h3m.hmm.trans[j].cpu().numpy()[np.ix_(keep, keep)]
        p = p / p.sum()
        a = a / np.maximum(a.sum(-1, keepdims=True), 1e-300)
        dev = res.h3m.hmm.mean.device
        idx = torch.as_tensor(keep, device=dev)
        out.append(HMM(prior=torch.as_tensor(p, device=dev),
                       trans=torch.as_tensor(a, device=dev),
                       mean=res.h3m.hmm.mean[j][idx],
                       cov=res.h3m.hmm.cov[j][idx]))
    return out


def remove_empty_clusters(res: VBHEMResult, cluster_thresh: float = 1.0,
                          state_thresh: float = 1e-3) -> VBHEMResult:
    """Post-hoc pruning (`vbh3m_remove_empty.m`): drop clusters with
    Nj < cluster_thresh, renormalize, relabel.  States with count below
    ``state_thresh`` are dropped when converting to HMM lists."""
    nj = res.nj.cpu().numpy()
    keep = np.where(nj >= cluster_thresh)[0]
    if len(keep) == len(nj):
        return res
    perm = torch.as_tensor(keep, device=res.nj.device)
    post = tree_map(lambda a: a[perm], res.post)
    hat_z = res.hat_z[:, perm]
    hat_z = hat_z / torch.sum(hat_z, dim=-1, keepdim=True)
    return VBHEMResult(
        post=post, h3m=post.to_h3m(), ll=res.ll, hat_z=hat_z,
        ll_elbo=res.ll_elbo[:, perm], nj=res.nj[perm],
        label=torch.argmax(hat_z, dim=-1),
        counts_n1=res.counts_n1[perm], counts=res.counts[perm],
        trans_counts=res.trans_counts[perm])


def vbh3m_remove_empty(res: VBHEMResult, cluster_thresh: float = 1.0,
                       state_thresh: float = 1e-3,
                       sortclusters: str = "f"):
    """Full `vbh3m_remove_empty.m` semantics: (1) drop clusters with
    Nj < cluster_thresh and renormalize/relabel (`:15-59`,
    :func:`remove_empty_clusters`); (2) prune each surviving cluster
    HMM's states with soft count < state_thresh (`:63-76`, the
    reference's ``vbhmm_remove_empty(hmm, 0, 1e-3)``); (3) standardize
    each pruned HMM's state order (`:80-83`).

    Returns ``(cluster_pruned_result, hmm_list)``: ``hmm_list`` holds the
    per-cluster state-pruned, standardized ``VBHMMResult``s (ragged state
    counts), the reference's ``h3mo.hmm``."""
    res = remove_empty_clusters(res, cluster_thresh=cluster_thresh,
                                state_thresh=state_thresh)
    hmms = []
    for j in range(res.post.alpha.shape[-1]):
        post_j = HMMPosterior(alpha=res.post.eta[j],
                              epsilon=res.post.epsilon[j],
                              niw=tree_map(lambda a: a[j], res.post.niw))
        sr = post_j.alpha.shape[-1]
        r_j = VBHMMResult(
            post=post_j, model=post_j.to_point(), ll=res.ll,
            gamma=torch.zeros((1, 1, sr), dtype=res.post.eta.dtype,
                              device=res.post.eta.device),
            counts_n1=res.counts_n1[j], counts=res.counts[j],
            trans_counts=res.trans_counts[j],
            state_mask=torch.ones((sr,), dtype=torch.bool,
                                  device=res.post.eta.device))
        r_j, _, _ = vbhmm.remove_empty(r_j, thresh=state_thresh)
        hmms.append(vbhmm.standardize(r_j, sortclusters))
    return res, hmms
