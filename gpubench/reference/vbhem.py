"""Plain reference of one VBHEM iteration for one (K, S) model of a bank
of HMMs: the reduced model's digamma expectations, the expected emission
log-likelihood of every (base state, reduced state) pair, the
hierarchical backward/forward recursion over tau virtual steps, the
virtual-count soft assignments, the statistics, the conjugate M-step and
the 10-term lower bound of the toolbox's `vbhem_h3m_c_step_fc.m`,
`vbhem_hmm_bwd_fwd_fast.m`, `vbhem_compute_Statistics.m`,
`vbhem_mstep_component.m` and `vbhemh3m_lb.m`; and the (K, S) selection
rule of `vbhem_h3m_cluster.m:261-345`.

The bank is unbatched ([Kb, Sb, ...], padded states with zero prior and
transitions); the model is unpadded ([K, S, ...]) and may carry leading
lane axes (restarts), each lane its own model of the same bank.
Everything runs in the dtype of the inputs.  Plain PyTorch; it imports
nothing of the program under test.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .numeric import (e_log_det_lambda, e_log_dirichlet, inv_psd,
                      log_dirichlet_const, log_wishart_b, logdet_psd,
                      logsumexp, sym, tiny)


class Bank(NamedTuple):
    omega: torch.Tensor    # [Kb]
    prior: torch.Tensor    # [Kb, Sb]
    trans: torch.Tensor    # [Kb, Sb, Sb]
    mean: torch.Tensor     # [Kb, Sb, D]
    cov: torch.Tensor      # [Kb, Sb, D, D]


class Post(NamedTuple):
    alpha: torch.Tensor    # [K]
    eta: torch.Tensor      # [K, S]
    epsilon: torch.Tensor  # [K, S, S]
    beta: torch.Tensor     # [K, S]   (the toolbox's lambda)
    v: torch.Tensor        # [K, S]
    m: torch.Tensor        # [K, S, D]
    w: torch.Tensor        # [K, S, D, D]


class Hyps(NamedTuple):
    alpha0: float
    eta0: float
    epsilon0: float
    lambda0: float
    v0: float
    m0: tuple
    w0: tuple              # diagonal of W0


def cast(tree, dtype):
    return type(tree)(*(a.to(dtype) for a in tree))


def pair_stats(bank: Bank, post: Post, tau: int):
    """E3logN and the recursion over every (base i, reduced j) pair:
    (ll_elbo [*L, Kb, K], nu_1 [*L, Kb, K, S], sum_xi [*L, Kb, K, S, S],
    sum_t_nu [*L, Kb, K, S, Sb])."""
    d = bank.mean.shape[-1]
    log_pi = e_log_dirichlet(post.eta)
    log_a = e_log_dirichlet(post.epsilon)
    log_lam = e_log_det_lambda(post.v, post.w)
    tr = torch.einsum("...jrde,ibed->...ijbr", post.w, bank.cov)
    diff = bank.mean[:, None, :, None, :] - post.m[..., None, :, None, :, :]
    quad = torch.einsum("...ijbrd,...jrde,...ijbre->...ijbr", diff, post.w,
                         diff)

    def rb(x):
        return x[..., None, :, None, :]

    ell = -0.5 * (d * math.log(2.0 * math.pi) - rb(log_lam)
                  + d / rb(post.beta) + rb(post.v) * (tr + quad))
    # backward (`vbhem_hmm_bwd_fwd_fast.m:166-257`):
    # logtheta[i, j, rho_prev, b_cur, rho_cur]
    la = log_a[..., None, :, :, None, :]
    ll_old = torch.zeros_like(ell)
    thetas = []
    for _ in range(tau - 1):
        logtheta = la + (ell + ll_old)[..., :, :, None, :, :]
        lse = logsumexp(logtheta, -1)
        thetas.append(torch.exp(logtheta - lse[..., None]))
        ll_old = torch.einsum("ibc,...ijrc->...ijbr", bank.trans, lse)
    logtheta1 = log_pi[..., None, :, None, :] + ell + ll_old
    lse1 = logsumexp(logtheta1, -1)
    theta1 = torch.exp(logtheta1 - lse1[..., None])
    ll_elbo = torch.einsum("ib,...ijb->...ij", bank.prior, lse1)
    # forward (`:266-341`)
    nu = bank.prior[:, None, None, :] * theta1.transpose(-1, -2)
    nu_1 = torch.sum(nu, -1)
    sum_t_nu = nu
    sum_xi = torch.zeros(nu.shape[:-1] + nu.shape[-2:-1], dtype=nu.dtype,
                         device=nu.device)
    for theta_t in reversed(thetas):
        xi = torch.einsum("...ijrb,ibc->...ijrc", nu, bank.trans)[..., None] \
            * theta_t
        sum_xi = sum_xi + torch.sum(xi, -2)
        nu = torch.sum(xi, -3).transpose(-1, -2)
        sum_t_nu = sum_t_nu + nu
    return ll_elbo, nu_1, sum_xi, sum_t_nu


def soft_assignments(bank: Bank, post: Post, ll_elbo, nv: int):
    """hat_Z, z_ni = hat_Z tilde_N and Nj with tilde_N = Nv Kb omega
    (`vbhem_h3m_c_step_fc.m:275-283`)."""
    dtype = ll_elbo.dtype
    tilde_n = (nv * bank.omega.shape[0]) * bank.omega
    log_omega = e_log_dirichlet(post.alpha)
    hat_z = torch.softmax(tilde_n[:, None] * (log_omega[..., None, :]
                                              + ll_elbo), -1) + tiny(dtype)
    z_ni = hat_z * tilde_n[:, None]
    return hat_z, z_ni, torch.sum(z_ni, -2) + tiny(dtype)


def elbo(post: Post, ll_elbo, hat_z, z_ni, nj, hyps: Hyps) -> torch.Tensor:
    """The 10-term bound (`vbhemh3m_lb.m:88-186`) of each lane [*L]."""
    dtype, dev = post.alpha.dtype, post.alpha.device
    k, s, d = post.m.shape[-3:]
    r2, r3 = (-2, -1), (-3, -2, -1)
    two_pi = 2.0 * math.pi

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    a0, h0, e0, l0, v0 = (t(hyps.alpha0), t(hyps.eta0), t(hyps.epsilon0),
                          t(hyps.lambda0), t(hyps.v0))
    m0, w0inv = t(hyps.m0), 1.0 / t(hyps.w0)
    log_omega = e_log_dirichlet(post.alpha)
    log_pi = e_log_dirichlet(post.eta)
    log_a = e_log_dirichlet(post.epsilon)
    log_lam = e_log_det_lambda(post.v, post.w)

    lt1 = torch.sum(z_ni * ll_elbo, r2)
    lt2 = torch.sum(nj * log_omega, -1)
    lt3 = (k * (torch.lgamma(s * h0) - s * torch.lgamma(h0))
           + (h0 - 1.0) * torch.sum(log_pi, r2))
    lt4 = (k * s * (torch.lgamma(s * e0) - s * torch.lgamma(e0))
           + (e0 - 1.0) * torch.sum(log_a, r3))
    dm = post.m - m0
    m_w_m = torch.einsum("...jrd,...jrde,...jre->...jr", dm, post.w, dm)
    tr_w0inv_w = torch.sum(w0inv * torch.diagonal(post.w, dim1=-2, dim2=-1),
                           -1)
    lt5 = (0.5 * torch.sum(d * torch.log(l0 / two_pi) + log_lam
                           - d * l0 / post.beta - l0 * post.v * m_w_m, r2)
           + k * s * log_wishart_b(torch.sum(torch.log(w0inv)), v0, d)
           + 0.5 * (v0 - d - 1.0) * torch.sum(log_lam, r2)
           - 0.5 * torch.sum(post.v * tr_w0inv_w, r2))
    lt6 = (torch.lgamma(k * a0) - k * torch.lgamma(a0)
           + (a0 - 1.0) * torch.sum(log_omega, -1))
    lt7 = torch.sum(hat_z * torch.log(hat_z), r2)
    lt8 = (log_dirichlet_const(post.alpha)
           + torch.sum((post.alpha - 1.0) * log_omega, -1))
    lt9 = (torch.sum(log_dirichlet_const(post.eta), -1)
           + torch.sum((post.eta - 1.0) * log_pi, r2)
           + torch.sum(log_dirichlet_const(post.epsilon), r2)
           + torch.sum((post.epsilon - 1.0) * log_a, r3))
    log_bk = log_wishart_b(-logdet_psd(post.w), post.v, d)
    h_ent = torch.sum(-log_bk - 0.5 * (post.v - d - 1.0) * log_lam
                      + 0.5 * post.v * d, r2)
    lt10 = (0.5 * torch.sum(log_lam + d * torch.log(post.beta / two_pi), r2)
            - 0.5 * d * k * s - h_ent)
    return (lt1 + lt2 + lt3 + lt4 + lt5 + lt6 - lt7 - lt8 - lt9 - lt10)


def m_step(bank: Bank, pair, z_ni, nj, hyps: Hyps) -> Post:
    """Statistics (`vbhem_compute_Statistics.m`) and the conjugate update
    (`vbhem_mstep_component.m:42-72`)."""
    _, nu_1, sum_xi, sum_t_nu = pair
    dtype, dev = z_ni.dtype, z_ni.device
    nj_rho1 = torch.einsum("...ij,...ijr->...jr", z_ni, nu_1)
    nj_rho2rho = torch.einsum("...ij,...ijrs->...jrs", z_ni, sum_xi)
    if nj_rho1.shape[-1] == 1:
        nj_rho2rho = torch.full_like(nj_rho2rho, 1e-12)
    nj_rho = torch.einsum("...ij,...ijr->...jr", z_ni,
                          torch.sum(sum_t_nu, -1)) \
        + tiny(dtype)
    w_stn = z_ni[..., None, None] * sum_t_nu
    m2_b = bank.mean[..., :, None] * bank.mean[..., None, :] + bank.cov
    y_bar = torch.einsum("...ijrb,ibd->...jrd", w_stn, bank.mean) \
        / nj_rho[..., None]
    s_plus_c = sym(torch.einsum("...ijrb,ibde->...jrde", w_stn, m2_b)
                   / nj_rho[..., None, None]
                   - y_bar[..., :, None] * y_bar[..., None, :])
    m0 = torch.as_tensor(hyps.m0, dtype=dtype, device=dev)
    w0inv = torch.diag(1.0 / torch.as_tensor(hyps.w0, dtype=dtype,
                                             device=dev))
    lam = hyps.lambda0 + nj_rho
    mult1 = hyps.lambda0 * nj_rho / lam
    diff = y_bar - m0
    winv = (w0inv + nj_rho[..., None, None] * s_plus_c
            + mult1[..., None, None] * diff[..., :, None] * diff[..., None, :])
    return Post(alpha=hyps.alpha0 + nj, eta=hyps.eta0 + nj_rho1,
                epsilon=hyps.epsilon0 + nj_rho2rho, beta=lam,
                v=hyps.v0 + nj_rho + 1.0,
                m=(hyps.lambda0 * m0 + nj_rho[..., None] * y_bar)
                / lam[..., None],
                w=inv_psd(winv))


def iteration(bank: Bank, post: Post, hyps: Hyps, nv: int, tau: int):
    """One EM iteration: (the bound at ``post``, the M-step's posterior)."""
    pair = pair_stats(bank, post, tau)
    hat_z, z_ni, nj = soft_assignments(bank, post, pair[0], nv)
    return (elbo(post, pair[0], hat_z, z_ni, nj, hyps),
            m_step(bank, pair, z_ni, nj, hyps))


def _where(mask, new: Post, old: Post) -> Post:
    return Post(*(torch.where(mask.reshape(mask.shape + (1,) * (a.dim()
                                                                - mask.dim())),
                              a, b) for a, b in zip(new, old)))


def em(bank: Bank, post: Post, hyps: Hyps, nv: int, tau: int,
       max_iter: int, min_diff: float) -> Post:
    """The EM loop of `vbhem_h3m_c_step_fc.m:115-433` on every lane of
    ``post`` (one leading lane axis): per iteration the bound at the
    posterior and the M-step, the M-step applied on the converging
    iteration too; a lane stops once ``|(ll - last) / last| <= min_diff``
    after its first iteration or at ``max_iter``, and a NaN bound keeps
    the old posterior and stops the lane.  Returns the final posteriors."""
    lanes = post.alpha.shape[:-1]
    dtype, dev = post.alpha.dtype, post.alpha.device
    last = torch.full(lanes, -torch.finfo(dtype).max, dtype=dtype,
                      device=dev)
    done = torch.zeros(lanes, dtype=torch.bool, device=dev)
    for it in range(max_iter):
        ll, new = iteration(bank, post, hyps, nv, tau)
        unstable = torch.isnan(ll)
        post = _where(~done & ~unstable, new, post)
        conv = (it > 0) & (torch.abs((ll - last) / last) <= min_diff)
        last = torch.where(done, last, ll)
        done = done | conv | unstable
        if bool(torch.all(done)):
            break
    return post


def lane_block(bank: Bank, k: int, s: int, tau: int, itemsize: int,
               budget: float = 4e9) -> int:
    """Lanes of a (K, S) model whose recursion (its tau - 1 stored steps
    of [Kb, K, S, Sb, S]) fits in ``budget`` bytes."""
    kb, sb = bank.prior.shape
    per_lane = max(tau - 1, 1) * kb * k * s * sb * s * itemsize * 3
    return max(1, int(budget // per_lane))


def select(scores, ks, ss):
    """The two-stage (K, S) rule: per K the S maximizing LL + lgamma(K+1)
    + lgamma(S+1) (``scores`` [nK, nS] holds that sum), then the K whose
    winner's LL + lgamma(K+1) is largest.  Returns (K, S)."""
    scores = np.asarray(scores, dtype=np.float64)
    s_star = np.argmax(scores, axis=1)
    s_corr = np.asarray([math.lgamma(s + 1) for s in ss])
    per_k = scores[np.arange(len(ks)), s_star] - s_corr[s_star]
    if not np.isfinite(per_k).any():
        return ks[0], ss[0]
    bi = int(np.argmax(per_k))
    return ks[bi], ss[int(s_star[bi])]
