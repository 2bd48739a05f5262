"""Plain reference of one VBEM iteration over a bank of subjects: the
expected log emissions, the scaled forward-backward, the sufficient
statistics, the conjugate M-step and the 8-term lower bound of the
toolbox's `vbhmm_em.m` / `vbhmm_fb.m` / `vbhmm_em_lb.m`.

One lane per subject: data x [B, N, T, D] with a mask [B, N, T], a
posterior with leading axis [B].  Everything runs in the dtype of the
inputs (float64 for the reference, lower for its control).  Plain
PyTorch; it imports nothing of the program under test.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .numeric import (e_log_det_lambda, e_log_dirichlet, inv_psd,
                      log_dirichlet_const, log_wishart_b, logdet_psd, sym,
                      tiny)


class Post(NamedTuple):
    """Variational posterior of one Gaussian HMM per lane."""
    alpha: torch.Tensor    # [B, K]
    epsilon: torch.Tensor  # [B, K, K]
    beta: torch.Tensor     # [B, K]
    v: torch.Tensor        # [B, K]
    m: torch.Tensor        # [B, K, D]
    w: torch.Tensor        # [B, K, D, D]


class Hyps(NamedTuple):
    alpha0: float
    epsilon0: float
    beta0: float
    v0: float
    m0: tuple
    w0: tuple              # diagonal of W0


def cast(post: Post, dtype) -> Post:
    return Post(*(a.to(dtype) for a in post))


def _fb(log_pz1, log_trans, log_rho, mask):
    """Scaled forward-backward (`vbhmm_fb.m:201-379`): log_rho [B, N, T, K]
    rescaled per step by its max, alpha renormalized by c_t, a padded step
    carrying alpha with c = 1 and beta reset before a padded successor.
    Returns gamma [B, N, T, K], xi_sum [B, N, K, K], phi_norm [B, N]."""
    t_max = log_rho.shape[-2]
    pz1 = torch.exp(log_pz1)[:, None, :]                  # [B, 1, K]
    trans = torch.exp(log_trans)[:, None]                 # [B, 1, K, K]
    maskf = mask.to(log_rho.dtype)
    max_rho = torch.amax(log_rho, dim=-1)
    px = torch.exp(log_rho - max_rho[..., None])
    delta = pz1 * px[..., 0, :]
    c = torch.sum(delta, dim=-1)
    alphas, cs = [delta / c[..., None]], [c]
    for t in range(1, t_max):
        prev = alphas[-1]
        delta = torch.sum(prev[..., :, None] * trans, dim=-2) * px[..., t, :]
        c = torch.sum(delta, dim=-1)
        c = torch.where(c > 0, c, torch.ones_like(c))
        valid = mask[..., t]
        alphas.append(torch.where(valid[..., None], delta / c[..., None],
                                  prev))
        cs.append(torch.where(valid, c, torch.ones_like(c)))
    beta = torch.ones_like(alphas[0])
    betas = [beta]
    xi_sum = torch.zeros(log_rho.shape[:-2] + trans.shape[-2:],
                         dtype=log_rho.dtype, device=log_rho.device)
    for t in range(t_max - 2, -1, -1):
        valid = mask[..., t + 1]
        bp = beta * px[..., t + 1, :]
        beta_t = torch.sum(trans * bp[..., None, :], dim=-1) / cs[t + 1][
            ..., None]
        beta = torch.where(valid[..., None], beta_t, torch.ones_like(beta_t))
        xi_t = (trans * (alphas[t][..., :, None] * bp[..., None, :])
                / cs[t + 1][..., None, None])
        xi_sum = xi_sum + torch.where(valid[..., None, None], xi_t,
                                      torch.zeros_like(xi_t))
        betas.append(beta)
    betas.reverse()
    gamma = torch.stack(alphas, -2) * torch.stack(betas, -2) * maskf[..., None]
    log_c = torch.where(mask, torch.log(torch.stack(cs, -1)),
                        torch.zeros_like(maskf))
    phi_norm = torch.sum(log_c, -1) + torch.sum(max_rho * maskf, -1)
    return gamma, xi_sum, phi_norm, log_rho * maskf[..., None]


def e_step(x, mask, post: Post):
    """Expected log emissions (Bishop 10.64) and the forward-backward."""
    d = x.shape[-1]
    diff = x[:, :, :, None, :] - post.m[:, None, None]      # [B,N,T,K,D]
    quad = torch.einsum("bntkd,bkde,bntke->bntk", diff, post.w, diff)
    log_lam = e_log_det_lambda(post.v, post.w)
    log_rho = (0.5 * log_lam[:, None, None] - 0.5 * (
        d / post.beta[:, None, None] + post.v[:, None, None] * quad)
        - 0.5 * d * math.log(2.0 * math.pi))
    return _fb(e_log_dirichlet(post.alpha), e_log_dirichlet(post.epsilon),
               log_rho, mask)


def stats(x, gamma, xi_sum):
    """Masked sufficient statistics (`vbhmm_em.m:158-246`)."""
    nk1 = torch.sum(gamma[:, :, 0, :], dim=1)
    nk = torch.sum(gamma, dim=(1, 2)) + tiny(gamma.dtype)
    m_trans = torch.sum(xi_sum, dim=1)
    xbar = torch.einsum("bntk,bntd->bkd", gamma, x) / nk[..., None]
    m2 = torch.einsum("bntk,bntd,bnte->bkde", gamma, x, x) / nk[..., None,
                                                                 None]
    s = sym(m2 - xbar[..., :, None] * xbar[..., None, :])
    return nk1, nk, m_trans, xbar, s


def m_step(st, hyps: Hyps, dtype, device) -> Post:
    """Conjugate Dirichlet / Normal-Wishart updates (`vbhmm_em.m:352-408`)."""
    nk1, nk, m_trans, xbar, s = st
    m0 = torch.as_tensor(hyps.m0, dtype=dtype, device=device)
    w0inv = torch.diag(1.0 / torch.as_tensor(hyps.w0, dtype=dtype,
                                             device=device))
    alpha = hyps.alpha0 + nk1 + tiny(dtype)
    epsilon = hyps.epsilon0 + m_trans
    beta = hyps.beta0 + nk
    v = hyps.v0 + nk + 1.0
    m = (hyps.beta0 * m0 + nk[..., None] * xbar) / beta[..., None]
    mult1 = hyps.beta0 * nk / (hyps.beta0 + nk)
    diff = xbar - m0
    winv = (w0inv + nk[..., None, None] * s
            + mult1[..., None, None] * diff[..., :, None] * diff[..., None, :])
    return Post(alpha=alpha, epsilon=epsilon, beta=beta, v=v, m=m,
                w=inv_psd(winv))


def elbo(post: Post, st, fb, hyps: Hyps) -> torch.Tensor:
    """The 8-term bound (`vbhmm_em_lb.m:120-257`) of each lane [B]."""
    gamma, _, phi_norm, log_rho = fb
    nk1, nk, m_trans, xbar, s = st
    dtype, dev = post.alpha.dtype, post.alpha.device
    k, d = post.m.shape[-2:]
    two_pi = 2.0 * math.pi
    m0 = torch.as_tensor(hyps.m0, dtype=dtype, device=dev)
    w0inv_diag = 1.0 / torch.as_tensor(hyps.w0, dtype=dtype, device=dev)
    a0 = torch.as_tensor(hyps.alpha0, dtype=dtype, device=dev)
    e0 = torch.as_tensor(hyps.epsilon0, dtype=dtype, device=dev)
    v0 = torch.as_tensor(hyps.v0, dtype=dtype, device=dev)
    b0 = hyps.beta0
    log_lam = e_log_det_lambda(post.v, post.w)
    log_pi = e_log_dirichlet(post.alpha)
    log_a = e_log_dirichlet(post.epsilon)
    log_b0 = log_wishart_b(torch.sum(torch.log(w0inv_diag)), v0, d)

    def quad(a, w):
        return torch.sum(a[..., :, None] * w * a[..., None, :], dim=(-2, -1))

    tr_sw = torch.sum(s * post.w.transpose(-1, -2), dim=(-2, -1))
    lt1 = 0.5 * torch.sum(nk * (log_lam - d / post.beta - post.v * tr_sw
                                - post.v * quad(xbar - post.m, post.w)
                                - d * math.log(two_pi)), -1)
    lt2 = torch.sum(nk1 * log_pi, -1) + torch.sum(m_trans * log_a, (-2, -1))
    lt3 = (torch.lgamma(k * a0) - k * torch.lgamma(a0)
           + (a0 - 1.0) * torch.sum(log_pi, -1))
    lt4 = (k * (torch.lgamma(k * e0) - k * torch.lgamma(e0))
           + (e0 - 1.0) * torch.sum(log_a, (-2, -1)))
    tr_w0inv_w = torch.sum(w0inv_diag * torch.diagonal(post.w, dim1=-2,
                                                       dim2=-1), -1)
    lt5 = (0.5 * torch.sum(d * math.log(b0 / two_pi) + log_lam
                           - d * b0 / post.beta
                           - b0 * post.v * quad(post.m - m0, post.w), -1)
           + k * log_b0 + 0.5 * (v0 - d - 1.0) * torch.sum(log_lam, -1)
           - 0.5 * torch.sum(post.v * tr_w0inv_w, -1))
    lt6 = lt2 + torch.sum(gamma * log_rho, (1, 2, 3)) - torch.sum(phi_norm, 1)
    lt7 = (torch.sum((post.alpha - 1.0) * log_pi, -1)
           + log_dirichlet_const(post.alpha)
           + torch.sum(torch.sum((post.epsilon - 1.0) * log_a, -1)
                       + log_dirichlet_const(post.epsilon), -1))
    log_bk = log_wishart_b(-logdet_psd(post.w), post.v, d)
    h_ent = torch.sum(-log_bk - 0.5 * (post.v - d - 1.0) * log_lam
                      + 0.5 * post.v * d, -1)
    lt8 = (0.5 * torch.sum(log_lam + d * torch.log(post.beta / two_pi), -1)
           - 0.5 * d * k - h_ent)
    return lt1 + lt2 + lt3 + lt4 + lt5 - lt6 - lt7 - lt8


def iteration(x, mask, post: Post, hyps: Hyps):
    """One EM iteration on every lane: (the bound at ``post``, the
    M-step's posterior)."""
    fb = e_step(x, mask, post)
    st = stats(x, fb[0], fb[1])
    return elbo(post, st, fb, hyps), m_step(st, hyps, post.alpha.dtype,
                                            post.alpha.device)


def em(x, mask, post: Post, hyps: Hyps, max_iter: int,
       min_diff: float) -> Post:
    """The VBEM loop of `vbhmm_em.m:112-414` on every lane [B]: per
    iteration the bound at the posterior and the M-step, the M-step
    applied on the converging iteration too; a lane stops once
    ``|(ll - last) / last| <= min_diff`` after its first iteration or at
    ``max_iter``, and a NaN bound keeps the old posterior and stops the
    lane.  Returns the final posteriors."""
    dtype, dev = post.alpha.dtype, post.alpha.device
    b = post.alpha.shape[0]
    last = torch.full((b,), -torch.finfo(dtype).max, dtype=dtype,
                      device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for it in range(max_iter):
        ll, new = iteration(x, mask, post, hyps)
        unstable = torch.isnan(ll)
        keep = ~done & ~unstable
        post = Post(*(torch.where(keep.reshape((b,) + (1,) * (a.dim() - 1)),
                                  a, o) for a, o in zip(new, post)))
        conv = (it > 0) & (torch.abs((ll - last) / last) <= min_diff)
        last = torch.where(done, last, ll)
        done = done | conv | unstable
        if bool(torch.all(done)):
            break
    return post
