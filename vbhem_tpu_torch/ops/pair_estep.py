"""Hierarchical backward/forward recursions over virtual samples — the
VBHEM / VHEM E-step over all (base i, reduced j) pairs, in plain PyTorch.

This is the plain version of the CUDA kernels ``csrc/pair_estep_fused.cu``
(B1: the variational E3logN and the recursion) and ``csrc/pair_bwd_fwd.cu``
(B3: the recursion on a precomputed ``ell``), see :mod:`.pair_estep_cuda`:
the CPU path of the dispatches and the kernels' reference on the card.  It
mirrors :mod:`vbhem_tpu.ops.pair_estep` with ``lax.scan`` replaced by a
Python loop over tau.

Reduced-model arguments may carry extra leading lane axes (restart
trials): ``log_pi_r`` [..., Kr, Sr] etc.  The base bank has none.  The
outputs then gain the same leading axes:
  * ``ll_elbo``  [..., Kb, Kr]          lower bound E_i[log p(virtual | j)]
  * ``nu_1``     [..., Kb, Kr, Sr]      expected initial-state counts
  * ``sum_xi``   [..., Kb, Kr, Sr, Sr]  expected transition counts
  * ``sum_t_nu`` [..., Kb, Kr, Sr, Sb]  time-summed state pair counts
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.numeric import inv_psd, logdet_psd, logsumexp, quad_diff


class PairStats(NamedTuple):
    ll_elbo: torch.Tensor    # [..., Kb, Kr]
    nu_1: torch.Tensor       # [..., Kb, Kr, Sr]
    sum_xi: torch.Tensor     # [..., Kb, Kr, Sr, Sr]
    sum_t_nu: torch.Tensor   # [..., Kb, Kr, Sr, Sb]


def expected_pair_ll_variational(mean_b: torch.Tensor, cov_b: torch.Tensor,
                                 m_r: torch.Tensor, w_r: torch.Tensor,
                                 v_r: torch.Tensor, lam_r: torch.Tensor,
                                 log_lam_tilde: torch.Tensor) -> torch.Tensor:
    """E3logN of the VBHEM E-step (`vbhem_hmm_bwd_fwd_fast.m:102-135`):

      -0.5 [ D log 2pi - E[log|Lambda|] + D/lambda
             + v (tr(W Sigma_b) + (mu_b - m)^T W (mu_b - m)) ]

    mean_b [Kb,Sb,D], cov_b [Kb,Sb,D,D]; m_r [..., Kr,Sr,D],
    w_r [..., Kr,Sr,D,D], v_r/lam_r/log_lam_tilde [..., Kr,Sr]
    ->  [..., Kb, Kr, Sb, Sr].
    """
    d = mean_b.shape[-1]
    tr = torch.einsum("...jrde,ibed->...ijbr", w_r, cov_b)
    # diff [..., i, j, b, r, D]
    diff = mean_b[:, None, :, None, :] - m_r[..., None, :, None, :, :]
    quad = torch.einsum("...ijbrd,...jrde,...ijbre->...ijbr", diff, w_r, diff)

    def rb(x):   # [..., Kr, Sr] -> [..., 1, Kr, 1, Sr]
        return x[..., None, :, None, :]

    return -0.5 * (d * math.log(2.0 * math.pi) - rb(log_lam_tilde)
                   + d / rb(lam_r) + rb(v_r) * (tr + quad))


def expected_pair_ll_point(mean_b: torch.Tensor, cov_b: torch.Tensor,
                           mean_r: torch.Tensor,
                           cov_r: torch.Tensor) -> torch.Tensor:
    """Expected log Gaussian between point-estimate banks, the VHEM flavor
    (`g3m_stats.m`; `hem_hmm_bwd_fwd_mex.c` ELL blocks):

      E_{N(mu_b, S_b)}[log N(y | mu_r, S_r)]
        = -0.5 [ D log 2pi + log|S_r| + tr(S_r^-1 S_b)
                 + (mu_b - mu_r)^T S_r^-1 (mu_b - mu_r) ]

    mean_b [Kb,Sb,D], cov_b [Kb,Sb,D,D]; mean_r [..., Kr,Sr,D],
    cov_r [..., Kr,Sr,D,D]  ->  [..., Kb, Kr, Sb, Sr].

    The result is a view of a buffer laid out [..., Kr, Sb, Sr, Kb], the
    layout kernel B3 reads, so the kernel's wrapper copies nothing."""
    d = mean_b.shape[-1]
    prec_r = inv_psd(cov_r)                                   # [..,Kr,Sr,D,D]
    logdet = logdet_psd(cov_r)                                # [..,Kr,Sr]
    tr = torch.einsum("...jrde,ibed->...jbri", prec_r, cov_b)
    # [Sb, 1, Kb, D] against [..., Kr, 1, Sr, 1, D]: [..., Kr, Sb, Sr, Kb]
    quad = quad_diff(mean_b.transpose(0, 1)[:, None],
                     mean_r[..., :, None, :, None, :],
                     prec_r[..., :, None, :, None, :, :])
    ell = -0.5 * (d * math.log(2.0 * math.pi)
                  + logdet[..., :, None, :, None] + tr + quad)
    return ell.contiguous().movedim(-1, -4)


def pair_bwd_fwd(prior_b: torch.Tensor, trans_b: torch.Tensor,
                 log_pi_r: torch.Tensor, log_a_r: torch.Tensor,
                 ell: torch.Tensor, tau: int) -> PairStats:
    """Backward + forward recursions over T=tau virtual steps for all
    (i, j) pairs at once.

    prior_b [Kb,Sb], trans_b [Kb,Sb,Sb]  (zero-padded rows for ragged Sb)
    log_pi_r [..., Kr,Sr], log_a_r [..., Kr,Sr,Sr]
    ell [..., Kb,Kr,Sb,Sr]  expected emission log-likelihood matrix.

    Backward mirror: `vbhem_hmm_bwd_fwd_fast.m:166-257`;
    forward mirror: `:266-341`.
    """
    # ---- backward: Theta[t], LL ----
    # logtheta[..., i, j, rho_prev, b_cur, rho_cur]
    log_a = log_a_r[..., None, :, :, None, :]
    ll_old = torch.zeros_like(ell)
    thetas = []          # ordered t = tau .. 2
    for _ in range(tau - 1):
        logtheta = log_a + (ell + ll_old)[..., None, :, :]
        lse = logsumexp(logtheta, dim=-1)            # [.., i, j, rho_prev, b]
        thetas.append(torch.exp(logtheta - lse[..., None]))
        # LL_new[i,j,b_prev,rho_prev] = sum_{b_cur} Ab[i,b_prev,b_cur] lse
        ll_old = torch.einsum("ibc,...ijrc->...ijbr", trans_b, lse)

    # ---- terminate (t = 1) ----
    logtheta1 = log_pi_r[..., None, :, None, :] + ell + ll_old
    lse1 = logsumexp(logtheta1, dim=-1)              # [..., i, j, b]
    theta1 = torch.exp(logtheta1 - lse1[..., None])
    ll_elbo = torch.einsum("ib,...ijb->...ij", prior_b, lse1)

    # ---- forward ----
    nu = prior_b[:, None, None, :] * theta1.transpose(-1, -2)  # [..,i,j,rho,b]
    nu_1 = torch.sum(nu, dim=-1)
    sum_t_nu = nu
    sum_xi = torch.zeros(nu.shape[:-1] + nu.shape[-2:-1], dtype=nu.dtype,
                         device=nu.device)
    for theta_t in reversed(thetas):                 # t = 2 .. tau
        foo = torch.einsum("...ijrb,ibc->...ijrc", nu, trans_b)
        xi = foo[..., None] * theta_t                # [.., rho_prev, b, rho]
        sum_xi = sum_xi + torch.sum(xi, dim=-2)
        nu = torch.sum(xi, dim=-3).transpose(-1, -2)  # [.., rho_cur, b_cur]
        sum_t_nu = sum_t_nu + nu
    return PairStats(ll_elbo=ll_elbo, nu_1=nu_1, sum_xi=sum_xi,
                     sum_t_nu=sum_t_nu)
