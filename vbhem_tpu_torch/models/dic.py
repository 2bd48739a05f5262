"""Deviance Information Criterion for a learned VBH3M, and AIC/BIC for a
VHEM solution: the counterpart of :mod:`vbhem_tpu.models.dic`.

Parity map: `src/compare_mtds/dic/myDIC.m` — effective parameter count
P_d from the gap between plug-in estimates and posterior expectations
of omega/pi/A/mu/Sigma (`:36-96`), plus a deviance term from the
expected log-likelihood of the base bank under the point-estimate
reduced model, through the VHEM pair recursion (`:160-177`): kernel B3 on
the card, its plain version on the CPU.  Models with minimum DIC are
selected by the evaluation harness.
"""
from __future__ import annotations

import numpy as np
import torch

from ..containers import H3M
from ..ops.pair_estep import expected_pair_ll_point
from ..ops.pair_estep_cuda import pair_bwd_fwd_auto
from ..utils.numeric import e_log_det_lambda, e_log_dirichlet, logsumexp
from .vbhem import VBHEMResult


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def dic(base: H3M, res: VBHEMResult, tau: int, lambda0: float = 1.0,
        per_time: bool = False, synthetic: bool = False) -> tuple:
    """Returns (P_d, DIC).  ``lambda0`` is the NIW mean-precision prior
    used during learning (`myDIC.m:25`).

    ``synthetic`` selects the reference's `issyn=1` variant
    (`myDIC.m:98-154`): the Sigma plug-in precision is the inverse of
    the converted point-estimate covariance instead of the vb path's vW
    (`myDIC.m:86-90`).  The count weights (N_Eta, N_Eps, Nl_j) are the
    aggregated E-step statistics in both variants.  The P_d terms are
    host sums in the inputs' precision; the deviance runs on the bank's
    device."""
    post = res.post
    reduced = res.h3m
    kb = base.num_hmms
    nj = _np(res.nj)
    ni = nj.sum() / kb                                       # myDIC.m:21

    # omega term (myDIC.m:29-40)
    log_omega_tilde = _np(e_log_dirichlet(post.alpha))
    log_omega_hat = np.log(_np(reduced.omega))
    term_omega = float(nj @ (log_omega_hat - log_omega_tilde))

    # pi term (myDIC.m:44-54): counts N1 = posterior initial-state counts
    log_pi_tilde = _np(e_log_dirichlet(post.eta))            # [Kr,Sr]
    log_pi_hat = np.log(_np(reduced.hmm.prior))
    term_pi = float(np.sum(_np(res.counts_n1) * (log_pi_hat - log_pi_tilde)))

    # A term (myDIC.m:58-70)
    log_a_tilde = _np(e_log_dirichlet(post.epsilon))         # [Kr,Sr,Sr]
    log_a_hat = np.log(np.maximum(_np(reduced.hmm.trans), 1e-300))
    term_eps = float(np.sum(_np(res.trans_counts) * (log_a_hat - log_a_tilde)))

    # mu term (myDIC.m:73-78)
    term_mu = float(-0.5 * np.sum(lambda0 / _np(post.niw.beta)))

    # Sigma term: plug-in precision = v*W (vb path, myDIC.m:82-96) or
    # inv(expected covariance) (synthetic path, myDIC.m:139-147)
    log_lam_tilde = _np(e_log_det_lambda(post.niw.v, post.niw.w))
    if synthetic:
        logdet_plug = -np.linalg.slogdet(_np(reduced.hmm.cov))[1]
    else:
        v, w = _np(post.niw.v), _np(post.niw.w)
        logdet_plug = np.linalg.slogdet(v[..., None, None] * w)[1]
    term_w = float(0.5 * np.sum(_np(res.counts)
                                * (logdet_plug - log_lam_tilde)))

    p_d = 2.0 * (term_omega + term_pi + term_eps + term_mu + term_w)

    # deviance (myDIC.m:160-177): base vs point-estimate reduced
    ell = expected_pair_ll_point(base.hmm.mean, base.hmm.cov,
                                 reduced.hmm.mean, reduced.hmm.cov)
    pair = pair_bwd_fwd_auto(
        base.hmm.prior, base.hmm.trans,
        torch.log(torch.clamp_min(reduced.hmm.prior, 1e-300)),
        torch.log(torch.clamp_min(reduced.hmm.trans, 1e-300)), ell, tau)
    log_z = torch.log(torch.clamp_min(reduced.omega, 1e-300))[None, :] \
        + float(ni) * pair.ll_elbo
    ll = float(torch.sum(logsumexp(log_z, dim=-1)))
    if per_time:
        ll = ll / tau
    return p_d, 2.0 * p_d - 2.0 * ll


def aic_bic_vhem(ll: float, k: int, s: int, d: int, n_obs: int) -> tuple:
    """AIC/BIC for a VHEM solution with the reference's explicit
    parameter count (K-1) + K((S-1) + S(S-1) + 2SD)
    (`evaluate_vbhem_jounarl.m:160-239`)."""
    n_params = (k - 1) + k * ((s - 1) + s * (s - 1) + 2 * s * d)
    aic = -2.0 * ll + 2.0 * n_params
    bic = -2.0 * ll + n_params * np.log(max(n_obs, 1))
    return aic, bic
