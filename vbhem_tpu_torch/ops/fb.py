"""Masked, batched scaled forward-backward of the VBEM E-step: the plain
PyTorch version, the counterpart of :mod:`vbhem_tpu.ops.fb`.

This is the path for CPU tensors and the oracle of the hand-written CUDA
kernel ``csrc/fb.cuh`` (see :mod:`.fb_cuda`): of its first entry
:func:`forward_backward`, and of its fused E-step
:func:`expected_log_gauss` followed by :func:`forward_backward`.  It
keeps the reference's numerical conventions (`vbhmm_fb.m:289-377`):
emissions rescaled per step by ``max_k log_rho``, the forward pass
renormalized by ``c_t``, a padded step carrying alpha through with c = 1,
and beta reset to ones before a padded successor.

Every function accepts leading lane axes (subjects x restarts):
``log_rho [..., N, T, K]`` with a mask ``[..., N, T]`` that broadcasts
against it, and shared (``[..., K]`` / ``[..., K, K]``) or per-sequence
(``[..., N, K]`` / ``[..., N, K, K]``) initial and transition scores.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..containers import NIW
from ..utils.numeric import e_log_det_lambda, quad_diff


class FBStats(NamedTuple):
    """E-step outputs, mirroring `vbhmm_fb.m:383-389`."""
    log_rho: torch.Tensor   # [..., N, T, K] expected log emission (masked = 0)
    gamma: torch.Tensor     # [..., N, T, K] responsibilities (masked = 0)
    xi_sum: torch.Tensor    # [..., N, K, K] summed transition responsibilities
    phi_norm: torch.Tensor  # [..., N] per-sequence log normalizer of q(Z)


def expected_log_gauss(x: torch.Tensor, niw: NIW) -> torch.Tensor:
    """Expected log Gaussian density under the NIW posterior, Bishop
    (10.46)/(10.64) as in `vbhmm_fb.m:234-257`:

        delta[k]  = D / beta_k + v_k (x - m_k)^T W_k (x - m_k)
        logrho[k] = 0.5 E[log|Lambda_k|] - 0.5 delta[k] - (D/2) log(2 pi)

    x [..., N, T, D] (its leading axes broadcast against the posterior's
    lane axes), niw fields [..., K, ...] -> [..., N, T, K]."""
    d = x.shape[-1]
    quad = quad_diff(x[..., :, :, None, :], niw.m[..., None, None, :, :],
                     niw.w[..., None, None, :, :, :])        # [..,N,T,K]
    delta = d / niw.beta[..., None, None, :] + niw.v[..., None, None, :] * quad
    log_lam = e_log_det_lambda(niw.v, niw.w)                 # [..., K]
    cd = 0.5 * d * math.log(2.0 * math.pi)
    return 0.5 * log_lam[..., None, None, :] - 0.5 * delta - cd


def emission_constants(niw: NIW) -> torch.Tensor:
    """The per-state constants of :func:`expected_log_gauss` that the fused
    E-step of kernel B2 reads: [..., K, 1 + D + D*D] holding, per state,
    c_k = 0.5 E[log|Lambda_k|] - 0.5 D / beta_k - (D/2) log(2 pi), m_k and
    P_k = v_k W_k (row-major), so that

        log_rho_k(x) = c_k - 0.5 (x - m_k)^T P_k (x - m_k)."""
    d = niw.m.shape[-1]
    c = (0.5 * e_log_det_lambda(niw.v, niw.w) - 0.5 * d / niw.beta
         - 0.5 * d * math.log(2.0 * math.pi))
    p = niw.v[..., None, None] * niw.w
    return torch.cat([c[..., None], niw.m, p.flatten(-2)], dim=-1)


def _scores(log_pz1: torch.Tensor, log_trans: torch.Tensor, log_rho_dim: int):
    """exp of the initial and transition scores, broadcast to
    [..., N, K] and [..., N, K, K]; whether each is per sequence is read
    from its rank against ``log_rho``'s."""
    pz1 = torch.exp(log_pz1)
    trans = torch.exp(log_trans)
    if pz1.dim() == log_rho_dim - 2:          # shared [..., K]
        pz1 = pz1[..., None, :]
    if trans.dim() == log_rho_dim - 1:        # shared [..., K, K]
        trans = trans[..., None, :, :]
    return pz1, trans


def forward_backward(log_pz1: torch.Tensor, log_trans: torch.Tensor,
                     log_rho: torch.Tensor, mask: torch.Tensor) -> FBStats:
    """Scaled forward-backward over a padded batch (`vbhmm_fb.m:201-379`).

    log_pz1   [..., K] or [..., N, K]        E[log pi], not normalized
    log_trans [..., K, K] or [..., N, K, K]  E[log A], row format
    log_rho   [..., N, T, K]                 expected log emissions
    mask      [..., N, T] bool (broadcasts against log_rho[..., 0]); every
              sequence must have mask[..., 0] true.

    A Python loop over T: the plain version of kernel B2."""
    t_max = log_rho.shape[-2]
    pz1, trans = _scores(log_pz1, log_trans, log_rho.dim())
    mask = torch.broadcast_to(mask, log_rho.shape[:-1])
    maskf = mask.to(log_rho.dtype)

    max_rho = torch.amax(log_rho, dim=-1)                    # [..., N, T]
    px = torch.exp(log_rho - max_rho[..., None])             # [..., N, T, K]

    # ---- forward: alpha_t = normalize((alpha_{t-1} A) * px_t) ----
    delta0 = pz1 * px[..., 0, :]
    c0 = torch.sum(delta0, dim=-1)
    alphas = [delta0 / c0[..., None]]
    cs = [c0]
    for t in range(1, t_max):
        prev = alphas[-1]
        delta = torch.sum(prev[..., :, None] * trans, dim=-2) * px[..., t, :]
        c = torch.sum(delta, dim=-1)
        c_safe = torch.where(c > 0, c, torch.ones_like(c))
        valid = mask[..., t]
        # a padded step carries alpha through; its c contributes log 1
        alphas.append(torch.where(valid[..., None], delta / c_safe[..., None],
                                  prev))
        cs.append(torch.where(valid, c_safe, torch.ones_like(c_safe)))

    # ---- backward: beta, gamma, xi (vbhmm_fb.m:325-362) ----
    beta = torch.ones_like(alphas[0])
    betas = [beta]
    xi_sum = torch.zeros(log_rho.shape[:-2] + trans.shape[-2:],
                         dtype=log_rho.dtype, device=log_rho.device)
    for t in range(t_max - 2, -1, -1):
        valid = mask[..., t + 1]
        bp = beta * px[..., t + 1, :]
        c_next = cs[t + 1]
        beta_t = torch.sum(trans * bp[..., None, :], dim=-1) / c_next[..., None]
        beta = torch.where(valid[..., None], beta_t, torch.ones_like(beta_t))
        xi_t = (trans * (alphas[t][..., :, None] * bp[..., None, :])
                / c_next[..., None, None])
        xi_sum = xi_sum + torch.where(valid[..., None, None], xi_t,
                                      torch.zeros_like(xi_t))
        betas.append(beta)
    betas.reverse()

    gamma = torch.stack(alphas, dim=-2) * torch.stack(betas, dim=-2)
    gamma = gamma * maskf[..., None]
    log_c = torch.where(mask, torch.log(torch.stack(cs, dim=-1)),
                        torch.zeros_like(maskf))
    phi_norm = torch.sum(log_c, dim=-1) + torch.sum(max_rho * maskf, dim=-1)
    return FBStats(log_rho=log_rho * maskf[..., None], gamma=gamma,
                   xi_sum=xi_sum, phi_norm=phi_norm)


def _scaled_products(m: torch.Tensor, suffix: bool):
    """Inclusive products of the matrices m [..., n, K, K] along axis -3 in
    log(n) doubling rounds: prefix P_t = m_0 ... m_t, or with ``suffix``
    S_t = m_t ... m_{n-1}.  Each product is kept divided by its largest
    entry; the logs of those divisors add up in the second result
    [..., n], so P_t (S_t) is exp(s_t) times the returned matrix."""
    n = m.shape[-3]
    s = torch.zeros(m.shape[:-2], dtype=m.dtype, device=m.device)
    d = 1
    while d < n:
        # m_i m_{i+d}: the new S_i (suffix), or the new P_{i+d} (prefix)
        prod = m[..., :n - d, :, :] @ m[..., d:, :, :]
        s_sum = s[..., :n - d] + s[..., d:]
        scale = torch.amax(prod, dim=(-2, -1))
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        prod = prod / scale[..., None, None]
        s_sum = s_sum + torch.log(scale)
        if suffix:
            m = torch.cat([prod, m[..., n - d:, :, :]], dim=-3)
            s = torch.cat([s_sum, s[..., n - d:]], dim=-1)
        else:
            m = torch.cat([m[..., :d, :, :], prod], dim=-3)
            s = torch.cat([s[..., :d], s_sum], dim=-1)
        d *= 2
    return m, s


def forward_backward_assoc(log_pz1: torch.Tensor, log_trans: torch.Tensor,
                           log_rho: torch.Tensor, mask: torch.Tensor
                           ) -> FBStats:
    """Forward-backward in log(T) depth over time
    (`vbhem_tpu.ops.fb.forward_backward_assoc`): alpha_t is the initial
    row times the prefix product of the step operators
    M_t[i, j] = A[i, j] px_t[j] (the identity on a masked step), beta_t
    the suffix product times ones, so every alpha_t and beta_t comes from
    one doubling scan over T instead of a sequential pass.  The same
    gamma, xi_sum and phi_norm as :func:`forward_backward`, whose
    arguments and lane-leading shapes it takes; O(T K^3) work for the
    sequential O(T K^2).  It is on no call path, as in the JAX package."""
    t_max, k = log_rho.shape[-2:]
    dtype = log_rho.dtype
    pz1, trans = _scores(log_pz1, log_trans, log_rho.dim())
    mask = torch.broadcast_to(mask, log_rho.shape[:-1])
    maskf = mask.to(dtype)
    eye = torch.eye(k, dtype=dtype, device=log_rho.device)

    max_rho = torch.amax(log_rho, dim=-1)                    # [..., N, T]
    px = torch.exp(log_rho - max_rho[..., None])             # [..., N, T, K]
    trans_t = trans[..., None, :, :]                         # [.., N, 1, K, K]
    m_ops = torch.where(mask[..., 1:, None, None],
                        trans_t * px[..., 1:, None, :], eye)  # [..,N,T-1,K,K]
    pre_m, pre_s = _scaled_products(m_ops, suffix=False)
    suf_m, _ = _scaled_products(m_ops, suffix=True)

    def normalized(x):
        norm = torch.sum(x, dim=-1, keepdim=True)
        return x / torch.where(norm > 0, norm, torch.ones_like(norm)), norm

    alpha1 = pz1 * px[..., 0, :]                             # [..., N, K]
    alpha = torch.cat([alpha1[..., None, :],
                       torch.einsum("...k,...tkj->...tj", alpha1, pre_m)],
                      dim=-2)                                # [..., N, T, K]
    alpha_hat, alpha_norm = normalized(alpha)
    # log normalizer: log(alpha_1 P_{T-1} 1) + the scan's scales + shifts
    phi_norm = torch.log(alpha_norm[..., -1, 0]) \
        + torch.sum(max_rho * maskf, dim=-1)
    if t_max > 1:
        phi_norm = phi_norm + pre_s[..., -1]

    beta = torch.cat([torch.sum(suf_m, dim=-1),
                      torch.ones_like(alpha1)[..., None, :]], dim=-2)
    beta_hat, _ = normalized(beta)
    gamma, _ = normalized(alpha_hat * beta_hat)
    gamma = gamma * maskf[..., None]

    # xi_t (t -> t+1): alpha_t[i] A[i, j] px_{t+1}[j] beta_{t+1}[j], renormed
    bb = px[..., 1:, :] * beta_hat[..., 1:, :]               # [..,N,T-1,K]
    xi = alpha_hat[..., :-1, :, None] * trans_t * bb[..., None, :]
    xi_norm = torch.sum(xi, dim=(-2, -1), keepdim=True)
    xi = xi / torch.where(xi_norm > 0, xi_norm, torch.ones_like(xi_norm))
    xi_sum = torch.sum(xi * maskf[..., 1:, None, None], dim=-3)
    return FBStats(log_rho=log_rho * maskf[..., None], gamma=gamma,
                   xi_sum=xi_sum, phi_norm=phi_norm)
