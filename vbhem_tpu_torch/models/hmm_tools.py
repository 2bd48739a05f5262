"""Point-estimate HMM utilities: likelihood, Viterbi decoding, sampling,
KL divergence, entropy — the counterpart of
:mod:`vbhem_tpu.models.hmm_tools`.

Parity map: `vbhmm_ll.m`, `vbhmm_map_state.m` (viterbi_path),
`vbhmm_random_sample.m`, `vbhmm_kld.m`, `vbhmm_entropy.m`,
`vbhmm_prob_state.m` in the reference's `src/hmm/`.

The JAX package runs these recursions in ``lax.scan`` outside any Pallas
kernel; here they are plain PyTorch loops over time on the device of
their inputs.  ``loglik`` and ``viterbi`` take HMMs with leading model
axes ([*M, K, ...]) and evaluate every model on every sequence in one
batched pass, where the JAX package vmaps over models.  Randomness comes
from an explicit ``torch.Generator`` and is drawn on the generator's
device; its draws differ from ``jax.random``'s.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..containers import HMM, SeqBatch
from ..utils.numeric import inv_psd, logdet_psd, tiny


def _log_gauss_obs(x: torch.Tensor, hmm: HMM) -> torch.Tensor:
    """log N(x_t | mean_k, cov_k): x [N, T, D] and an HMM with model axes
    [*M, K, ...] -> [*M, N, T, K]."""
    d = x.shape[-1]
    prec = inv_psd(hmm.cov)                                    # [*M, K, D, D]
    diff = x[:, :, None, :] - hmm.mean[..., None, None, :, :]  # [*M,N,T,K,D]
    quad = torch.einsum("...ntkd,...kde,...ntke->...ntk", diff, prec, diff)
    logdet = logdet_psd(hmm.cov)[..., None, None, :]          # [*M,1,1,K]
    return -0.5 * (quad + logdet + d * math.log(2 * math.pi))


def loglik(batch: SeqBatch, hmm: HMM, normalize: bool = False) -> torch.Tensor:
    """Per-sequence data log-likelihood via the scaled forward recursion
    (`vbhmm_ll.m`): batch x [N, T, D] and an HMM with model axes
    [*M, K, ...] -> [*M, N].  ``normalize`` divides by sequence length
    (`vbhmm_ll.m:108-114`).  Each step's scale is floored at the dtype's
    smallest positive normal, as the reference floors densities at
    4.94e-323 (`vbhmm_ll.m:70-72`)."""
    mask = batch.mask                                          # [N, T]
    floor = tiny(batch.x.dtype)
    logb = _log_gauss_obs(batch.x, hmm)                        # [*M,N,T,K]
    maxb = torch.amax(logb, dim=-1)                            # [*M,N,T]
    b = torch.exp(logb - maxb[..., None])
    prior = hmm.prior[..., None, :]                            # [*M,1,K]
    trans = hmm.trans

    alpha = prior * b[..., 0, :]
    c0 = torch.clamp_min(torch.sum(alpha, dim=-1), floor)
    alpha = alpha / c0[..., None]
    log_c = torch.log(c0)
    for t in range(1, batch.x.shape[-2]):
        valid = mask[:, t]
        al = torch.matmul(alpha, trans) * b[..., t, :]
        c = torch.clamp_min(torch.sum(al, dim=-1), floor)
        al = al / c[..., None]
        alpha = torch.where(valid[:, None], al, alpha)
        log_c = log_c + torch.log(torch.where(valid, c, torch.ones_like(c)))
    ll = log_c + torch.sum(maxb * mask.to(batch.x.dtype), dim=-1)
    if normalize:
        ll = ll / batch.lengths.to(ll.dtype)
    return ll


def viterbi(batch: SeqBatch, hmm: HMM) -> Tuple[torch.Tensor, torch.Tensor]:
    """MAP state sequences (`vbhmm_map_state.m:41-103`).

    Returns (paths [*M, N, T] int32 with -1 on padding, log probability
    [*M, N]).  Ties go to the first maximal state, as ``jnp.argmax``
    breaks them."""
    mask = batch.mask
    logb = _log_gauss_obs(batch.x, hmm)                        # [*M,N,T,K]
    log_a = torch.log(hmm.trans)[..., None, :, :]              # [*M,1,K,K]
    delta = torch.log(hmm.prior)[..., None, :] + logb[..., 0, :]
    args = []
    for t in range(1, batch.x.shape[-2]):
        cand = delta[..., :, :, None] + log_a                  # [*M,N,K,K]
        best = torch.amax(cand, dim=-2) + logb[..., t, :]
        args.append(torch.argmax(cand, dim=-2))
        delta = torch.where(mask[:, t, None], best, delta)
    logp = torch.amax(delta, dim=-1)
    state = torch.argmax(delta, dim=-1)                        # [*M, N]
    states = [state]
    for t in range(batch.x.shape[-2] - 2, -1, -1):
        prev = torch.gather(args[t], -1, state[..., None])[..., 0]
        state = torch.where(mask[:, t + 1], prev, state)
        states.append(state)
    paths = torch.stack(states[::-1], dim=-1).to(torch.int32)
    paths = torch.where(mask, paths, torch.full_like(paths, -1))
    return paths, logp


def _categorical(gen: torch.Generator, p: torch.Tensor) -> torch.Tensor:
    """One draw per row of probabilities p [..., K] by inverting the CDF of
    a uniform drawn on the generator's device."""
    u = torch.rand(p.shape[:-1] + (1,), generator=gen, device=gen.device,
                   dtype=torch.float64).to(p.device)
    cdf = torch.cumsum(p.double(), dim=-1)
    z = torch.searchsorted(cdf, u * cdf[..., -1:], right=True)[..., 0]
    return torch.clamp_max(z, p.shape[-1] - 1)


def sample(gen: torch.Generator, hmm: HMM, t: int,
           n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ancestral sampling of n sequences of length t
    (`vbhmm_random_sample.m`): the hidden chain, then Gaussian emissions
    through the Cholesky factor of each state's covariance.  Returns
    (states [N, T] int64, x [N, T, D]) on the HMM's device.  The chain
    draws one uniform per sequence and step, then the emission noise
    [N, T, D], all from ``gen``."""
    dev = hmm.mean.device
    chol = torch.linalg.cholesky(hmm.cov)
    z = _categorical(gen, hmm.prior.expand(n, -1))
    states = [z]
    for _ in range(1, t):
        z = _categorical(gen, hmm.trans[z])
        states.append(z)
    states = torch.stack(states, dim=1)                        # [N, T]
    eps = torch.randn((n, t, hmm.dim), generator=gen, device=gen.device,
                      dtype=hmm.mean.dtype).to(dev)
    x = hmm.mean[states] + torch.einsum("ntde,nte->ntd", chol[states], eps)
    return states, x


def kld(gen: Optional[torch.Generator], hmm1: HMM, hmm2: HMM,
        batch: Optional[SeqBatch] = None, n_samples: int = 100,
        t: int = 50) -> torch.Tensor:
    """Monte-Carlo KL(hmm1 || hmm2) ~= mean(ll1 - ll2) on hmm1's data
    (`vbhmm_kld.m`).  If no data is given, samples from hmm1
    (`vbhmm_kld.m:36-40`)."""
    if batch is None:
        _, x = sample(gen, hmm1, t, n_samples)
        batch = SeqBatch(x=x, lengths=torch.full(
            (n_samples,), t, dtype=torch.int32, device=x.device))
    return torch.mean(loglik(batch, hmm1) - loglik(batch, hmm2))


def entropy(batch: SeqBatch, hmm: HMM) -> torch.Tensor:
    """Mean normalized negative log-likelihood (`vbhmm_entropy.m`)."""
    return -torch.mean(loglik(batch, hmm, normalize=True))


def state_seq_logprob(states: torch.Tensor, hmm: HMM) -> torch.Tensor:
    """log p(z_1..z_T) of hidden-state sequences [N, T]
    (`vbhmm_prob_state.m`)."""
    states = states.long()
    lp0 = torch.log(hmm.prior)[states[:, 0]]
    lpt = torch.log(hmm.trans)[states[:, :-1], states[:, 1:]]
    return lp0 + torch.sum(lpt, dim=-1)
