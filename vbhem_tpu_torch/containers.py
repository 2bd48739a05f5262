"""Containers for HMMs, variational posteriors and H3M banks, as
``NamedTuple``s of tensors with the field names and layouts of
:mod:`vbhem_tpu.containers`.

Conventions (as in the JAX package):
  * means are row-major: ``m`` is [K, D];
  * transition matrices are row-stochastic: ``trans[i, j] = p(j | i)``;
  * banks of HMMs are stacked on a leading axis and padded to the max
    state count with a boolean ``state_mask``.

Reduced posteriors may carry extra leading lane axes (restart trials),
[L, Kr, ...]; every method here works on the trailing axes only.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class NIW(NamedTuple):
    """Normal-inverse-Wishart variational posterior over (mu, Lambda):
    mu | Lambda ~ N(m, (beta Lambda)^-1);  Lambda ~ Wishart(W, v)."""
    beta: torch.Tensor   # [..., K]
    v: torch.Tensor      # [..., K]
    m: torch.Tensor      # [..., K, D]
    w: torch.Tensor      # [..., K, D, D]   Wishart scale (precision-like)

    @property
    def dim(self) -> int:
        return self.m.shape[-1]

    @property
    def num_states(self) -> int:
        return self.m.shape[-2]

    def expected_cov(self) -> torch.Tensor:
        """E[Sigma] = W^{-1} / (v - D - 1); falls back to v when the mean of
        the inverse-Wishart does not exist (`vbhmm_em.m:394-408`)."""
        from .utils.numeric import inv_psd, sym
        d = self.dim
        winv = inv_psd(self.w)
        denom = torch.where(self.v > d + 1, self.v - d - 1.0, self.v)
        return sym(winv / denom[..., None, None])


class HMMPosterior(NamedTuple):
    """Variational posterior of one Gaussian-emission HMM (VBEM's
    ``varpar``).  alpha: Dirichlet over the initial state; epsilon:
    row-wise Dirichlet over transitions; niw: per-state emission."""
    alpha: torch.Tensor    # [..., K]
    epsilon: torch.Tensor  # [..., K, K]
    niw: NIW

    @property
    def num_states(self) -> int:
        return self.alpha.shape[-1]

    def to_point(self) -> "HMM":
        """Normalize counts into a point-estimate HMM (`vbhmm_em.m:424-464`)."""
        prior = self.alpha / torch.sum(self.alpha, dim=-1, keepdim=True)
        esum = torch.sum(self.epsilon, dim=-1, keepdim=True)
        esum = torch.where(esum == 0, torch.ones_like(esum), esum)
        return HMM(prior=prior, trans=self.epsilon / esum, mean=self.niw.m,
                   cov=self.niw.expected_cov())


class HMM(NamedTuple):
    """Point-estimate Gaussian-emission HMM."""
    prior: torch.Tensor  # [..., K]
    trans: torch.Tensor  # [..., K, K] row-stochastic
    mean: torch.Tensor   # [..., K, D]
    cov: torch.Tensor    # [..., K, D, D]

    @property
    def num_states(self) -> int:
        return self.prior.shape[-1]

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]


class VBHMMResult(NamedTuple):
    """Output of VBHMM learning for one subject: posterior + point model +
    sufficient statistics (`vbhmm_em.m:424-492`)."""
    post: HMMPosterior
    model: HMM
    ll: torch.Tensor
    gamma: torch.Tensor        # [N, T, K]
    counts_n1: torch.Tensor    # [K]
    counts: torch.Tensor       # [K]
    trans_counts: torch.Tensor  # [K, K]
    state_mask: Optional[torch.Tensor] = None  # [K]


class H3M(NamedTuple):
    """A bank of point-estimate HMMs with mixture weights, stacked on axis
    0 and padded to the max state count; ``state_mask`` marks real
    states."""
    omega: torch.Tensor       # [Kb]
    hmm: HMM                  # fields have a leading [Kb] axis
    state_mask: torch.Tensor  # [Kb, Sb_max] bool

    @property
    def num_hmms(self) -> int:
        return self.omega.shape[-1]


class H3MPosterior(NamedTuple):
    """Variational posterior of the reduced H3M learned by VBHEM:
    Dirichlets over cluster weights (alpha), initial states (eta) and
    transitions (epsilon), and per-cluster-state NIW emissions."""
    alpha: torch.Tensor    # [..., Kr]
    eta: torch.Tensor      # [..., Kr, Sr]
    epsilon: torch.Tensor  # [..., Kr, Sr, Sr]
    niw: NIW               # beta/v [..., Kr, Sr]; m [.., D]; w [.., D, D]

    @property
    def num_clusters(self) -> int:
        return self.alpha.shape[-1]

    @property
    def num_states(self) -> int:
        return self.eta.shape[-1]

    def to_h3m(self) -> H3M:
        """Posterior -> point-estimate H3M (`convert_h3mrtoh3mb.m`)."""
        omega = self.alpha / torch.sum(self.alpha, dim=-1, keepdim=True)
        prior = self.eta / torch.sum(self.eta, dim=-1, keepdim=True)
        esum = torch.sum(self.epsilon, dim=-1, keepdim=True)
        esum = torch.where(esum == 0, torch.ones_like(esum), esum)
        hmm = HMM(prior=prior, trans=self.epsilon / esum, mean=self.niw.m,
                  cov=self.niw.expected_cov())
        mask = torch.ones(self.eta.shape, dtype=torch.bool,
                          device=self.eta.device)
        return H3M(omega=omega, hmm=hmm, state_mask=mask)


class SeqBatch(NamedTuple):
    """Dense padded batch of variable-length sequences: [N, T_max, D] +
    lengths.  A bank of subjects' batches of one shape stacks on leading
    axes: x [..., N, T_max, D], lengths [..., N]."""
    x: torch.Tensor        # [..., N, T_max, D]
    lengths: torch.Tensor  # [..., N] int32

    @property
    def mask(self) -> torch.Tensor:  # [..., N, T_max] bool
        t = torch.arange(self.x.shape[-2], device=self.x.device)
        return t < self.lengths[..., None]

    @property
    def total(self) -> torch.Tensor:  # [...] observations per batch
        return torch.sum(self.lengths, dim=-1)


def tree_map(fn, *trees):
    """Map ``fn`` over the tensor leaves of NamedTuples of one type
    (``None`` leaves stay ``None``)."""
    first = trees[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*[tree_map(fn, *parts) for parts in zip(*trees)])
    if first is None:
        return None
    return fn(*trees)


def resolve_device(device) -> torch.device:
    """The device an entry point builds its tensors on.  Entry points
    default to ``"cuda"``; a CUDA device that is not there raises, so a
    machine without a card never quietly runs on the CPU.  Pass
    ``device="cpu"`` to run there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is available for {dev}; pass "
                           f"device='cpu' to build the tensors on the CPU")
    return dev


def pack_sequences(seqs, dtype=None, t_max: Optional[int] = None,
                   device="cuda") -> SeqBatch:
    """Pack a python list of [T_i, D] arrays into a SeqBatch on
    ``device`` (the card unless the caller names another)."""
    device = resolve_device(device)
    import numpy as np
    n = len(seqs)
    d = np.asarray(seqs[0]).shape[-1]
    tm = t_max if t_max is not None else max(
        int(np.asarray(s).shape[0]) for s in seqs)
    x = np.zeros((n, tm, d), dtype=dtype or np.asarray(seqs[0]).dtype)
    lengths = np.zeros((n,), dtype=np.int32)
    for i, s in enumerate(seqs):
        s = np.asarray(s)
        x[i, : s.shape[0]] = s
        lengths[i] = s.shape[0]
    return SeqBatch(x=torch.as_tensor(x, device=device),
                    lengths=torch.as_tensor(lengths, device=device))
