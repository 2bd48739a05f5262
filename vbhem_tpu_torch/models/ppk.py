"""PPK-SC: probability-product-kernel spectral clustering of HMMs — the
counterpart of :mod:`vbhem_tpu.models.ppk`.

Parity map: `src/compare_mtds/ppk/ppk_sc.m` (the pipeline), `elkernel.m`
(iterated PPK between two HMMs, T=10, rho=0.5, covariance pad 0.45),
`bhatt.m` (Bhattacharyya affinity between Gaussians, ridge 1e-5*trace),
`SpectralClustering.m` (Jordan-Weiss type 3: symmetric-normalized
affinity, top-K eigenvectors, row-normalized, k-means).

The Gram matrix is one batched evaluation over every pair of the
state-padded bank, on the bank's device; the eigendecomposition runs on
the host in NumPy, as in the JAX package; k-means is
:func:`..ops.kmeans.kmeans` on the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..containers import HMM
from ..ops.kmeans import kmeans
from ..utils.numeric import inv_psd, logdet_psd

PAD = 0.45          # elkernel.m:17 ("i don't know what is this!")
RHO = 0.5           # Bhattacharyya exponent
DEFAULT_T = 10


def _ridge(cov: torch.Tensor) -> torch.Tensor:
    d = cov.shape[-1]
    tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)
    return cov + 1e-5 * tr[..., None, None] * torch.eye(
        d, dtype=cov.dtype, device=cov.device)


def bhatt_affinity(mean1, cov1, mean2, cov2) -> torch.Tensor:
    """Bhattacharyya affinity between all Gaussian pairs (`bhatt.m`).

    mean1 [..., S1, D], cov1 [..., S1, D, D], mean2 [..., S2, D],
    cov2 [..., S2, D, D] -> [..., S1, S2]; leading axes broadcast."""
    d = mean1.shape[-1]
    c1, c2 = _ridge(cov1), _ridge(cov2)
    ic1, ic2 = inv_psd(c1), inv_psd(c2)                  # [..., S, D, D]
    cd = inv_psd(ic1[..., :, None, :, :] + ic2[..., None, :, :, :])
    md = (torch.einsum("...ide,...ie->...id", ic1, mean1)[..., :, None, :]
          + torch.einsum("...jde,...je->...jd", ic2, mean2)[..., None, :, :])
    q1 = torch.einsum("...id,...ide,...ie->...i", mean1, ic1, mean1)
    q2 = torch.einsum("...jd,...jde,...je->...j", mean2, ic2, mean2)
    qd = torch.einsum("...ijd,...ijde,...ije->...ij", md, cd, md)
    log_norm = ((1 - 2 * RHO) * (d / 2) * math.log(2 * math.pi)
                - (d / 2) * math.log(RHO)
                - (RHO / 2) * logdet_psd(c1)[..., :, None]
                - (RHO / 2) * logdet_psd(c2)[..., None, :]
                + 0.5 * logdet_psd(cd))
    return torch.exp(log_norm - (RHO / 2) * (q1[..., :, None]
                                             + q2[..., None, :] - qd))


def ppk(hmm1: HMM, hmm2: HMM, t: int = DEFAULT_T,
        rho: float = RHO) -> torch.Tensor:
    """Iterated probability-product kernel (`elkernel.m:28-53`); leading
    model axes of the two HMMs broadcast, so one call evaluates a whole
    grid of pairs.  A zero-padded state (prior and transition mass 0)
    contributes exactly 0: 0 ** rho is 0."""
    d = hmm1.dim
    pad = PAD * torch.eye(d, dtype=hmm1.cov.dtype, device=hmm1.cov.device)
    pot = bhatt_affinity(hmm1.mean, hmm1.cov + pad,
                         hmm2.mean, hmm2.cov + pad)     # [..., S1, S2]
    p1, p2 = hmm1.prior, hmm2.prior
    if t == 1:
        return torch.einsum("...i,...j,...ij->...", p1, p2, pot)
    a1, a2 = hmm1.trans ** rho, hmm2.trans ** rho
    # sep1 = sum_ij (p1_i p2_j)^rho pot_ij (A1_i:)^rho (A2_j:)^rho
    w0 = (p1[..., :, None] * p2[..., None, :]) ** rho * pot
    sep = torch.einsum("...ij,...ik,...jl->...kl", w0, a1, a2)
    # the reference's t=2..T updates sep (T-1 in all, the first included)
    for _ in range(t - 2):
        sep = torch.einsum("...ij,...ik,...jl->...kl", sep * pot, a1, a2)
    return torch.sum(sep * pot, dim=(-2, -1))


def gram_matrix(hmms: Sequence[HMM], t: int = DEFAULT_T) -> np.ndarray:
    """Pairwise PPK Gram matrix (`ppk_sc.m:16-22`) as one batched
    evaluation over every (i, j) of the state-padded bank
    (:func:`..models.vbhem.h3m_from_hmms`, on the HMMs' device); returns
    the symmetrized [N, N] matrix in NumPy."""
    from .vbhem import h3m_from_hmms
    hb = h3m_from_hmms(list(hmms), device=hmms[0].mean.device).hmm
    rows = HMM(*[f[:, None] for f in hb])
    cols = HMM(*[f[None, :] for f in hb])
    g = ppk(rows, cols, t).detach().cpu().numpy()
    return 0.5 * (g + g.T)


class PPKSCResult(NamedTuple):
    label: np.ndarray          # [N] cluster assignments (0-based)
    center_idx: np.ndarray     # [K] index of center HMM per cluster
    gram: np.ndarray           # [N, N]
    embedding: np.ndarray      # [N, K] spectral embedding


def spectral_cluster(gen: torch.Generator, affinity: np.ndarray,
                     k: int) -> tuple:
    """Jordan-Weiss normalized spectral clustering
    (`SpectralClustering.m:29-98`, Type 3): the eigendecomposition in
    NumPy, then k-means of the row-normalized top-K eigenvectors on the
    host.  Returns (assignment [N], centers [K, K], embedding [N, K])."""
    degs = affinity.sum(axis=1)
    degs = np.where(degs == 0, np.finfo(float).eps, degs)
    dm12 = 1.0 / np.sqrt(degs)
    lap = dm12[:, None] * affinity * dm12[None, :]
    lap = 0.5 * (lap + lap.T)
    vals, vecs = np.linalg.eigh(lap)
    u = vecs[:, np.argsort(-vals)[:k]]                  # top-K eigenvectors
    norms = np.sqrt((u ** 2).sum(axis=1, keepdims=True))
    u = np.where(norms > 0, u / norms, 0.0)
    assign, centers = kmeans(gen, torch.as_tensor(u), k)
    return assign.numpy(), centers.numpy(), u


def ppk_sc(gen: torch.Generator, hmms: Sequence[HMM], k: int,
           t: int = DEFAULT_T) -> PPKSCResult:
    """Full PPK-SC pipeline (`ppk_sc.m`).  Cluster 'centers' are the
    input HMMs mapped closest to the spectral centroids (`:36-45`)."""
    a = gram_matrix(hmms, t)
    assign, centers, u = spectral_cluster(gen, a, k)
    center_idx = np.zeros((k,), dtype=np.int64)
    for j in range(k):
        members = np.where(assign == j)[0]
        if len(members) == 0:
            center_idx[j] = int(np.argmin(
                ((u - centers[j]) ** 2).sum(axis=1)))
            continue
        d2 = ((u[members] - centers[j]) ** 2).sum(axis=1)
        center_idx[j] = members[int(np.argmin(d2))]
    return PPKSCResult(label=assign, center_idx=center_idx, gram=a,
                       embedding=u)
