"""CCFD: density-peak clustering of HMMs (Rodriguez-Laio style with
automatic center detection) — the counterpart of
:mod:`vbhem_tpu.models.ccfd`.

Parity map: `src/compare_mtds/ccfd/myccfd.m` (the pipeline: symmetric-KL
distance matrix + fitness-driven search over the cutoff percentage) and
`CCFD.m` (cutoff-kernel density rho, distance-to-denser-point delta,
gamma = rho*delta with 5-sigma outlier detection of centers, slope
gating, nearest-denser-neighbor assignment, halo/border computation,
fitness = mean inter-center distance / mean distance-to-center).

The distance matrix is one batched log-likelihood table on the HMMs'
device (:func:`.hmm_tools.loglik` over a models axis); the peak finding
is small-N host code in NumPy, as in the reference and the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..containers import HMM, SeqBatch
from . import hmm_tools


class CCFDResult(NamedTuple):
    label: np.ndarray        # [N] 0-based cluster labels
    center_idx: np.ndarray   # [K]
    halo: np.ndarray         # [N] label or -1 for halo points
    rho: np.ndarray
    delta: np.ndarray
    dist: np.ndarray         # [N, N]
    dc: float
    fitness: float


def _skl_distance_matrix_loop(gen: Optional[torch.Generator],
                              hmms: Sequence[HMM],
                              data: Optional[Sequence[SeqBatch]] = None,
                              n_samples: int = 100,
                              t: int = 50) -> np.ndarray:
    """The ordered-pair loop of `myccfd.m:17-30`, for subjects whose data
    shapes differ (the batched table needs one shape)."""
    n = len(hmms)
    dist = np.zeros((n, n))
    for i in range(n):
        batch = data[i] if data is not None else None
        for j in range(i + 1, n):
            d1 = float(hmm_tools.kld(gen, hmms[i], hmms[j], batch=batch,
                                     n_samples=n_samples, t=t))
            batch_j = data[j] if data is not None else None
            d2 = float(hmm_tools.kld(gen, hmms[j], hmms[i], batch=batch_j,
                                     n_samples=n_samples, t=t))
            dist[i, j] = dist[j, i] = 0.5 * (d1 + d2)
    return dist


def skl_distance_matrix(gen: Optional[torch.Generator], hmms: Sequence[HMM],
                        data: Optional[Sequence[SeqBatch]] = None,
                        n_samples: int = 100, t: int = 50) -> np.ndarray:
    """Symmetric KL distance matrix (`myccfd.m:17-30`):
    d(i,j) = 0.5 (KL(i||j) + KL(j||i)) estimated on each HMM's own data
    (or on ``n_samples`` sequences of length ``t`` drawn from it with
    ``gen``).

    Every KL is a difference of mean log-likelihoods, so the matrix comes
    from one [N_data x N_model] mean-loglik table LLm,
    d(i,j) = 0.5 (LLm[i,i]-LLm[i,j] + LLm[j,j]-LLm[j,i]), computed by
    one :func:`.hmm_tools.loglik` call of every sequence under every HMM
    of the state-padded bank.  Subjects whose data shapes differ take the
    ordered-pair loop instead."""
    from .vbhem import h3m_from_hmms

    n = len(hmms)
    if data is not None:
        shapes = {tuple(b.x.shape) for b in data}
        if len(shapes) != 1:
            return _skl_distance_matrix_loop(gen, hmms, data, n_samples, t)

    hb = h3m_from_hmms(list(hmms), device=hmms[0].mean.device).hmm
    if data is not None:
        xs = torch.stack([b.x for b in data])                # [N,ns,T,D]
        lens = torch.stack([b.lengths for b in data])
    else:
        # each HMM's own Monte-Carlo sample (`vbhmm_kld.m:36-40`)
        xs = torch.stack([hmm_tools.sample(gen, h, t, n_samples)[1]
                          for h in hmms])
        lens = torch.full((n, n_samples), t, dtype=torch.int32,
                          device=xs.device)
    ns = xs.shape[1]
    flat = SeqBatch(x=xs.reshape((-1,) + xs.shape[2:]),
                    lengths=lens.reshape(-1))
    ll = hmm_tools.loglik(flat, hb)                          # [N_model, N*ns]
    llm = torch.mean(ll.reshape(n, n, ns), dim=-1).T         # [N_data, N_model]
    llm = llm.detach().cpu().numpy()
    diag = np.diag(llm)
    dist = 0.5 * ((diag[:, None] - llm) + (diag[None, :] - llm.T))
    np.fill_diagonal(dist, 0.0)
    return dist


def _ccfd_core(dist: np.ndarray, dc: float, slope: float):
    """One CCFD evaluation at a given cutoff distance (`CCFD.m`)."""
    nd = dist.shape[0]
    iu = np.triu_indices(nd, 1)
    # cutoff-kernel density (`CCFD.m:35-42`)
    close = dist < dc
    np.fill_diagonal(close, False)
    rho = close.sum(axis=1).astype(float)

    order = np.argsort(-rho, kind="stable")
    delta = np.full(nd, dist.max())
    nneigh = np.zeros(nd, dtype=np.int64)
    for ii in range(1, nd):
        i = order[ii]
        denser = order[:ii]
        j = denser[np.argmin(dist[i, denser])]
        delta[i] = dist[i, j]
        nneigh[i] = j
    delta[order[0]] = delta.max()

    gamma = rho * delta
    # drop extreme gammas before fitting the normal (`CCFD.m:92-101`)
    use = gamma <= 2.0 * gamma.mean()
    mg = gamma[use].mean()
    sg = np.sqrt(gamma[use].var(ddof=1)) if use.sum() > 1 else 0.0
    sing = np.where((gamma > mg + 5 * sg) | (gamma < mg - 5 * sg))[0]
    if len(sing) == 0:
        raise ValueError("NO SINGULAR POINTS")

    # slope gating (`CCFD.m:139-168`)
    dr = delta.max() - delta.min()
    rr = rho.max() - rho.min()
    k_star1 = (slope * dr + delta.min()) / (rr + rho.min())
    k_star2 = ((1.0 / slope) * dr + delta.min()) / (rr + rho.min())
    centers = []
    cl = -np.ones(nd, dtype=np.int64)
    for j in sing:
        if delta[j] == 0 or rho[j] == 0:
            continue
        if (rho[j] / delta[j] < 1.0 / k_star2) and \
                (delta[j] / rho[j] < k_star1):
            cl[j] = len(centers)
            centers.append(int(j))
    if len(centers) == 0:
        raise ValueError("NO CLUSTER CENTERS")

    # assignation by nearest denser neighbor (`CCFD.m:177-182`)
    for i in order:
        if cl[i] == -1:
            cl[i] = cl[nneigh[i]]

    # halo (`CCFD.m:186-211`): points below the border density
    halo = cl.copy()
    nclust = len(centers)
    if nclust > 1:
        bord = np.zeros(nclust)
        for a, b in zip(*iu):
            if cl[a] != cl[b] and dist[a, b] <= dc:
                avg = 0.5 * (rho[a] + rho[b])
                bord[cl[a]] = max(bord[cl[a]], avg)
                bord[cl[b]] = max(bord[cl[b]], avg)
        halo[rho < bord[cl]] = -1

    # fitness (`CCFD.m:228-256`): separation / compactness
    fit1 = 0.0
    for j in range(nclust):
        members = cl == j
        fit1 += dist[members, centers[j]].sum() / nd
    fit1 /= nclust
    if nclust > 1:
        cc = np.asarray(centers)
        fit2 = dist[np.ix_(cc, cc)].sum() / nclust / (nclust - 1)
    else:
        fit2 = 0.0
    fitness = fit2 / fit1 if fit1 > 0 else 0.0
    return fitness, np.asarray(centers), cl, rho, delta, halo


def ccfd(gen: Optional[torch.Generator], hmms: Sequence[HMM],
         data: Optional[Sequence[SeqBatch]] = None,
         slope: float = 3.0, n_samples: int = 100) -> CCFDResult:
    """Full CCFD pipeline with the fitness-driven search over the cutoff
    percentage (`myccfd.m:40-77`: percent starts at 10, radius 3 shrinks
    by 0.5, testing percent + r*{-1,0,1} each round).  ``gen`` draws the
    Monte-Carlo samples when no data is given."""
    dist = skl_distance_matrix(gen, hmms, data, n_samples=n_samples)
    pur = dist[np.triu_indices(len(hmms), 1)]
    lo, hi = pur.min(), pur.max()

    def dc_of(percent):
        return lo + (hi - lo) * percent / 100.0

    percent, r = 10.0, 3.0
    best = None
    while r > 0:
        fits = []
        for c in (-1.0, 0.0, 1.0):
            p0 = percent + r * c
            try:
                out = _ccfd_core(dist, dc_of(p0), slope)
                fits.append((out[0], p0, out))
            except ValueError:
                fits.append((-np.inf, p0, None))
        fits_only = [f[0] for f in fits]
        idx = 2 if len(set(fits_only)) == 1 else int(np.argmax(fits_only))
        percent = fits[idx][1]
        if fits[idx][2] is not None:
            best = fits[idx]
        r -= 0.5
    if best is None or best[2] is None:
        raise ValueError("CCFD found no valid clustering")
    fitness, centers, cl, rho, delta, halo = best[2]
    return CCFDResult(label=cl, center_idx=centers, halo=halo, rho=rho,
                      delta=delta, dist=dist, dc=dc_of(best[1]),
                      fitness=fitness)
