"""Synthetic banks of base HMMs for checking the clustering path, and the
Rand index that scores a clustering against the planted groups.

Both the CPU tests and ``chip_smoke.py`` draw their banks from here, so
the two see the same data for the same seed.
"""
from __future__ import annotations

import numpy as np
import torch

from ..containers import H3M, HMM


def bank_from_numpy(prior, trans, mean, cov, mask, device, dtype) -> H3M:
    """An ``H3M`` of uniform weights from numpy arrays prior [Kb,Sb],
    trans [Kb,Sb,Sb], mean [Kb,Sb,D], cov [Kb,Sb,D,D], mask [Kb,Sb]."""
    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    kb = prior.shape[0]
    return H3M(omega=t(np.full((kb,), 1.0 / kb)),
               hmm=HMM(prior=t(prior), trans=t(trans), mean=t(mean),
                       cov=t(cov)),
               state_mask=torch.as_tensor(mask, device=device))


def random_bank(rng, kb, sb, d, device, dtype, ragged=False) -> H3M:
    """A bank of ``kb`` random base HMMs drawn from the numpy generator
    ``rng``, in the manner of ``bench.py``'s problem.  With ``ragged``,
    base HMM 0 has its last state zero-padded as ``h3m_from_results``
    pads a shorter HMM: zero prior and transitions, identity covariance,
    masked out."""
    mean = rng.normal(size=(kb, sb, d)) * 3.0
    a = rng.normal(size=(kb, sb, d, d)) * 0.3
    cov = np.einsum("ksde,ksfe->ksdf", a, a) + np.eye(d)
    prior = rng.dirichlet(np.ones(sb), kb)
    trans = rng.dirichlet(np.ones(sb), (kb, sb))
    mask = np.ones((kb, sb), bool)
    if ragged:
        prior[0] = np.append(rng.dirichlet(np.ones(sb - 1)), 0.0)
        trans[0] = 0.0
        trans[0, :-1, :-1] = rng.dirichlet(np.ones(sb - 1), sb - 1)
        mean[0, -1] = 0.0
        cov[0, -1] = np.eye(d)
        mask[0, -1] = False
    return bank_from_numpy(prior, trans, mean, cov, mask, device, dtype)


def planted_bank(kb, device, dtype, seed=3):
    """Two groups of 3-state, 2-D base HMMs.  Each group's states sit in
    two emission regions 6 standard deviations apart (state 0 in one,
    states 1 and 2 in the other), so that one 2-state cluster center
    cannot serve both groups; the groups sit 20 standard deviations
    apart.  Returns (bank, group labels [Kb])."""
    rng = np.random.default_rng(seed)
    sb, d = 3, 2
    labels = np.repeat([0, 1], kb // 2)
    centers = np.array([[0.0, 0.0], [6.0, 0.0], [6.0, 0.0]])
    offsets = np.array([[0.0, 0.0], [20.0, 20.0]])
    mean = (centers[None] + offsets[labels][:, None]
            + rng.normal(size=(kb, sb, d)) * 0.3)
    a = rng.normal(size=(kb, sb, d, d)) * 0.2
    cov = np.einsum("ksde,ksfe->ksdf", a, a) + np.eye(d)
    prior = rng.dirichlet(np.ones(sb) * 2, kb)
    trans = rng.dirichlet(np.ones(sb) * 2, (kb, sb))
    base = bank_from_numpy(prior, trans, mean, cov, np.ones((kb, sb), bool),
                           device, dtype)
    return base, labels


def rand_index(a, b) -> float:
    """Plain (unadjusted) Rand index of two labelings: the share of item
    pairs on which they agree."""
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    _, ia = np.unique(a, return_inverse=True)
    _, ib = np.unique(b, return_inverse=True)
    c = np.zeros((ia.max() + 1, ib.max() + 1))
    np.add.at(c, (ia, ib), 1)
    n = c.sum()
    pairs = n * (n - 1) / 2

    def comb2(x):
        return float((x * (x - 1) / 2).sum())

    agree = pairs + 2 * comb2(c) - comb2(c.sum(1)) - comb2(c.sum(0))
    return agree / pairs
