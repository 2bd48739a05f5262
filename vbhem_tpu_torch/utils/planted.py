"""Synthetic banks of base HMMs for checking the clustering path, the
synthetic protocol's fixation sequences for checking the whole pipeline,
and the Rand index that scores a clustering against the planted groups.

Both the CPU tests and ``chip_smoke.py`` draw their data from here, so
the two see the same data for the same seed.
"""
from __future__ import annotations

import numpy as np
import torch

from ..containers import H3M, HMM, SeqBatch, resolve_device
from . import metrics

# the synthetic protocol's ground truth (`exprmt1_sampledata.m:21-43`):
# two 2-state HMMs with shared emissions, one sticky and one switching
SYNTH_MEANS = np.array([[0.0, 0.0], [3.0, 3.0]])
SYNTH_TRANS = np.array([[[0.6, 0.4], [0.4, 0.6]],
                        [[0.4, 0.6], [0.6, 0.4]]])


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


def synthetic_subjects(n_per_group: int, n_seqs: int = 25, t: int = 50,
                       noise: float = 0.1, seed: int = 0, device="cuda",
                       dtype=torch.float32):
    """Fixation-like sequences of the synthetic protocol
    (`experiments/synthetic.py:27-59`, `exprmt1_sampledata.m:51-87`):
    ``n_per_group`` subjects for each of the two ground-truth HMMs (prior
    [.5, .5], means (0,0) / (3,3), identity covariances, transitions
    [[.6,.4],[.4,.6]] and the swapped matrix), ``n_seqs`` sequences of
    length ``t`` each, plus N(0, noise^2) noise.  Drawn with numpy from
    ``seed``.  Returns (one SeqBatch per subject on ``device``, the card
    unless the caller names another; group labels [S])."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    labels = np.repeat([0, 1], n_per_group)
    n_subj = len(labels)
    trans = SYNTH_TRANS[labels]                              # [S, 2, 2]
    rows = np.arange(n_subj)[:, None]
    z = np.empty((n_subj, n_seqs, t), np.int64)
    z[..., 0] = rng.random((n_subj, n_seqs)) < 0.5
    for tt in range(1, t):
        p1 = trans[rows, z[..., tt - 1], 1]                  # p(next = 1)
        z[..., tt] = rng.random((n_subj, n_seqs)) < p1
    x = SYNTH_MEANS[z] + rng.standard_normal(z.shape + (2,))
    x = x + noise * rng.standard_normal(x.shape)
    xt = torch.as_tensor(x, dtype=dtype, device=device)
    lengths = torch.full((n_subj, n_seqs), t, dtype=torch.int32,
                         device=device)
    return ([SeqBatch(x=xt[i], lengths=lengths[i]) for i in range(n_subj)],
            labels)


def rand_index(a, b) -> float:
    """Plain (unadjusted) Rand index of two labelings: the share of item
    pairs on which they agree."""
    return metrics.rand_index(a, b)[1]
