"""Clustering-quality metrics, in NumPy: this package's own copy of
:mod:`vbhem_tpu.utils.metrics`.

Parity map: `src/compare_mtds/eva/valid_RandIndex.m` (Hubert-Arabie
adjusted Rand + Rand/Mirkin/Hubert), `src/compare_mtds/eva/Purity.m`,
and the Dunn index computed from symmetric KL distances in
`Synthetic_experiment/evaluate_vbhem_jounarl.m:86-118`.
"""
from __future__ import annotations

import numpy as np

__all__ = ["rand_index", "purity", "dunn_index", "contingency"]


def contingency(labels1, labels2) -> np.ndarray:
    """Contingency table of two labelings (`valid_RandIndex.m:44-55`)."""
    l1 = np.asarray(labels1).ravel()
    l2 = np.asarray(labels2).ravel()
    if l1.shape != l2.shape:
        raise ValueError("label vectors must have the same length")
    u1, i1 = np.unique(l1, return_inverse=True)
    u2, i2 = np.unique(l2, return_inverse=True)
    c = np.zeros((len(u1), len(u2)), dtype=np.int64)
    np.add.at(c, (i1, i2), 1)
    return c


def rand_index(labels1, labels2):
    """(adjusted_rand, rand, mirkin, hubert) per `valid_RandIndex.m:18-42`."""
    c = contingency(labels1, labels2).astype(np.float64)
    n = c.sum()
    nis = (c.sum(axis=1) ** 2).sum()
    njs = (c.sum(axis=0) ** 2).sum()
    t1 = n * (n - 1) / 2.0              # total pairs
    t2 = (c ** 2).sum()
    t3 = 0.5 * (nis + njs)
    nc = (n * (n ** 2 + 1) - (n + 1) * nis - (n + 1) * njs
          + 2 * (nis * njs) / n) / (2.0 * (n - 1))
    a = t1 + t2 - t3                    # agreements
    d = -t2 + t3                        # disagreements
    if t1 == nc:
        ar = 0.0
    else:
        ar = (a - nc) / (t1 - nc)
    return float(ar), float(a / t1), float(d / t1), float((a - d) / t1)


def purity(labels_pred, labels_true) -> float:
    """Cluster purity (`Purity.m:7-19`): sum of majority counts / N."""
    c = contingency(labels_pred, labels_true)
    return float(c.max(axis=1).sum() / c.sum())


def dunn_index(dist: np.ndarray, labels) -> float:
    """Dunn index from a pairwise distance matrix: min inter-cluster
    distance / max intra-cluster diameter
    (`evaluate_vbhem_jounarl.m:107-113` uses symmetric KL distances)."""
    dist = np.asarray(dist)
    labels = np.asarray(labels).ravel()
    uniq = np.unique(labels)
    max_diam = 0.0
    for u in uniq:
        idx = np.where(labels == u)[0]
        if len(idx) > 1:
            max_diam = max(max_diam, float(dist[np.ix_(idx, idx)].max()))
    min_inter = np.inf
    for i, u in enumerate(uniq):
        for v in uniq[i + 1:]:
            iu = np.where(labels == u)[0]
            iv = np.where(labels == v)[0]
            min_inter = min(min_inter, float(dist[np.ix_(iu, iv)].min()))
    if max_diam == 0.0:
        return np.inf
    return min_inter / max_diam
