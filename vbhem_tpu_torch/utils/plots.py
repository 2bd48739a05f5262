"""Visualization: the counterpart of :mod:`vbhem_tpu.utils.plots` (the
reference's `src/plots/` + `vbhmm_plot*`, `vhem_plot*`, as matplotlib
figures), on this package's results.

Parity map: `plot_emissions.m` (2-std ROI ellipses over an optional
image), `plot_transprob.m` / `plot_prior.m` (heat-matrix and bar plots),
`plot_fixations.m` (scatter colored by Viterbi state),
`vbhmm_plot_compact.m` (one panel per HMM), `vhem_plot.m` (grid of
cluster-center HMMs).  Pure presentation: tensors move to the CPU for
drawing, and matplotlib is imported inside the functions that make a
figure, so the package imports where matplotlib is not installed (the
axes-level functions take the caller's matplotlib axes).
"""
from __future__ import annotations

import numpy as np
import torch


def _np(a) -> np.ndarray:
    """A tensor (on any device) or array as a NumPy array on the host."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


COLORS = ["tab:red", "tab:green", "tab:blue", "tab:orange", "tab:purple",
          "tab:cyan", "tab:olive", "tab:pink", "tab:brown", "tab:gray"]


def _state_colors(k):
    """Per-state color list (`get_color_list.m`)."""
    return [COLORS[i % len(COLORS)] for i in range(k)]


def _ellipse_points(mean, cov, n_std=2.0, n=100):
    t = np.linspace(0, 2 * np.pi, n)
    circ = np.stack([np.cos(t), np.sin(t)])
    vals, vecs = np.linalg.eigh(cov[:2, :2])
    vals = np.maximum(vals, 0)
    pts = vecs @ (np.sqrt(vals)[:, None] * circ) * n_std
    return mean[0] + pts[0], mean[1] + pts[1]


def plot_emissions(ax, hmm, image=None, n_std: float = 2.0,
                   labels: bool = True):
    """ROI ellipses at n_std standard deviations (`plot_emissions.m`)."""
    if image is not None:
        ax.imshow(image)
    mean = _np(hmm.mean)
    cov = _np(hmm.cov)
    for k in range(mean.shape[0]):
        xs, ys = _ellipse_points(mean[k], cov[k], n_std)
        c = COLORS[k % len(COLORS)]
        ax.plot(xs, ys, color=c, lw=2)
        ax.plot(mean[k, 0], mean[k, 1], "o", color=c)
        if labels:
            ax.annotate(str(k + 1), (mean[k, 0], mean[k, 1]),
                        color=c, fontweight="bold")
    ax.set_aspect("equal", adjustable="datalim")
    return ax


def plot_transprob(ax, trans, cmap="Blues"):
    """Transition-matrix heat map (`plot_transprob.m`)."""
    trans = _np(trans)
    im = ax.imshow(trans, cmap=cmap, vmin=0, vmax=1)
    k = trans.shape[0]
    for i in range(k):
        for j in range(k):
            ax.text(j, i, f"{trans[i, j]:.2f}", ha="center", va="center",
                    color="black" if trans[i, j] < 0.6 else "white")
    ax.set_xlabel("to")
    ax.set_ylabel("from")
    ax.set_xticks(range(k), [str(i + 1) for i in range(k)])
    ax.set_yticks(range(k), [str(i + 1) for i in range(k)])
    return im


def plot_prior(ax, prior):
    """Initial-state bar plot (`plot_prior.m`)."""
    prior = _np(prior)
    k = prior.shape[0]
    ax.bar(range(k), prior,
           color=[COLORS[i % len(COLORS)] for i in range(k)])
    ax.set_xticks(range(k), [str(i + 1) for i in range(k)])
    ax.set_ylim(0, 1)
    ax.set_ylabel("prior")
    return ax


def plot_fixations(ax, batch, hmm, image=None):
    """Fixation scatter colored by Viterbi state (`plot_fixations.m` +
    `vbhmm_map_state` coloring)."""
    from ..models.hmm_tools import viterbi
    if image is not None:
        ax.imshow(image)
    paths, _ = viterbi(batch, hmm)      # on the data's device
    x = _np(batch.x)
    mask = _np(batch.mask)
    p = _np(paths)
    for k in range(hmm.num_states):
        sel = (p == k) & mask
        ax.scatter(x[..., 0][sel], x[..., 1][sel], s=8,
                   color=COLORS[k % len(COLORS)], alpha=0.6)
    return ax


def plot_vbhmm(res, batch=None, image=None, title: str = ""):
    """One-figure summary of a learned HMM (`vbhmm_plot_compact.m`):
    emissions + prior + transitions (+ fixations if data given)."""
    import matplotlib.pyplot as plt
    ncols = 3 + (batch is not None)
    fig, axes = plt.subplots(1, ncols, figsize=(4 * ncols, 3.6))
    plot_emissions(axes[0], res.model, image)
    axes[0].set_title(f"emissions {title}")
    plot_prior(axes[1], res.model.prior)
    plot_transprob(axes[2], res.model.trans)
    if batch is not None:
        plot_fixations(axes[3], batch, res.model, image)
        axes[3].set_title("fixations (Viterbi)")
    fig.tight_layout()
    return fig


def plot_vbhem_clusters(res, image=None):
    """Grid of cluster-center HMMs with member counts (`vhem_plot.m` /
    `vhem_plot_clusters.m`)."""
    import matplotlib.pyplot as plt
    from ..containers import HMM
    h3m = res.h3m
    kr = h3m.omega.shape[-1]
    fig, axes = plt.subplots(2, kr, figsize=(4 * kr, 7.2), squeeze=False)
    groups = res.groups
    for j in range(kr):
        hmm_j = HMM(prior=h3m.hmm.prior[j], trans=h3m.hmm.trans[j],
                    mean=h3m.hmm.mean[j], cov=h3m.hmm.cov[j])
        plot_emissions(axes[0][j], hmm_j, image)
        axes[0][j].set_title(
            f"cluster {j + 1} (n={len(groups[j])}, "
            f"w={float(h3m.omega[j]):.2f})")
        plot_transprob(axes[1][j], hmm_j.trans)
    fig.tight_layout()
    return fig


def plot_model_selection(ax, ll_grid, k_values, s_values=None):
    """ELBO model-selection curve/heatmap (`vbdemo_face.m:71-78`)."""
    ll_grid = _np(ll_grid)
    if ll_grid.ndim == 1 or (s_values is None or len(s_values) == 1):
        ax.plot(k_values, ll_grid.ravel(), "o-")
        ax.set_xlabel("K")
        ax.set_ylabel("corrected ELBO")
    else:
        im = ax.imshow(ll_grid, aspect="auto", origin="lower")
        ax.set_xticks(range(len(s_values)), [str(s) for s in s_values])
        ax.set_yticks(range(len(k_values)), [str(k) for k in k_values])
        ax.set_xlabel("S")
        ax.set_ylabel("K")
        return im
    return ax


def plot_emissions_dur(ax, hmm, n_std: float = 2.0):
    """Duration-axis emission plot for 3-D (x, y, duration) models
    (`src/plots/plot_emissions_dur.m`): per-state duration mean +/-
    n_std as horizontal bars."""
    mean = _np(hmm.mean)
    cov = _np(hmm.cov)
    if mean.shape[-1] < 3:
        raise ValueError("plot_emissions_dur needs 3-D emissions "
                         "(x, y, duration)")
    k = mean.shape[0]
    colors = _state_colors(k)
    for j in range(k):
        mu = mean[j, 2]
        sd = np.sqrt(cov[j, 2, 2])
        ax.barh(j, 2 * n_std * sd, left=mu - n_std * sd, height=0.6,
                color=colors[j], alpha=0.5, edgecolor=colors[j])
        ax.plot([mu], [j], marker="|", color="k", markersize=14)
    ax.set_yticks(range(k))
    ax.set_yticklabels([f"S{j + 1}" for j in range(k)])
    ax.set_xlabel("fixation duration")


def plot_transcount(ax, trans_counts, cmap="Greens"):
    """Transition-count heat matrix (`src/plots/plot_transcount.m`)."""
    m = _np(trans_counts)
    im = ax.imshow(m, cmap=cmap)
    k = m.shape[0]
    for i in range(k):
        for j in range(k):
            ax.text(j, i, f"{m[i, j]:.1f}", ha="center", va="center",
                    fontsize=8)
    ax.set_xticks(range(k)); ax.set_yticks(range(k))
    ax.set_xlabel("to state"); ax.set_ylabel("from state")
    ax.set_title("transition counts")
    return im


def plot_emcounts(ax, counts):
    """Per-state emission-count bar plot (`src/plots/plot_emcounts.m`)."""
    c = _np(counts)
    k = c.shape[0]
    ax.bar(range(k), c, color=_state_colors(k))
    ax.set_xticks(range(k))
    ax.set_xticklabels([f"S{j + 1}" for j in range(k)])
    ax.set_ylabel("soft count N")
    ax.set_title("emission counts")


def plot_ccfd_decision(ax, rho, delta, center_idx=None):
    """CCFD decision graph — rho vs delta with the auto-selected centers
    highlighted (`src/compare_mtds/ccfd/CCFD_plot.m`)."""
    rho, delta = _np(rho), _np(delta)
    ax.scatter(rho, delta, s=18, color="tab:gray")
    if center_idx is not None:
        ci = _np(center_idx)
        ax.scatter(rho[ci], delta[ci], s=60, color="tab:red", marker="*",
                   label="centers")
        ax.legend(loc="best", fontsize=8)
    ax.set_xlabel(r"density $\rho$")
    ax.set_ylabel(r"distance $\delta$")
    ax.set_title("CCFD decision graph")
