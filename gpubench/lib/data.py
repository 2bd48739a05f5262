"""The benchmark's own input generators, driven by a configuration file's
numbers and a seed: banks of subject HMMs drawn around a deployment's
group HMMs, and fixation-like sequences sampled from them.  Every draw
is made on the device from one ``torch.Generator`` in a few large calls,
so the same seed gives the same inputs.  The program under test receives
only the tensors made here.
"""
from __future__ import annotations

import torch

MASK64 = (1 << 64) - 1


def derive_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed from ``seed`` and ``salt`` (splitmix64 steps), so
    runs and jobs draw independent streams from one ``--seed``."""
    z = seed & MASK64
    for s in salt:
        z = (z + 0x9E3779B97F4A7C15 * (s + 1)) & MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
        z ^= z >> 31
    return z >> 1


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def groups_tensors(groups, device, dtype):
    """The configuration's group HMMs as stacked tensors (prior [G, S],
    trans [G, S, S], mean [G, S, D], cov [G, S, D, D])."""
    def t(key):
        return torch.tensor([g[key] for g in groups], dtype=dtype,
                            device=device)
    return t("prior"), t("trans"), t("mean"), t("cov")


def group_labels(n: int, n_groups: int, device) -> torch.Tensor:
    """Subjects split into equal consecutive blocks, one per group."""
    return torch.arange(n, device=device) * n_groups // n


def _dirichlet(gen, conc):
    g = torch._standard_gamma(conc, generator=gen)
    return g / torch.sum(g, dim=-1, keepdim=True)


def draw_bank(gen: torch.Generator, groups, n: int, spec: dict, device,
              dtype=torch.float32):
    """``n`` subject HMMs, each a perturbed copy of its group's HMM on a
    random subset of the group's states (``spec['state_counts']`` with
    probabilities ``spec['state_count_p']``), padded to the group's state
    count as a bank pads a shorter HMM: zero prior and transitions, a zero
    mean and identity covariance, masked out.

    The prior and each transition row are Dirichlet draws of
    concentration ``prior_conc`` / ``trans_conc`` times the group's
    (renormalized) probabilities, the means the group's plus
    N(0, mean_sd^2), the covariances L L^T with L = chol(group cov) (I +
    cov_sd G), G standard normal.  Returns (omega [n], prior [n, S],
    trans [n, S, S], mean [n, S, D], cov [n, S, D, D], mask [n, S] bool)."""
    g_prior, g_trans, g_mean, g_cov = groups_tensors(groups, device, dtype)
    n_groups, s, d = g_mean.shape
    labels = group_labels(n, n_groups, device)
    counts = torch.tensor(spec["state_counts"], device=device)
    pick = torch.multinomial(
        torch.tensor(spec["state_count_p"], dtype=torch.float64,
                     device=device), n, replacement=True, generator=gen)
    n_states = counts[pick]                                    # [n]
    # a random subset of n_states of the group's states, in their order
    rank = torch.argsort(torch.argsort(
        torch.rand((n, s), generator=gen, device=device), dim=-1), dim=-1)
    keep = rank < n_states[:, None]
    order = torch.argsort(torch.where(keep, 0, s) * s
                          + torch.arange(s, device=device), dim=-1)
    mask = torch.arange(s, device=device) < n_states[:, None]   # [n, S]
    maskf = mask.to(dtype)
    rows = torch.arange(n, device=device)[:, None]
    prior0 = g_prior[labels][rows, order] * maskf
    trans0 = g_trans[labels][rows[..., None], order[:, :, None],
                             order[:, None, :]]
    trans0 = trans0 * maskf[:, None, :] * maskf[:, :, None]
    mean0 = g_mean[labels][rows, order]
    cov0 = g_cov[labels][rows, order]

    def conc(p, scale):
        p = p / torch.clamp(torch.sum(p, -1, keepdim=True), min=1e-30)
        return torch.where(p > 0, scale * p, torch.ones_like(p))

    prior = _dirichlet(gen, conc(prior0, spec["prior_conc"])) * maskf
    prior = prior / torch.sum(prior, -1, keepdim=True)
    trans = _dirichlet(gen, conc(trans0, spec["trans_conc"]))
    trans = trans * maskf[:, None, :] * maskf[:, :, None]
    trans = trans / torch.clamp(torch.sum(trans, -1, keepdim=True),
                                min=1e-30)
    noise = torch.randn((n, s, d), generator=gen, device=device, dtype=dtype)
    mean = (mean0 + spec["mean_sd"] * noise) * maskf[..., None]
    eye = torch.eye(d, dtype=dtype, device=device)
    gmat = torch.randn((n, s, d, d), generator=gen, device=device,
                       dtype=dtype)
    chol = torch.linalg.cholesky(cov0) @ (eye + spec["cov_sd"] * gmat)
    cov = chol @ chol.transpose(-1, -2)
    cov = torch.where(mask[..., None, None], 0.5 * (cov + cov.transpose(
        -1, -2)), eye)
    omega = torch.full((n,), 1.0 / n, dtype=dtype, device=device)
    return omega, prior, trans, mean, cov, mask


def _categorical(gen, p):
    u = torch.rand(p.shape[:-1] + (1,), generator=gen, device=p.device,
                   dtype=p.dtype)
    cdf = torch.cumsum(p, dim=-1)[..., :-1]
    return torch.sum(u > cdf, dim=-1)


def draw_sequences(gen: torch.Generator, groups, n: int, n_seqs: int,
                   t: int, noise: float, device, dtype=torch.float32):
    """Fixation-like sequences (`exprmt1_sampledata.m:51-87`): ``n``
    subjects in equal blocks per group, each ``n_seqs`` sequences of
    ``t`` steps sampled from its group's HMM, plus N(0, noise^2) on every
    coordinate.  Returns (x [n, n_seqs, t, D], lengths [n, n_seqs])."""
    g_prior, g_trans, g_mean, g_cov = groups_tensors(groups, device,
                                                     torch.float64)
    d = g_mean.shape[-1]
    labels = group_labels(n, len(groups), device)
    lab = labels[:, None].expand(n, n_seqs)
    z = _categorical(gen, g_prior[lab])
    states = [z]
    for _ in range(1, t):
        z = _categorical(gen, g_trans[lab, z])
        states.append(z)
    z = torch.stack(states, dim=-1)                            # [n, N, T]
    lab_t = lab[..., None].expand_as(z)
    chol = torch.linalg.cholesky(g_cov)                        # [G, S, D, D]
    eps = torch.randn(z.shape + (d,), generator=gen, device=device,
                      dtype=torch.float64)
    x = g_mean[lab_t, z] + torch.einsum("...de,...e->...d",
                                        chol[lab_t, z], eps)
    x = x + noise * torch.randn(x.shape, generator=gen, device=device,
                                dtype=torch.float64)
    lengths = torch.full((n, n_seqs), t, dtype=torch.int32, device=device)
    return x.to(dtype), lengths
