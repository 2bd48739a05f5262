"""The starts of the restarts, restated from the toolbox and computed
from the same uniforms as the program under test draws them, so that the
reference can rerun a restart from where the program's began.

The draws follow the program's documented protocol: its entry points take
one ``torch.Generator`` and draw, on the generator's device and in this
order,

* VBHEM 'baseem' (`vbhemhmm_init.m:58-100`), every lane of the padded
  (K, S) grid at once: the base HMM of each reduced state (integers in
  [0, Kb), [n, Kr, Sr]), a uniform that picks its state (float64,
  [n, Kr, Sr]) and the uniforms of the cluster weights (the bank's dtype,
  [n, Kr]);
* VBHEM 'wtkmeans' (`vbhemhmm_init.m:294-425`): the kmeans++ uniforms of
  the Kr cluster seeds [n, Kr], of the global Sr centers [n, Sr] and of
  each cluster's [n, Kr, Sr] (float64), then the uniforms of the random
  priors [n, Kr, Sr] and transitions [n, Kr, Sr, Sr] (the bank's dtype);
* VBEM 'random' (`vbhmm_init.m:25-91`): one float64 uniform per subject,
  restart and pooled observation [S, L, N*T]; the K largest pick the
  randSample start means of that restart's GMM.

A restart's start is a function of the bank (or data) and these numbers
alone.  Plain PyTorch, in the dtype of the inputs; it imports nothing of
the program under test.
"""
from __future__ import annotations

import math

import torch

from . import vbem as rvbem
from . import vbhem as rvbhem
from .numeric import inv_psd, logdet_psd, logsumexp, sym

F64 = torch.float64


def _rand(gen, shape, dtype):
    return torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)


# --------------------------------------------------------------------------
# VBHEM
# --------------------------------------------------------------------------

def baseem_draws(gen, kb: int, n: int, kr: int, sr: int, dtype) -> dict:
    shp = (n, kr, sr)
    return {"rand_b": torch.randint(0, kb, shp, generator=gen,
                                    device=gen.device),
            "u_state": _rand(gen, shp, F64),
            "u_omega": _rand(gen, (n, kr), dtype)}


def baseem(bank: rvbhem.Bank, mask, hyps: rvbhem.Hyps, nv: int, kr: int,
           sr: int, rand_b, u_state, u_omega) -> rvbhem.Post:
    """Each reduced state's emission copies a random valid state of a
    random base HMM; uniform dynamics; random cluster weights."""
    dtype, dev = bank.mean.dtype, bank.mean.device
    kb, sb = mask.shape
    d = bank.mean.shape[-1]
    rand_b = rand_b.to(dev)
    nv_total = nv * kb
    nlr = nv_total / kr
    n_states = torch.sum(mask, -1)
    rand_g = torch.floor(u_state.to(dev).to(F64) * n_states[rand_b]).long()
    rand_g = torch.clamp(rand_g, max=sb - 1)
    shp = tuple(rand_b.shape)
    v = torch.full(shp, hyps.v0 + nlr / sr + 1.0, dtype=dtype, device=dev)
    lam = torch.full(shp, hyps.lambda0 + nlr / sr, dtype=dtype, device=dev)
    w = inv_psd((v - d - 1.0)[..., None, None] * bank.cov[rand_b, rand_g])
    eta = torch.full(shp, nlr / sr + hyps.eta0, dtype=dtype, device=dev)
    eps = torch.full(shp + (sr,), nlr / sr / sr + hyps.epsilon0,
                     dtype=dtype, device=dev)
    omega = u_omega.to(dev).to(dtype)
    omega = omega / torch.sum(omega, -1, keepdim=True)
    return rvbhem.Post(alpha=hyps.alpha0 + omega * nv_total, eta=eta,
                       epsilon=eps, beta=lam, v=v,
                       m=bank.mean[rand_b, rand_g], w=w)


def wtkmeans_draws(gen, n: int, kr: int, sr: int, dtype) -> dict:
    return {"u_assign": _rand(gen, (n, kr), F64),
            "u_global": _rand(gen, (n, sr), F64),
            "u_cluster": _rand(gen, (n, kr, sr), F64),
            "u_prior": _rand(gen, (n, kr, sr), dtype),
            "u_trans": _rand(gen, (n, kr, sr, sr), dtype)}


def _inverse_cdf(p, u):
    """The first index whose cumulative weight exceeds u times the total."""
    cdf = torch.cumsum(p.to(F64), -1)
    idx = torch.searchsorted(cdf, (u.to(F64) * cdf[..., -1])[..., None],
                             right=True)
    return idx[..., 0].clamp_max(p.shape[-1] - 1)


def _d2(x, c):
    """x [M, D], c [..., K, D] -> squared distances [..., M, K]."""
    return torch.sum((x[:, None, :] - c[..., None, :, :]) ** 2, -1)


def kmeans_pp(x, k: int, weights, u):
    """Weighted kmeans++ seeds from uniforms u [*L, K]: each center drawn
    in proportion to its weight times the squared distance to the nearest
    earlier center (the weight alone where all those are 0)."""
    lanes = tuple(u.shape[:-1])
    m = x.shape[0]
    w = weights.to(x.dtype).expand(lanes + (m,))
    d2min = torch.full(lanes + (m,), math.inf, dtype=x.dtype,
                       device=x.device)
    centers = []
    for t in range(k):
        p = w
        if t > 0:
            p = w * d2min
            p = torch.where(torch.sum(p, -1, keepdim=True) > 0, p, w)
        c = x[_inverse_cdf(p, u[..., t].to(x.device))]
        d2min = torch.minimum(d2min, torch.sum((x - c[..., None, :]) ** 2,
                                               -1))
        centers.append(c)
    return torch.stack(centers, -2)


def kmeans(x, k: int, weights, centers, n_iter: int = 100):
    """``n_iter`` weighted Lloyd iterations from ``centers`` [*L, K, D]
    (an empty cluster keeps its center): (assignment, centers)."""
    for _ in range(n_iter):
        one_hot = torch.nn.functional.one_hot(
            torch.argmin(_d2(x, centers), -1), k).to(x.dtype) \
            * weights[..., :, None]
        mass = torch.sum(one_hot, -2)
        new = torch.matmul(one_hot.transpose(-1, -2), x) \
            / torch.clamp_min(mass, 1e-30)[..., None]
        centers = torch.where(mass[..., None] > 0, new, centers)
    return torch.argmin(_d2(x, centers), -1), centers


def weighted_kmeans(x, w, centers, max_iter: int = 100, tol: float = 1e-6):
    """The energy-adjusted weighted k-means of `my_weighted_kmeans.m`: a
    member of cluster c costs d2 w_c / (w_c - w_i), a non-member d2 w_c /
    (w_c + w_i); every point moves to its cheapest cluster until the total
    energy changes by less than ``tol``.  Returns the assignment."""
    k = centers.shape[-2]
    inf = torch.tensor(math.inf, dtype=x.dtype, device=x.device)

    def centroids(assign):
        one_hot = torch.nn.functional.one_hot(assign, k).to(x.dtype) \
            * w[:, None]
        w_c = torch.sum(one_hot, -2)
        return (torch.matmul(one_hot.transpose(-1, -2), x)
                / torch.clamp_min(w_c, 1e-30)[..., None]), w_c

    def energies(assign, cen, w_c):
        d2 = _d2(x, cen)
        member = torch.nn.functional.one_hot(assign, k).bool()
        wc = w_c[..., None, :]
        den = wc - w[:, None]
        f = torch.where(member, torch.where(den > 0, d2 * wc / den, inf),
                        d2 * wc / (wc + w[:, None]))
        own = torch.gather(f, -1, assign[..., None])[..., 0]
        return f, torch.sum(torch.where(torch.isfinite(own), w * own,
                                        torch.zeros_like(own)), -1)

    assign = torch.argmin(_d2(x, centers), -1)
    cen, w_c = centroids(assign)
    _, new_e = energies(assign, cen, w_c)
    old_e = new_e + 2 * tol + 1.0
    it = torch.zeros(new_e.shape, dtype=torch.int64, device=x.device)
    while True:
        active = (it < max_iter) & (torch.abs(new_e - old_e) >= tol)
        if not bool(torch.any(active)):
            return assign
        f, _ = energies(assign, cen, w_c)
        nxt = torch.argmin(f, -1)
        n_cen, n_wc = centroids(nxt)
        _, e = energies(nxt, n_cen, n_wc)
        assign = torch.where(active[..., None], nxt, assign)
        cen = torch.where(active[..., None, None], n_cen, cen)
        w_c = torch.where(active[..., None], n_wc, w_c)
        old_e = torch.where(active, new_e, old_e)
        new_e = torch.where(active, e, new_e)
        it = it + active.long()


def wtkmeans(bank: rvbhem.Bank, mask, hyps: rvbhem.Hyps, nv: int, kr: int,
             sr: int, u_assign, u_global, u_cluster, u_prior,
             u_trans) -> rvbhem.Post:
    """Weighted k-means of the bank's state means into Kr clusters under
    the long-run state weights (seeded by plain k-means from kmeans++),
    k-means of each cluster's states into Sr centers (a cluster with no
    state takes the global k-means' centers), every W from the first base
    state's covariance; random dynamics."""
    dtype, dev = bank.mean.dtype, bank.mean.device
    kb, sb = mask.shape
    d = bank.mean.shape[-1]
    x = bank.mean.reshape(kb * sb, d)
    valid = mask.reshape(-1).to(dtype)
    p = bank.prior
    for _ in range(50):
        p = torch.einsum("ib,ibc->ic", p, bank.trans)
    lr = (p * mask).reshape(-1)
    lr = lr / torch.sum(lr)
    _, c0 = kmeans(x, kr, valid, kmeans_pp(x, kr, valid, u_assign))
    assign = weighted_kmeans(x, lr, c0)                       # [*L, M]
    member = (assign[..., None, :] == torch.arange(kr, device=dev)[:, None])
    wts = member.to(dtype) * valid
    has = torch.sum(wts, -1) > 0                              # [*L, Kr]
    wts = torch.where(has[..., None], wts, valid)
    _, glob = kmeans(x, sr, valid, kmeans_pp(x, sr, valid, u_global))
    _, cen = kmeans(x, sr, wts, kmeans_pp(x, sr, wts, u_cluster))
    cen = torch.where(has[..., None, None], cen, glob[..., None, :, :])
    shp = tuple(cen.shape[:-1])
    nj = nv * kb / kr
    v = torch.full(shp, hyps.v0 + nj / sr + 1.0, dtype=dtype, device=dev)
    lam = torch.full(shp, hyps.lambda0 + nj / sr, dtype=dtype, device=dev)
    w = inv_psd((v - d - 1.0)[..., None, None] * bank.cov.reshape(
        kb * sb, d, d)[0])
    u_prior, u_trans = u_prior.to(dev).to(dtype), u_trans.to(dev).to(dtype)
    prior = u_prior / torch.sum(u_prior, -1, keepdim=True)
    trans = u_trans / torch.sum(u_trans, -1, keepdim=True)
    return rvbhem.Post(alpha=torch.full(shp[:-1], hyps.alpha0 + nj,
                                        dtype=dtype, device=dev),
                       eta=prior * nj + hyps.eta0,
                       epsilon=trans * nj + hyps.epsilon0, beta=lam, v=v,
                       m=cen, w=w)


VBHEM_STARTS = {"baseem": (baseem_draws, baseem),
                "wtkmeans": (wtkmeans_draws, wtkmeans)}


def vbhem_starts(mode: str, gen, bank: rvbhem.Bank, mask,
                 hyps: rvbhem.Hyps, nv: int, kr: int, sr: int, n: int,
                 lanes: slice, draw_dtype) -> rvbhem.Post:
    """The starts of lanes ``lanes`` of the ``n`` the program draws for
    the padded (Kr, Sr) grid in ``mode``, in the bank's dtype."""
    draw, start = VBHEM_STARTS[mode]
    kb = mask.shape[0]
    draws = draw(gen, kb, n, kr, sr, draw_dtype) if mode == "baseem" \
        else draw(gen, n, kr, sr, draw_dtype)
    return start(bank, mask, hyps, nv, kr, sr,
                 **{k: v[lanes] for k, v in draws.items()})


def slice_post(post: rvbhem.Post, k: int, s: int) -> rvbhem.Post:
    """A padded start confined to its cell's first K clusters and S
    states, as the program's cluster and state masks confine it."""
    return rvbhem.Post(post.alpha[..., :k], post.eta[..., :k, :s],
                       post.epsilon[..., :k, :s, :s], post.beta[..., :k, :s],
                       post.v[..., :k, :s], post.m[..., :k, :s, :],
                       post.w[..., :k, :s, :, :])


# --------------------------------------------------------------------------
# VBEM
# --------------------------------------------------------------------------

def gmm_draws(gen, subjects: int, restarts: int, points: int):
    return _rand(gen, (subjects, restarts, points), F64)


def _log_gauss(x, mean, cov):
    """x [B, 1, M, D], mean [B, L, K, D], cov [B, L, K, D, D] ->
    [B, L, M, K]."""
    d = x.shape[-1]
    diff = x[..., :, None, :] - mean[..., None, :, :]
    quad = torch.einsum("...mkd,...kde,...mke->...mk", diff, inv_psd(cov),
                        diff)
    return -0.5 * (quad + logdet_psd(cov)[..., None, :]
                   + d * math.log(2.0 * math.pi))


def gmm(x, w_pt, u, k: int, max_iter: int = 100, tol: float = 1e-5,
        reg: float = 1e-6):
    """`gmdistribution.fit(..., 'Start', 'randSample')` per subject and
    restart: x [B, M, D] pooled observations, w_pt [B, M] their weights,
    u [B, L, M] the restarts' uniforms (the K largest pick the start
    means).  Every component starts from the pooled data covariance plus
    a relative ridge and weight 1/K; EM until the relative log-likelihood
    change is at most ``tol`` after two iterations.  (weight [B, L, K],
    mean [B, L, K, D], cov [B, L, K, D, D])."""
    dtype = x.dtype
    d = x.shape[-1]
    idx = torch.topk(u.to(x.device), k, dim=-1).indices      # [B, L, K]
    mean = torch.gather(x[:, None].expand(-1, u.shape[1], -1, -1), -2,
                        idx[..., None].expand(idx.shape + (d,)))
    ws = torch.sum(w_pt, -1)
    xm = torch.sum(w_pt[..., None] * x, -2) / ws[..., None]
    xc = x - xm[..., None, :]
    data_cov = torch.matmul((xc * w_pt[..., None]).transpose(-1, -2), xc) \
        / ws[..., None, None]
    scale = torch.diagonal(data_cov, dim1=-2, dim2=-1).sum(-1) / d
    ridge = (reg * scale + 1e-30)[..., None, None] \
        * torch.eye(d, dtype=dtype, device=x.device)           # [B, D, D]
    ridge = ridge[:, None, None]
    cov = (data_cov[:, None, None] + ridge).expand(mean.shape + (d,))
    weight = torch.full(mean.shape[:-1], 1.0 / k, dtype=dtype,
                        device=x.device)
    xb, wb = x[:, None], w_pt[:, None]
    lanes = weight.shape[:-1]
    ll = torch.full(lanes, -torch.finfo(dtype).max, dtype=dtype,
                    device=x.device)
    last = ll.clone()
    it = torch.zeros(lanes, dtype=torch.int64, device=x.device)
    while True:
        denom = torch.where(last == 0, torch.ones_like(last), last)
        active = (it < max_iter) & ((it < 2) | (torch.abs(
            (ll - last) / denom) > tol))
        if not bool(torch.any(active)):
            return weight, mean, cov
        lp = _log_gauss(xb, mean, cov) + torch.log(weight)[..., None, :]
        norm = logsumexp(lp, -1)
        resp = torch.exp(lp - norm[..., None]) * wb[..., None]
        new_ll = torch.sum(norm * wb, -1)
        nk = torch.sum(resp, -2) + 1e-30
        n_mean = torch.einsum("...mk,...md->...kd", resp, x[:, None]) \
            / nk[..., None]
        m2 = torch.einsum("...mk,...md,...me->...kde", resp, x[:, None],
                          x[:, None]) / nk[..., None, None]
        n_cov = sym(m2 - n_mean[..., :, None] * n_mean[..., None, :]) + ridge
        a = active[..., None]
        weight = torch.where(a, nk / torch.sum(nk, -1, keepdim=True), weight)
        mean = torch.where(a[..., None], n_mean, mean)
        cov = torch.where(a[..., None, None], n_cov, cov)
        last = torch.where(active, ll, last)
        ll = torch.where(active, new_ll, ll)
        it = it + active.long()


def vbem_start(weight, mean, cov, n_total, hyps: rvbem.Hyps) -> rvbem.Post:
    """A GMM fit -> the initial variational posterior
    (`vbhmm_init.m:163-199`); ``n_total`` the observations of each lane."""
    dtype, dev = mean.dtype, mean.device
    k = mean.shape[-2]
    m0 = torch.as_tensor(hyps.m0, dtype=dtype, device=dev)
    w0inv = torch.diag(1.0 / torch.as_tensor(hyps.w0, dtype=dtype,
                                             device=dev))
    n_total = n_total.to(dtype)[..., None]
    nk = n_total * weight
    nk2 = (n_total / k).expand(weight.shape)
    beta = hyps.beta0 + nk
    mult1 = hyps.beta0 * nk / (hyps.beta0 + nk)
    diff = mean - m0
    winv = (w0inv + nk[..., None, None] * cov
            + mult1[..., None, None] * diff[..., :, None] * diff[..., None, :])
    return rvbem.Post(alpha=hyps.alpha0 + nk2,
                      epsilon=hyps.epsilon0 + nk2[..., None, :].expand(
                          weight.shape + (k,)),
                      beta=beta, v=hyps.v0 + nk + 1.0,
                      m=(hyps.beta0 * m0 + nk[..., None] * mean)
                      / beta[..., None], w=inv_psd(winv))
