"""GMM fitting that initializes VBEM (and the VBHEM 'random' initializer),
and the mixture-hierarchies EM that initializes VHEM and the VBHEM
'gmmNew' pair: the counterpart of :mod:`vbhem_tpu.ops.gmm`
(``fit_gmm``, ``fit_gmm_split`` and ``mix_hier_em``).

Same convention as MATLAB's ``gmdistribution.fit(..., 'Start',
'randSample')`` (`vbhmm_init.m:59-60`): the start means are K distinct
random data points, every component starts from the pooled data
covariance with uniform weights, and EM runs to a relative
log-likelihood tolerance.

Every function fits many GMMs at once.  Data ``x [*X, M, D]`` carries
leading data axes (subjects); :func:`fit_gmm` adds restart ``lanes`` after
them, each with its own random start.  The EM is one shared core,
:func:`fit_gmm_from_means`, that also takes the start means directly, so
a test can give this package and the JAX package the same start.  The
``lax.while_loop`` becomes a loop with a per-lane ``done`` mask: a lane
that has converged is frozen while the others run.

Randomness comes from an explicit ``torch.Generator``, drawn on the
generator's device; its draws differ from ``jax.random``'s.

The EM to tolerance (:func:`_em_to_tol`) is this module's plain version;
on the card the fits run it as one launch of the CUDA kernel of
``csrc/gmm.cu`` (:func:`.gmm_cuda.em_to_tol_auto`), which takes K up to 8
and D up to 4 (:func:`.gmm_cuda.check_fit`, called before any draw).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from . import gmm_cuda
from .kmeans import inverse_cdf
from ..utils.numeric import (inv_psd, lane_contract, logdet_psd,
                             logsumexp, quad_diff, sym)


class GMM(NamedTuple):
    weight: torch.Tensor  # [..., K]
    mean: torch.Tensor    # [..., K, D]
    cov: torch.Tensor     # [..., K, D, D]


def _log_gauss(x: torch.Tensor, mean: torch.Tensor,
               cov: torch.Tensor) -> torch.Tensor:
    """log N(x | mean, cov): x [..., M, D], mean [..., K, D],
    cov [..., K, D, D] -> [..., M, K]."""
    d = x.shape[-1]
    quad = quad_diff(x[..., :, None, :], mean[..., None, :, :],
                     inv_psd(cov)[..., None, :, :, :])        # [.., M, K]
    logdet = logdet_psd(cov)[..., None, :]
    return -0.5 * (quad + logdet + d * math.log(2 * math.pi))


def _weights(x: torch.Tensor, weights: Optional[torch.Tensor]):
    return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device) \
        if weights is None else weights.to(x.dtype)


def _pooled(x, w_pt, reg):
    """Weighted data covariance [..., D, D] and the relative ridge."""
    d = x.shape[-1]
    w_sum = torch.sum(w_pt, dim=-1)
    xm = torch.sum(w_pt[..., None] * x, dim=-2) / w_sum[..., None]
    xc = x - xm[..., None, :]
    data_cov = torch.matmul((xc * w_pt[..., None]).transpose(-1, -2),
                            xc) / w_sum[..., None, None]
    scale = torch.diagonal(data_cov, dim1=-2, dim2=-1).sum(-1) / d
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    ridge = (reg * scale + 1e-30)[..., None, None] * eye
    return xm, data_cov, ridge


def _e_step(x, w_pt, g: GMM, log_floor: float, active=None):
    """Responsibilities [..., M, K] (weighted by the points' weights) and
    the weighted log-likelihood [...]."""
    lw = torch.log(g.weight + log_floor)
    if active is not None:
        lw = torch.where(active, lw, torch.full_like(lw, -math.inf))
    lp = _log_gauss(x, g.mean, g.cov) + lw[..., None, :]
    norm = logsumexp(lp, dim=-1)
    resp = torch.exp(lp - norm[..., None])
    if active is not None:
        resp = torch.where(active, resp, torch.zeros_like(resp))
    return resp * w_pt[..., None], torch.sum(norm * w_pt, dim=-1)


def _m_step(x, resp, ridge, nx):
    """(counts [..., K], means [..., K, D], covariances [..., K, D, D]);
    ``nx`` counts the data axes of x [*X, 1.., M, D]."""
    d = x.shape[-1]
    nk = torch.sum(resp, dim=-2) + 1e-30
    mean = lane_contract(resp, x, nx) / nk[..., None]
    xx = (x[..., :, None] * x[..., None, :]).flatten(-2)     # [.., M, D*D]
    m2 = lane_contract(resp, xx, nx).unflatten(-1, (d, d)) \
        / nk[..., None, None]
    cov = sym(m2 - mean[..., :, None] * mean[..., None, :]) + \
        ridge[..., None, :, :]
    return nk, mean, cov


def _em_to_tol(x, w_pt, g: GMM, ridge, max_iter: int, tol: float,
               log_floor: float, nx: int) -> GMM:
    """EM from ``g`` on every lane until its relative log-likelihood
    change is at most ``tol`` (after at least two iterations) or it has
    run ``max_iter`` iterations; finished lanes are frozen.  The plain
    version: :func:`em_iterations` also returns each lane's count."""
    return em_iterations(x, w_pt, g, ridge, max_iter, tol, log_floor, nx)[0]


def em_iterations(x, w_pt, g: GMM, ridge, max_iter: int, tol: float,
                  log_floor: float, nx: int):
    """:func:`_em_to_tol` and the iterations each lane ran (int64 [lanes]).

    The EM runs on the data centered at its weighted mean, the means
    shifted with it, which changes no likelihood: a covariance is
    E[x x^T] - mean mean^T, and far from the origin (fixations in pixels)
    that difference loses to float32 rounding what the ridge adds, so a
    component on one or two points turned indefinite and its lane NaN."""
    dtype = x.dtype
    lanes = g.weight.shape[:-1]
    center = torch.sum(w_pt[..., None] * x, dim=-2, keepdim=True) \
        / torch.sum(w_pt, dim=-1)[..., None, None]
    x = x - center
    g = g._replace(mean=g.mean - center)
    big = torch.full(lanes, -torch.finfo(dtype).max, dtype=dtype,
                     device=x.device)
    ll, last = big, big
    it = torch.zeros(lanes, dtype=torch.int64, device=x.device)
    while True:
        denom = torch.where(last == 0, torch.ones_like(last), last)
        not_conv = torch.abs((ll - last) / denom) > tol
        active = (it < max_iter) & ((it < 2) | not_conv)
        if not bool(torch.any(active)):
            return g._replace(mean=g.mean + center), it
        resp, new_ll = _e_step(x, w_pt, g, log_floor)
        nk, mean, cov = _m_step(x, resp, ridge, nx)
        new = GMM(weight=nk / torch.sum(nk, dim=-1, keepdim=True),
                  mean=mean, cov=cov)
        g = GMM(*[torch.where(active.reshape(lanes + (1,) * (a.dim()
                                                            - len(lanes))),
                              a, b) for a, b in zip(new, g)])
        last = torch.where(active, ll, last)
        ll = torch.where(active, new_ll, ll)
        it = it + active.to(it.dtype)


def fit_gmm_from_means(x: torch.Tensor, mean0: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       max_iter: int = 100, tol: float = 1e-5,
                       reg: float = 1e-6) -> GMM:
    """The EM of :func:`fit_gmm` from given start means.

    x [*X, M, D], weights [*X, M] or None, mean0 [*X, *L, K, D]: the data
    axes X lead the start means' axes, and each lane of ``mean0`` fits its
    own GMM to its subject's data.  Returns a GMM with axes [*X, *L]."""
    k, d = mean0.shape[-2:]
    extra = mean0.dim() - 2 - (x.dim() - 2)
    w_pt = _weights(x, weights)
    nx = x.dim() - 2
    x = x.reshape(x.shape[:nx] + (1,) * extra + x.shape[nx:])
    w_pt = w_pt.reshape(w_pt.shape[:nx] + (1,) * extra + w_pt.shape[nx:])
    _, data_cov, ridge = _pooled(x, w_pt, reg)
    lanes = mean0.shape[:-2]
    cov0 = torch.broadcast_to((data_cov + ridge)[..., None, :, :],
                              lanes + (k, d, d))
    weight0 = torch.full(lanes + (k,), 1.0 / k, dtype=x.dtype,
                         device=x.device)
    start = GMM(weight0, mean0.to(x.dtype), cov0)
    return gmm_cuda.em_to_tol_auto(x, w_pt, start, ridge, max_iter, tol, 0.0,
                                   nx)


def fit_gmm(gen: torch.Generator, x: torch.Tensor, k: int,
            weights: Optional[torch.Tensor] = None,
            lanes: Sequence[int] = (), max_iter: int = 100,
            tol: float = 1e-5, reg: float = 1e-6,
            start_weighted: bool = False) -> GMM:
    """EM fit of K-component full-covariance GMMs on x [*X, M, D], one
    per data row and restart lane: the result has axes [*X, *lanes].

    ``weights`` [*X, M] weights each point (0 masks a padded one).  The
    randSample start draws K distinct points per lane, uniformly among the
    points of positive weight (a padded step or an empty trial of a ragged
    bank never seeds a component while K real points exist), or with
    ``start_weighted`` in proportion to ``weights`` (without replacement,
    by Gumbel top-k: a point of weight 0 never seeds a component while
    K points of positive weight exist), as the JAX package's ``fit_gmm``
    draws them for the VBHEM 'random' initializer's per-cluster pools
    (`vbhemhmm_init.m:874-1038`).  ``reg`` is a relative ridge on the
    covariances."""
    lanes = tuple(lanes)
    m, d = x.shape[-2:]
    gmm_cuda.check_fit(x.device, k, d)
    nx = x.dim() - 2
    shape = x.shape[:nx] + lanes + (m,)
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float64).to(x.device)
    if start_weighted:
        w = _weights(x, weights).double()
        w = w.reshape(w.shape[:nx] + (1,) * len(lanes) + (m,))
        u = torch.log(w / torch.sum(w, dim=-1, keepdim=True)) \
            - torch.log(-torch.log(u.clamp_min(1e-300)))
    elif weights is not None:
        # the uniforms of padded points fall below every real point's
        real = weights.reshape(weights.shape[:nx] + (1,) * len(lanes)
                               + (m,)) > 0
        u = torch.where(real, u, -1.0)
    idx = torch.topk(u, k, dim=-1).indices                   # [*X, *L, K]
    xl = x.reshape(x.shape[:nx] + (1,) * len(lanes) + (m, d))
    xl = torch.broadcast_to(xl, x.shape[:nx] + lanes + (m, d))
    mean0 = torch.gather(xl, -2, idx[..., None].expand(idx.shape + (d,)))
    return fit_gmm_from_means(x, mean0, weights, max_iter, tol, reg)


def sample_without_replacement(weights: torch.Tensor,
                               u: torch.Tensor) -> torch.Tensor:
    """K distinct indices per row of weights [*X, M] >= 0 from drawn
    uniforms u [*X, K]: successive draws by inverse CDF in proportion to
    the weights of the indices not yet drawn (uniform over those where
    none of positive weight is left), the distribution of
    ``fit_gmm(start_weighted=True)``'s Gumbel top-k.  [*X, K]."""
    left = weights.double().clone()
    free = torch.ones_like(left)
    out = []
    for t in range(u.shape[-1]):
        p = torch.where(torch.sum(left, -1, keepdim=True) > 0, left, free)
        i = inverse_cdf(p, u[..., t])[..., None]
        left.scatter_(-1, i, 0.0)
        free.scatter_(-1, i, 0.0)
        out.append(i[..., 0])
    return torch.stack(out, dim=-1)


def fit_gmm_split(x: torch.Tensor, k: int,
                  weights: Optional[torch.Tensor] = None,
                  max_iter: int = 100, tol: float = 1e-5,
                  reg: float = 1e-6, em_iters_per_split: int = 15) -> GMM:
    """GMM fit by LBG-style component splitting, the 'split' initmode of
    `vbhmm_init.m:104-111`, over the data axes of x [*X, M, D].

    Start from the single weighted-ML Gaussian; K-1 times, split the live
    component with the largest weight * trace(cov) along its principal
    eigenvector by +-0.5 sqrt(lambda_max), halve its weight and run a few
    masked EM iterations; finish with EM to tolerance.  Deterministic."""
    m, d = x.shape[-2:]
    gmm_cuda.check_fit(x.device, k, d)
    lead = x.shape[:-2]
    dtype, dev = x.dtype, x.device
    w_pt = _weights(x, weights)
    xm, data_cov, ridge = _pooled(x, w_pt, reg)

    mean = torch.zeros(lead + (k, d), dtype=dtype, device=dev)
    mean[..., 0, :] = xm
    cov = torch.broadcast_to((data_cov + ridge)[..., None, :, :],
                             lead + (k, d, d)).clone()
    weight = torch.zeros(lead + (k,), dtype=dtype, device=dev)
    weight[..., 0] = 1.0
    slots = torch.arange(k, device=dev)

    def masked_em(g: GMM, active) -> GMM:
        for _ in range(em_iters_per_split):
            resp, _ = _e_step(x, w_pt, g, 1e-300, active)
            nk, mean, cov = _m_step(x, resp, ridge, len(lead))
            weight = torch.where(active, nk / torch.sum(nk, -1, keepdim=True),
                                 torch.zeros_like(nk))
            # inactive slots stay inert
            g = GMM(weight=weight,
                    mean=torch.where(active[:, None], mean, g.mean),
                    cov=torch.where(active[:, None, None], cov, g.cov))
        return g

    def take(a, j):
        """a[..., j, ...] along the component axis of [*lead, K, ...]."""
        idx = j.reshape(lead + (1,) * (a.dim() - len(lead)))
        idx = idx.expand(lead + (1,) + a.shape[len(lead) + 1:])
        return torch.gather(a, len(lead), idx).squeeze(len(lead))

    g = GMM(weight, mean, cov)
    for n_active in range(1, k):
        active = slots < n_active
        spread = torch.where(
            active, g.weight * torch.diagonal(g.cov, dim1=-2,
                                              dim2=-1).sum(-1),
            torch.full_like(g.weight, -math.inf))
        j = torch.argmax(spread, dim=-1)                      # [*lead]
        evals, evecs = torch.linalg.eigh(take(g.cov, j))
        delta = 0.5 * torch.sqrt(torch.clamp(evals[..., -1], min=1e-30))[
            ..., None] * evecs[..., :, -1]
        wj, mj, cj = take(g.weight, j), take(g.mean, j), take(g.cov, j)
        at_j = (slots == j[..., None])                        # [*lead, K]
        weight = torch.where(at_j, (wj / 2)[..., None], g.weight)
        weight[..., n_active] = wj / 2
        mean = torch.where(at_j[..., None], (mj - delta)[..., None, :],
                           g.mean)
        mean[..., n_active, :] = mj + delta
        cov = g.cov.clone()
        cov[..., n_active, :, :] = cj
        g = masked_em(GMM(weight, mean, cov), slots < n_active + 1)
    return gmm_cuda.em_to_tol_auto(x, w_pt, g, ridge, max_iter, tol, 1e-300,
                                   len(lead))


def mix_hier_em(gen: torch.Generator, mean: torch.Tensor, cov: torch.Tensor,
                prior: torch.Tensor, t: int, nv: float = 100.0,
                max_iter: int = 30, tol: float = 1e-6,
                lanes: Sequence[int] = (),
                seeds: Optional[torch.Tensor] = None):
    """Vasconcelos mixture-hierarchies EM: reduce a pooled bank of P
    Gaussians to a T-component GMM using virtual samples
    (`GMM_MixHierEM.m`: E-step `:113-165`, M-step `:179-199`), for the
    VHEM 'gmmNew', 'gmmNew2' and 'gmm' initializers and the VBHEM
    'gmmNew' pair.

    mean [P, D], cov [P, D, D], prior [P] (masked-out components carry
    prior 0 and are inert), shared by the restart ``lanes``; each lane
    seeds its own weighted kmeans++ start, or starts from the given
    kmeans++ ``seeds`` [*lanes, T, D] (the lanes then are their leading
    axes; a test hands both packages the same seeds).  Returns (GMM with
    axes [*lanes, T], log-posterior lp [*lanes, T, P]).  A lane stops once its
    mean log-likelihood gains at most ``tol`` (after two iterations) or
    after ``max_iter``; finished lanes are frozen."""
    from .kmeans import kmeans
    lanes = tuple(lanes) if seeds is None else tuple(seeds.shape[:-2])
    p, d = mean.shape
    dtype, dev = mean.dtype, mean.device
    prior = prior / torch.sum(prior)
    coef = -0.5 * d * math.log(2.0 * math.pi)
    dpp = nv * prior                                        # [P]

    # init: weighted kmeans++ centers on base means, covariance = mean
    # base covariance, uniform weights (GMM_MixHierEM.m:92-100)
    _, cent = kmeans(gen, mean, t, weights=prior, init_centers=seeds,
                     max_iter=10, lanes=lanes)
    vrnc = torch.einsum("p,pde->de", prior, cov).expand(
        lanes + (t, d, d)).clone()
    mxwt = torch.full(lanes + (t,), 1.0 / t, dtype=dtype, device=dev)

    def e_step(mxwt, cent, vrnc):
        ivr = inv_psd(vrnc)                                 # [*L, T, D, D]
        tr = torch.einsum("...tde,ped->...tp", ivr, cov)
        quad = quad_diff(mean, cent[..., :, None, :],
                         ivr[..., :, None, :, :])           # [*L, T, P]
        xpt = (torch.log(mxwt)[..., None]
               + dpp * (coef - 0.5 * (tr + quad
                                      + logdet_psd(vrnc)[..., None])))
        lse = logsumexp(xpt, dim=-2)                        # [*L, P]
        return xpt - lse[..., None, :], torch.mean(lse, dim=-1)

    def m_step(logpost):
        post = torch.exp(logpost)                           # [*L, T, P]
        mxwt = torch.mean(post, dim=-1) + 1e-30
        wts = post * prior
        wts = wts / (torch.sum(wts, dim=-1, keepdim=True) + 1e-30)
        cent = torch.matmul(wts, mean)                      # [*L, T, D]
        diff = mean - cent[..., :, None, :]                 # [*L, T, P, D]
        vrnc = (torch.einsum("...tp,...tpd,...tpe->...tde", wts, diff, diff)
                + torch.einsum("...tp,pde->...tde", wts, cov))
        return mxwt / torch.sum(mxwt, dim=-1, keepdim=True), cent, sym(vrnc)

    big = torch.full(lanes, -torch.finfo(dtype).max, dtype=dtype, device=dev)
    ll, last = big, big
    it = torch.zeros(lanes, dtype=torch.int64, device=dev)
    while True:
        active = (it < max_iter) & ((it < 2) | (ll - last > tol))
        if not bool(torch.any(active)):
            break
        logpost, new_ll = e_step(mxwt, cent, vrnc)
        new = m_step(logpost)
        mxwt, cent, vrnc = (
            torch.where(active.reshape(lanes + (1,) * (a.dim() - len(lanes))),
                        a, b) for a, b in zip(new, (mxwt, cent, vrnc)))
        last = torch.where(active, ll, last)
        ll = torch.where(active, new_ll, ll)
        it = it + active.to(it.dtype)
    logpost, _ = e_step(mxwt, cent, vrnc)
    return GMM(weight=mxwt, mean=cent, cov=vrnc), logpost
