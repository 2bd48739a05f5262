"""Weighted k-means with kmeans++ seeding, used by the VHEM and VBHEM
initializers: the counterpart of :mod:`vbhem_tpu.ops.kmeans`
(``kmeans_pp_init``, ``kmeans`` and ``weighted_kmeans_energy``).

Replaces MATLAB `kmeans(...,'Replicates',1)`: plain Lloyd iterations
with weight-able centroid updates from kmeans++ seeds; and the
energy-adjusted weighted k-means of `my_weighted_kmeans.m` that the VBHEM
'wtkmeans' initializer runs.  The points x [M, D] are shared by restart
``lanes``; each lane draws its own seeds (and may weigh the points its
own way), and the results carry the lane axes first.

Randomness comes from an explicit ``torch.Generator``, drawn on the
generator's device; its draws differ from ``jax.random``'s, so a test
gives both packages the same ``init_centers``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def _sq_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x [M, D], c [..., K, D] -> [..., M, K] squared distances."""
    return (torch.sum(x * x, -1)[:, None]
            - 2.0 * torch.matmul(x, c.transpose(-1, -2))
            + torch.sum(c * c, -1)[..., None, :])


def _categorical(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of logits [..., M] (Gumbel-max, as
    ``jax.random.categorical``), on the logits' device."""
    u = torch.rand(logits.shape, generator=gen, device=gen.device,
                   dtype=torch.float64).to(logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-300)))
    return torch.argmax(logits.double() + gumbel, dim=-1)


def kmeans_pp_init(gen: torch.Generator, x: torch.Tensor, k: int,
                   weights: Optional[torch.Tensor] = None,
                   lanes: Sequence[int] = ()) -> torch.Tensor:
    """Weighted kmeans++ seeding of every lane: x [M, D] -> [*lanes, K, D].
    ``weights`` is [M], or [*lanes, M] for a weighting per lane."""
    lanes = tuple(lanes)
    m = x.shape[0]
    w = torch.ones((m,), dtype=x.dtype, device=x.device) if weights is None \
        else weights.to(x.dtype)
    d2min = torch.full(lanes + (m,), torch.inf, dtype=x.dtype,
                       device=x.device)
    centers = []
    for t in range(k):
        p = w.expand(lanes + (m,)) if t == 0 else w * d2min
        c = x[_categorical(gen, torch.log(p + 1e-30))]        # [*L, D]
        d2min = torch.minimum(d2min, torch.sum((x - c[..., None, :]) ** 2,
                                               -1))
        centers.append(c)
    return torch.stack(centers, dim=-2)


def inverse_cdf(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One index drawn from each row of weights p [..., M] >= 0 with the
    uniforms u [...]: the first index whose cumulative weight exceeds
    u times the row's total (float64), so an index of weight 0 is never
    drawn while the row has positive weight."""
    cdf = torch.cumsum(p.double(), dim=-1)
    idx = torch.searchsorted(cdf, (u.double() * cdf[..., -1])[..., None],
                             right=True)
    return idx[..., 0].clamp_max(p.shape[-1] - 1)


def kmeans_pp_from_uniforms(x: torch.Tensor, k: int, weights: torch.Tensor,
                            u: torch.Tensor) -> torch.Tensor:
    """Weighted kmeans++ seeding from drawn uniforms u [*L, K], one a
    center, each center drawn by :func:`inverse_cdf` in proportion to
    the weight times the squared distance to the nearest earlier center
    (to the weight alone where every such product is 0): x [M, D] ->
    [*L, K, D].  ``weights`` is [M] or [*L, M].  The draws are only K
    numbers a lane, so they can be made for every lane up front and the
    lanes seeded in any chunks."""
    lanes = tuple(u.shape[:-1])
    m = x.shape[0]
    w = weights.to(x.dtype).expand(lanes + (m,))
    u = u.to(x.device)
    d2min = torch.full(lanes + (m,), torch.inf, dtype=x.dtype,
                       device=x.device)
    centers = []
    for t in range(k):
        p = w
        if t > 0:
            p = w * d2min
            p = torch.where(torch.sum(p, -1, keepdim=True) > 0, p, w)
        c = x[inverse_cdf(p, u[..., t])]                       # [*L, D]
        d2min = torch.minimum(d2min, torch.sum((x - c[..., None, :]) ** 2,
                                               -1))
        centers.append(c)
    return torch.stack(centers, dim=-2)


def kmeans(gen: torch.Generator, x: torch.Tensor, k: int,
           weights: Optional[torch.Tensor] = None,
           init_centers: Optional[torch.Tensor] = None,
           max_iter: int = 100,
           lanes: Sequence[int] = ()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted Lloyd k-means of x [M, D].  Returns (assignment [*L, M],
    centers [*L, K, D]); the lanes L are ``lanes``, or the leading axes of
    ``init_centers`` [*L, K, D] when it is given.  ``weights`` is [M], or
    [*L, M] for a weighting per lane.  Runs ``max_iter`` iterations, as
    the JAX package's fixed-trip loop does.  Empty clusters keep their
    previous center."""
    w = torch.ones(x.shape[:1], dtype=x.dtype, device=x.device) \
        if weights is None else weights.to(x.dtype)
    c = kmeans_pp_init(gen, x, k, w, lanes) if init_centers is None \
        else init_centers.to(x.dtype)
    for _ in range(max_iter):
        assign = torch.argmin(_sq_dist(x, c), dim=-1)          # [*L, M]
        one_hot = torch.nn.functional.one_hot(assign, k).to(x.dtype) \
            * w[..., :, None]                                   # [*L, M, K]
        mass = torch.sum(one_hot, dim=-2)                       # [*L, K]
        new_c = torch.matmul(one_hot.transpose(-1, -2), x) \
            / torch.clamp_min(mass, 1e-30)[..., None]
        c = torch.where(mass[..., None] > 0, new_c, c)
    return torch.argmin(_sq_dist(x, c), dim=-1), c


def weighted_kmeans_energy(x: torch.Tensor, weights: torch.Tensor,
                           init_centers: torch.Tensor, max_iter: int = 100,
                           tol: float = 1e-6
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Energy-adjusted weighted k-means (`my_weighted_kmeans.m`) of x
    [M, D] with point weights [M], from ``init_centers`` [*L, K, D] (the
    lanes L optional).

    Hartigan-style reassignment: a member of cluster j has energy
    ``d2 * w_c / (w_c - w_i)`` (the increase its removal would undo,
    `:95-100`; +inf where w_c - w_i is not positive, a cluster owning all
    its weight through one point), a non-member ``d2 * w_c / (w_c + w_i)``
    (the cost of joining, `:42-44`); points move to the minimum-energy
    cluster until the total energy changes by less than ``tol`` or
    ``max_iter`` moves have run.  Each lane stops on its own and is frozen
    from then on, as under ``jax.vmap`` of the JAX package's
    ``lax.while_loop``.  Empty clusters get a zero center.

    Returns (assignment [*L, M], centers [*L, K, D])."""
    k = init_centers.shape[-2]
    dtype = x.dtype
    w = weights.to(dtype)
    inf = torch.tensor(math.inf, dtype=dtype, device=x.device)

    def centroids(assign):
        one_hot = torch.nn.functional.one_hot(assign, k).to(dtype) \
            * w[:, None]                                        # [*L, M, K]
        w_c = torch.sum(one_hot, dim=-2)                        # [*L, K]
        cen = torch.matmul(one_hot.transpose(-1, -2), x) \
            / torch.clamp_min(w_c, 1e-30)[..., None]
        return cen, w_c

    def energies(assign, cen, w_c):
        d2 = _sq_dist(x, cen)                                   # [*L, M, K]
        member = torch.nn.functional.one_hot(assign, k).bool()
        wc = w_c[..., None, :]
        denom_in = wc - w[:, None]
        f_in = torch.where(denom_in > 0, d2 * wc / denom_in, inf)
        f_out = d2 * wc / (wc + w[:, None])
        fmat = torch.where(member, f_in, f_out)
        own = torch.gather(fmat, -1, assign[..., None])[..., 0]
        total = torch.sum(torch.where(torch.isfinite(own), w * own,
                                      torch.zeros_like(own)), dim=-1)
        return fmat, total

    assign = torch.argmin(_sq_dist(x, init_centers.to(dtype)), dim=-1)
    cen, w_c = centroids(assign)
    _, new_e = energies(assign, cen, w_c)
    old_e = new_e + 2 * tol + 1.0
    it = torch.zeros(new_e.shape, dtype=torch.int64, device=x.device)
    while True:
        active = (it < max_iter) & (torch.abs(new_e - old_e) >= tol)
        if not bool(torch.any(active)):
            return assign, cen
        fmat, _ = energies(assign, cen, w_c)
        nxt = torch.argmin(fmat, dim=-1)
        n_cen, n_wc = centroids(nxt)
        _, e = energies(nxt, n_cen, n_wc)
        assign = torch.where(active[..., None], nxt, assign)
        cen = torch.where(active[..., None, None], n_cen, cen)
        w_c = torch.where(active[..., None], n_wc, w_c)
        old_e = torch.where(active, new_e, old_e)
        new_e = torch.where(active, e, new_e)
        it = it + active.to(it.dtype)
