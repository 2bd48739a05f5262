"""Weighted k-means with kmeans++ seeding, used by the VHEM initializers
through :func:`..ops.gmm.mix_hier_em`: the counterpart of
``kmeans_pp_init`` and ``kmeans`` in :mod:`vbhem_tpu.ops.kmeans`.

Replaces MATLAB `kmeans(...,'Replicates',1)`: plain Lloyd iterations
with weight-able centroid updates from kmeans++ seeds.  The points
x [M, D] are shared by restart ``lanes``; each lane draws its own seeds,
and the results carry the lane axes first.

Randomness comes from an explicit ``torch.Generator``, drawn on the
generator's device; its draws differ from ``jax.random``'s, so a test
gives both packages the same ``init_centers``.
"""
from __future__ import annotations

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
    """Weighted kmeans++ seeding of every lane: x [M, D] -> [*lanes, K, D]."""
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


def kmeans(gen: torch.Generator, x: torch.Tensor, k: int,
           weights: Optional[torch.Tensor] = None,
           init_centers: Optional[torch.Tensor] = None,
           max_iter: int = 100,
           lanes: Sequence[int] = ()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted Lloyd k-means of x [M, D].  Returns (assignment [*L, M],
    centers [*L, K, D]); the lanes L are ``lanes``, or the leading axes of
    ``init_centers`` [*L, K, D] when it is given.  Runs ``max_iter``
    iterations, as the JAX package's fixed-trip loop does.  Empty
    clusters keep their previous center."""
    w = torch.ones(x.shape[:1], dtype=x.dtype, device=x.device) \
        if weights is None else weights.to(x.dtype)
    c = kmeans_pp_init(gen, x, k, w, lanes) if init_centers is None \
        else init_centers.to(x.dtype)
    for _ in range(max_iter):
        assign = torch.argmin(_sq_dist(x, c), dim=-1)          # [*L, M]
        one_hot = torch.nn.functional.one_hot(assign, k).to(x.dtype) \
            * w[:, None]                                        # [*L, M, K]
        mass = torch.sum(one_hot, dim=-2)                       # [*L, K]
        new_c = torch.matmul(one_hot.transpose(-1, -2), x) \
            / torch.clamp_min(mass, 1e-30)[..., None]
        c = torch.where(mass[..., None] > 0, new_c, c)
    return torch.argmin(_sq_dist(x, c), dim=-1), c
