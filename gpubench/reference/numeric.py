"""Numerical helpers of the plain reference: digamma and lgamma
expectations, Wishart normalizers and closed-form 2x2 / 3x3 algebra.

Every function computes in the dtype of its inputs, so the same code runs
the reference in float64 and its lower-precision control in float32 or
bfloat16.  Plain PyTorch; it imports nothing of the program under test.
"""
from __future__ import annotations

import math

import torch


def tiny(dtype) -> float:
    """Smallest positive normal of ``dtype``: the toolbox's +1e-50 mass
    floors, which underflow below float64."""
    return torch.finfo(dtype).tiny


def logsumexp(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """log-sum-exp over ``dim``; an all -inf slice gives -inf."""
    amax = torch.amax(a, dim=dim, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    return (torch.log(torch.sum(torch.exp(a - amax), dim=dim, keepdim=True))
            + amax).squeeze(dim)


def sym(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * (a + a.transpose(-1, -2))


def _entries(a: torch.Tensor):
    s = sym(a)
    return s, s.shape[-1]


def det_psd(a: torch.Tensor) -> torch.Tensor:
    """Determinant of symmetric [..., D, D], D <= 3, by cofactors."""
    s, d = _entries(a)
    if d == 1:
        return s[..., 0, 0]
    if d == 2:
        return s[..., 0, 0] * s[..., 1, 1] - s[..., 0, 1] ** 2
    if d == 3:
        return (s[..., 0, 0] * (s[..., 1, 1] * s[..., 2, 2] - s[..., 1, 2] ** 2)
                - s[..., 0, 1] * (s[..., 0, 1] * s[..., 2, 2]
                                  - s[..., 1, 2] * s[..., 0, 2])
                + s[..., 0, 2] * (s[..., 0, 1] * s[..., 1, 2]
                                  - s[..., 1, 1] * s[..., 0, 2]))
    raise ValueError(f"D={d}: the reference handles D <= 3")


def inv_psd(a: torch.Tensor) -> torch.Tensor:
    """Inverse of symmetric positive-definite [..., D, D], D <= 3, as the
    adjugate over the determinant."""
    s, d = _entries(a)
    if d == 1:
        return 1.0 / s
    if d == 2:
        adj = torch.stack([torch.stack([s[..., 1, 1], -s[..., 0, 1]], -1),
                           torch.stack([-s[..., 0, 1], s[..., 0, 0]], -1)],
                          -2)
        return adj / det_psd(s)[..., None, None]
    if d == 3:
        cof = torch.empty_like(s)
        for i in range(3):
            for j in range(3):
                r = [x for x in range(3) if x != i]
                c = [x for x in range(3) if x != j]
                minor = (s[..., r[0], c[0]] * s[..., r[1], c[1]]
                         - s[..., r[0], c[1]] * s[..., r[1], c[0]])
                cof[..., j, i] = (-1) ** (i + j) * minor
        return cof / det_psd(s)[..., None, None]
    raise ValueError(f"D={d}: the reference handles D <= 3")


def logdet_psd(a: torch.Tensor) -> torch.Tensor:
    return torch.log(det_psd(a))


def e_log_dirichlet(conc: torch.Tensor) -> torch.Tensor:
    """E[log pi] under Dir(conc) over the last axis."""
    return (torch.special.digamma(conc)
            - torch.special.digamma(torch.sum(conc, dim=-1, keepdim=True)))


def log_dirichlet_const(conc: torch.Tensor) -> torch.Tensor:
    return (torch.lgamma(torch.sum(conc, dim=-1))
            - torch.sum(torch.lgamma(conc), dim=-1))


def e_log_det_lambda(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """E[log |Lambda|] for Lambda ~ Wishart(W, v), Bishop (10.65)."""
    d = w.shape[-1]
    i = torch.arange(1, d + 1, dtype=v.dtype, device=v.device)
    return (torch.sum(torch.special.digamma(0.5 * (v[..., None] + 1.0 - i)),
                      dim=-1) + d * math.log(2.0) + logdet_psd(w))


def log_wishart_b(logdet_winv: torch.Tensor, v: torch.Tensor,
                  d: int) -> torch.Tensor:
    """log B(W, v) of a Wishart from log det(W^-1)."""
    i = torch.arange(1, d + 1, dtype=v.dtype, device=v.device)
    return (0.5 * v * logdet_winv - 0.5 * v * d * math.log(2.0)
            - 0.25 * d * (d - 1) * math.log(math.pi)
            - torch.sum(torch.lgamma(0.5 * (v[..., None] + 1.0 - i)),
                        dim=-1))
