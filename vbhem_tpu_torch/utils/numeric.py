"""Numeric primitives shared by the engines (the counterpart of
:mod:`vbhem_tpu.utils.numeric`): log-sum-exp, digamma expectations,
Dirichlet / Wishart normalizers (with masked forms for the padded (K, S)
grid), and small symmetric positive-definite
inverses and log-determinants.  Dtype-polymorphic: float64 for the CPU
parity tests, float32 on the card.  The engines' bounds call the
normalizers in float64 in every run (:func:`block_cast`): in float32,
lgamma(S eps0) - S lgamma(eps0) and the posterior's Dirichlet constants
are differences of numbers as large as 1e12 whose rounding dwarfs the
bound's change between EM iterations.
"""
from __future__ import annotations

import math

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

__all__ = [
    "tiny",
    "logsumexp",
    "masked_logsumexp",
    "e_log_det_lambda",
    "e_log_dirichlet",
    "log_dirichlet_const",
    "masked_e_log_dirichlet",
    "masked_log_dirichlet_const",
    "log_wishart_b",
    "sym",
    "solve_psd",
    "inv_psd",
    "logdet_psd",
    "quad_diff",
    "lane_contract",
    "lane_hyp",
    "block_cast",
]


def tiny(dtype) -> float:
    """Smallest positive normal of ``dtype``: the reference's `+1e-50`
    mass floors underflow in float32 (`vbhem_h3m_c_step_fc.m:277`)."""
    return torch.finfo(dtype).tiny


def logsumexp(a: torch.Tensor, dim=-1, keepdim: bool = False) -> torch.Tensor:
    """log-sum-exp (the reference's `logtrick`), with the finite-max guard
    of the JAX package: an all -inf slice gives -inf, not NaN."""
    amax = torch.amax(a, dim=dim, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    out = torch.log(torch.sum(torch.exp(a - amax), dim=dim,
                              keepdim=True)) + amax
    return out if keepdim else out.squeeze(dim)


def masked_logsumexp(a: torch.Tensor, mask: torch.Tensor, dim=-1,
                     keepdim: bool = False) -> torch.Tensor:
    """log-sum-exp over the entries where ``mask`` (broadcasting against
    ``a``) is True; a slice with no finite active entry gives -inf.
    Masked entries are set to -inf before the max shift, and the shift is
    0 where the max is not finite, so no inf - inf arises."""
    neg_inf = torch.full_like(a, -math.inf)
    am = torch.where(mask, a, neg_inf)
    amax = torch.amax(am, dim=dim, keepdim=True)
    finite = torch.isfinite(amax)
    safe = torch.where(finite, amax, torch.zeros_like(amax))
    s = torch.sum(torch.where(mask, torch.exp(am - safe),
                              torch.zeros_like(am)), dim=dim, keepdim=True)
    out = torch.where(finite, torch.log(s) + safe,
                      torch.full_like(s, -math.inf))
    return out if keepdim else out.squeeze(dim)


def e_log_det_lambda(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """E[log |Lambda|] for Lambda ~ Wishart(W, v); Bishop (10.65):
    sum_i psi((v + 1 - i)/2) + D log 2 + log det W.  v [...], w [..., D, D]."""
    d = w.shape[-1]
    i = torch.arange(1, d + 1, dtype=v.dtype, device=v.device)
    t = torch.sum(torch.special.digamma(0.5 * (v[..., None] + 1.0 - i)),
                  dim=-1)
    return t + d * math.log(2.0) + logdet_psd(w)


def e_log_dirichlet(conc: torch.Tensor, dim=-1) -> torch.Tensor:
    """E[log pi_k] for pi ~ Dir(conc); Bishop (10.66)."""
    return (torch.special.digamma(conc)
            - torch.special.digamma(torch.sum(conc, dim=dim, keepdim=True)))


def log_dirichlet_const(conc: torch.Tensor, dim=-1) -> torch.Tensor:
    """log C(conc) of a Dirichlet: lgamma(sum conc) - sum lgamma(conc)."""
    return (torch.lgamma(torch.sum(conc, dim=dim))
            - torch.sum(torch.lgamma(conc), dim=dim))


def masked_e_log_dirichlet(conc: torch.Tensor, mask: torch.Tensor,
                           dim=-1, big: float = 1e30) -> torch.Tensor:
    """E[log pi_k] over the active entries of a padded Dirichlet (the
    padded (K, S) grid): the normalizer sums active concentrations only,
    and masked entries get -big, finite, so every downstream exp() is
    exactly 0 with no inf arithmetic.  ``mask`` broadcasts against
    ``conc``."""
    mask = torch.broadcast_to(mask, conc.shape)
    conc_safe = torch.where(mask, conc, torch.ones_like(conc))
    total = torch.sum(torch.where(mask, conc, torch.zeros_like(conc)),
                      dim=dim, keepdim=True)
    val = torch.special.digamma(conc_safe) - torch.special.digamma(total)
    return torch.where(mask, val, torch.full_like(val, -big))


def masked_log_dirichlet_const(conc: torch.Tensor, mask: torch.Tensor,
                               dim=-1) -> torch.Tensor:
    """log C(conc) over the active entries of a padded Dirichlet."""
    mask = torch.broadcast_to(mask, conc.shape)
    conc_safe = torch.where(mask, conc, torch.ones_like(conc))
    total = torch.sum(torch.where(mask, conc, torch.zeros_like(conc)),
                      dim=dim)
    return torch.lgamma(total) - torch.sum(
        torch.where(mask, torch.lgamma(conc_safe),
                    torch.zeros_like(conc_safe)), dim=dim)


def log_wishart_b(logdet_winv, v, d: int) -> torch.Tensor:
    """log B(W, v) of a Wishart given log det(W^{-1}) (`vbhmm_em_lb.m:88-89`):
    (v/2) logdet(W^-1) - (v d / 2) log 2 - (d(d-1)/4) log pi
    - sum_i lgamma((v + 1 - i)/2)."""
    if not torch.is_tensor(v):
        v = torch.as_tensor(v, dtype=torch.as_tensor(logdet_winv).dtype)
    i = torch.arange(1, d + 1, dtype=v.dtype, device=v.device)
    return (0.5 * v * logdet_winv
            - 0.5 * v * d * math.log(2.0)
            - 0.25 * d * (d - 1) * math.log(math.pi)
            - torch.sum(torch.lgamma(0.5 * (v[..., None] + 1.0 - i)), dim=-1))


def sym(a: torch.Tensor) -> torch.Tensor:
    """Symmetrize [..., D, D]."""
    return 0.5 * (a + a.transpose(-1, -2))


def solve_psd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a @ x = b for symmetric positive-definite ``a`` via Cholesky."""
    return torch.cholesky_solve(b, torch.linalg.cholesky(a))


def inv_psd(a: torch.Tensor) -> torch.Tensor:
    """Inverse of a symmetric positive-definite matrix.

    D <= 3 uses the closed-form cofactor inverse (the model family's
    emission dims are tiny; elementwise arithmetic batches without a
    per-matrix factorization launch).  Larger D uses Cholesky."""
    d = a.shape[-1]
    if d == 1:
        return 1.0 / a
    if d == 2:
        a00 = a[..., 0, 0]
        a01 = 0.5 * (a[..., 0, 1] + a[..., 1, 0])
        a11 = a[..., 1, 1]
        det = a00 * a11 - a01 * a01
        inv = torch.stack([
            torch.stack([a11, -a01], dim=-1),
            torch.stack([-a01, a00], dim=-1)], dim=-2)
        return inv / det[..., None, None]
    if d == 3:
        s = sym(a)
        a00, a01, a02 = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
        a11, a12, a22 = s[..., 1, 1], s[..., 1, 2], s[..., 2, 2]
        c00 = a11 * a22 - a12 * a12
        c01 = a02 * a12 - a01 * a22
        c02 = a01 * a12 - a02 * a11
        c11 = a00 * a22 - a02 * a02
        c12 = a01 * a02 - a00 * a12
        c22 = a00 * a11 - a01 * a01
        det = a00 * c00 + a01 * c01 + a02 * c02
        inv = torch.stack([
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c01, c11, c12], dim=-1),
            torch.stack([c02, c12, c22], dim=-1)], dim=-2)
        return inv / det[..., None, None]
    eye = torch.eye(d, dtype=a.dtype, device=a.device).expand(a.shape)
    return sym(solve_psd(a, eye))


def logdet_psd(a: torch.Tensor) -> torch.Tensor:
    """log det of a symmetric positive-definite matrix: closed form for
    D <= 3 (see :func:`inv_psd`), Cholesky otherwise."""
    d = a.shape[-1]
    if d == 1:
        return torch.log(a[..., 0, 0])
    if d == 2:
        a01 = 0.5 * (a[..., 0, 1] + a[..., 1, 0])
        return torch.log(a[..., 0, 0] * a[..., 1, 1] - a01 * a01)
    if d == 3:
        s = sym(a)
        a00, a01, a02 = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
        a11, a12, a22 = s[..., 1, 1], s[..., 1, 2], s[..., 2, 2]
        det = (a00 * (a11 * a22 - a12 * a12)
               + a01 * (a02 * a12 - a01 * a22)
               + a02 * (a01 * a12 - a02 * a11))
        return torch.log(det)
    chol = torch.linalg.cholesky(a)
    diag = torch.diagonal(chol, dim1=-2, dim2=-1)
    return 2.0 * torch.sum(torch.log(diag), dim=-1)


def quad_diff(x: torch.Tensor, m: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """(x - m)^T W (x - m) over the last axis, for x [..., D], m [..., D]
    and w [..., D, D] that broadcast against one another.  Works one
    dimension at a time, so the only large temporaries are D differences
    of the broadcast shape (no [..., D, D] product is materialized)."""
    d = x.shape[-1]
    diffs = [x[..., e] - m[..., e] for e in range(d)]
    out = 0
    for e in range(d):
        for f in range(d):
            out = out + diffs[e] * w[..., e, f] * diffs[f]
    return out


def lane_contract(wt: torch.Tensor, y: torch.Tensor, nx: int) -> torch.Tensor:
    """sum_m wt[*X, *L, M, K] y[*X, 1.., M, E] -> [*X, *L, K, E].

    ``y`` holds data shared by the lanes L (unit axes there), so it is
    not expanded over them: the lanes fold into the columns of one
    batched matmul over the X axes."""
    lead, lanes = wt.shape[:nx], wt.shape[nx:-2]
    m, k = wt.shape[-2:]
    y = y.reshape(y.shape[:nx] + y.shape[-2:])                # [*X, M, E]
    g = wt.movedim(-2, nx).reshape(lead + (m, -1))            # [*X, M, L*K]
    out = torch.matmul(y.transpose(-1, -2), g)                # [*X, E, L*K]
    return out.transpose(-1, -2).reshape(lead + lanes + (k, y.shape[-1]))


def lane_hyp(h: torch.Tensor, own: int, axes: int) -> torch.Tensor:
    """A hyperparameter leaf against a lane-leading tensor.  ``h`` is
    unbatched (``own`` axes: 0 for a scalar, 1 for a [D] vector, 2 for a
    [D, D] matrix), or carries the lanes in front of them; ``axes`` unit
    axes go between the lanes and its own axes, so that it broadcasts
    against [*lanes, <axes>, <own>].  An unbatched leaf is returned as it
    is, so the arithmetic of an unbatched run does not change."""
    if h.dim() == own:
        return h
    cut = h.dim() - own
    return h.reshape(h.shape[:cut] + (1,) * axes + h.shape[cut:])


def _leaves(tree) -> list:
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for part in tree for x in _leaves(part)]
    return [] if tree is None else [tree]


def _rebuild(tree, parts):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_rebuild(part, parts) for part in tree])
    return None if tree is None else next(parts)


def block_cast(trees: tuple, dtype) -> tuple:
    """``trees`` (tensors or NamedTuples of them) with every tensor in
    ``dtype``, cast as one block: the tensors are flattened into one
    vector, cast once and split back into views of their shapes (torch's
    own flatten helpers, one call each way), so a posterior with its
    hyperparameters costs two launches, not one a tensor.  Tensors in
    ``dtype`` already are kept as they are.  Differentiable."""
    leaves = [x for t in trees for x in _leaves(t)]
    todo = [x for x in leaves if x.dtype != dtype]
    if not todo:
        return tuple(trees)
    if len(todo) == 1:
        cast = iter([todo[0].to(dtype)])
    else:
        cast = iter(_unflatten_dense_tensors(
            _flatten_dense_tensors(todo).to(dtype), todo))
    parts = iter([x if x.dtype == dtype else next(cast) for x in leaves])
    return tuple(_rebuild(t, parts) for t in trees)

