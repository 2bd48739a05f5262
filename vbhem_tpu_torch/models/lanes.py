"""The lane schedule of the EM engines (:func:`.vbhem.vbhem_em`,
:func:`.vbhmm.vbem_em`, :func:`.vbhmm_groups.vbem_em`,
:func:`.vhem.vhem_em`): all restart lanes of a fit in one loop, as under
``jax.vmap`` of ``lax.while_loop`` (:func:`run_lanes`), each iteration
guarded by :func:`settle`; and the lanes cut into memory-sized chunks
(:func:`in_chunks`).  Lanes are independent, so chunking changes nothing
but memory and time.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..containers import tree_map
from ..utils import profiling


def lane_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-lane mask [...] against a lane-leading tensor."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def lane_where(mask: torch.Tensor, a, b):
    """``torch.where`` lane by lane over the leaves of ``a`` and ``b``
    (NamedTuples of one type, or tensors): a lane's leaves from ``a``
    where ``mask`` [...] holds, else from ``b``."""
    return tree_map(lambda x, y: torch.where(lane_mask(mask, x), x, y), a, b)


def within(min_diff: float) -> Callable:
    """The convergence test of VBHEM and VBEM:
    ``|(ll - last) / last| <= min_diff``."""
    return lambda ll, last: torch.abs((ll - last) / last) <= min_diff


def start(shape, dtype, device):
    """The loop's start for lanes ``shape``: (bound -max [...], iterations
    0 [...] int64, done False [...])."""
    return (torch.full(shape, -torch.finfo(dtype).max, dtype=dtype,
                       device=device),
            torch.zeros(shape, dtype=torch.int64, device=device),
            torch.zeros(shape, dtype=torch.bool, device=device))


def settle(ll: torch.Tensor, last: torch.Tensor, it: torch.Tensor,
           max_iter: int, converged: Callable):
    """One iteration's guard: (ll with NaN -> -inf, unstable, done).
    ``converged(ll, last)`` is the engine's test of the bound ``ll``
    against the previous iteration's ``last``; ``it`` counts the lane's
    iterations before this one.  ``done`` is a function of ``ll``,
    ``last`` and ``it`` alone."""
    unstable = torch.isnan(ll)
    ll = torch.where(unstable, torch.full_like(ll, -math.inf), ll)
    done = (((it > 0) & converged(ll, last)) | unstable
            | (it + 1 >= max_iter))
    return ll, unstable, done


def run_lanes(name: str, body: Callable, st0):
    """Run ``body`` (state -> state, over every lane) from ``st0``, a
    NamedTuple with ``it`` and ``done`` fields [...], until every lane is
    done; a lane done before an iteration keeps every field through it.
    Each iteration is one ``<name>.iter`` span, which ends on the
    iteration's ``done`` check: its sync waits for the iteration's device
    work.  While recording, the counters ``<name>.lane_iters_active`` (the
    lanes' own iterations) and ``<name>.lane_iters_launched`` (the
    iterations run times the lanes) are added to."""
    it_span = f"{name}.iter"
    with profiling.span(it_span):
        st = body(st0)
        finished = bool(torch.all(st.done))
    n_iter = 1
    while not finished:
        with profiling.span(it_span):
            active = ~st.done
            st = lane_where(active, body(st), st)
            finished = bool(torch.all(st.done))
        n_iter += 1
    if profiling.active():
        profiling.count(f"{name}.lane_iters_active", int(torch.sum(st.it)))
        profiling.count(f"{name}.lane_iters_launched",
                        n_iter * st.done.numel())
    return st


def chunk_slices(n: int, chunk: Optional[int]) -> list:
    """Slices of ``n`` lanes, ``chunk`` at a time (all at once for None)."""
    step = chunk or n
    return [slice(a, min(a + step, n)) for a in range(0, n, step)]


def in_chunks(fn: Callable, n: int, chunk: Optional[int]):
    """``fn(lane slice)`` over the :func:`chunk_slices` of ``n`` lanes, its
    results (tensors or NamedTuples of them, lanes leading) concatenated
    along the lanes."""
    parts = [fn(sl) for sl in chunk_slices(n, chunk)]
    return parts[0] if len(parts) == 1 else tree_map(
        lambda *xs: torch.cat(xs), *parts)
