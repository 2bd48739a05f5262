"""Multi-device VBHEM over ``torch.distributed``: the counterpart of
:mod:`vbhem_tpu.parallel.spmd`.

The ranks of the default process group form a ('trial', 'base') mesh
(:func:`make_mesh`):

  * ``trial`` axis: restart trials (and (K, S) grid cells) are
    independent; each rank runs its contiguous block of them and nothing
    is exchanged until the results are gathered;
  * ``base`` axis: the Kb base-HMM bank is sharded in contiguous blocks;
    every EM iteration sums Nj, the five raw moment sums and the ELBO's
    two sums over Kb over the ranks of the row (``group`` in
    :func:`..models.vbhem.vbhem_em`), so the reduced posterior stays the
    same on every rank of the row.

Every function takes the whole bank and the whole lane-leading posterior
on every rank (as the JAX functions take global arrays), runs its own
block, and returns the whole result on every rank: trials gathered over
'trial', hat_z and ll_elbo over 'base', so ``select_best_trial`` and the
labels see all of them.

The backend is the caller's: NCCL where every rank has a card of its own,
gloo on CPU tensors and for ranks that share one card (NCCL refuses two
ranks on one device).  Only all_reduce, broadcast and all_gather are
used, the collectives gloo takes on CUDA tensors; a backend that refuses
one raises, nothing is copied through the host here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..containers import H3M, H3MPosterior, tree_map
from ..models import vbhem
from ..models.lanes import in_chunks


class Mesh(NamedTuple):
    """This rank's place on the ('trial', 'base') mesh, and its two
    groups: ``base_group`` is the rank's row (the ranks that share its
    trials and split the bank), ``trial_group`` its column."""
    n_trial: int
    n_base: int
    trial: int                 # this rank's index on the 'trial' axis
    base: int                  # ... on the 'base' axis
    trial_group: object
    base_group: object


def make_mesh(n_trial: int, n_base: int) -> Mesh:
    """A ('trial', 'base') mesh over the ranks of the default process
    group, rank r at (r // n_base, r % n_base).  Every rank must call it,
    with the same sizes; ``n_trial * n_base`` must be the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if n_trial * n_base != world:
        raise ValueError(f"mesh {n_trial}x{n_base} needs {n_trial * n_base}"
                         f" ranks, the process group has {world}")
    rows = [[t * n_base + b for b in range(n_base)] for t in range(n_trial)]
    cols = [[t * n_base + b for t in range(n_trial)] for b in range(n_base)]
    base_group, _ = dist.new_subgroups_by_enumeration(rows)
    trial_group, _ = dist.new_subgroups_by_enumeration(cols)
    t, b = divmod(dist.get_rank(), n_base)
    return Mesh(n_trial, n_base, t, b, trial_group, base_group)


# ---------------------------------------------------------------------------
# blocks and gathers
# ---------------------------------------------------------------------------

def _block(x: torch.Tensor, index: int, n: int, dim: int = 0) -> torch.Tensor:
    size = x.shape[dim] // n
    return x.narrow(dim, index * size, size)


def _base_shard(mesh: Mesh, base: H3M) -> H3M:
    """This rank's contiguous block of the bank (every leaf is Kb-leading);
    Kb must divide by the 'base' axis, as under ``shard_map``."""
    kb = base.num_hmms
    if kb % mesh.n_base:
        raise ValueError(f"Kb={kb} not divisible by the 'base' mesh axis "
                         f"({mesh.n_base})")
    return tree_map(lambda a: _block(a, mesh.base, mesh.n_base), base)


def _check_trials(mesh: Mesh, n: int):
    if n % mesh.n_trial:
        raise ValueError(f"{n} trials not divisible by the 'trial' mesh "
                         f"axis ({mesh.n_trial})")


def _trial_block(mesh: Mesh, tree, dim: int = 0):
    """This rank's block of the trials on axis ``dim`` of every leaf."""
    return tree_map(lambda a: _block(a, mesh.trial, mesh.n_trial, dim), tree)


def _reduce_group(mesh: Mesh):
    """The group EM sums over: the row, or none on a 1-wide base axis."""
    return mesh.base_group if mesh.n_base > 1 else None


def _gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """Concatenate the blocks of the ``n`` ranks of ``group`` on ``dim``
    (in the group's rank order, which is the mesh axis's order)."""
    if n == 1:
        return x
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts, dim)
    return out.bool() if x.dtype == torch.bool else out


def _gather_trials(mesh: Mesh, tree, dim: int = 0):
    return tree_map(lambda a: _gather(a, mesh.trial_group, mesh.n_trial, dim),
                    tree)


def _gather_state(mesh: Mesh, st: vbhem.VBHEMState,
                  dim: int = 0) -> vbhem.VBHEMState:
    """The whole state from every rank's block: hat_z and ll_elbo over
    'base' (their Kb axis), then every leaf over 'trial' (axis ``dim``)."""
    rows = {f: _gather(getattr(st, f), mesh.base_group, mesh.n_base, -2)
            for f in ("hat_z", "ll_elbo")}
    return _gather_trials(mesh, st._replace(**rows), dim)


def replicate_to_mesh(mesh: Mesh, tree):
    """Every rank gets rank 0's values of ``tree``'s tensors (a broadcast
    from rank 0 over the mesh's ranks); returns the tree on this rank."""
    def bcast(t):
        t = t.contiguous()
        dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t,
                       src=0)
        return t
    return tree_map(bcast, tree)


def _check_same_generator(gen: torch.Generator, device):
    """Raise unless every rank's generator is in the same state: each rank
    draws every lane's start and keeps its own, so the ranks' starts are
    the unsharded ones only if they all draw alike."""
    state = gen.get_state().to(torch.int64)
    weight = torch.arange(1, state.numel() + 1, dtype=torch.int64)
    fp = torch.stack([state.sum(), (state * weight).sum()])
    both = torch.cat([fp, -fp]).to(device)
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    if not torch.equal(both[:2].cpu(), -both[2:].cpu()):
        raise ValueError("the ranks' generators are not in the same state; "
                         "seed them alike before a sharded fit")


# ---------------------------------------------------------------------------
# the sharded engine
# ---------------------------------------------------------------------------

def sharded_em_step(mesh: Mesh, base: H3M, posts: H3MPosterior,
                    hyps: vbhem.VBHEMHyps, nv: int, tau: int):
    """One VBHEM EM iteration, trials (the leading axis of ``posts``) in
    blocks over 'trial' and the bank over 'base'.  Returns (new posts,
    per-trial ELBO), both whole on every rank."""
    shard = _base_shard(mesh, base)
    _check_trials(mesh, posts.alpha.shape[0])
    post = _trial_block(mesh, posts)
    tilde_n = (nv * base.num_hmms) * shard.omega
    new_post, ll, _, _, _ = vbhem._em_iteration(
        shard, post, hyps, tilde_n, tau, group=_reduce_group(mesh))
    return _gather_trials(mesh, new_post), _gather_trials(mesh, ll)


def _sharded_em(mesh: Mesh, base: H3M, posts: H3MPosterior,
                hyps: vbhem.VBHEMHyps, nv: int, tau: int, max_iter: int,
                min_diff: float, covar_type: str, cmask=None, smask=None,
                chunk: Optional[int] = None) -> vbhem.VBHEMState:
    """This rank's lanes (``posts`` already its trial block) on its shard
    of the bank, ``chunk`` lanes at a time (all at once for None).  Every
    rank of a row runs the same chunks: each rank's chunk is all-reduced
    to the row's least."""
    shard = _base_shard(mesh, base)
    group = _reduce_group(mesh)
    n = posts.alpha.shape[0]
    step = chunk or n
    if group is not None:
        least = torch.tensor([step], device=shard.omega.device)
        dist.all_reduce(least, op=dist.ReduceOp.MIN, group=group)
        step = int(least)
    return in_chunks(lambda sl: vbhem.vbhem_em(
        shard, tree_map(lambda x: x[sl], posts), hyps, nv, tau,
        max_iter=max_iter, min_diff=min_diff, covar_type=covar_type,
        cmask=None if cmask is None else cmask[sl],
        smask=None if smask is None else smask[sl], group=group,
        kb_total=base.num_hmms), n, step)


def sharded_vbhem_em(mesh: Mesh, base: H3M, posts: H3MPosterior,
                     hyps: vbhem.VBHEMHyps, nv: int, tau: int,
                     max_iter: int = 200, min_diff: float = 1e-5,
                     covar_type: str = "full",
                     cmask: Optional[torch.Tensor] = None,
                     smask: Optional[torch.Tensor] = None
                     ) -> vbhem.VBHEMState:
    """The whole VBHEM EM loop, trials (the leading axis of ``posts``, and
    of ``cmask`` / ``smask`` when given: the masked loop of the padded
    grid) in blocks over 'trial' and the bank over 'base'.  Each
    iteration's statistics and ELBO sums are all-reduced over the row; the
    posterior stays the same on every rank of a row, so the row's ranks
    leave the loop together.  Returns the :class:`..models.vbhem.VBHEMState`
    with a leading trials axis, whole on every rank (hat_z and ll_elbo
    [trials, Kb, Kr])."""
    _check_trials(mesh, posts.alpha.shape[0])
    post, cm, sm = (_trial_block(mesh, x) for x in (posts, cmask, smask))
    st = _sharded_em(mesh, base, post, hyps, nv, tau, max_iter, min_diff,
                     covar_type, cm, sm)
    return _gather_state(mesh, st)


def make_sharded_vbhem_em(mesh: Mesh, nv: int, tau: int, max_iter: int = 200,
                          min_diff: float = 1e-5, covar_type: str = "full"):
    """:func:`sharded_vbhem_em` with its settings bound: the returned
    callable ``(base, posts, hyps, cmask=None, smask=None) -> VBHEMState``
    can be called again and again (the JAX function builds its program
    once this way; nothing is traced here)."""
    def call(base: H3M, posts: H3MPosterior, hyps: vbhem.VBHEMHyps,
             cmask=None, smask=None):
        return sharded_vbhem_em(mesh, base, posts, hyps, nv, tau, max_iter,
                                min_diff, covar_type, cmask, smask)
    return call


def sharded_fit_trials(mesh: Mesh, base: H3M, kr: int, sr: int, config,
                       hyps: vbhem.VBHEMHyps, gen: torch.Generator,
                       initmode: Optional[str] = None) -> vbhem.VBHEMState:
    """``config.trials`` restarts of one (K, S) cell, trials in blocks over
    'trial' and the bank over 'base': the form of the reference's
    ``parfor it=1:trials`` (`vbhem_h3m_c.m:28`).  Every rank draws every
    trial's start from ``gen`` (:func:`..models.vbhem.draw_lanes`, the
    ranks' generators checked alike) and keeps its block, so the starts
    are those of :func:`..models.vbhem.fit_single_ks` from the same
    generator state.  A rank runs its lanes in the chunks
    :func:`..models.vbhem.lane_chunk` sizes from the card's free memory.
    ``config.trials`` must divide by the 'trial' axis.  Returns the state
    with a leading trials axis, whole on every rank."""
    mode = vbhem.resolve_initmode(initmode or config.initmode)
    _check_trials(mesh, config.trials)
    _check_same_generator(gen, base.omega.device)
    post = _trial_block(mesh, vbhem.draw_lanes(
        mode, gen, base, kr, sr, hyps, config.nv, config.trials))
    chunk = vbhem.lane_chunk(_base_shard(mesh, base), kr, sr, config.tau,
                             post.alpha.shape[0])
    st = _sharded_em(mesh, base, post, hyps, config.nv, config.tau,
                     config.max_iter, config.min_diff, config.covar_type,
                     chunk=chunk)
    return _gather_state(mesh, st)


def sharded_grid_sweep(mesh: Mesh, base: H3M, ks, ss, config,
                       hyps: vbhem.VBHEMHyps, gen: torch.Generator,
                       initmode: Optional[str] = None,
                       trial_chunk: Optional[int] = None):
    """The padded (K, S) sweep of :func:`..models.vbhem.fit_grid_batched`
    with each cell's trials in blocks over 'trial' and the bank over
    'base': the form of the reference's grid recursion with ``parfor``
    (`vbhem_h3m_cluster.m:261-354`, `vbhem_h3m_c.m:28`).  Every rank draws
    every (cell, trial) start in cell-major order, as ``fit_grid_batched``
    does, and keeps its trials of every cell; its lanes run in chunks of
    ``trial_chunk`` (default :func:`..models.vbhem.lane_chunk`'s).
    ``config.trials`` must divide by the 'trial' axis.  Returns (state
    with leading [n_cells, trials] axes, whole on every rank; cells;
    cmasks [n_cells, Kmax]; smasks [n_cells, Smax]), as
    ``fit_grid_batched``."""
    dev = base.omega.device
    cells, cmasks, smasks = vbhem.grid_cells(ks, ss, dev)
    kmax, smax = cmasks.shape[1], smasks.shape[1]
    mode = vbhem.resolve_initmode(initmode or config.initmode)
    n_cells, trials = len(cells), config.trials
    _check_trials(mesh, trials)
    _check_same_generator(gen, dev)
    post0 = vbhem.draw_lanes(mode, gen, base, kmax, smax, hyps, config.nv,
                             n_cells * trials)
    ci = torch.arange(n_cells, device=dev).repeat_interleave(trials)

    def mine(x):
        """[n_cells * trials] lanes -> this rank's trials of every cell."""
        x = x.reshape((n_cells, trials) + x.shape[1:])
        return _block(x, mesh.trial, mesh.n_trial, 1).flatten(0, 1)

    post = tree_map(mine, post0)
    cm, sm = mine(cmasks[ci]), mine(smasks[ci])
    if trial_chunk is None:
        trial_chunk = vbhem.lane_chunk(_base_shard(mesh, base), kmax, smax,
                                       config.tau, post.alpha.shape[0])
    st = _sharded_em(mesh, base, post, hyps, config.nv, config.tau,
                     config.max_iter, config.min_diff, config.covar_type,
                     cm, sm, trial_chunk)
    st = tree_map(lambda x: x.reshape((n_cells, -1) + x.shape[1:]), st)
    return _gather_state(mesh, st, dim=1), cells, cmasks, smasks
