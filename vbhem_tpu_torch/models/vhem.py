"""VHEM: non-Bayesian hierarchical EM clustering of HMM banks, the H3M
toolbox's baseline (reference `src/compare_mtds/hem/`) — the PyTorch
counterpart of :mod:`vbhem_tpu.models.vhem`.

Parity map:
  * `vhem_cluster.m`        -> :func:`cluster`
  * `hem_h3m_c.m`           -> :func:`fit_single_ks` (restarts as lanes)
  * `hem_h3m_c_step.m`      -> :func:`vhem_em`
  * `hem_hmm_bwd_fwd_mex.c` -> the pair recursion on the point-estimate
    expected log-Gaussian (:func:`..ops.pair_estep.expected_pair_ll_point`):
    kernel B3 on the card, its plain version on the CPU
  * `hem_mstep_component.m` -> :func:`m_step` (weighted ML updates)
  * `initialize_hem_h3m_c.m` -> the initializers

Where the JAX package vmaps restart trials, the reduced H3M here carries
an explicit leading lane axis [L, Kr, ...]; every function of the EM
iteration accepts any number of leading lane axes, and kernel B3 folds
L*Kr into one launch.  :func:`vhem_em` runs all lanes together with a
per-lane ``done`` mask and freezes a lane once it is done, as
``jax.vmap`` of ``lax.while_loop`` does.

Degenerate handling (`hem_h3m_c_step.m:461-493`): after each M-step,
zero-mass clusters are replaced by a perturbed copy of the heaviest
cluster with its weight split, and zero-count states within a cluster by
a perturbed copy of that cluster's heaviest state.

Randomness comes from an explicit ``torch.Generator``, drawn on the
generator's device; its draws differ from ``jax.random``'s, so restarts
are comparable only in distribution.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import HEMConfig
from ..containers import H3M, HMM, tree_map
from ..ops.pair_estep import PairStats, expected_pair_ll_point
from ..ops.pair_estep_cuda import pair_bwd_fwd_auto
from ..utils.numeric import logsumexp, sym, tiny
from .lanes import lane_where, run_lanes, settle, start


class VHEMState(NamedTuple):
    h3m: H3M                  # reduced model (point estimates)
    ll: torch.Tensor          # [...]
    last_ll: torch.Tensor     # [...]
    it: torch.Tensor          # [...] int64
    z: torch.Tensor           # [..., Kb, Kr]
    ll_elbo: torch.Tensor     # [..., Kb, Kr]
    emit_counts: torch.Tensor  # [..., Kr, Sr] state virtual counts
    done: torch.Tensor        # [...] bool
    # the JAX package's PRNG key; None here, where the degenerate repairs
    # draw from the generator handed to vhem_em
    key: Optional[object] = None


def _inf_norm(mode: str, nv: int, tau: int, kb: int) -> float:
    """Normalization of L_elbo (`hem_h3m_c_step.m:110-119`)."""
    if mode == "":
        return 1.0
    if mode == "n":
        return nv / kb
    if mode in ("tn", "nt"):
        return tau * nv / kb
    if mode == "t":
        return float(tau)
    raise ValueError(f"unknown inf_norm {mode!r}")


def _rand(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """U[0, 1) draws on the generator's device, moved to ``device``."""
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=dtype).to(device)


def _log_floor(x: torch.Tensor) -> torch.Tensor:
    """log(max(x, 1e-300)): in float32 the floor rounds to 0, so a zero
    probability gives -inf, as in the JAX package."""
    return torch.log(torch.clamp_min(x, 1e-300))


def e_step(base: H3M, reduced: H3M, tau: int,
           smooth: float = 1.0) -> PairStats:
    """Pair E-step with point-estimate scores (`hem_h3m_c_step.m:185-287`)
    over every lane of ``reduced``: kernel B3 on the card, the plain
    PyTorch version on the CPU.  ``smooth`` tempers the expected emission
    log-likelihood."""
    ell = expected_pair_ll_point(base.hmm.mean, base.hmm.cov,
                                 reduced.hmm.mean, reduced.hmm.cov)
    if smooth != 1.0:
        ell = ell / smooth
    return pair_bwd_fwd_auto(base.hmm.prior, base.hmm.trans,
                             _log_floor(reduced.hmm.prior),
                             _log_floor(reduced.hmm.trans), ell, tau)


def m_step(base: H3M, pair: PairStats, z: torch.Tensor,
           config: HEMConfig) -> tuple:
    """Weighted ML updates (`hem_h3m_c_step.m:428-459` +
    `hem_mstep_component.m:83-166`); z [..., Kb, Kr].  Returns (reduced
    H3M, emit counts [..., Kr, Sr])."""
    dtype = z.dtype
    kb, kr = z.shape[-2:]
    sr = pair.nu_1.shape[-1]
    d = base.hmm.mean.shape[-1]
    eps = tiny(dtype)
    eye = torch.eye(d, dtype=dtype, device=z.device)

    omega_new = torch.sum(z, dim=-2) / kb                      # [..., Kr]
    zw = z * base.omega[:, None]                               # Zomega
    prior_u = torch.einsum("...ij,...ijr->...jr", zw, pair.nu_1)
    a_u = torch.einsum("...ij,...ijrs->...jrs", zw, pair.sum_xi)
    if sr == 1:
        a_u = torch.full_like(a_u, 1e-12)    # hem_mstep_component.m:124-126
    if config.tau == 1:
        a_u = 1e-12 * torch.eye(sr, dtype=dtype,
                                device=z.device).expand(a_u.shape)
    prior_new = prior_u / torch.clamp_min(
        torch.sum(prior_u, -1, keepdim=True), eps)
    trans_new = a_u / torch.clamp_min(torch.sum(a_u, -1, keepdim=True), eps)

    # emission stats are linear in sum_t_nu against cached base moments
    mean_b = base.hmm.mean
    m2_b = mean_b[..., :, None] * mean_b[..., None, :] + base.hmm.cov
    w_stn = zw[..., None, None] * pair.sum_t_nu                # [.., i,j,r,b]
    w_sum = torch.sum(w_stn, dim=(-4, -1))                     # Gweight
    mu_sum = torch.einsum("...ijrb,ibd->...jrd", w_stn, mean_b)
    m2_sum = torch.einsum("...ijrb,ibde->...jrde", w_stn, m2_b)
    w_safe = torch.clamp_min(w_sum, eps)
    mean_new = mu_sum / w_safe[..., None]
    cov_new = sym(m2_sum / w_safe[..., None, None]
                  - mean_new[..., :, None] * mean_new[..., None, :])
    cov_new = cov_new + config.reg_cov * eye
    if config.covar_type == "diag":
        # `hem_mstep_component.m` diag case: the diagonal of the weighted
        # second moment minus mean^2
        cov_new = cov_new * eye

    # state virtual counts (`hem_mstep_component.m:138`)
    emit_counts = torch.sum(a_u, dim=-2) + prior_u
    h3m = H3M(omega=omega_new,
              hmm=HMM(prior=prior_new, trans=trans_new, mean=mean_new,
                      cov=cov_new),
              state_mask=torch.ones(prior_new.shape, dtype=torch.bool,
                                    device=z.device))
    return h3m, emit_counts


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[..., idx, ...] along axis ``idx.dim()`` of a, keeping that axis
    with size 1: a [*X, N, *rest], idx [*X] -> [*X, 1, *rest]."""
    rest = a.shape[idx.dim() + 1:]
    i = idx.reshape(idx.shape + (1,) * (1 + len(rest)))
    return torch.gather(a, idx.dim(), i.expand(idx.shape + (1,) + rest))


def fix_degenerate_components(h3m: H3M, gen: torch.Generator) -> H3M:
    """Replace zero-weight clusters by a perturbed copy of the heaviest
    one with its weight split (`hem_fix_degenerate_component.m`), in every
    lane.  All simultaneous zeros of a lane draw from the same donor and
    share half its weight.  The copied cluster gets the donor's
    emissions, a noised copy of the donor's prior, and a fresh random
    transition matrix keeping the donor's zero pattern."""
    omega = h3m.omega                                          # [..., Kr]
    kr, sr = h3m.hmm.prior.shape[-2:]
    dtype, dev = omega.dtype, omega.device
    lanes = omega.shape[:-1]
    deg = omega <= 0.0
    n_deg = torch.sum(deg, dim=-1, keepdim=True)               # [..., 1]
    donor = torch.argmax(omega, dim=-1)                        # [...]
    is_donor = torch.arange(kr, device=dev) == donor[..., None]

    w_max = _take(omega, donor)                                # [..., 1]
    omega_new = torch.where(deg, 0.5 * w_max / torch.clamp_min(n_deg, 1),
                            omega)
    omega_new = torch.where((n_deg > 0) & is_donor, 0.5 * w_max, omega_new)
    omega_new = omega_new / torch.sum(omega_new, dim=-1, keepdim=True)

    # prior: donor prior + (.1/Sr) * U[0,1), renormalized
    prior_fix = _take(h3m.hmm.prior, donor) + (0.1 / sr) * _rand(
        gen, lanes + (kr, sr), dtype, dev)
    prior_fix = prior_fix / torch.sum(prior_fix, dim=-1, keepdim=True)
    prior_new = torch.where(deg[..., None], prior_fix, h3m.hmm.prior)
    # A: fresh (.1/Sr)*rand with the donor's zeros kept, renormalized
    a_fix = (0.1 / sr) * _rand(gen, lanes + (kr, sr, sr), dtype, dev)
    a_fix = torch.where(_take(h3m.hmm.trans, donor) == 0,
                        torch.zeros_like(a_fix), a_fix)
    a_fix = a_fix / torch.clamp_min(torch.sum(a_fix, -1, keepdim=True),
                                    1e-300)
    trans_new = torch.where(deg[..., None, None], a_fix, h3m.hmm.trans)

    mean_new = torch.where(deg[..., None, None], _take(h3m.hmm.mean, donor),
                           h3m.hmm.mean)
    cov_new = torch.where(deg[..., None, None, None],
                          _take(h3m.hmm.cov, donor), h3m.hmm.cov)
    return h3m._replace(omega=omega_new,
                        hmm=HMM(prior=prior_new, trans=trans_new,
                                mean=mean_new, cov=cov_new))


def fix_degenerate_states(h3m: H3M, emit_counts: torch.Tensor,
                          gen: torch.Generator) -> H3M:
    """Replace zero-count states of each cluster by a split of that
    cluster's heaviest state (`hem_fix_degenerate_hmm.m`), in every lane:
    prior mass halved between donor and copy, donor's outgoing row
    copied, incoming column split, emission mean perturbed by 1%
    multiplicative noise."""
    sr = h3m.hmm.prior.shape[-1]
    dtype, dev = h3m.hmm.prior.dtype, h3m.hmm.prior.device
    deg = emit_counts <= 0.0                                  # [..., Kr, Sr]
    n_deg = torch.sum(deg, dim=-1, keepdim=True)              # [..., Kr, 1]
    any_deg = n_deg > 0
    donor = torch.argmax(emit_counts, dim=-1)                 # [..., Kr]
    is_donor = torch.arange(sr, device=dev) == donor[..., None]
    share_n = torch.clamp_min(n_deg, 1)

    p_max = _take(h3m.hmm.prior, donor)                       # [..., Kr, 1]
    prior_new = torch.where(deg, 0.5 * p_max / share_n, h3m.hmm.prior)
    prior_new = torch.where(any_deg & is_donor, 0.5 * p_max, prior_new)
    prior_new = prior_new / torch.clamp_min(
        torch.sum(prior_new, -1, keepdim=True), 1e-300)

    # rows: a degenerate state gets the donor's outgoing row
    trans = h3m.hmm.trans
    trans_new = torch.where(deg[..., None], _take(trans, donor), trans)
    # columns: incoming donor mass split between donor and degenerates
    col_d = torch.gather(trans_new, -1, donor[..., None, None].expand(
        donor.shape + (sr, 1)))                               # [..., Kr,Sr,1]
    trans_new = torch.where(deg[..., None, :], 0.5 * col_d / share_n[..., None],
                            trans_new)
    trans_new = torch.where((any_deg & is_donor)[..., None, :], 0.5 * col_d,
                            trans_new)
    trans_new = trans_new / torch.clamp_min(
        torch.sum(trans_new, -1, keepdim=True), 1e-300)

    noise = 1.0 + 0.01 * _rand(gen, h3m.hmm.mean.shape, dtype, dev)
    mean_new = torch.where(deg[..., None], _take(h3m.hmm.mean, donor) * noise,
                           h3m.hmm.mean)
    cov_new = torch.where(deg[..., None, None], _take(h3m.hmm.cov, donor),
                          h3m.hmm.cov)
    return h3m._replace(hmm=HMM(prior=prior_new, trans=trans_new,
                                mean=mean_new, cov=cov_new))


def _iteration(base: H3M, h3m: H3M, config: HEMConfig, n_i: torch.Tensor,
               inf_norm: float, gen: torch.Generator):
    """One EM iteration on every lane: returns (new H3M after the
    degenerate repairs, emit counts, LL of ``h3m``, z, pair ll_elbo)."""
    pair = e_step(base, h3m, config.tau, config.smooth)
    log_z = _log_floor(h3m.omega)[..., None, :] \
        + n_i[:, None] * (pair.ll_elbo / inf_norm)
    lse = logsumexp(log_z, dim=-1, keepdim=True)
    z = torch.exp(log_z - lse)
    ll = torch.sum(lse[..., 0], dim=-1)
    new_h3m, emit_counts = m_step(base, pair, z, config)
    # degenerate repair (hem_h3m_c_step.m:461-478)
    new_h3m = fix_degenerate_components(new_h3m, gen)
    new_h3m = fix_degenerate_states(new_h3m, emit_counts, gen)
    return new_h3m, emit_counts, ll, z, pair.ll_elbo


def vhem_em(base: H3M, init: H3M, config: HEMConfig,
            gen: Optional[torch.Generator] = None) -> VHEMState:
    """The VHEM EM loop (`hem_h3m_c_step.m:179-505`) over every lane of
    ``init`` at once.

    Per iteration: pair E-step, soft assignments, LL, convergence check,
    M-step and degenerate repairs; a NaN LL becomes -inf and keeps the
    old model.  A lane is done once its relative LL change falls below
    ``min_diff`` after its first iteration, it went unstable, or it
    reached ``max_iter``; from then on it is frozen.  ``gen`` feeds the
    degenerate repairs (a fixed-seed generator on the bank's device when
    None)."""
    dtype = base.hmm.mean.dtype
    dev = base.hmm.mean.device
    kb = base.num_hmms
    n_i = (config.nv * kb) * base.omega                       # [Kb]
    inf_norm = _inf_norm(config.inf_norm, config.nv, config.tau, kb)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)

    # the covariance regularization, once up front (`hem_h3m_c_step.m:98-108`)
    d = base.hmm.mean.shape[-1]
    init = init._replace(hmm=init.hmm._replace(
        cov=init.hmm.cov + config.reg_cov * torch.eye(d, dtype=dtype,
                                                      device=dev)))

    def converged(ll, last):
        return (ll - last) / torch.abs(last) < config.min_diff

    def body(st: VHEMState) -> VHEMState:
        new_h3m, emit_counts, ll, z, ll_elbo = _iteration(
            base, st.h3m, config, n_i, inf_norm, gen)
        ll, unstable, done = settle(ll, st.ll, st.it, config.max_iter,
                                    converged)
        return VHEMState(h3m=lane_where(unstable, st.h3m, new_h3m), ll=ll,
                         last_ll=st.ll, it=st.it + 1, z=z, ll_elbo=ll_elbo,
                         emit_counts=emit_counts, done=done)

    ll0, it0, done0 = start(init.omega.shape[:-1], dtype, dev)
    return run_lanes("vhem_em", body, VHEMState(
        h3m=init, ll=ll0, last_ll=ll0, it=it0, z=None, ll_elbo=None,
        emit_counts=None, done=done0))


# ---------------------------------------------------------------------------
# initializers (initialize_hem_h3m_c.m); each returns an H3M with leading
# lane axes ``lanes``
# ---------------------------------------------------------------------------

def _normalized(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sum(x, dim=-1, keepdim=True)


def _random_dynamics(gen, lanes, kr, sr, dtype, dev):
    """Random prior [*L, Kr, Sr] and transitions [*L, Kr, Sr, Sr], rows
    normalized (`initialize_hem_h3m_c.m` makeAprior random mode)."""
    return (_normalized(_rand(gen, lanes + (kr, sr), dtype, dev)),
            _normalized(_rand(gen, lanes + (kr, sr, sr), dtype, dev)))


def _ones_mask(lanes, kr, sr, dev):
    return torch.ones(lanes + (kr, sr), dtype=torch.bool, device=dev)


def init_baseem(gen: torch.Generator, base: H3M, kr: int, sr: int,
                config: HEMConfig, lanes: Sequence[int] = ()) -> H3M:
    """'baseem': random base emissions as reduced emissions, uniform
    prior/transitions (`initialize_hem_h3m_c.m:111-141`)."""
    lanes = tuple(lanes)
    dtype, dev = base.hmm.mean.dtype, base.hmm.mean.device
    kb, sb_max = base.state_mask.shape
    rand_b = torch.randint(0, kb, lanes + (kr, sr), generator=gen,
                           device=gen.device).to(dev)
    n_states = torch.sum(base.state_mask, dim=-1)
    u = _rand(gen, lanes + (kr, sr), torch.float64, dev)
    rand_g = torch.clamp(torch.floor(u * n_states[rand_b]).to(torch.int64),
                         max=sb_max - 1)
    omega = _normalized(_rand(gen, lanes + (kr,), dtype, dev) + 0.1)
    return H3M(omega=omega,
               hmm=HMM(prior=torch.full(lanes + (kr, sr), 1.0 / sr,
                                        dtype=dtype, device=dev),
                       trans=torch.full(lanes + (kr, sr, sr), 1.0 / sr,
                                        dtype=dtype, device=dev),
                       mean=base.hmm.mean[rand_b, rand_g],
                       cov=base.hmm.cov[rand_b, rand_g]),
               state_mask=_ones_mask(lanes, kr, sr, dev))


def _init_from_indices(base: H3M, idx: torch.Tensor, sr: int,
                       omega: torch.Tensor) -> H3M:
    """Reduced models copied from the base HMMs idx [*L, Kr], truncated to
    ``sr`` states and renormalized."""
    prior = base.hmm.prior[idx][..., :sr]
    prior = prior / torch.clamp_min(torch.sum(prior, -1, keepdim=True), 1e-12)
    trans = base.hmm.trans[idx][..., :sr, :sr]
    trans = trans / torch.clamp_min(torch.sum(trans, -1, keepdim=True), 1e-12)
    return H3M(omega=omega,
               hmm=HMM(prior=prior, trans=trans,
                       mean=base.hmm.mean[idx][..., :sr, :],
                       cov=base.hmm.cov[idx][..., :sr, :, :]),
               state_mask=torch.ones(prior.shape, dtype=torch.bool,
                                     device=prior.device))


def init_base_subset(gen: torch.Generator, base: H3M, kr: int, sr: int,
                     config: HEMConfig, lanes: Sequence[int] = ()) -> H3M:
    """'base': a random subset of input HMMs as initial centers
    (`initialize_hem_h3m_c.m:40-61,142-155`).  Requires the base HMMs to
    have >= sr states."""
    lanes = tuple(lanes)
    dtype, dev = base.hmm.mean.dtype, base.hmm.mean.device
    kb = base.num_hmms
    idx = torch.argsort(_rand(gen, lanes + (kb,), torch.float64, dev),
                        dim=-1)[..., :kr]
    return _init_from_indices(base, idx, sr, torch.full(
        lanes + (kr,), 1.0 / kr, dtype=dtype, device=dev))


def _pooled_emissions(base: H3M):
    kb, sb_max = base.state_mask.shape
    d = base.hmm.mean.shape[-1]
    return (base.hmm.mean.reshape(kb * sb_max, d),
            base.hmm.cov.reshape(kb * sb_max, d, d))


def _gather_lanes(a: torch.Tensor, idx: torch.Tensor, nl: int) -> torch.Tensor:
    """a [*L, T, *rest] indexed per lane by idx [*L, *I] -> [*L, *I, *rest]."""
    lanes = a.shape[:nl]
    n = math.prod(lanes)
    flat = a.reshape((n,) + a.shape[nl:])
    i = idx.reshape(n, -1)
    out = flat[torch.arange(n, device=a.device)[:, None], i]
    return out.reshape(lanes + idx.shape[nl:] + a.shape[nl + 1:])


def init_gmmNew(gen: torch.Generator, base: H3M, kr: int, sr: int,
                config: HEMConfig, lanes: Sequence[int] = ()) -> H3M:
    """'gmmNew': pool base emission Gaussians, reduce to Sr shared
    components with mixture-hierarchies EM, random prior/transitions
    (`initialize_hem_h3m_c.m:276-494` with makeAprior random mode)."""
    from ..ops.gmm import mix_hier_em
    lanes = tuple(lanes)
    dtype, dev = base.hmm.mean.dtype, base.hmm.mean.device
    d = base.hmm.mean.shape[-1]
    red, _ = mix_hier_em(gen, *_pooled_emissions(base),
                         base.state_mask.reshape(-1).to(dtype), sr,
                         nv=config.nv, lanes=lanes)
    prior, trans = _random_dynamics(gen, lanes, kr, sr, dtype, dev)
    omega = _normalized(_rand(gen, lanes + (kr,), dtype, dev) + 0.1)
    return H3M(omega=omega,
               hmm=HMM(prior=prior, trans=trans,
                       mean=red.mean[..., None, :, :].expand(
                           lanes + (kr, sr, d)).contiguous(),
                       cov=red.cov[..., None, :, :, :].expand(
                           lanes + (kr, sr, d, d)).contiguous()),
               state_mask=_ones_mask(lanes, kr, sr, dev))


def init_gmmNew2(gen: torch.Generator, base: H3M, kr: int, sr: int,
                 config: HEMConfig, lanes: Sequence[int] = ()) -> H3M:
    """'gmmNew2': reduce the pooled base Gaussians to Kr*Sr components
    and give each cluster its own random block of Sr
    (`initialize_hem_h3m_c.m:276-494`, tmpK = Sr*Kr branch)."""
    from ..ops.gmm import mix_hier_em
    lanes = tuple(lanes)
    dtype, dev = base.hmm.mean.dtype, base.hmm.mean.device
    red, _ = mix_hier_em(gen, *_pooled_emissions(base),
                         base.state_mask.reshape(-1).to(dtype), kr * sr,
                         nv=config.nv, lanes=lanes)
    use = torch.argsort(_rand(gen, lanes + (kr * sr,), torch.float64, dev),
                        dim=-1).reshape(lanes + (kr, sr))
    prior, trans = _random_dynamics(gen, lanes, kr, sr, dtype, dev)
    omega = _normalized(_rand(gen, lanes + (kr,), dtype, dev) + 0.1)
    nl = len(lanes)
    return H3M(omega=omega,
               hmm=HMM(prior=prior, trans=trans,
                       mean=_gather_lanes(red.mean, use, nl),
                       cov=_gather_lanes(red.cov, use, nl)),
               state_mask=_ones_mask(lanes, kr, sr, dev))


def init_gmm(gen: torch.Generator, base: H3M, kr: int, sr: int,
             config: HEMConfig, lanes: Sequence[int] = ()) -> H3M:
    """'gmm' (`initialize_hem_h3m_c.m:495-593`): pool all base emission
    Gaussians weighted by their long-run state probabilities (p A^50,
    `:533-545`), reduce them with mixture-hierarchies EM to one Gaussian,
    and give every (cluster, state) that emission; prior, transitions and
    omega random.  The NaN-retry ladder's initializer
    (`hem_h3m_c.m:304-320`)."""
    from ..ops.gmm import mix_hier_em
    lanes = tuple(lanes)
    dtype, dev = base.hmm.mean.dtype, base.hmm.mean.device
    d = base.hmm.mean.shape[-1]
    # long-run state weights p A^50 per base HMM (`:538-541`)
    p_inf = base.hmm.prior
    for _ in range(50):
        p_inf = torch.einsum("ib,ibc->ic", p_inf, base.hmm.trans)
    weights = (p_inf * base.state_mask).reshape(-1)
    red, _ = mix_hier_em(gen, *_pooled_emissions(base),
                         weights / torch.sum(weights), 1, nv=config.nv,
                         lanes=lanes)
    prior, trans = _random_dynamics(gen, lanes, kr, sr, dtype, dev)
    omega = _normalized(_rand(gen, lanes + (kr,), dtype, dev))
    return H3M(omega=omega,
               hmm=HMM(prior=prior, trans=trans,
                       mean=red.mean[..., :, None, :].expand(
                           lanes + (kr, sr, d)).contiguous(),
                       cov=red.cov[..., :, None, :, :].expand(
                           lanes + (kr, sr, d, d)).contiguous()),
               state_mask=_ones_mask(lanes, kr, sr, dev))


def init_highp(gen: torch.Generator, base: H3M, kr: int, sr: int,
               config: HEMConfig, lanes: Sequence[int] = ()) -> H3M:
    """'highp': the Kr highest-weight base HMMs as centers, uniform
    omega (`initialize_hem_h3m_c.m:259-269`)."""
    lanes = tuple(lanes)
    dtype, dev = base.hmm.mean.dtype, base.hmm.mean.device
    idx = torch.argsort(-base.omega, stable=True)[:kr]
    return _init_from_indices(base, idx.expand(lanes + (kr,)), sr,
                              torch.full(lanes + (kr,), 1.0 / kr,
                                         dtype=dtype, device=dev))


def init_trick(gen: torch.Generator, base: H3M, kr: int, sr: int,
               config: HEMConfig, lanes: Sequence[int] = ()) -> H3M:
    """'trick': evenly-spaced base HMMs as centers, random omega
    (`initialize_hem_h3m_c.m:247-257`)."""
    lanes = tuple(lanes)
    dtype, dev = base.hmm.mean.dtype, base.hmm.mean.device
    idx = torch.arange(kr, device=dev) * max(base.num_hmms // kr, 1)
    return _init_from_indices(
        base, idx.expand(lanes + (kr,)), sr,
        _normalized(_rand(gen, lanes + (kr,), dtype, dev)))


_INITIALIZERS = {"baseem": init_baseem, "base": init_base_subset,
                 "gmmNew": init_gmmNew, "gmmNew2": init_gmmNew2,
                 "gmm": init_gmm, "highp": init_highp,
                 "trick": init_trick}

# 'auto' tries these and keeps the best solution (`vhem_cluster.m:210-233`)
_AUTO_MODES = ("baseem", "gmmNew", "gmmNew2")


class VHEMResult(NamedTuple):
    """`h3m_to_hmms.m` output form: reduced models + memberships."""
    h3m: H3M
    ll: torch.Tensor
    z: torch.Tensor
    label: torch.Tensor
    emit_counts: torch.Tensor
    ll_elbo: torch.Tensor     # [Kb, Kr] per-pair expected LL (L_elbo1)

    @property
    def groups(self):
        lab = self.label.cpu().numpy()
        return [list(np.where(lab == j)[0])
                for j in range(self.h3m.omega.shape[-1])]


def finalize(st: VHEMState) -> VHEMResult:
    return VHEMResult(h3m=st.h3m, ll=st.ll, z=st.z,
                      label=torch.argmax(st.z, dim=-1),
                      emit_counts=st.emit_counts, ll_elbo=st.ll_elbo)


def fit_single_ks(gen: torch.Generator, base: H3M, kr: int, sr: int,
                  config: HEMConfig,
                  initmode: Optional[str] = None) -> VHEMState:
    """Random restarts for one (K, S) (`hem_h3m_c.m:229-322`): the
    ``config.trials`` restarts are the lanes of one :func:`vhem_em`.
    Returns the VHEMState with a leading trial axis."""
    mode = initmode or config.initmode
    if mode == "auto":
        mode = "baseem"
    init = _INITIALIZERS[mode](gen, base, kr, sr, config,
                               lanes=(config.trials,))
    return vhem_em(base, init, config, gen)


def select_best_trial(states: VHEMState) -> VHEMState:
    best = int(torch.argmax(states.ll))
    return tree_map(lambda a: a[best], states)


def cluster(gen: torch.Generator, base: H3M, kr: int, sr: int,
            config: HEMConfig = HEMConfig(),
            initmode: Optional[str] = None,
            allow_identity_shortcut: bool = True,
            info: Optional[dict] = None) -> VHEMResult:
    """VHEM clustering for one (K, S) (`vhem_cluster.m`).  When Kr == Kb
    the inputs are returned unchanged with an identity assignment and
    LogL = 0, exactly as `hem_h3m_c.m:19-25`.

    'auto' initmode tries {baseem, gmmNew, gmmNew2} and keeps the best
    solution by LL (`vhem_cluster.m:210-233`).

    NaN-retry ladder (`hem_h3m_c.m:304-320`): if every restart of a mode
    is unstable (ll = -inf), redo with fresh draws up to 5 times, then
    switch the initializer to 'gmm' for up to 5 more; a model that still
    failed is returned with ll = -inf.

    ``info``, when given, gains ``em_iters``: the EM iterations run (each
    restart batch counts its slowest lane), one pair E-step each."""
    if kr == base.num_hmms and allow_identity_shortcut:
        # identity shortcut (`hem_h3m_c.m:19-25`); callers that compare
        # LLs across a K grid must disable it
        dtype, dev = base.omega.dtype, base.omega.device
        return VHEMResult(h3m=base, ll=torch.zeros((), dtype=dtype,
                                                   device=dev),
                          z=torch.eye(kr, dtype=dtype, device=dev),
                          label=torch.arange(kr, device=dev),
                          emit_counts=torch.zeros_like(base.hmm.prior),
                          ll_elbo=torch.zeros((kr, kr), dtype=dtype,
                                              device=dev))
    mode = initmode or config.initmode
    modes = _AUTO_MODES if mode == "auto" else (mode,)
    if info is not None:
        info.setdefault("em_iters", 0)

    def fit(m):
        states = fit_single_ks(gen, base, kr, sr, config, m)
        if info is not None:
            info["em_iters"] += int(torch.max(states.it))
        return select_best_trial(states)

    best = None
    for m in modes:
        st = fit(m)
        redo = 0
        while not math.isfinite(float(st.ll)) and redo < 10:
            redo += 1
            # the reference ladder switches to 'gmm' after 5 redos
            st = fit(m if redo <= 5 else "gmm")
        if best is None or float(st.ll) > float(best.ll):
            best = st
    return finalize(best)


# ---------------------------------------------------------------------------
# 'split' mode: incremental K/S growing (hem_h3m_c.m:91-226)
# ---------------------------------------------------------------------------

def _split_gauss(mean, cov, f: float = 1.0):
    """Split one Gaussian along its principal axis
    (`hem_h3m_c.m:340-365`, generalized to full covariances via the top
    eigenpair)."""
    vals, vecs = np.linalg.eigh(cov)
    vmax, u = vals[-1], vecs[:, -1]
    delta = np.sqrt(max(vmax, 0.0)) * u
    new_cov = cov - (1.0 - 1.0 / (2.0 * f) ** 2) * vmax * np.outer(u, u)
    return mean + f * delta, mean - f * delta, new_cov


def cluster_split(gen: torch.Generator, base: H3M, kr: int, sr: int,
                  config: HEMConfig = HEMConfig()) -> VHEMResult:
    """'split' initialization: learn (K=1, S=1) from the global emission
    average, then repeatedly split the heaviest cluster until K=kr, then
    the most-used state of every cluster until S=sr, re-running the EM
    after each split (`hem_h3m_c.m:91-226`).  Deterministic apart from
    the degenerate repairs, which draw from ``gen``."""
    def host(t):   # a copy, which the splits below edit
        return np.array(t.detach().cpu().numpy())

    dtype = host(base.hmm.mean).dtype
    dev = base.hmm.mean.device
    d = base.hmm.mean.shape[-1]
    maskf = host(base.state_mask).astype(float)
    n_emit = maskf.sum()

    # global average emission (hem_h3m_c.m:113-121)
    mean0 = (host(base.hmm.mean) * maskf[..., None]).sum((0, 1)) / n_emit
    cov0 = (host(base.hmm.cov) * maskf[..., None, None]).sum((0, 1)) / n_emit

    def em(omega, prior, trans, means, covs):
        k, s = prior.shape

        def t(x):
            return torch.as_tensor(np.asarray(x, dtype), device=dev)

        init = H3M(omega=t(omega),
                   hmm=HMM(prior=t(prior), trans=t(trans), mean=t(means),
                           cov=t(covs)),
                   state_mask=torch.ones((k, s), dtype=torch.bool,
                                         device=dev))
        return vhem_em(base, init, config, gen)

    st = em(np.ones((1,)), np.ones((1, 1)), np.ones((1, 1, 1)),
            mean0[None, None, :], cov0[None, None, :, :])

    # --- grow K by splitting the heaviest cluster (hem_h3m_c.m:145-171) ---
    for _ in range(2, kr + 1):
        omega, prior, trans, means, covs = (
            host(x) for x in (st.h3m.omega, *st.h3m.hmm))
        j = int(np.argmax(omega))
        m1, m2, c_new = _split_gauss(means[j, 0], covs[j, 0])
        omega = np.concatenate([omega, [omega[j] / 2]])
        omega[j] /= 2
        prior = np.concatenate([prior, prior[j:j + 1]], axis=0)
        trans = np.concatenate([trans, trans[j:j + 1]], axis=0)
        means_new, covs_new = means[j:j + 1].copy(), covs[j:j + 1].copy()
        means[j, 0], covs[j, 0] = m1, c_new
        means_new[0, 0], covs_new[0, 0] = m2, c_new
        st = em(omega, prior, trans, np.concatenate([means, means_new]),
                np.concatenate([covs, covs_new]))

    # --- grow S by splitting the most-used state (hem_h3m_c.m:174-218) ---
    for ss in range(2, sr + 1):
        omega, means, covs = (host(x) for x in (st.h3m.omega, st.h3m.hmm.mean,
                                                st.h3m.hmm.cov))
        counts = host(st.emit_counts)
        k = means.shape[0]
        means2 = np.zeros((k, ss, d))
        covs2 = np.tile(np.eye(d), (k, ss, 1, 1))
        for j in range(k):
            mi = int(np.argmax(counts[j]))
            m1, m2, c_new = _split_gauss(means[j, mi], covs[j, mi])
            means2[j, :ss - 1] = means[j]
            covs2[j, :ss - 1] = covs[j]
            means2[j, mi], covs2[j, mi] = m1, c_new
            means2[j, ss - 1], covs2[j, ss - 1] = m2, c_new
        # uniform prior/A after a state split (hem_h3m_c.m:210-213)
        st = em(omega, np.full((k, ss), 1.0 / ss),
                np.full((k, ss, ss), 1.0 / ss), means2, covs2)
    return finalize(st)


def compute_stats(res: VHEMResult, base: H3M, tau: int = 10,
                  smooth: float = 1.0) -> dict:
    """Per-state MANOVA statistics (`vhem_cluster.m:239-266` +
    `hem_hmm_bwd_fwd.m:52-57` / `g3m_stats.m:307-315` second moments):
    normalized emission weights, effective ROI counts, and the
    Z-weighted emission moments — per reduced state, the assignment-
    weighted mean (the learned centre) and the weighted second moment of
    the base means (mu mu^T of the base centres, not mu mu^T + cov).
    NumPy outputs."""
    counts = res.emit_counts.detach().cpu().numpy()            # [Kr, Sr]
    tot_base_rois = int(base.state_mask.sum())
    weights = counts / max(counts.sum(), np.finfo(np.float64).tiny)

    # rerun the pair E-step at the final model to recover sum_t_nu (the
    # reference collects these during the final M-step,
    # hem_h3m_c_step.m:349-380)
    pair = e_step(base, res.h3m, tau, smooth)
    zw = res.z * base.omega[:, None]                           # [Kb, Kr]
    mean_b = base.hmm.mean
    mu2_b = mean_b[..., :, None] * mean_b[..., None, :]        # [Kb,Sb,D,D]
    w_stn = zw[..., None, None] * pair.sum_t_nu                # [i, j, r, b]
    w_sum = torch.sum(w_stn, dim=(0, 3))
    mu2_sum = torch.einsum("ijrb,ibde->jrde", w_stn, mu2_b)
    emit_mu2 = mu2_sum / torch.clamp_min(w_sum, tiny(w_sum.dtype))[
        ..., None, None]
    return {
        "tot_ind_rois": tot_base_rois,
        "emit_vcounts": counts,
        "weights": weights,
        "n_rois": tot_base_rois * weights,
        "emit_mu": res.h3m.hmm.mean.detach().cpu().numpy(),   # [Kr, Sr, D]
        "emit_mu2": emit_mu2.detach().cpu().numpy(),          # [Kr,Sr,D,D]
    }
