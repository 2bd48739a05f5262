"""Float64 re-evaluation of the VBEM and VBHEM bounds on the device: the
counterpart of :mod:`vbhem_tpu.models.rescore`.

When compute is float32, the restarts, the K and the bank's lanes are
picked on the float64 bound of each lane's solution (`vbhmm.py:518-543`,
`batch.py:125-152` of the JAX package), and the (K, S) cells of the VBHEM
grid on the float64 bound of each cell's winner (`vbhem.py:1500-1550`).
The JAX package evaluates both on the host in NumPy, one solution at a
time, because the TPU has no float64.  Here they are this package's own
functions run in float64 on the solutions' device: for VBEM all lanes in
one pass (on the card, the float64 instantiation of kernel B2's fused
E-step); for VBHEM one cell at a time, on the cell's unpadded model, whose
pair recursion is one launch of kernel B3's float64 body on the card.
"""
from __future__ import annotations

import math

import torch

from ..containers import H3M, H3MPosterior, HMMPosterior, SeqBatch, tree_map
from ..ops.pair_estep import expected_pair_ll_variational
from ..ops.pair_estep_cuda import pair_bwd_fwd_auto
from . import vbhem, vbhmm


def vbem_rescore_lanes(batch: SeqBatch, posts: HMMPosterior,
                       hyps: vbhmm.VBHyps) -> torch.Tensor:
    """The 8-term VBEM bound (`vbhmm_em_lb.m:120-257`) in float64 of every
    lane of ``posts`` (lanes [*X, *L] over the data's axes X, as in
    :mod:`.vbhmm`), with one set of hyperparameters or one per lane
    (leaves [*X, *L] and [*X, *L, D], as the hyp path learns them;
    `vbhem_tpu.models.rescore.vbem_rescore_lanes`).  A lane whose bound is
    NaN scores -inf.  Returns float64 [*X, *L] on the lanes' device."""
    vbhmm.check_lengths(batch)
    f64 = torch.float64
    b = SeqBatch(x=batch.x.to(f64), lengths=batch.lengths)
    p = tree_map(lambda a: a.to(f64), posts)
    h = tree_map(lambda a: a.to(f64), hyps)
    fb = vbhmm.e_step(b, p)
    stats = vbhmm.suff_stats(b, fb)
    ll = vbhmm.elbo(b, p, fb, stats, h)
    return torch.where(torch.isnan(ll), torch.full_like(ll, -math.inf), ll)


def _f64(tree):
    return tree_map(lambda a: a.to(torch.float64)
                    if a.is_floating_point() else a, tree)


def pair_ll_elbo_f64(prior_b, trans_b, log_pi, log_a, ell,
                     tau: int) -> torch.Tensor:
    """LL_elbo [Kb, Kr] of the hierarchical backward recursion
    (`vbhem_hmm_bwd_fwd_fast.m:166-257`) in float64 on the inputs' device:
    one launch of kernel B3's float64 body on the card, the plain version
    on the CPU.  prior_b [Kb, Sb], trans_b [Kb, Sb, Sb], log_pi [Kr, Sr],
    log_a [Kr, Sr, Sr], ell [Kb, Kr, Sb, Sr]."""
    f = [a.to(torch.float64) for a in (prior_b, trans_b, log_pi, log_a, ell)]
    return pair_bwd_fwd_auto(*f, tau).ll_elbo


def elbo_f64(base: H3M, post: H3MPosterior, hyps, nv: int, tau: int,
             return_terms: bool = False):
    """The full 10-term VBHEM bound (`vbhemh3m_lb.m:88-186`) in float64
    for an UNPADDED (K, S) model ``post`` of the bank ``base``, with the
    hyperparameters ``hyps`` (a ``VBHEMHyps``), on the model's device: the
    EM loop's own expectations, soft assignments and bound
    (:mod:`.vbhem`) on float64 casts, the data term's recursion one
    launch of kernel B3's float64 body, as in :func:`pair_ll_elbo_f64`.  The
    same bound as :func:`vbhem_tpu.models.rescore.elbo_f64` but for its
    mass floors (+1e-50 there, the smallest normal here).  Returns a
    float; with ``return_terms=True`` also the dict of the ten terms
    (lt1..lt10 in `vbhemh3m_lb.m:88-186` order, before their signs), for
    per-term decomposition of cell differences."""
    base, post, hyps = _f64(base), _f64(post), _f64(hyps)
    exps = vbhem.reduced_expectations(post)
    ell = expected_pair_ll_variational(
        base.hmm.mean, base.hmm.cov, post.niw.m, post.niw.w, post.niw.v,
        post.niw.beta, exps.log_lam)                      # [Kb, Kr, Sb, Sr]
    pair = pair_bwd_fwd_auto(base.hmm.prior, base.hmm.trans, exps.log_pi,
                             exps.log_a, ell, tau)
    tilde_n = (nv * base.num_hmms) * base.omega
    soft = vbhem.soft_assignments(tilde_n, exps.log_omega, pair.ll_elbo)
    total, terms = vbhem.elbo(post, exps, pair, *soft, hyps,
                              return_terms=True)
    if return_terms:
        return float(total), {k: float(t) for k, t in terms.items()}
    return float(total)
