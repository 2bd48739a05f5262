"""Readers of a ragged bank's job (job kind 'bank_select'): kernel B2's
bound counted on the real trials and fixations alone, the share of the
launched step slots that padding took, and the EM iterations checked
against B2's launches.

The bound is ``bounds.b2_fused_bound``'s arithmetic restated for a bank
whose subjects have different numbers of sequences and steps: padding
counts as no work, so a kernel that skipped it would read nearer its
bound.
"""
from __future__ import annotations

from . import bounds, spans
from .layers import B2, _is_double


def b2_bound_real(subjects: int, restarts: int, k: int, d: int,
                  itemsize: int, real_steps: int, real_seqs: int,
                  mask_bytes: int) -> dict:
    """One fused B2 launch at K over ``subjects`` x ``restarts`` lanes,
    counting only the bank's ``real_steps`` fixations in ``real_seqs``
    trials: x read once per subject (D values a fixation), the mask's bits
    of the real trials, each lane's emission constants and scores; the
    masked log_rho and gamma written once a real fixation and lane, xi_sum
    and phi_norm once a real trial and lane.  Operations: K exp and one
    log a fixation and lane, the exp of the scores, 10 K^2 flops and the
    emission's K (D + 2 D^2 + 1) a fixation and lane."""
    lanes = subjects * restarts
    log_pz1, log_trans = lanes * k, lanes * k * k
    emis = lanes * k * (1 + d + d * d)
    steps = real_steps * restarts
    n_bytes = (itemsize * (real_steps * d + emis + log_pz1 + log_trans
                           + 2 * steps * k + restarts * real_seqs
                           * (k * k + 1))
               + mask_bytes)
    sfu = steps * (k + 1) + log_pz1 + log_trans
    flop = steps * (10 * k * k + k * (d + 2 * d * d + 1))
    return bounds.bound(n_bytes, sfu, flop, itemsize)


def b2_roofline_real(ctx):
    """B2's share (%) of its bound over the traced job's float32 fused
    launches, one a lane EM iteration of each K's loop, each at the bound
    of the real trials at its K, against their device time."""
    if ctx.trace is None:
        return None
    w = ctx.traced["work"]
    n, secs = ctx.trace.kernel_time_s(
        lambda name: B2 in name and not _is_double(name))
    if n == 0 or n != sum(w["k_iters"]):
        return None
    bound_ms = sum(
        it * b2_bound_real(w["subjects"], lanes, k, w["d"], w["itemsize"],
                           w["real_steps"], w["real_seqs"],
                           w["mask_bytes"])["bound_ms"]
        for k, lanes, it in zip(w["ks"], w["restarts"], w["k_iters"]))
    return 100.0 * bound_ms / 1e3 / secs


def pad_share(ctx):
    """100 x the step slots the EM loops launched that padding took (the
    program's counters ``learn_bank.steps_launched`` and
    ``learn_bank.steps_valid``, over every K's restarts)."""
    tree = spans.root_tree(ctx, "learn_bank")
    if tree is None:
        return None
    counters = tree[2].counters
    launched = counters.get("learn_bank.steps_launched", 0)
    if launched <= 0:
        return None
    valid = counters.get("learn_bank.steps_valid", 0)
    return 100.0 * (launched - valid) / launched


def em_iters(ctx):
    """EM iterations per job over every K's loop, each one launch of B2's
    fused entry, checked equal to those launches less one float64 pick a K
    in float32 runs; a job that fails the check gives no reading."""
    if not ctx.jobs:
        return None
    for job in ctx.jobs:
        w = job["work"]
        picks = len(w["ks"]) if w["itemsize"] == 4 else 0
        if job["counters"]["B2_fused"] != w["em_iters"] + picks:
            return None
    return sum(j["work"]["em_iters"] for j in ctx.jobs) / len(ctx.jobs)
