"""Job kind 'grid': one (K, S)-grid clustering of a bank of subject HMMs
by ``vbhem.cluster_batched`` over the configuration's grid, restarts and
VBHEM settings (the starts, EM over every lane chunk, the float64
rescoring of each cell's winner and the selection), and how its answer is
judged.

Job ``j`` of a run with ``--seed n`` clusters its own bank, drawn on the
device from ``derive_seed(n, 1, j)`` (``lib/data.draw_bank``), and hands
the program a generator seeded with ``derive_seed(n, 2, j)`` for its
restarts.  The warm job is ``j = -1``.

The numbers compared, each the largest over the cells of an answer:

* ``rescore_gap``: the program's float64 score of a cell's winner against
  the reference's bound of the same model;
* ``bound_gap``: the program's float32 EM bound against it (the EM
  iteration, kernel B1's ll_elbo, the soft assignments, the bound);
* ``stationarity``: how far one reference EM iteration moves the bound
  from the model: the program's converged answer is a fixed point of the
  reference's EM only where its E-step, statistics and M-step are the
  reference's;
* ``selection``: 1 where the program's (K, S) is not the one the
  reference's two-stage rule picks from its own scores;
* ``pick_gap``: how far the program's model of a cell falls below the
  best of that cell's restarts rerun by the reference, over the selected
  cell and every cell of K <= 2 and S <= 2 (``pick_cells``; larger cells
  cost the reference too long): each restart's start restated from the
  uniforms the program drew (``reference/starts.py``: baseem, wtkmeans),
  the reference's float64 EM to convergence, the bound at each final
  model.  It holds the starts and the restart pick, which the other
  numbers, read at the winners, cannot.

The control puts the reference in the program's place one step below
the stated precision: at the program's answers each cell's EM step and
bound in bfloat16 and its score in float32; and for the selected cell
the restarts' starts and EM in bfloat16, picked on float32 bounds.
"""
from __future__ import annotations

import copy
import math

import numpy as np
import torch

from ..lib import data
from ..lib.judge import rel, shortfall
from ..lib.timed import cfg_value, timed
from ..reference import starts as rstarts
from ..reference import vbhem as rvbhem

F64 = torch.float64


class Job:
    """Constructing it is the set-up; ``run(j)`` draws job ``j``'s bank
    and runs the program on it once."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from vbhem_tpu_torch.config import VBHEMConfig
        self.config = config
        self.seed = seed
        self.device = device
        self.dtype = getattr(torch, config["dtype"])
        self.ks, self.ss = config["grid"]["k"], config["grid"]["s"]
        self.vbhem = VBHEMConfig(**{k: cfg_value(v) for k, v in
                                    config["vbhem"].items()})

    def inputs(self, index: int):
        """Job ``index``'s bank: (omega, prior, trans, mean, cov, mask)."""
        gen = data.generator(data.derive_seed(self.seed, 1, index),
                             self.device)
        return data.draw_bank(gen, self.config["groups"],
                              self.config["subjects"],
                              self.config["grid_bank"], self.device,
                              self.dtype)

    def run(self, index: int):
        from vbhem_tpu_torch.containers import H3M, HMM
        from vbhem_tpu_torch.models import vbhem
        bank = self.inputs(index)
        omega, prior, trans, mean, cov, mask = bank
        base = H3M(omega=omega, hmm=HMM(prior=prior, trans=trans, mean=mean,
                                        cov=cov), state_mask=mask)
        rseed = data.derive_seed(self.seed, 2, index)
        gen = data.generator(rseed, self.device)
        (_, info), seconds, peak, counts = timed(
            lambda: vbhem.cluster_batched(gen, base, self.ks, self.ss,
                                          self.vbhem))
        cells = [(k, s) for k in self.ks for s in self.ss
                 for _ in range(self.vbhem.trials)]
        step = info["grid_trial_chunk"] or len(cells)
        lanes = [min(step, len(cells) - a) for a in range(0, len(cells),
                                                           step)]
        iters = list(info["grid_chunk_iters"])
        kb, sb = mask.shape
        work = {"kb": kb, "sb": sb, "d": mean.shape[-1],
                "kmax": max(self.ks), "smax": max(self.ss),
                "tau": self.vbhem.tau, "itemsize": mean.element_size(),
                "lane_cells": cells, "chunk": info["grid_trial_chunk"],
                "chunk_iters": iters, "em_iters": int(sum(iters)),
                "lane_iters": int(sum(n * i for n, i in zip(lanes, iters)))}
        answer = {"index": index, "bank": bank, "restart_seed": rseed,
                  "info": info}
        return answer, {"seconds": seconds, "peak_bytes": peak,
                        "counters": counts, "work": work}


# --------------------------------------------------------------------------
# the comparison
# --------------------------------------------------------------------------

def ref_bank(answer, dtype=F64) -> rvbhem.Bank:
    omega, prior, trans, mean, cov, _ = answer["bank"]
    return rvbhem.Bank(*(a.to(dtype) for a in (omega, prior, trans, mean,
                                               cov)))


def _vec(v, dim: int) -> tuple:
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * dim


def ref_hyps(cfg: dict, dim: int) -> rvbhem.Hyps:
    """The prior of the configuration file's ``vbhem`` group."""
    return rvbhem.Hyps(alpha0=cfg["alpha0"], eta0=cfg["eta0"],
                       epsilon0=cfg["epsilon0"], lambda0=cfg["lambda0"],
                       v0=cfg["v0"], m0=_vec(cfg["m0"], dim),
                       w0=_vec(cfg["w0"], dim))


def _corr(k: int, s: int) -> float:
    return math.lgamma(k + 1) + math.lgamma(s + 1)


def pick_cells(ks, ss, best) -> list:
    """The cells whose restarts the reference reruns."""
    cells = [(k, s) for k in ks for s in ss if k <= 2 and s <= 2]
    return cells + [tuple(best)] if tuple(best) not in cells else cells


def outputs(job, answer) -> dict:
    """The program's answer: per cell its model, its float32 EM bound and
    its float64 score (both without the lgamma corrections), the selected
    (K, S), and the models of ``pick_cells`` as their restart picks."""
    info = answer["info"]
    cells = {}
    for ki, k in enumerate(info["model_k"]):
        for si, s in enumerate(info["model_s"]):
            p = info["model_all"][(k, s)].post
            cells[(k, s)] = {
                "post": rvbhem.Post(p.alpha, p.eta, p.epsilon, p.niw.beta,
                                    p.niw.v, p.niw.m, p.niw.w),
                "bound": float(info["model_ll_device"][ki, si]) - _corr(k, s),
                "score": float(info["model_ll"][ki, si]) - _corr(k, s)}
    best = (int(info["model_best_k"]), int(info["model_best_s"]))
    ks, ss = list(info["model_k"]), list(info["model_s"])
    return {"cells": cells, "best": best, "ks": ks, "ss": ss,
            "picks": {c: cells[c]["post"] for c in pick_cells(ks, ss,
                                                              best)}}


def rerun(job, answer, cell, dtype, pick_dtype):
    """The restarts of ``cell`` run by the reference in ``dtype`` from the
    starts that the program's uniforms give; returns the final model that
    the bound in ``pick_dtype`` ranks first, and that bound."""
    cfg = job.config["vbhem"]
    k, s = cell
    trials = cfg["trials"]
    order = [(a, b) for a in job.ks for b in job.ss]
    ci = order.index(tuple(cell))
    bank = ref_bank(answer, dtype)
    mask = answer["bank"][-1]
    hyps = ref_hyps(cfg, bank.mean.shape[-1])
    gen = data.generator(answer["restart_seed"], job.device)
    start = rstarts.vbhem_starts(
        cfg["initmode"], gen, bank, mask, hyps, cfg["nv"], max(job.ks),
        max(job.ss), len(order) * trials,
        slice(ci * trials, (ci + 1) * trials), job.dtype)
    start = rstarts.slice_post(start, k, s)
    block = rvbhem.lane_block(bank, k, s, cfg["tau"],
                              torch.finfo(dtype).bits // 8)
    best, best_e = None, -math.inf
    bank_p = ref_bank(answer, pick_dtype)
    for a in range(0, trials, block):
        post = rvbhem.em(bank, rvbhem.Post(*(x[a:a + block] for x in start)),
                         hyps, cfg["nv"], cfg["tau"], cfg["max_iter"],
                         cfg["min_diff"])
        post_p = rvbhem.cast(post, pick_dtype)
        e, _ = rvbhem.iteration(bank_p, post_p, hyps, cfg["nv"], cfg["tau"])
        e = torch.nan_to_num(e.to(F64), nan=-math.inf)
        i = int(torch.argmax(e))
        if float(e[i]) > best_e or best is None:
            best_e = float(e[i])
            best = rvbhem.Post(*(x[i] for x in post))
        del post, post_p
    return best, best_e


def control(job, answer) -> dict:
    """The reference in the program's place: each cell's EM step and
    bound in bfloat16 and its score in float32 from the program's model,
    and the selected cell's restarts started, run and picked one step
    below the program."""
    out = outputs(job, answer)
    bank = ref_bank(answer)
    cfg = job.config["vbhem"]
    hyps = ref_hyps(cfg, bank.mean.shape[-1])
    low, mid = torch.bfloat16, torch.float32
    scores = np.full((len(out["ks"]), len(out["ss"])), -np.inf)
    for (k, s), c in out["cells"].items():
        b_low, post_low = rvbhem.iteration(rvbhem.cast(bank, low),
                                           rvbhem.cast(c["post"], low),
                                           hyps, cfg["nv"], cfg["tau"])
        post32 = rvbhem.cast(post_low, mid)
        s32, _ = rvbhem.iteration(rvbhem.cast(bank, mid), post32, hyps,
                                  cfg["nv"], cfg["tau"])
        c.update(post=post32, bound=float(b_low), score=float(s32))
        scores[out["ks"].index(k), out["ss"].index(s)] = (
            float(s32) + _corr(k, s))
    out["best"] = rvbhem.select(scores, out["ks"], out["ss"])
    out["picks"] = {c: rerun(job, answer, c, low, mid)[0]
                    for c in out["picks"]}
    return out


def readings(job, answer, outs=None) -> dict:
    """The numbers compared for one answer (see the module's docstring);
    ``outs`` in place of the program's answer for the control."""
    out = outs or outputs(job, answer)
    bank = ref_bank(answer)
    cfg = job.config["vbhem"]
    hyps = ref_hyps(cfg, bank.mean.shape[-1])
    nv, tau = cfg["nv"], cfg["tau"]
    ref = np.full((len(out["ks"]), len(out["ss"])), -np.inf)
    rescore = bound = station = 0.0
    for (k, s), c in out["cells"].items():
        post = rvbhem.cast(c["post"], F64)
        e0, post1 = rvbhem.iteration(bank, post, hyps, nv, tau)
        e1, _ = rvbhem.iteration(bank, post1, hyps, nv, tau)
        e0, e1 = float(e0), float(e1)
        rescore = max(rescore, rel(c["score"], e0))
        bound = max(bound, rel(c["bound"], e0))
        station = max(station, rel(e1, e0))
        ref[out["ks"].index(k), out["ss"].index(s)] = e0 + _corr(k, s)
    picked = tuple(int(v) for v in out["best"])
    want = tuple(int(v) for v in rvbhem.select(ref, out["ks"], out["ss"]))
    pick = 0.0
    for cell, post in out["picks"].items():
        e_pick, _ = rvbhem.iteration(bank, rvbhem.cast(post, F64), hyps, nv,
                                     tau)
        _, e_best = rerun(job, answer, cell, F64, F64)
        pick = max(pick, shortfall(e_pick, e_best))
    return {"rescore_gap": rescore, "bound_gap": bound,
            "stationarity": station, "selection": float(picked != want),
            "pick_gap": pick}


# --------------------------------------------------------------------------
# the harness's CPU tests: a size the CPU runs in seconds, and faults
# --------------------------------------------------------------------------

def tiny(config: dict) -> dict:
    """The configuration at a size the CPU runs in a few seconds."""
    cfg = copy.deepcopy(config)
    cfg["subjects"] = 16
    cfg["grid"] = {"k": [1, 2], "s": [1, 2]}
    cfg["vbhem"].update(trials=8, tau=5)
    return cfg


def _state_unchanged(mp):
    from vbhem_tpu_torch.models import vbhem
    step = vbhem._em_iteration

    def unchanged(base, post, *a, **k):
        _, *rest = step(base, post, *a, **k)
        return (post, *rest)
    mp.setattr(vbhem, "_em_iteration", unchanged)


def _half_bank(mp):
    from vbhem_tpu_torch.models import vbhem
    agg = vbhem.aggregate_stats

    def half(base, pair, z_ni, nj, group=None):
        kb = z_ni.shape[-2]
        z = z_ni.clone()
        z[..., kb // 2:, :] = 0.0
        return agg(base, pair, 2.0 * z, nj, group)
    mp.setattr(vbhem, "aggregate_stats", half)


def _altered_score(mp):
    from vbhem_tpu_torch.models import rescore
    f64 = rescore.elbo_f64

    def altered(*a, **k):
        return f64(*a, **k) * (1.0 + 1e-6)
    mp.setattr(rescore, "elbo_f64", altered)


def _worst_restart(mp):
    from vbhem_tpu_torch.containers import tree_map
    from vbhem_tpu_torch.models import vbhem
    fit = vbhem.fit_grid_batched

    def worst(*a, **k):
        states, *rest = fit(*a, **k)
        ll = torch.nan_to_num(states.ll, nan=math.inf)
        pick = torch.argmin(ll, dim=1)                  # [n_cells]
        cells = torch.arange(ll.shape[0], device=ll.device)

        def keep(x):
            w = x[cells, pick][:, None]
            return w.expand(x.shape).clone()
        return (tree_map(keep, states), *rest)
    mp.setattr(vbhem, "fit_grid_batched", worst)


FAULTS = {"state_unchanged": _state_unchanged, "half_bank": _half_bank,
          "altered_score": _altered_score, "worst_restart": _worst_restart}
