"""Job kind 'bank': learning one HMM per subject for the whole bank by
``batch.learn_bank`` (the GMM starts, the lanes' EM, the float64 restart
pick and the per-subject results), and how its answer is judged.

Job ``j`` of a run with ``--seed n`` learns its own dataset, sampled on
the device from ``derive_seed(n, 1, j)`` (``lib/data.draw_sequences``),
and hands the program a generator seeded with ``derive_seed(n, 2, j)``
for its restarts.  The warm job is ``j = -1``.

The numbers compared, each the largest over the subjects of an answer:

* ``bound_gap``: the program's float32 EM bound of a subject's model
  against the reference's bound of the same model (kernel B2's fused
  E-step, the statistics, M-step and bound);
* ``stationarity``: how far one reference EM iteration moves the bound
  from the model;
* ``pick_gap``, over ``PICK_SUBJECTS`` subjects drawn from the seed: how
  far the program's model falls below the best of the subject's restarts
  rerun by the reference: each restart's GMM start restated from the
  uniforms the program drew (``reference/starts.py``), the reference's
  float64 EM to convergence, the bound at each final model.  It holds the
  starts and the float64 restart pick.

The control puts the reference in the program's place one step below
the stated precision: each subject's EM step and bound in bfloat16 from
the program's model, and the sampled subjects' restarts started and run
in bfloat16 and picked on float32 bounds.
"""
from __future__ import annotations

import copy
import math

import torch

from ..lib import data
from ..lib.judge import shortfall
from ..lib.timed import cfg_value, timed
from ..reference import starts as rstarts
from ..reference import vbem as rvbem

F64 = torch.float64
PICK_SUBJECTS = 256
BLOCK = 2048


class Job:
    """Constructing it is the set-up; ``run(j)`` samples job ``j``'s
    dataset and runs the program on it once."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from vbhem_tpu_torch.config import VBConfig
        self.config = config
        self.seed = seed
        self.device = device
        self.dtype = getattr(torch, config["dtype"])
        vb = dict(config["vbem"])
        self.k = vb.pop("k")
        self.vbem = VBConfig(**{k: cfg_value(v) for k, v in vb.items()})

    def inputs(self, index: int):
        """Job ``index``'s dataset: (x [S, N, T, D], lengths [S, N])."""
        gen = data.generator(data.derive_seed(self.seed, 1, index),
                             self.device)
        d = self.config["data"]
        return data.draw_sequences(gen, self.config["groups"],
                                   self.config["subjects"],
                                   d["seqs_per_subject"], d["seq_len"],
                                   d["noise"], self.device, self.dtype)

    def run(self, index: int):
        from vbhem_tpu_torch.containers import SeqBatch
        from vbhem_tpu_torch.models import batch as vbem_batch
        x, lengths = self.inputs(index)
        rseed = data.derive_seed(self.seed, 2, index)
        gen = data.generator(rseed, self.device)

        def job():
            batches = [SeqBatch(x=x[i], lengths=lengths[i])
                       for i in range(x.shape[0])]
            return vbem_batch.learn_bank(gen, batches, self.k, self.vbem)

        (results, info), seconds, peak, counts = timed(job)
        s, n, t, d = x.shape
        work = {"subjects": s, "restarts": self.vbem.numtrials, "n": n,
                "t": t, "d": d, "k": self.k, "itemsize": x.element_size(),
                "em_iters": int(info["model_em_iters"])}
        answer = {"index": index, "x": x, "lengths": lengths,
                  "restart_seed": rseed, "results": results, "info": info}
        return answer, {"seconds": seconds, "peak_bytes": peak,
                        "counters": counts, "work": work}


# --------------------------------------------------------------------------
# the comparison
# --------------------------------------------------------------------------

def _vec(v, dim: int) -> tuple:
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * dim


def ref_hyps(cfg: dict, dim: int) -> rvbem.Hyps:
    """The prior of the configuration file's ``vbem`` group."""
    return rvbem.Hyps(alpha0=cfg["alpha0"], epsilon0=cfg["epsilon0"],
                      beta0=cfg["beta0"], v0=cfg["v0"],
                      m0=_vec(cfg["mu0"], dim), w0=_vec(cfg["w0"], dim))


def _mask(answer):
    x, lengths = answer["x"], answer["lengths"]
    return torch.arange(x.shape[2], device=x.device) < lengths[..., None]


def picked_subjects(job, answer) -> torch.Tensor:
    """The subjects whose restarts the reference reruns, drawn from the
    run's seed and the job's index."""
    s = answer["x"].shape[0]
    gen = torch.Generator().manual_seed(
        data.derive_seed(job.seed, 3, answer["index"]))
    return torch.sort(torch.randperm(s, generator=gen)[:PICK_SUBJECTS]).values


def outputs(job, answer) -> dict:
    """Every subject's model and float32 EM bound, stacked; the sampled
    subjects' models as their restart picks."""
    res = answer["results"]
    post = rvbem.Post(*(torch.stack([getattr(r.post, f) for r in res])
                        for f in ("alpha", "epsilon")),
                      *(torch.stack([getattr(r.post.niw, f) for r in res])
                        for f in ("beta", "v", "m", "w")))
    sub = picked_subjects(job, answer).to(post.alpha.device)
    return {"post": post, "bound": torch.stack([r.ll for r in res]),
            "pick_post": rvbem.Post(*(a[sub] for a in post))}


def rerun(job, answer, dtype, pick_dtype) -> rvbem.Post:
    """The sampled subjects' restarts run by the reference in ``dtype``
    from the GMM starts that the program's uniforms give; each subject's
    final model that the bound in ``pick_dtype`` ranks first."""
    cfg = job.config["vbem"]
    x, lengths = answer["x"], answer["lengths"]
    s, n, t, d = x.shape
    restarts = 1 if job.k == 1 else cfg["numtrials"]
    gen = data.generator(answer["restart_seed"], job.device)
    sub = picked_subjects(job, answer).to(x.device)
    u = rstarts.gmm_draws(gen, s, restarts, n * t)[sub.to(gen.device)]
    xs = x[sub].to(dtype)
    ms = _mask(answer)[sub]
    w_pt = ms.flatten(1).to(dtype)
    weight, mean, cov = rstarts.gmm(xs.flatten(1, 2), w_pt, u, job.k)
    del u
    hyps = ref_hyps(cfg, d)
    post0 = rstarts.vbem_start(weight, mean, cov,
                               torch.sum(w_pt, -1)[:, None], hyps)
    b = len(sub)
    post0 = rvbem.Post(*(a.reshape((b * restarts,) + a.shape[2:])
                         for a in post0))
    xl = xs.repeat_interleave(restarts, 0)
    ml = ms.repeat_interleave(restarts, 0)
    post = rvbem.em(xl, ml, post0, hyps, cfg["max_iter"], cfg["min_diff"])
    e, _ = rvbem.iteration(xl.to(pick_dtype), ml,
                           rvbem.cast(post, pick_dtype), hyps)
    e = torch.nan_to_num(e.to(F64), nan=-math.inf).reshape(b, restarts)
    best = torch.argmax(e, 1) + torch.arange(b, device=e.device) * restarts
    return rvbem.Post(*(a[best] for a in post))


def control(job, answer) -> dict:
    """The reference in the program's place: each subject's EM step and
    bound in bfloat16 from the program's model, and the sampled subjects'
    restarts started and run in bfloat16, picked on float32 bounds."""
    out = outputs(job, answer)
    hyps = ref_hyps(job.config["vbem"], out["post"].m.shape[-1])
    x, mask = answer["x"], _mask(answer)
    posts, bounds = [], []
    for a in range(0, x.shape[0], BLOCK):
        p = rvbem.Post(*(t[a:a + BLOCK] for t in out["post"]))
        b_low, p_low = rvbem.iteration(x[a:a + BLOCK].to(torch.bfloat16),
                                       mask[a:a + BLOCK],
                                       rvbem.cast(p, torch.bfloat16), hyps)
        posts.append(rvbem.cast(p_low, torch.float32))
        bounds.append(b_low.float())
    return {"post": rvbem.Post(*(torch.cat(a) for a in zip(*posts))),
            "bound": torch.cat(bounds),
            "pick_post": rerun(job, answer, torch.bfloat16, torch.float32)}


def readings(job, answer, outs=None) -> dict:
    """The numbers compared for one answer; ``outs`` in place of the
    program's answer for the control."""
    out = outs or outputs(job, answer)
    hyps = ref_hyps(job.config["vbem"], out["post"].m.shape[-1])
    x, mask = answer["x"], _mask(answer)
    bound = station = 0.0
    for a in range(0, x.shape[0], BLOCK):
        p = rvbem.cast(rvbem.Post(*(t[a:a + BLOCK] for t in out["post"])),
                       F64)
        xb = x[a:a + BLOCK].to(F64)
        e0, p1 = rvbem.iteration(xb, mask[a:a + BLOCK], p, hyps)
        e1, _ = rvbem.iteration(xb, mask[a:a + BLOCK], p1, hyps)
        prog = out["bound"][a:a + BLOCK].to(F64)
        gap = torch.abs(prog - e0) / torch.abs(e0)
        st = torch.abs(e1 - e0) / torch.abs(e0)
        bound = max(bound, float(torch.max(torch.nan_to_num(
            gap, nan=math.inf))))
        station = max(station, float(torch.max(torch.nan_to_num(
            st, nan=math.inf))))
    sub = picked_subjects(job, answer).to(x.device)
    xs, ms = x[sub].to(F64), mask[sub]
    e_pick, _ = rvbem.iteration(xs, ms, rvbem.cast(out["pick_post"], F64),
                                hyps)
    e_best, _ = rvbem.iteration(xs, ms, rerun(job, answer, F64, F64), hyps)
    pick = max(shortfall(g, b) for g, b in zip(e_pick.tolist(),
                                               e_best.tolist()))
    return {"bound_gap": bound, "stationarity": station, "pick_gap": pick}


# --------------------------------------------------------------------------
# the harness's CPU tests: a size the CPU runs in seconds, and faults
# --------------------------------------------------------------------------

def tiny(config: dict) -> dict:
    """The configuration at a size the CPU runs in a few seconds."""
    cfg = copy.deepcopy(config)
    cfg["subjects"] = 16
    cfg["vbem"].update(numtrials=6)
    cfg["data"].update(seqs_per_subject=5, seq_len=10)
    return cfg


def _state_unchanged(mp):
    from vbhem_tpu_torch.models import vbhmm
    step = vbhmm._iteration

    def unchanged(batch, post, *a, **k):
        _, *rest = step(batch, post, *a, **k)
        return (post, *rest)
    mp.setattr(vbhmm, "_iteration", unchanged)


def _half_batch(mp):
    from vbhem_tpu_torch.models import vbhmm
    stats = vbhmm.suff_stats

    def half(batch, fb):
        n = fb.gamma.shape[-3]
        gamma, xi = fb.gamma.clone(), fb.xi_sum.clone()
        gamma[..., n // 2:, :, :] = 0.0
        xi[..., n // 2:, :, :] = 0.0
        return stats(batch, fb._replace(gamma=2.0 * gamma, xi_sum=2.0 * xi))
    mp.setattr(vbhmm, "suff_stats", half)


def _altered_bound(mp):
    from vbhem_tpu_torch.models import vbhmm
    fin = vbhmm.finalize

    def altered(batch, st):
        res = fin(batch, st)
        return res._replace(ll=res.ll * (1.0 + 1e-2))
    mp.setattr(vbhmm, "finalize", altered)


def _worst_restart(mp):
    from vbhem_tpu_torch.models import batch
    score = batch.vbem_rescore_lanes

    def worst(*a, **k):
        return -torch.nan_to_num(score(*a, **k), nan=-math.inf)
    mp.setattr(batch, "vbem_rescore_lanes", worst)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "altered_bound": _altered_bound, "worst_restart": _worst_restart}
