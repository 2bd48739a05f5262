"""Job kind 'bank_select': the face demo's first stage for a whole bank of
ragged viewers by one ``batch.learn_bank`` call over a list of K (the GMM
starts, one EM loop a K over the padded bank, the float64 restart pick, the
selection of each viewer's K by bound + lgamma(K+1) and the per-viewer
results), and how its answer is judged.

Job ``j`` of a run with ``--seed n`` learns its own viewers, drawn on the
device from ``derive_seed(n, 1, j)``: each viewer's HMM as
``lib/data.draw_bank`` draws one (1-3 of its group's states), its number
of trials and each trial's number of fixations uniform in the
configuration's ranges, the fixations sampled from its HMM.  The program
gets one ``SeqBatch`` a viewer, of its own shape, and a generator seeded
with ``derive_seed(n, 2, j)`` for its restarts.  The warm job is
``j = -1``.

The numbers compared, each the worst over the viewers of an answer and
each read by the reference on the viewer's real trials alone
(``reference/select.py``):

* ``bound_gap``: the program's float32 EM bound of a viewer's model
  against the reference's bound of the same model;
* ``stationarity``: how far one reference EM iteration moves that bound;
* ``selection``: the viewers whose K is not the one the reference picks
  by bound + lgamma(K+1) over the program's own per-K winners (an exact
  count);
* ``pick_gap``, over ``PICK_SUBJECTS`` viewers drawn from the seed: how
  far the program's model (bound + lgamma(K+1)) falls below the best over
  every K's restarts rerun by the reference from the starts restated from
  the program's uniforms, in float64 to convergence, picked on the bound
  at each final model.  It holds the starts, the restart pick and the
  selection.

The control puts the reference in the program's place one step below the
stated precision: each viewer's K picked on bfloat16 bounds of the
program's per-K winners, its EM step and bound in bfloat16 (both about
the viewer's mean, as the program takes its moments), and the sampled
viewers' restarts started and run in bfloat16, picked on float32 bounds.
"""
from __future__ import annotations

import copy
import math
import types

import torch

from ..lib import data
from ..lib.judge import shortfall
from ..lib.timed import cfg_value, timed
from ..reference import select as rselect
from ..reference import vbem as rvbem
from .bank import ref_hyps

F64 = torch.float64
PICK_SUBJECTS = 256


def draw_viewers(gen, config: dict, device, dtype):
    """One job's viewers: (x [S, N, T, D] with zeros past each trial's end,
    lengths [S, N] int32 with 0 for a viewer's absent trials, each viewer's
    trial count and longest trial as lists).  N and T are the most trials
    and fixations any viewer has: the layout of the program's padded
    bank."""
    s = config["subjects"]
    (n_lo, n_hi), (t_lo, t_hi) = (config["trials"]["per_viewer"],
                                  config["trials"]["fixations"])
    _, prior, trans, mean, cov, _ = data.draw_bank(
        gen, config["groups"], s, config["viewer_hmm"], device, F64)
    n_trials = torch.randint(n_lo, n_hi + 1, (s,), generator=gen,
                             device=device)
    lengths = torch.randint(t_lo, t_hi + 1, (s, n_hi), generator=gen,
                            device=device)
    present = torch.arange(n_hi, device=device) < n_trials[:, None]
    lengths = torch.where(present, lengths, 0).to(torch.int32)
    rows = torch.arange(s, device=device)[:, None]
    z = data._categorical(gen, prior[:, None, :].expand(s, n_hi, -1))
    states = [z]
    for _ in range(1, t_hi):
        z = data._categorical(gen, trans[rows, z])
        states.append(z)
    z = torch.stack(states, dim=-1)                            # [S, N, T]
    d = mean.shape[-1]
    eps = torch.randn(z.shape + (d,), generator=gen, device=device,
                      dtype=F64)
    rows = rows[..., None]
    x = mean[rows, z] + torch.einsum(
        "...de,...e->...d", torch.linalg.cholesky(cov)[rows, z], eps)
    mask = torch.arange(t_hi, device=device) < lengths[..., None]
    x = torch.where(mask[..., None], x, 0.0)
    n_trials, t_longest = (n_trials.tolist(),
                           torch.max(lengths, dim=-1).values.tolist())
    # the program's padded bank holds as many trials and steps as the
    # largest viewer; the start uniforms are laid out on it
    n_used, t_used = max(n_trials), max(t_longest)
    return (x[:, :n_used, :t_used].to(dtype), lengths[:, :n_used],
            n_trials, t_longest)


class Job:
    """Constructing it is the set-up; ``run(j)`` draws job ``j``'s viewers
    and runs the program on them once."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from vbhem_tpu_torch.config import VBConfig
        self.config = config
        self.seed = seed
        self.device = device
        self.dtype = getattr(torch, config["dtype"])
        vb = dict(config["vbem"])
        self.ks = list(vb.pop("k"))
        self.vbem = VBConfig(**{k: cfg_value(v) for k, v in vb.items()})
        self.restarts = [1 if k == 1 else self.vbem.numtrials
                         for k in self.ks]

    def inputs(self, index: int):
        gen = data.generator(data.derive_seed(self.seed, 1, index),
                             self.device)
        return draw_viewers(gen, self.config, self.device, self.dtype)

    def run(self, index: int):
        from vbhem_tpu_torch.containers import SeqBatch
        from vbhem_tpu_torch.models import batch as vbem_batch
        x, lengths, n_trials, t_longest = self.inputs(index)
        rseed = data.derive_seed(self.seed, 2, index)
        gen = data.generator(rseed, self.device)

        def job():
            batches = [SeqBatch(x=x[i, :n, :t], lengths=lengths[i, :n])
                       for i, (n, t) in enumerate(zip(n_trials, t_longest))]
            return vbem_batch.learn_bank(gen, batches, self.ks, self.vbem)

        (results, info), seconds, peak, counts = timed(job)
        s, n, t, d = x.shape
        work = {"subjects": s, "ks": self.ks, "restarts": self.restarts,
                "d": d, "itemsize": x.element_size(),
                "k_iters": [i["model_em_iters"] for i in info["model_infos"]],
                "em_iters": int(info["model_em_iters"]),
                "real_steps": int(torch.sum(lengths)),
                "real_seqs": int(torch.sum(lengths > 0)),
                "mask_bytes": int(torch.sum((lengths + 7) // 8))}
        answer = {"index": index, "x": x, "lengths": lengths,
                  "restart_seed": rseed, "results": results, "info": info}
        return answer, {"seconds": seconds, "peak_bytes": peak,
                        "counters": counts, "work": work}


# --------------------------------------------------------------------------
# the comparison
# --------------------------------------------------------------------------

def _post(p) -> rvbem.Post:
    """The program's posterior (HMMPosterior) as the reference's."""
    return rvbem.Post(p.alpha, p.epsilon, p.niw.beta, p.niw.v, p.niw.m,
                      p.niw.w)


def _stack(posts) -> rvbem.Post:
    return rvbem.Post(*(torch.stack(a) for a in zip(*posts)))


def picked_subjects(job, answer) -> torch.Tensor:
    """The viewers whose restarts the reference reruns, drawn from the
    run's seed and the job's index."""
    s = answer["x"].shape[0]
    gen = torch.Generator().manual_seed(
        data.derive_seed(job.seed, 3, answer["index"]))
    return torch.sort(torch.randperm(s, generator=gen)[:PICK_SUBJECTS]).values


def _by_k(ks, k_of, posts_of) -> dict:
    """{K: (rows whose K it is, their posteriors stacked)} from each row's
    K and a function giving the posterior of a list of rows at one K."""
    out = {}
    for k in ks:
        rows = [i for i, q in enumerate(k_of) if q == k]
        if rows:
            out[k] = (torch.as_tensor(rows), posts_of(k, rows))
    return out


def outputs(job, answer) -> dict:
    """What the program answered: each viewer's K (``k``), its model
    (``sel``: {K: (viewers, posteriors)}) and float32 bound; each K's
    winners for every viewer (``winners``); the sampled viewers' models
    (``pick``: {K: (positions among them, posteriors)})."""
    res, info = answer["results"], answer["info"]
    k_of = [int(r.post.alpha.shape[-1]) for r in res]
    sel = _by_k(job.ks, k_of,
                lambda k, rows: _stack([_post(res[i].post) for i in rows]))
    sub = picked_subjects(job, answer).tolist()
    pick = _by_k(job.ks, [k_of[i] for i in sub], lambda k, rows: _stack(
        [_post(res[sub[i]].post) for i in rows]))
    return {"k": k_of, "sel": sel, "pick": pick,
            "bound": torch.stack([r.ll for r in res]),
            "winners": [_post(r.post) for r in info["model_all"]]}


def control(job, answer) -> dict:
    """The reference in the program's place in bfloat16: each viewer's K
    picked on bfloat16 bounds of the program's per-K winners, its EM step
    and bound in bfloat16 from that winner, both about the viewer's mean;
    the sampled viewers' restarts started and run in bfloat16, picked on
    float32 bounds."""
    out = outputs(job, answer)
    x, lengths = answer["x"], answer["lengths"]
    dev, s = x.device, x.shape[0]
    hyps = ref_hyps(job.config["vbem"], x.shape[-1])
    every = torch.arange(s, device=dev)
    scores = torch.stack([
        rselect.iteration(x, lengths, every, w, hyps, torch.bfloat16,
                          center=True)[0].float() + math.lgamma(k + 1)
        for k, w in zip(job.ks, out["winners"])], 1)
    k_of = [job.ks[c] for c in torch.argmax(scores, 1).tolist()]
    bound = torch.empty(s, dtype=torch.float32, device=dev)
    sel = {}
    for k, w in zip(job.ks, out["winners"]):
        rows = torch.as_tensor([i for i, q in enumerate(k_of) if q == k],
                               dtype=torch.long)
        if len(rows):
            r = rows.to(dev)
            b_low, p_low = rselect.iteration(
                x, lengths, r, rvbem.Post(*(a[r] for a in w)), hyps,
                torch.bfloat16, center=True)
            bound[r] = b_low.float()
            sel[k] = (rows, rvbem.cast(p_low, torch.float32))
    chosen, picked, _ = _rerun(job, answer, torch.bfloat16, torch.float32)
    pick = _by_k(job.ks, chosen, lambda k, rows: rvbem.cast(rvbem.Post(
        *(a[torch.as_tensor(rows).to(dev)] for a in
          picked[job.ks.index(k)])), torch.float32))
    return {"k": k_of, "sel": sel, "pick": pick, "bound": bound,
            "winners": out["winners"]}


def _rerun(job, answer, dtype, pick_dtype):
    """The sampled viewers' stage rerun by the reference from the
    program's uniforms: (chosen K, per-K picked posteriors, corrected
    scores)."""
    x, lengths = answer["x"], answer["lengths"]
    s, n, t, d = x.shape
    gen = data.generator(answer["restart_seed"], job.device)
    sub = picked_subjects(job, answer).to(x.device)
    us = rselect.draws(gen, s, job.restarts, n * t, sub)
    return rselect.select(x, lengths, sub, us, job.ks,
                          ref_hyps(job.config["vbem"], d),
                          job.config["vbem"], dtype, pick_dtype)


def readings(job, answer, outs=None) -> dict:
    """The numbers compared for one answer; ``outs`` in place of the
    program's answer for the control."""
    out = outs or outputs(job, answer)
    x, lengths = answer["x"], answer["lengths"]
    dev, s = x.device, x.shape[0]
    hyps = ref_hyps(job.config["vbem"], x.shape[-1])
    bound = station = 0.0
    for k, (rows, post) in out["sel"].items():
        r = rows.to(dev)
        p = rvbem.cast(rvbem.Post(*(a.to(dev) for a in post)), F64)
        e0, p1 = rselect.iteration(x, lengths, r, p, hyps)
        e1, _ = rselect.iteration(x, lengths, r, p1, hyps)
        prog = out["bound"][r].to(F64)
        gap = torch.abs(prog - e0) / torch.abs(e0)
        st = torch.abs(e1 - e0) / torch.abs(e0)
        bound = max(bound, float(torch.max(torch.nan_to_num(
            gap, nan=math.inf))))
        station = max(station, float(torch.max(torch.nan_to_num(
            st, nan=math.inf))))
    every = torch.arange(s, device=dev)
    scores = torch.stack([
        torch.nan_to_num(rselect.iteration(
            x, lengths, every, rvbem.cast(w, F64), hyps)[0], nan=-math.inf)
        + math.lgamma(k + 1) for k, w in zip(job.ks, out["winners"])], 1)
    ref_k = [job.ks[c] for c in torch.argmax(scores, 1).tolist()]
    selection = float(sum(a != b for a, b in zip(ref_k, out["k"])))
    _, _, corrected = _rerun(job, answer, F64, F64)
    best = torch.max(corrected, 1).values.tolist()
    sub = picked_subjects(job, answer).to(dev)
    pick = 0.0
    for k, (pos, post) in out["pick"].items():
        p = rvbem.cast(rvbem.Post(*(a.to(dev) for a in post)), F64)
        e, _ = rselect.iteration(x, lengths, sub[pos.to(dev)], p, hyps)
        for i, got in zip(pos.tolist(), (e + math.lgamma(k + 1)).tolist()):
            pick = max(pick, shortfall(got, best[i]))
    return {"bound_gap": bound, "stationarity": station,
            "selection": selection, "pick_gap": pick}


# --------------------------------------------------------------------------
# the harness's CPU tests: a size the CPU runs in seconds, and faults
# --------------------------------------------------------------------------

def tiny(config: dict) -> dict:
    """The configuration at a size the CPU runs in a few seconds."""
    cfg = copy.deepcopy(config)
    cfg["subjects"] = 24
    cfg["trials"] = {"per_viewer": [2, 4], "fixations": [2, 6]}
    cfg["vbem"].update(numtrials=3, max_iter=40)
    return cfg


def _padded_step(mp):
    """Every empty trial counted as one step of data."""
    from vbhem_tpu_torch.containers import SeqBatch
    from vbhem_tpu_torch.models import batch
    pad = batch.pad_bank

    def one_step(batches):
        bank, added = pad(batches)
        return SeqBatch(x=bank.x, lengths=torch.clamp(bank.lengths,
                                                      min=1)), added
    mp.setattr(batch, "pad_bank", one_step)


def _no_lgamma(mp):
    """Each viewer's K picked on its bound alone."""
    from vbhem_tpu_torch.models import batch
    mp.setattr(batch, "math", types.SimpleNamespace(lgamma=lambda v: 0.0))


def _worst_restart(mp):
    from vbhem_tpu_torch.models import batch
    score = batch.vbem_rescore_lanes

    def worst(*a, **k):
        return -torch.nan_to_num(score(*a, **k), nan=-math.inf)
    mp.setattr(batch, "vbem_rescore_lanes", worst)


def _state_unchanged(mp):
    from vbhem_tpu_torch.models import vbhmm
    step = vbhmm._iteration

    def unchanged(batch, post, *a, **k):
        _, *rest = step(batch, post, *a, **k)
        return (post, *rest)
    mp.setattr(vbhmm, "_iteration", unchanged)


FAULTS = {"padded_step": _padded_step, "no_lgamma": _no_lgamma,
          "worst_restart": _worst_restart,
          "state_unchanged": _state_unchanged}
