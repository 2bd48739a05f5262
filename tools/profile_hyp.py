"""Profile one evaluation of each engine's hyperparameter objective on one
NVIDIA card, at the hyps-on protocol's shapes (chip_smoke.py's phase
"protocol hyps").

    python3 tools/profile_hyp.py [--n 3] [--out FILE]

An evaluation of the objective (``vbhmm.neg_elbo_objective``,
``vbhem.neg_elbo_objective``) is a whole EM run from each lane's start
under the candidate hyps, the final E-step and statistics, and the bound
with the hyps requiring grad; L-BFGS then takes autograd's backward.  Both
are split into those stages, each timed over ``n`` evaluations at hyps0
by CUDA events and by the host's clock, and a torch.profiler window of one
whole evaluation gives the device kernels, the busy share and the
kernel's mean device time, printed beside the kernel's bound at the
objective's launch (chip_smoke.py's ``b2_fused_bound``, ``b1_bound``).

VBEM: 40 subjects (20 per planted group, drawn from chip_smoke.py's
PROTOCOL_HYPS_SEED), 25 sequences of T=50, D=2, K=2, float32, 20 restarts
run to convergence at ``default_vb_config()``; the lanes are each
subject's uniqueLL survivors, at most 5, padded with its best (200 lanes,
as ``batch.learn_bank`` lays them out).  Kernel B2.

VBHEM: the bank those subjects learn (``learn_bank``, hyps off), the
protocol grid's restarts (``fit_grid_batched``, K=1..6 x S=1..5, 50
trials, tau=50, Nv=100, baseem, float32), and as lanes each cell's
uniqueLL survivors, at most 5, the lane count padded to a multiple of 16
(as ``optimize_hyps_grid_batched`` lays them out), on the masked EM.
Kernel B1.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
object with every number; ``--out`` also writes it to a file.  Traces go
to ``build/profile/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from tools.profile_em import profile_window  # noqa: E402
from vbhem_tpu_torch import SeqBatch, hyp  # noqa: E402
from vbhem_tpu_torch.containers import tree_map  # noqa: E402
from vbhem_tpu_torch.experiments import synthetic  # noqa: E402
from vbhem_tpu_torch.models import batch, vbhem, vbhmm  # noqa: E402
from vbhem_tpu_torch.utils.planted import synthetic_subjects  # noqa: E402

CAP = 5


def timed(fn, device):
    """(result, device ms by CUDA events, host ms) of one call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def split_evaluation(stages, n, device) -> dict:
    """Mean event and host ms of each stage over ``n`` evaluations;
    ``stages`` is a list of (name, fn(previous outputs) -> outputs)."""
    times = {name: [[], []] for name, _ in stages}
    for _ in range(n):
        carry = None
        for name, fn in stages:
            carry, ev, host = timed(lambda: fn(carry), device)
            times[name][0].append(ev)
            times[name][1].append(host)
    out = {name: {"event_ms": float(np.mean(e)), "host_ms": float(np.mean(h))}
           for name, (e, h) in times.items()}
    out["evaluation"] = {k: sum(v[k] for v in out.values())
                         for k in ("event_ms", "host_ms")}
    return out


def _theta(hyps0, specs, n):
    t = torch.as_tensor(hyp.pack(hyps0, specs), device=hyps0.alpha0.device)
    return t.expand(n, -1).clone().requires_grad_(True)


def profile_vbem(n, trace_dir: Path, device):
    cfg = synthetic.default_vb_config()
    batches, _ = synthetic_subjects(20, seed=chip_smoke.PROTOCOL_HYPS_SEED,
                                    device=device)
    bank = SeqBatch(x=torch.stack([b.x for b in batches]),
                    lengths=torch.stack([b.lengths for b in batches]))
    h0 = vbhmm.VBHyps.from_config(cfg, 2, torch.float32, device)
    gen = torch.Generator(device=device).manual_seed(0)
    post0 = vbhmm.random_init(gen, bank, 2, h0, lanes=(cfg.numtrials,))
    states = vbhmm.vbem_em(bank, post0, h0, max_iter=cfg.max_iter,
                           min_diff=cfg.min_diff)
    lls = states.ll.double().cpu().numpy()
    si, ti = [], []
    for s in range(lls.shape[0]):
        u = hyp.unique_ll(lls[s], cfg.min_diff)[:CAP]
        u = np.concatenate([u, np.full(CAP - len(u), u[0])])
        si += [s] * CAP
        ti += u.tolist()
    si = torch.as_tensor(si, device=device)
    ti = torch.as_tensor(ti, device=device)
    data = SeqBatch(x=bank.x[si], lengths=bank.lengths[si])
    posts = tree_map(lambda a: a[si, ti], states.post)
    specs = hyp.vb_specs(2, cfg.bounds, cfg.learn_hyps_keys)
    n_lanes = len(si)
    lanes = torch.arange(n_lanes, device=device)
    its = []

    def em(_):
        with torch.no_grad():
            st = vbhmm.vbem_em(data, posts, h0, max_iter=cfg.max_iter,
                               min_diff=cfg.min_diff)
        its.append(int(torch.max(st.it)))
        return st.post

    def e_step(post):
        with torch.no_grad():
            return post, vbhmm.e_step(data, post)

    def stats(c):
        with torch.no_grad():
            return c + (vbhmm.suff_stats(data, c[1]),)

    def bound(c):
        theta = _theta(h0, specs, n_lanes)
        v = -vbhmm.elbo(data, c[0], c[1], c[2], hyp.unpack(theta, h0, specs))
        return v, theta

    def backward(c):
        return torch.autograd.grad(c[0].sum(), c[1])

    name = (f"VBEM hyp objective: {n_lanes} lanes (40 subjects x {CAP} "
            f"survivors), 25 sequences T=50 D=2 K=2 f32")
    out = split_evaluation([("EM run (vbem_em)", em),
                            ("final E-step (B2)", e_step),
                            ("suff_stats", stats),
                            ("bound forward (elbo)", bound),
                            ("autograd backward", backward)], n, device)
    out["em_iterations"] = its
    fun = vbhmm.neg_elbo_objective(data, posts, cfg, per_lane_data=True)

    def evaluation():
        theta = _theta(h0, specs, n_lanes)
        v = fun(hyp.unpack(theta, h0, specs), lanes)
        torch.autograd.grad(v.sum(), theta)

    out["profile"] = profile_window(
        evaluation, 1, trace_dir / "trace_hyp_vbem.json",
        kernel_name=chip_smoke.DEVICE_NAMES["B2"], label="fb")
    # B2's bound at the objective's launch (the EM's own posteriors)
    x, mask = vbhmm._views(data, posts.alpha.shape[:-1])
    out["b2_bound"] = chip_smoke.b2_fused_bound(
        x, mask, chip_smoke.e_log_dirichlet(posts.alpha),
        chip_smoke.e_log_dirichlet(posts.epsilon),
        chip_smoke.fb_plain.emission_constants(posts.niw))
    print(f"[{name}] {json.dumps(out)}", flush=True)
    return name, out, batches


def profile_vbhem(n, trace_dir: Path, device, batches):
    vcfg = dataclasses.replace(synthetic.default_vb_config(),
                               learn_hyps=False)
    results, _ = batch.learn_bank(
        torch.Generator(device=device).manual_seed(0), batches, 2, vcfg)
    base = vbhem.h3m_from_results(results, device=device)
    cfg = synthetic.default_vbhem_config()
    h0 = vbhem.VBHEMHyps.from_config(cfg, 2, torch.float32, device)
    ks, ss = chip_smoke.GRID
    states, cells, cmasks, smasks = vbhem.fit_grid_batched(
        torch.Generator(device="cpu").manual_seed(0), base, ks, ss, cfg, h0)
    lls = states.ll.double().cpu().numpy()
    lanes_ = []
    for c in range(len(cells)):
        lanes_ += [(c, int(t)) for t in hyp.unique_ll(lls[c],
                                                      cfg.min_diff)[:CAP]]
    while len(lanes_) % 16:
        lanes_.append(lanes_[0])
    ci = torch.as_tensor([c for c, _ in lanes_], device=device)
    tr = torch.as_tensor([t for _, t in lanes_], device=device)
    posts = tree_map(lambda a: a[ci, tr], states.post)
    cm, sm = cmasks[ci], smasks[ci]
    specs = hyp.vbhem_specs(2, cfg.bounds, cfg.learn_hyps_keys)
    n_lanes = len(lanes_)
    lanes = torch.arange(n_lanes, device=device)
    tilde_n = (cfg.nv * base.num_hmms) * base.omega
    its = []

    def em(_):
        with torch.no_grad():
            st = vbhem.vbhem_em_masked(base, posts, h0, nv=cfg.nv,
                                       tau=cfg.tau, cmask=cm, smask=sm,
                                       max_iter=cfg.max_iter,
                                       min_diff=cfg.min_diff)
        its.append(int(torch.max(st.it)))
        return st.post

    def e_step(post):
        with torch.no_grad():
            post_w, exps_w, exps = vbhem.wide_expectations(post, cm, sm)
            return (post_w, exps_w, vbhem.e_step(base, post, exps, cfg.tau),
                    exps)

    def soft(c):
        with torch.no_grad():
            return c[:3] + (vbhem.soft_assignments(tilde_n, c[3].log_omega,
                                                   c[2].ll_elbo),)

    def bound(c):
        theta = _theta(h0, specs, n_lanes)
        v = -vbhem.elbo(c[0], c[1], c[2], *c[3],
                        hyp.unpack(theta, h0, specs), cm, sm)
        return v, theta

    def backward(c):
        return torch.autograd.grad(c[0].sum(), c[1])

    name = (f"VBHEM hyp objective: {n_lanes} lanes (each cell's survivors, "
            f"at most {CAP}), Kb={base.num_hmms} Kmax={max(ks)} "
            f"Smax={max(ss)} Sb=2 tau={cfg.tau} f32, masked")
    out = split_evaluation([("EM run (vbhem_em_masked)", em),
                            ("final pair E-step (B1)", e_step),
                            ("soft_assignments", soft),
                            ("bound forward (elbo, masked)", bound),
                            ("autograd backward", backward)], n, device)
    out["em_iterations"] = its
    fun = vbhem.neg_elbo_objective(base, posts, cfg, cmask=cm, smask=sm)

    def evaluation():
        theta = _theta(h0, specs, n_lanes)
        v = fun(hyp.unpack(theta, h0, specs), lanes)
        torch.autograd.grad(v.sum(), theta)

    out["profile"] = profile_window(
        evaluation, 1, trace_dir / "trace_hyp_vbhem.json",
        kernel_name=chip_smoke.DEVICE_NAMES["B1"], label="pair_estep")
    # B1's bound at the objective's launch: every lane at the padded shape
    kb, sb = base.state_mask.shape
    out["b1_bound"] = chip_smoke.b1_bound(kb, n_lanes * max(ks), sb,
                                          max(ss), 2, cfg.tau, 4)
    print(f"[{name}] {json.dumps(out)}", flush=True)
    return name, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_hyp: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    trace_dir = REPO / "build" / "profile"
    trace_dir.mkdir(parents=True, exist_ok=True)
    result = {"device": torch.cuda.get_device_name(0),
              "nvidia_smi": chip_smoke.nvidia_smi_line()}
    name, out, batches = profile_vbem(args.n, trace_dir, device)
    result[name] = out
    name, out = profile_vbhem(args.n, trace_dir, device, batches)
    result[name] = out
    line = json.dumps(result)
    print(line, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
