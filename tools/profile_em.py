"""Profile one EM iteration of each engine of the PyTorch / CUDA port on
one NVIDIA card, stage by stage.

    python3 tools/profile_em.py [--n 50] [--iters 20] [--out FILE]

VBHEM: at the bench shape (Kb=8192, one lane of Kr=8) and at the largest
cell of chip_smoke.py's ``cluster`` grid (Kb=8192, 8 lanes of Kr=3), both
with Sb=Sr=3, D=2, tau=10 in float32, it

  * times each stage of the iteration alone (``wide_expectations``, the
    float64 expectations for the bound and their float32 rounding for the
    E-step, of which ``reduced_expectations`` is the part in float64
    only in a float64 run; ``e_step``, the kernel wrapper,
    ``soft_assignments``, ``elbo`` on the expectations the iteration gives
    it, ``aggregate_stats``, ``m_step``) and the whole iteration
    (``vbhem._em_iteration``), by CUDA events over ``n`` calls after
    warm-up, beside the host's time to enqueue the same calls;
  * lists the device kernels of ``elbo`` by their time (a profiler
    window of 10 calls; 3 for VBEM);
  * records a torch.profiler window of ``iters`` whole iterations and
    reads from its trace the device kernels launched, the device busy
    time (the union of the kernels' intervals), the window's wall time
    and the pair E-step kernel's mean device time.

VBEM: at the VBEM path of chip_smoke.py (``batch.learn_bank`` on 8192
synthetic subjects x 20 restarts, 25 sequences of T=50, D=2, K=2, float32)
it times the stages of one iteration (the emission constants, the
expectations of pi and A, the E-step in kernel B2's fused entry, which
forms the emission scores on chip, ``suff_stats``, ``elbo``, ``m_step``),
the per-iteration lane freeze of ``vbem_em`` (``lanes.lane_where`` over
the whole ``EMState``), the whole iteration and the float64 rescoring
pass the same way, and reads a profiler window of ``max(iters // 4, 2)`` iterations for the
device kernels, the busy share and B2's mean device time.

VHEM: at the largest launch of chip_smoke.py's VHEM path (20 restart
lanes of Kr=3, Sr=3 on a Kb=8192 bank of 2-state HMMs, D=2, tau=10,
float32; the bank is drawn at random with the learned bank's shapes) it
times the stages of one iteration (``expected_pair_ll_point``, the logs
of the reduced prior and transitions, the pair recursion with kernel B3,
the soft assignments, ``m_step`` and the two degenerate repairs) and the
whole iteration, and reads a profiler window for the device kernels, the
busy share and B3's mean device time.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
object with every number; ``--out`` also writes the object to a file.
The profiler's traces go to ``build/profile/``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from vbhem_tpu_torch import (HEMConfig, SeqBatch, VBConfig,  # noqa: E402
                             VBHEMConfig)
from vbhem_tpu_torch.models import rescore, vbhem, vbhmm, vhem  # noqa: E402
from vbhem_tpu_torch.models.lanes import lane_where  # noqa: E402
from vbhem_tpu_torch.ops import fb as fb_plain  # noqa: E402
from vbhem_tpu_torch.ops import fb_cuda, pair_estep_cuda  # noqa: E402
from vbhem_tpu_torch.ops import pair_estep as pair_plain  # noqa: E402
from vbhem_tpu_torch.utils.numeric import (e_log_dirichlet,  # noqa: E402
                                           logsumexp)
from vbhem_tpu_torch.utils.planted import (random_bank,  # noqa: E402
                                           synthetic_subjects)

SHAPES = [
    # name, kb, lanes, kr, sr
    ("bench Kb=8192 L=1 Kr=8 Sb=Sr=3 D=2 tau=10", 8192, 1, 8, 3),
    ("main-path cell Kb=8192 L=8 Kr=3 Sb=Sr=3 D=2 tau=10", 8192, 8, 3, 3),
]
KERNEL_NAME = "pair_estep_fused_kernel"
FB_KERNEL_NAME = "fb_resident_kernel"
BF_KERNEL_NAME = "pair_bwd_fwd_kernel"


def time_stage(fn, n, warmup=5):
    """(device ms per call by CUDA events, host ms per call to enqueue)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    host = (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, host * 1e3


def trace_numbers(trace_file: Path, kernel_name: str = KERNEL_NAME,
                  label: str = "pair_estep") -> dict:
    """Kernel count, busy time and the mean device time of the kernels
    named ``kernel_name`` from a chrome trace written by torch.profiler."""
    events = json.loads(trace_file.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in kernels)
    busy, cur_start, cur_end = 0.0, None, None
    for s, e in spans:
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        busy += cur_end - cur_start
    ours = [float(e["dur"]) for e in kernels if kernel_name in e["name"]]
    return {"device_kernels": len(kernels), "device_busy_ms": busy / 1e3,
            f"{label}_kernels": len(ours),
            f"{label}_kernel_device_ms":
                float(np.mean(ours)) / 1e3 if ours else None}


def profile_window(step, iters, trace_file: Path, **names) -> dict:
    """A torch.profiler window of ``iters`` calls of ``step``."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(trace_file))
    window = dict(iterations=iters, wall_ms=wall,
                  **trace_numbers(trace_file, **names))
    window["device_busy_share"] = window["device_busy_ms"] / wall
    return window


def kernel_breakdown(fn, calls, trace_file: Path, top=8) -> dict:
    """Device kernels of ``calls`` calls of ``fn`` in a torch.profiler
    window: kernels and device ms a call, and the ``top`` kernel names by
    device time with their ms and launches a call."""
    fn()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_file))
    kernels = [e for e in json.loads(trace_file.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]
    by_name = {}
    for e in kernels:
        ms, k = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + float(e["dur"]) / 1e3, k + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"kernels_per_call": len(kernels) / calls,
            "device_ms_per_call": sum(v[0] for v in by_name.values())
            / calls,
            "top": [{"name": name[:120], "ms_per_call": ms / calls,
                     "launches_per_call": k / calls}
                    for name, (ms, k) in ranked]}


def profile_vbem(n, iters, trace_dir: Path, n_per_group=4096, trials=20):
    """Stages of one VBEM iteration at chip_smoke.py's VBEM path."""
    name = (f"VBEM {2 * n_per_group} subjects x {trials} restarts, 25 "
            f"sequences T=50 D=2 K=2")
    device = torch.device("cuda", 0)
    batches, _ = synthetic_subjects(n_per_group, seed=1, device=device)
    bank = SeqBatch(x=torch.stack([b.x for b in batches]),
                    lengths=torch.stack([b.lengths for b in batches]))
    cfg = VBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=trials)
    hyps = vbhmm.VBHyps.from_config(cfg, 2, torch.float32, device)
    gen = torch.Generator(device=device).manual_seed(0)
    post = vbhmm.random_init(gen, bank, 2, hyps, lanes=(trials,))
    x, mask = vbhmm._views(bank, post.alpha.shape[:-1])
    emis = fb_plain.emission_constants(post.niw)
    log_pz1 = e_log_dirichlet(post.alpha)
    log_trans = e_log_dirichlet(post.epsilon)
    fb = fb_cuda.e_step_fused(x, mask, log_pz1, log_trans, emis)
    stats = vbhmm.suff_stats(bank, fb)
    ll = vbhmm.elbo(bank, post, fb, stats, hyps)
    it = torch.ones(ll.shape, dtype=torch.int64, device=device)
    active = torch.ones(ll.shape, dtype=torch.bool, device=device)
    st = vbhmm.EMState(post=post, ll=ll, last_ll=ll, it=it, gamma=fb.gamma,
                       stats=stats, done=~active)
    n_small = max(n // 10, 3)
    stages = {
        "emission_constants": lambda: fb_plain.emission_constants(post.niw),
        "e_log_dirichlet (pi, A)": lambda: (e_log_dirichlet(post.alpha),
                                            e_log_dirichlet(post.epsilon)),
        "e_step_fused (B2 fused entry: wrapper + kernel)":
            lambda: fb_cuda.e_step_fused(x, mask, log_pz1, log_trans, emis),
        "suff_stats": lambda: vbhmm.suff_stats(bank, fb),
        "elbo": lambda: vbhmm.elbo(bank, post, fb, stats, hyps),
        "m_step": lambda: vbhmm.m_step(stats, hyps),
        "lane freeze (vbem_em's lane_where over the EMState)":
            lambda: lane_where(active, st, st),
        "em_iteration": lambda: vbhmm._iteration(bank, post, hyps),
        "f64 rescoring (vbem_rescore_lanes)":
            lambda: rescore.vbem_rescore_lanes(bank, post, hyps),
    }
    out = {}
    for stage, fn in stages.items():
        ev, host = time_stage(fn, n_small, warmup=2)
        out[stage] = {"event_ms": ev, "host_enqueue_ms": host}
        print(f"[{name}] {stage}: {ev:.4f} ms by events, host enqueue "
              f"{host:.4f} ms", flush=True)
    out["elbo_kernels"] = kernel_breakdown(
        stages["elbo"], 3, trace_dir / "trace_vbem_elbo.json")
    print(f"[{name}] elbo kernels: {json.dumps(out['elbo_kernels'])}",
          flush=True)
    state = [post]

    def step():
        state[0] = vbhmm._iteration(bank, state[0], hyps)[0]
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    window = profile_window(step, max(iters // 4, 2),
                            trace_dir / "trace_vbem.json",
                            kernel_name=FB_KERNEL_NAME, label="fb")
    window["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["profile"] = window
    print(f"[{name}] profiler window: {json.dumps(window)}", flush=True)
    return name, out


def profile_vhem(n, iters, trace_dir: Path, kb=8192, lanes=20, kr=3, sr=3):
    """Stages of one VHEM iteration at chip_smoke.py's largest VHEM launch."""
    name = (f"VHEM Kb={kb} Sb=2 L={lanes} Kr={kr} Sr={sr} D=2 tau=10")
    device = torch.device("cuda", 0)
    base = random_bank(np.random.default_rng(2), kb, 2, 2, device,
                       torch.float32)
    cfg = HEMConfig(trials=lanes, nv=100, tau=10)
    gen = torch.Generator(device=device).manual_seed(0)
    h3m = vhem.init_baseem(gen, base, kr, sr, cfg, lanes=(lanes,))
    n_i = (cfg.nv * kb) * base.omega
    inf_norm = vhem._inf_norm(cfg.inf_norm, cfg.nv, cfg.tau, kb)
    ell = pair_plain.expected_pair_ll_point(base.hmm.mean, base.hmm.cov,
                                            h3m.hmm.mean, h3m.hmm.cov)
    log_pi = vhem._log_floor(h3m.hmm.prior)
    log_a = vhem._log_floor(h3m.hmm.trans)
    pair = pair_estep_cuda.pair_bwd_fwd_auto(base.hmm.prior, base.hmm.trans,
                                             log_pi, log_a, ell, cfg.tau)

    def assign():
        log_z = vhem._log_floor(h3m.omega)[..., None, :] \
            + n_i[:, None] * (pair.ll_elbo / inf_norm)
        lse = logsumexp(log_z, dim=-1, keepdim=True)
        return torch.exp(log_z - lse), torch.sum(lse[..., 0], dim=-1)
    z, _ = assign()
    new, counts = vhem.m_step(base, pair, z, cfg)
    stages = {
        "expected_pair_ll_point": lambda: pair_plain.expected_pair_ll_point(
            base.hmm.mean, base.hmm.cov, h3m.hmm.mean, h3m.hmm.cov),
        "log prior / trans": lambda: (vhem._log_floor(h3m.hmm.prior),
                                      vhem._log_floor(h3m.hmm.trans)),
        "pair_bwd_fwd_auto (B3 wrapper + kernel)":
            lambda: pair_estep_cuda.pair_bwd_fwd_auto(
                base.hmm.prior, base.hmm.trans, log_pi, log_a, ell, cfg.tau),
        "soft assignments and LL": assign,
        "m_step": lambda: vhem.m_step(base, pair, z, cfg),
        "fix_degenerate_components":
            lambda: vhem.fix_degenerate_components(new, gen),
        "fix_degenerate_states":
            lambda: vhem.fix_degenerate_states(new, counts, gen),
        "em_iteration": lambda: vhem._iteration(base, h3m, cfg, n_i,
                                                inf_norm, gen),
    }
    out = {}
    for stage, fn in stages.items():
        ev, host = time_stage(fn, n)
        out[stage] = {"event_ms": ev, "host_enqueue_ms": host}
        print(f"[{name}] {stage}: {ev:.4f} ms by events, host enqueue "
              f"{host:.4f} ms", flush=True)
    state = [h3m]

    def step():
        state[0] = vhem._iteration(base, state[0], cfg, n_i, inf_norm,
                                   gen)[0]
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    state[0] = h3m
    window = profile_window(step, iters, trace_dir / "trace_vhem.json",
                            kernel_name=BF_KERNEL_NAME, label="pair_bwd_fwd")
    out["profile"] = window
    print(f"[{name}] profiler window: {json.dumps(window)}", flush=True)
    return name, out


def profile_shape(name, kb, lanes, kr, sr, n, iters, trace_dir: Path):
    device = torch.device("cuda", 0)
    tau, d = 10, 2
    base = random_bank(np.random.default_rng(0), kb, 3, d, device,
                       torch.float32)
    cfg = VBHEMConfig(m0=(0.0,) * d, w0=1.0, nv=100, tau=tau)
    hyps = vbhem.VBHEMHyps.from_config(cfg, d, torch.float32, device)
    gen = torch.Generator(device="cpu").manual_seed(1)
    post = vbhem.stack_lanes([vbhem.init_baseem(gen, base, kr, sr, hyps,
                                                cfg.nv)
                              for _ in range(lanes)])
    tilde_n = (cfg.nv * kb) * base.omega
    post_w, exps_w, exps = vbhem.wide_expectations(post)
    pair = vbhem.e_step(base, post, exps, tau)
    hat_z, z_ni, nj = vbhem.soft_assignments(tilde_n, exps.log_omega,
                                             pair.ll_elbo)
    stats = vbhem.aggregate_stats(base, pair, z_ni, nj)
    kargs = (base.hmm.prior, base.hmm.trans, base.hmm.mean, base.hmm.cov,
             exps.log_pi, exps.log_a, post.niw.m, post.niw.w, post.niw.v,
             post.niw.beta, exps.log_lam, tau)

    def iteration(p):
        return vbhem._em_iteration(base, p, hyps, tilde_n, tau)[0]

    stages = {
        "wide_expectations": lambda: vbhem.wide_expectations(post),
        "reduced_expectations": lambda: vbhem.reduced_expectations(post),
        "e_step": lambda: vbhem.e_step(base, post, exps, tau),
        "kernel_wrapper(pair_bwd_fwd_fused_cuda)":
            lambda: pair_estep_cuda.pair_bwd_fwd_fused_cuda(*kargs),
        "soft_assignments": lambda: vbhem.soft_assignments(
            tilde_n, exps.log_omega, pair.ll_elbo),
        "elbo": lambda: vbhem.elbo(post_w, exps_w, pair, hat_z, z_ni, nj,
                                   hyps),
        "aggregate_stats": lambda: vbhem.aggregate_stats(base, pair, z_ni,
                                                         nj),
        "m_step": lambda: vbhem.m_step(stats, hyps),
        "em_iteration": lambda: iteration(post),
    }
    out = {}
    for stage, fn in stages.items():
        ev, host = time_stage(fn, n)
        out[stage] = {"event_ms": ev, "host_enqueue_ms": host}
        print(f"[{name}] {stage}: {ev:.4f} ms by events, host enqueue "
              f"{host:.4f} ms", flush=True)

    out["elbo_kernels"] = kernel_breakdown(
        stages["elbo"], 10, trace_dir / f"trace_{kb}_{lanes}x{kr}_elbo.json")
    print(f"[{name}] elbo kernels: {json.dumps(out['elbo_kernels'])}",
          flush=True)
    state = [post]

    def step():
        state[0] = iteration(state[0])
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    state[0] = post
    window = profile_window(step, iters,
                            trace_dir / f"trace_{kb}_{lanes}x{kr}.json")
    out["profile"] = window
    print(f"[{name}] profiler window: {json.dumps(window)}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=50,
                    help="calls per stage timing")
    ap.add_argument("--iters", type=int, default=20,
                    help="EM iterations in the profiler window")
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_em: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    trace_dir = REPO / "build" / "profile"
    trace_dir.mkdir(parents=True, exist_ok=True)
    result = {"card": smi}
    for name, kb, lanes, kr, sr in SHAPES:
        result[name] = profile_shape(name, kb, lanes, kr, sr, args.n,
                                     args.iters, trace_dir)
    for fn in (profile_vbem, profile_vhem):
        name, out = fn(args.n, args.iters, trace_dir)
        result[name] = out
    text = json.dumps(result, indent=1)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
