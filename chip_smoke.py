"""Drive the PyTorch / CUDA port (``vbhem_tpu_torch``) once on one NVIDIA
card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device and build: the card's name and power limit, and the build of
     every CUDA kernel from the sources in this checkout;
  2. kernel parity: each kernel against its plain PyTorch version on the
     same CUDA tensors, the plain version evaluated in float64; the
     float32 kernel within 5e-5 and the float64 kernel within 1e-10 of
     max |got - want| / (|want| + 1), at small shapes and at the main
     path's own launch shapes;
  3. main path: ``vbhem.cluster`` over (K, S) in {1,2,3} x {2,3} on a
     planted bank of 8192 base HMMs with 8 restart trials per cell; the
     ELBOs must be finite, every EM iteration must have launched the pair
     E-step kernel, and the (K=2, S=2) labels must recover the planted
     groups (Rand index 1.0); plus a 50-iteration ``em_trace`` whose ELBO
     must not decrease;
  4. timing (informational): the E-step and one EM iteration, kernel
     against plain, at the bench shape and at the main path's largest
     cell.

Prints a JSON line describing each kernel, the ``nvidia-smi`` name and
power-limit line, and last ``{"ok": true, "device": {...}}``.  Exits
non-zero, before any result, when no CUDA device is available.  Imports
neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from vbhem_tpu_torch import VBHEMConfig
from vbhem_tpu_torch.models import vbhem
from vbhem_tpu_torch.ops import _build
from vbhem_tpu_torch.ops import pair_estep as plain
from vbhem_tpu_torch.ops import pair_estep_cuda
from vbhem_tpu_torch.utils.planted import (planted_bank, rand_index,
                                           random_bank)

TOL = {torch.float32: 5e-5, torch.float64: 1e-10}
KERNEL = {"name": "pair_estep_fused", "route": "cuda",
          "source": "vbhem_tpu_torch/csrc/pair_estep_fused.cu",
          "replaces": "vbhem_tpu/ops/pair_estep_pallas.py:128"}


class Failures:
    def __init__(self):
        self.items = []

    def check(self, ok: bool, what: str):
        print(("PASS " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.items.append(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def random_posts(gen, base, hyps, lanes, kr, sr, nv):
    return vbhem.stack_lanes([vbhem.init_baseem(gen, base, kr, sr, hyps, nv)
                              for _ in range(lanes)])


def kernel_args(base, post):
    exps = vbhem.reduced_expectations(post)
    return (base.hmm.prior, base.hmm.trans, base.hmm.mean, base.hmm.cov,
            exps.log_pi, exps.log_a, post.niw.m, post.niw.w, post.niw.v,
            post.niw.beta, exps.log_lam)


def plain_e_step(base, post, exps, tau):
    """The plain PyTorch pair E-step (what the CPU path runs)."""
    ell = plain.expected_pair_ll_variational(
        base.hmm.mean, base.hmm.cov, post.niw.m, post.niw.w, post.niw.v,
        post.niw.beta, exps.log_lam)
    return plain.pair_bwd_fwd(base.hmm.prior, base.hmm.trans, exps.log_pi,
                              exps.log_a, ell, tau)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

PARITY_CASES = [
    # name, kb, kr, sb, sr, d, tau, lanes, ragged
    ("kb256_tau10", 256, 4, 3, 3, 2, 10, 1, False),
    ("tau1", 256, 4, 3, 3, 2, 1, 1, False),
    ("ragged_sb", 256, 4, 3, 3, 2, 10, 1, True),
    ("d3", 256, 4, 3, 3, 3, 10, 1, False),
    ("sr1", 256, 4, 3, 1, 2, 10, 1, False),
    ("sr2", 256, 4, 3, 2, 2, 10, 1, False),
    ("lanes3", 256, 4, 3, 3, 2, 10, 3, False),
    ("bench_shape", 8192, 8, 3, 3, 2, 10, 1, False),
    # the launches of phase 3's largest cells: 8 restart lanes of Kr=3
    ("main_cell", 8192, 3, 3, 3, 2, 10, 8, False),
    ("main_cell_sr2", 8192, 3, 3, 2, 2, 10, 8, False),
]


def _plain_pair(args, tau):
    ell = plain.expected_pair_ll_variational(*args[2:4], *args[6:])
    return plain.pair_bwd_fwd(*args[:2], *args[4:6], ell, tau)


def _errors(got, want):
    """{field: max |got - want| / (|want| + 1)}, max |got - want|."""
    errs, max_abs = {}, 0.0
    for f in want._fields:
        g = getattr(got, f).double()
        w = getattr(want, f).double()
        errs[f] = float(torch.max(torch.abs(g - w) / (w.abs() + 1)))
        max_abs = max(max_abs, float(torch.max(torch.abs(g - w))))
    return errs, max_abs


def phase_parity(fails: Failures, device) -> float:
    """Kernel against the plain version on the same CUDA tensors; returns
    the largest absolute float32 error seen.

    The reference is the plain version evaluated in float64 on the
    kernel's inputs (float32 inputs are exact in float64).  At the main
    path's 196k pairs the plain version's own float32 rounding reaches
    1e-4 on this measure, so a float32-against-float32 comparison would
    add the two versions' rounding; it is printed beside the gated
    error."""
    max_abs_f32 = 0.0
    for dtype in (torch.float32, torch.float64):
        for name, kb, kr, sb, sr, d, tau, lanes, ragged in PARITY_CASES:
            rng = np.random.default_rng(7)
            base = random_bank(rng, kb, sb, d, device, dtype, ragged)
            cfg = VBHEMConfig(m0=(0.0,) * d, w0=1.0, nv=100, tau=tau)
            hyps = vbhem.VBHEMHyps.from_config(cfg, d, dtype, device)
            gen = torch.Generator(device="cpu").manual_seed(11)
            post = random_posts(gen, base, hyps, lanes, kr, sr, cfg.nv)
            args = kernel_args(base, post)
            got = pair_estep_cuda.pair_bwd_fwd_fused_cuda(*args, tau)
            want = _plain_pair(tuple(a.double() for a in args), tau)
            torch.cuda.synchronize()
            errs, max_abs = _errors(got, want)
            worst = max(errs.values())
            detail = " ".join(f"{k}={v:.3e}" for k, v in errs.items())
            dt = "f32" if dtype == torch.float32 else "f64"
            if dtype == torch.float32:
                max_abs_f32 = max(max_abs_f32, max_abs)
                p32 = _plain_pair(args, tau)
                plain32, _ = _errors(p32, want)
                k_vs_p32, _ = _errors(got, p32)
                print(f"info {name} f32: plain f32 vs f64 reference "
                      f"{max(plain32.values()):.3e}; kernel vs plain f32 "
                      f"{max(k_vs_p32.values()):.3e}", flush=True)
            fails.check(math.isfinite(worst) and worst <= TOL[dtype],
                        f"parity {name} {dt} tol={TOL[dtype]:.0e}: {detail}")
    return max_abs_f32


def phase_main_path(fails: Failures, device, kb=8192, trials=8,
                    trace_iters=50) -> int:
    """cluster() and em_trace() on the planted bank; returns the kernel
    launches counted during the cluster() run."""
    dtype = torch.float32
    base, labels = planted_bank(kb, device, dtype)
    cfg = VBHEMConfig(trials=trials, learn_hyps=False, initmode="baseem",
                      nv=100, tau=10, m0=(13.0, 10.0), w0=1.0)
    gen = torch.Generator(device="cpu").manual_seed(0)

    pair_estep_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    res, info = vbhem.cluster(gen, base, [1, 2, 3], [2, 3], cfg)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pair_estep_cuda.LAUNCHES

    lls = np.asarray(info["model_ll"])
    iters = sum(info["model_em_iters"].values())
    print(f"main path: Kb={kb} trials={trials} grid K=[1,2,3] x S=[2,3] "
          f"wall={wall:.3f}s em_iterations={iters} kernel_launches="
          f"{launches}", flush=True)
    print(f"main path: selected K={info['model_best_k']} "
          f"S={info['model_best_s']}; scores={lls.tolist()}", flush=True)
    fails.check(bool(np.all(np.isfinite(lls))), "main path ELBOs finite")
    if device.type == "cuda":
        fails.check(launches >= iters > 0,
                    f"main path launched the kernel {launches} times for "
                    f"{iters} EM iterations")
    r22 = info["model_all"][(2, 2)]
    ri = rand_index(r22.label.cpu().numpy(), labels)
    fails.check(ri == 1.0, f"(K=2, S=2) labels vs planted groups: "
                           f"Rand index {ri}")

    hyps = vbhem.VBHEMHyps.from_config(cfg, 2, dtype, device)
    post0 = vbhem.init_baseem(gen, base, 2, 2, hyps, cfg.nv)
    _, trace = vbhem.em_trace(base, post0, hyps, cfg.nv, cfg.tau,
                              n_iter=trace_iters)
    tr = trace.double().cpu().numpy()
    drop = np.max((tr[:-1] - tr[1:]) / np.abs(tr[:-1]))
    fails.check(bool(np.all(np.isfinite(tr))) and drop <= 1e-5,
                f"em_trace {trace_iters} iterations: ELBO {tr[0]:.6g} -> "
                f"{tr[-1]:.6g}, largest relative decrease {drop:.3e}")
    return launches


def _time(fn, n, device) -> float:
    """Mean seconds per call of ``fn`` over ``n`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / n


def em_iteration(base, post, hyps, tilde_n, tau, pair_fn):
    exps = vbhem.reduced_expectations(post)
    pair = pair_fn(base, post, exps, tau)
    hat_z, z_ni, nj = vbhem.soft_assignments(tilde_n, exps.log_omega,
                                             pair.ll_elbo)
    ll = vbhem.elbo(post, exps, pair, hat_z, z_ni, nj, hyps)
    stats = vbhem.aggregate_stats(base, pair, z_ni, nj)
    return vbhem.m_step(stats, hyps), ll


TIMING_SHAPES = [
    # name, kb, lanes, kr, sr
    ("bench Kb=8192 L=1 Kr=8 Sb=Sr=3 D=2 tau=10", 8192, 1, 8, 3),
    ("main-path cell Kb=8192 L=8 Kr=3 Sb=Sr=3 D=2 tau=10", 8192, 8, 3, 3),
]


def phase_timing(device, n=50, warmup=5):
    """E-step and EM-iteration times, kernel and plain, in the order
    kernel, plain, plain, kernel; returns {shape: {...}}."""
    out = {}
    tau, d = 10, 2
    for name, kb, lanes, kr, sr in TIMING_SHAPES:
        rng = np.random.default_rng(0)
        base = random_bank(rng, kb, 3, d, device, torch.float32)
        cfg = VBHEMConfig(m0=(0.0,) * d, w0=1.0, nv=100, tau=tau)
        hyps = vbhem.VBHEMHyps.from_config(cfg, d, torch.float32, device)
        gen = torch.Generator(device="cpu").manual_seed(1)
        post = random_posts(gen, base, hyps, lanes, kr, sr, cfg.nv)
        exps = vbhem.reduced_expectations(post)
        tilde_n = (cfg.nv * kb) * base.omega
        pair_fns = {"kernel": vbhem.e_step, "plain": plain_e_step}
        res = {"kernel": {"estep": [], "iter": []},
               "plain": {"estep": [], "iter": []}}
        for which in ("kernel", "plain", "plain", "kernel"):
            fn = pair_fns[which]
            for _ in range(warmup):
                fn(base, post, exps, tau)
            res[which]["estep"].append(
                _time(lambda: fn(base, post, exps, tau), n, device))
            state = [post]

            def step():
                state[0], _ = em_iteration(base, state[0], hyps, tilde_n,
                                           tau, fn)

            for _ in range(warmup):
                step()
            state[0] = post
            res[which]["iter"].append(_time(step, n, device))
        pairs = kb * lanes * kr
        row = {}
        for which in ("kernel", "plain"):
            est = float(np.mean(res[which]["estep"]))
            itr = float(np.mean(res[which]["iter"]))
            row[which] = {"estep_ms": est * 1e3, "iter_ms": itr * 1e3,
                          "pairs_per_s": pairs / itr,
                          "estep_ms_runs": [x * 1e3 for x in
                                            res[which]["estep"]],
                          "iter_ms_runs": [x * 1e3 for x in
                                           res[which]["iter"]]}
            print(f"timing [{name}] {which}: E-step {est * 1e3:.4f} ms, "
                  f"EM iteration {itr * 1e3:.4f} ms, "
                  f"{pairs / itr:.4g} pair-updates/s (runs: E-step "
                  f"{row[which]['estep_ms_runs']} ms, iteration "
                  f"{row[which]['iter_ms_runs']} ms)", flush=True)
        out[name] = row
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "only on an NVIDIA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    fails = Failures()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})", flush=True)
    smi = nvidia_smi_line()
    print(f"nvidia-smi: {smi}", flush=True)

    # phase 1: build
    t0 = time.perf_counter()
    try:
        lib = _build.build()
    except _build.KernelBuildError as e:
        print(f"FAIL build: {e}", flush=True)
        return 1
    print(f"build: {lib.name} ready in {time.perf_counter() - t0:.2f}s",
          flush=True)
    log = lib.with_suffix(".log")
    if log.is_file():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas: {line.strip()}", flush=True)

    max_abs, launches, timing = float("nan"), 0, {}
    phases = (("parity", lambda: phase_parity(fails, device)),
              ("main path", lambda: phase_main_path(fails, device)),
              ("timing", lambda: phase_timing(device)))
    results = {}
    for name, run in phases:
        try:
            results[name] = run()
        except Exception:   # report the phase as failed, keep going
            traceback.print_exc()
            fails.check(False, f"phase {name} raised")
    max_abs = results.get("parity", max_abs)
    launches = results.get("main path", launches)
    timing = results.get("timing", timing)

    bench = timing.get(TIMING_SHAPES[0][0], {})
    kernel = dict(KERNEL, launches=launches, max_abs_err=max_abs,
                  ms=bench.get("kernel", {}).get("estep_ms"),
                  plain_ms=bench.get("plain", {}).get("estep_ms"))
    if fails.items:
        print(f"chip_smoke: {len(fails.items)} check(s) failed: "
              f"{fails.items}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
