"""Drive the PyTorch / CUDA port (``vbhem_tpu_torch``) once on one NVIDIA
card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device and build: the card's name and power limit, and the build of
     every CUDA kernel from the sources in this checkout (one nvcc per
     source, all at once);
  2. kernel parity: each kernel against its plain PyTorch version on the
     same CUDA tensors, the plain version evaluated in float64; the
     float32 kernel within 5e-5 and the float64 kernel within 1e-10 of
     max |got - want| / (|want| + 1), at small shapes and at the shapes the
     main paths launch.  B1 is the pair E-step, B2 the VBEM
     forward-backward;
  3. VBHEM path: ``vbhem.cluster`` over (K, S) in {1,2,3} x {2,3} on a
     planted bank of 8192 base HMMs with 8 restart trials per cell; the
     ELBOs must be finite, every EM iteration must have launched B1, and
     the (K=2, S=2) labels must recover the planted groups (Rand index
     1.0); plus a 50-iteration ``em_trace`` whose ELBO must not decrease;
  4. VBEM path: ``batch.learn_bank`` on the synthetic protocol's data at
     8192 subjects (25 sequences of T=50, D=2), K=2, 20 restarts: every
     ELBO finite, B2 launched on every EM iteration, the planted
     transition structure recovered for at least 99.9% of subjects, and a
     50-iteration VBEM ``em_trace`` whose ELBO never falls by more than
     1e-5 relative;
  5. pipeline: the bank phase 4 learned, through ``h3m_from_results`` and
     ``vbhem.cluster`` (K in {1,2,3}, S=2, the JAX package's test
     settings with 64 restarts, see PIPELINE_TRIALS); the (K=2, S=2)
     labels must recover the two groups;
  6. timing (informational): each kernel's device time, its wrapper's
     time and its plain version's time at its main-path shape, and one EM
     iteration of each engine with the kernel and with the plain version.

Each of phases 3-5 sets every kernel's launch count to 0 just before it
runs its path and reads the counts just after.  Prints a JSON line
describing each kernel, the ``nvidia-smi`` name and power-limit line, and
last ``{"ok": true, "device": {...}}``.  Exits non-zero, before any
result, when no CUDA device is available.  Imports neither JAX nor the
JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from vbhem_tpu_torch import SeqBatch, VBConfig, VBHEMConfig
from vbhem_tpu_torch.models import batch as vbem_batch
from vbhem_tpu_torch.models import vbhem, vbhmm
from vbhem_tpu_torch.ops import _build
from vbhem_tpu_torch.ops import fb as fb_plain
from vbhem_tpu_torch.ops import fb_cuda
from vbhem_tpu_torch.ops import pair_estep as plain
from vbhem_tpu_torch.ops import pair_estep_cuda
from vbhem_tpu_torch.utils.numeric import e_log_dirichlet
from vbhem_tpu_torch.utils.planted import (planted_bank, rand_index,
                                           random_bank, synthetic_subjects)

TOL = {torch.float32: 5e-5, torch.float64: 1e-10}
KERNELS = {
    "B1": {"name": "pair_estep_fused", "route": "cuda",
           "source": "vbhem_tpu_torch/csrc/pair_estep_fused.cu",
           "replaces": "vbhem_tpu/ops/pair_estep_pallas.py:128"},
    "B2": {"name": "fb", "route": "cuda",
           "source": "vbhem_tpu_torch/csrc/fb.cu",
           "replaces": "vbhem_tpu/ops/fb_pallas.py:51"},
}
COUNTERS = {"B1": pair_estep_cuda, "B2": fb_cuda}
DEVICE_NAMES = {"B1": "pair_estep_fused_kernel", "B2": "fb_kernel"}

# Peak rates of one H100 SXM, from NVIDIA's published specifications:
# device memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.
# Special functions (exp, log) run on the SFUs: 16 results per clock per
# SM (NVIDIA's published arithmetic throughput table for compute
# capability 9.0) at the 1.98 GHz boost clock, over the card's SMs.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
SFU_PER_SM_PER_CLOCK = 16
BOOST_HZ = 1.98e9


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


def reset_counts():
    for mod in COUNTERS.values():
        mod.LAUNCHES = 0


def read_counts() -> dict:
    return {k: mod.LAUNCHES for k, mod in COUNTERS.items()}


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

def bound(n_bytes: float, n_sfu: float, n_flop: float) -> dict:
    """The larger of the bytes time and the operations time (special
    functions on the SFUs, the rest at the float32 rate)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(n_sfu / (sms * SFU_PER_SM_PER_CLOCK * BOOST_HZ),
                n_flop / F32_FLOP_PER_S)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "sfu_ops": n_sfu, "flops": n_flop}


def b1_bound(kb, lkr, sb, sr, d, tau, itemsize) -> dict:
    """B1 per (base, reduced) pair, counting what the function needs:
    per backward step Sr*Sb*Sr exp (each gives one Theta entry up to a
    per-(r', b) factor, so the forward pass needs no more) and Sr*Sb log;
    the termination Sb*(2 Sr) exp and Sb log.  The kernel's forward pass
    rebuilds Theta with another Sr*Sb*Sr exp per step instead of storing
    it; that work, and the carry scratch it reads back (``scratch_bytes``,
    written and read once), are the kernel's choice and not counted.
    Bytes: the base bank and the reduced models read once, the four
    outputs written once."""
    pairs = kb * lkr
    sfu = pairs * ((tau - 1) * (sr * sr * sb + sr * sb) + sb * (2 * sr + 1))
    flop = pairs * ((tau - 1) * (5 * sr * sr * sb + 4 * sr * sb * sb)
                    + sb * sr * (4 * d * d + 4))
    n_bytes = itemsize * (kb * (sb + sb * sb + sb * d + sb * d * d)
                          + lkr * sr * (sr + d + d * d + 4)
                          + pairs * (1 + sr + sr * sr + sr * sb))
    return {**bound(n_bytes, sfu, flop),
            "scratch_bytes": 2 * itemsize * (tau - 1) * sb * sr * pairs}


def b2_bound(log_pz1, log_trans, log_rho, mask) -> dict:
    """B2 on these inputs: log_rho read and gamma written once, the mask
    as the kernel reads it (one row per subject, shared by its
    restarts), the scores, xi_sum and phi_norm.  Operations for the
    steps this mask makes valid: K exp and one log per valid step, the
    exp of the scores, and about 10 K^2 flops per valid step."""
    *lanes, n, t, k = log_rho.shape
    n_seq = math.prod(lanes) * n
    size = log_rho.element_size()
    m8, rep = fb_cuda._mask_lanes(mask, tuple(lanes))
    valid = float(torch.sum(m8.float())) * rep
    n_bytes = (size * (2 * n_seq * t * k + n_seq * (k * k + 1)
                       + log_pz1.numel() + log_trans.numel())
               + m8.numel())
    sfu = valid * (k + 1) + log_pz1.numel() + log_trans.numel()
    return bound(n_bytes, sfu, valid * 10 * k * k)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

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


def device_ms(fn, kernel_name, n) -> float:
    """Mean device time (ms) of the kernels named ``kernel_name`` over
    ``n`` calls of ``fn``, read from a torch.profiler trace."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    durs = [float(e["dur"]) for e in events
            if e.get("cat") == "kernel" and kernel_name in e.get("name", "")]
    return float(np.mean(durs)) / 1e3 if durs else float("nan")


def interleaved(fns: dict, n, device, warmup=2) -> dict:
    """{name: [seconds per call, ...]} for fns "kernel" and "plain" in
    the order kernel, plain, plain, kernel."""
    runs = {name: [] for name in fns}
    for which in ("kernel", "plain", "plain", "kernel"):
        for _ in range(warmup):
            fns[which]()
        runs[which].append(_time(fns[which], n, device))
    return runs


# ---------------------------------------------------------------------------
# phase 2: kernel parity
# ---------------------------------------------------------------------------

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


B1_CASES = [
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
    # the launches of phase 5: a learned bank of 2-state HMMs, tau=50
    ("pipeline_cell", 8192, 3, 2, 2, 2, 50, 8, False),
    ("pipeline_cell_64", 8192, 2, 2, 2, 2, 50, 64, False),
]


def _plain_pair(args, tau):
    ell = plain.expected_pair_ll_variational(*args[2:4], *args[6:])
    return plain.pair_bwd_fwd(*args[:2], *args[4:6], ell, tau)


def _errors(got, want, fields=None):
    """{field: max |got - want| / (|want| + 1)}, max |got - want|."""
    errs, max_abs = {}, 0.0
    for f in fields or want._fields:
        g = getattr(got, f).double()
        w = getattr(want, f).double()
        errs[f] = float(torch.max(torch.abs(g - w) / (w.abs() + 1)))
        max_abs = max(max_abs, float(torch.max(torch.abs(g - w))))
    return errs, max_abs


def _gate(fails, kernel, name, dtype, errs):
    worst = max(errs.values())
    detail = " ".join(f"{k}={v:.3e}" for k, v in errs.items())
    dt = "f32" if dtype == torch.float32 else "f64"
    fails.check(math.isfinite(worst) and worst <= TOL[dtype],
                f"parity {kernel} {name} {dt} tol={TOL[dtype]:.0e}: "
                f"{detail}")


def phase_parity_b1(fails: Failures, device) -> float:
    """B1 against the plain version on the same CUDA tensors; returns the
    largest absolute float32 error seen.

    The reference is the plain version evaluated in float64 on the
    kernel's inputs (float32 inputs are exact in float64).  At the main
    path's 196k pairs the plain version's own float32 rounding reaches
    1e-4 on this measure, so a float32-against-float32 comparison would
    add the two versions' rounding; it is printed beside the gated
    error."""
    max_abs_f32 = 0.0
    for dtype in (torch.float32, torch.float64):
        for name, kb, kr, sb, sr, d, tau, lanes, ragged in B1_CASES:
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
            if dtype == torch.float32:
                max_abs_f32 = max(max_abs_f32, max_abs)
                p32 = _plain_pair(args, tau)
                plain32, _ = _errors(p32, want)
                k_vs_p32, _ = _errors(got, p32)
                print(f"info B1 {name} f32: plain f32 vs f64 reference "
                      f"{max(plain32.values()):.3e}; kernel vs plain f32 "
                      f"{max(k_vs_p32.values()):.3e}", flush=True)
            _gate(fails, "B1", name, dtype, errs)
    return max_abs_f32


def fb_inputs(seed, lanes, n, t, k, device, dtype, per_seq=False,
              ragged=False, mask_per_lane=False):
    """Sub-normalized scores, emission scores and a mask for B2, drawn on
    the card.  The mask is one row per subject (the first lane axis),
    shared by the restarts, unless ``mask_per_lane``."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(shape):
        return torch.rand(shape, generator=g, device=device,
                          dtype=torch.float64)

    ps = lanes + ((n,) if per_seq else ())
    log_pz1 = torch.log(rand(ps + (k,)) * 0.9 + 0.05).to(dtype)
    log_trans = torch.log(rand(ps + (k, k)) * 0.9 + 0.05).to(dtype)
    log_rho = (torch.randn(lanes + (n, t, k), generator=g, device=device,
                           dtype=torch.float64) * 2.0 - 1.0).to(dtype)
    rows = lanes if mask_per_lane else lanes[:1] + (1,) * (len(lanes) - 1)
    if ragged:
        lengths = torch.floor(rand(rows + (n,)) * t).long() + 1
        lengths[..., 0] = 1
        lengths[..., -1] = t
    else:
        lengths = torch.full(rows + (n,), t, device=device)
    mask = torch.arange(t, device=device) < lengths[..., None]
    return log_pz1, log_trans, log_rho, mask


FULL = (8192, 20)      # subjects x restarts of the VBEM main path
B2_CASES = [
    # name, lanes, N, T, K, per_seq, ragged, mask_per_lane
    ("small", (1,), 256, 50, 2, False, False, False),
    ("ragged_len1", (4,), 256, 50, 3, False, True, False),
    ("t1", (2,), 128, 1, 2, False, False, False),
    ("k1", (2,), 128, 20, 1, False, True, False),
    ("k8", (2,), 128, 20, 8, False, True, False),
    ("per_seq", (3,), 128, 20, 3, True, True, True),
    ("lanes", (16, 20), 25, 50, 2, False, True, False),
    ("full_width", FULL, 25, 50, 2, False, False, False),
    ("full_width_k3", FULL, 25, 50, 3, False, False, False),
]


def phase_parity_b2(fails: Failures, device) -> float:
    """B2 against the plain version in float64 on the kernel's inputs, as
    for B1; returns the largest absolute float32 error seen."""
    max_abs_f32 = 0.0
    fields = ("gamma", "xi_sum", "phi_norm")
    for dtype in (torch.float32, torch.float64):
        for name, lanes, n, t, k, per_seq, ragged, mpl in B2_CASES:
            args = fb_inputs(1, lanes, n, t, k, device, dtype, per_seq,
                             ragged, mpl)
            got = fb_cuda.forward_backward_cuda(*args)
            torch.cuda.synchronize()
            want = fb_plain.forward_backward(
                *[a.double() if a.is_floating_point() else a for a in args])
            errs, max_abs = _errors(got, want, fields)
            if dtype == torch.float32:
                max_abs_f32 = max(max_abs_f32, max_abs)
                del want
                p32 = fb_plain.forward_backward(*args)
                k_vs_p32, _ = _errors(got, p32, fields)
                print(f"info B2 {name} f32: kernel vs plain f32 "
                      f"{max(k_vs_p32.values()):.3e}", flush=True)
                del p32
            del got
            _gate(fails, "B2", name, dtype, errs)
            torch.cuda.empty_cache()
    return max_abs_f32


# ---------------------------------------------------------------------------
# phase 3: the VBHEM path on a planted bank
# ---------------------------------------------------------------------------

def phase_vbhem_path(fails: Failures, device, kb=8192, trials=8,
                     trace_iters=50) -> dict:
    """cluster() and em_trace() on the planted bank; returns the kernel
    launches counted during the cluster() run."""
    dtype = torch.float32
    base, labels = planted_bank(kb, device, dtype)
    cfg = VBHEMConfig(trials=trials, learn_hyps=False, initmode="baseem",
                      nv=100, tau=10, m0=(13.0, 10.0), w0=1.0)
    gen = torch.Generator(device="cpu").manual_seed(0)

    reset_counts()
    t0 = time.perf_counter()
    res, info = vbhem.cluster(gen, base, [1, 2, 3], [2, 3], cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()

    lls = np.asarray(info["model_ll"])
    iters = sum(info["model_em_iters"].values())
    print(f"VBHEM path: Kb={kb} trials={trials} grid K=[1,2,3] x S=[2,3] "
          f"wall={wall:.3f}s em_iterations={iters} launches={launches}",
          flush=True)
    print(f"VBHEM path: selected K={info['model_best_k']} "
          f"S={info['model_best_s']}; scores={lls.tolist()}", flush=True)
    fails.check(bool(np.all(np.isfinite(lls))), "VBHEM path ELBOs finite")
    fails.check(launches["B1"] >= iters > 0,
                f"VBHEM path launched B1 {launches['B1']} times for "
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
                f"VBHEM em_trace {trace_iters} iterations: ELBO "
                f"{tr[0]:.6g} -> {tr[-1]:.6g}, largest relative decrease "
                f"{drop:.3e}")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phases 4-5: the VBEM path and the pipeline
# ---------------------------------------------------------------------------

VB_CONFIG = VBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=20, learn_hyps=False)


def phase_vbem_path(fails: Failures, device, n_per_group=4096,
                    trace_iters=50) -> dict:
    """learn_bank() on the synthetic protocol's data, and a VBEM
    em_trace; returns the results, labels and launches."""
    batches, labels = synthetic_subjects(n_per_group, seed=1, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    t0 = time.perf_counter()
    results, info = vbem_batch.learn_bank(gen, batches, 2, VB_CONFIG)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()

    iters = info["model_em_iters"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_subj = len(results)
    print(f"VBEM path: {n_subj} subjects x {VB_CONFIG.numtrials} restarts "
          f"(25 sequences, T=50, D=2, K=2) wall={wall:.3f}s "
          f"em_iterations={iters} launches={launches} "
          f"peak_memory={peak:.2f} GiB", flush=True)
    lls = torch.stack([r.ll for r in results])
    fails.check(bool(torch.all(torch.isfinite(lls))),
                f"VBEM path: all {n_subj} ELBOs finite")
    fails.check(launches["B2"] >= iters > 0,
                f"VBEM path launched B2 {launches['B2']} times for {iters} "
                f"EM iterations")
    trans = torch.stack([r.model.trans for r in results])
    diag = torch.diagonal(trans, dim1=-2, dim2=-1).mean(-1).cpu().numpy()
    side = float(np.mean((diag > 0.5) == (labels == 0)))
    fails.check(side >= 0.999,
                f"VBEM path: mean transition diagonal on the planted "
                f"group's side of 0.5 for {side:.6f} of subjects "
                f"(group means {diag[labels == 0].mean():.4f} / "
                f"{diag[labels == 1].mean():.4f})")

    bank = SeqBatch(
        x=torch.stack([b.x for b in batches]),
        lengths=torch.stack([b.lengths for b in batches]))
    hyps = vbhmm.VBHyps.from_config(VB_CONFIG, 2, torch.float32, device)
    post0 = vbhmm.random_init(gen, bank, 2, hyps, lanes=(1,))
    _, trace = vbhmm.em_trace(bank, post0, hyps, n_iter=trace_iters)
    tr = trace.double().cpu().numpy()                 # [iters, S, 1]
    drop = float(np.max((tr[:-1] - tr[1:]) / np.abs(tr[:-1])))
    fails.check(bool(np.all(np.isfinite(tr))) and drop <= 1e-5,
                f"VBEM em_trace {trace_iters} iterations on {n_subj} "
                f"subjects: largest relative decrease {drop:.3e}")
    return {"results": results, "labels": labels, "launches": launches,
            "bank": bank, "hyps": hyps, "wall_s": wall, "iters": iters}


# Restarts of the pipeline's cluster() call.  tests/test_vbhem.py:49-56
# uses 8 at Kb=12.  At Kb=8192 most baseem restarts collapse into one
# cluster: with Nv*Kb near alpha0=1e6, the random initial cluster weights
# tilt the first E-step's assignments.  tools/restart_success.py counts
# the restarts that recover the groups on the bank phase 4 learns; 64
# make a miss of every one unlikely, and the best ELBO picks the restart
# (see PERF.md).
PIPELINE_TRIALS = 64


def phase_pipeline(fails: Failures, device, vbem) -> dict:
    """h3m_from_results() + cluster() on the bank phase 4 learned, at the
    settings of the JAX package's tests/test_vbhem.py:49-56 but with
    PIPELINE_TRIALS restarts."""
    labels = vbem["labels"]
    cfg = VBHEMConfig(alpha0=1e6, m0=(1.5, 1.5), w0=1.0,
                      trials=PIPELINE_TRIALS, nv=100, tau=50,
                      initmode="baseem", learn_hyps=False)
    gen = torch.Generator(device="cpu").manual_seed(0)
    reset_counts()
    t0 = time.perf_counter()
    base = vbhem.h3m_from_results(vbem["results"])
    res, info = vbhem.cluster(gen, base, [1, 2, 3], 2, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    iters = sum(info["model_em_iters"].values())
    print(f"pipeline: Kb={base.num_hmms} on {base.hmm.mean.device} "
          f"K=[1,2,3] S=2 tau=50 trials={cfg.trials} wall={wall:.3f}s "
          f"em_iterations={iters} launches={launches}", flush=True)
    print(f"pipeline: selected K={info['model_best_k']} "
          f"S={info['model_best_s']}; scores="
          f"{np.asarray(info['model_ll']).ravel().tolist()}", flush=True)
    fails.check(launches["B1"] >= iters > 0,
                f"pipeline launched B1 {launches['B1']} times for {iters} "
                f"EM iterations")
    fails.check(bool(np.all(np.isfinite(info["model_ll"]))),
                "pipeline ELBOs finite")
    ri = rand_index(info["model_all"][(2, 2)].label.cpu().numpy(), labels)
    fails.check(ri == 1.0, f"pipeline (K=2, S=2) labels vs planted groups: "
                           f"Rand index {ri}")
    return {"launches": launches, "best_k": info["model_best_k"]}


# ---------------------------------------------------------------------------
# phase 6: timing
# ---------------------------------------------------------------------------

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


def timing_b1(device, n=50) -> dict:
    """B1: E-step (wrapper and kernel) and EM iteration times, kernel and
    plain, in the order kernel, plain, plain, kernel; the kernel's device
    time by the profiler; the bound.  The last shape is the kernels
    line's."""
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
        estep = interleaved({w: (lambda f=f: f(base, post, exps, tau))
                             for w, f in pair_fns.items()}, n, device)

        def stepper(f):
            state = [post]

            def step():
                state[0], _ = em_iteration(base, state[0], hyps, tilde_n,
                                           tau, f)
            return step
        iters = interleaved({w: stepper(f) for w, f in pair_fns.items()},
                            n, device)
        dev_ms = device_ms(lambda: vbhem.e_step(base, post, exps, tau),
                           DEVICE_NAMES["B1"], 20)
        pairs = kb * lanes * kr
        row = {"kernel_device_ms": dev_ms,
               **b1_bound(kb, lanes * kr, 3, sr, d, tau, 4)}
        for which in ("kernel", "plain"):
            est = float(np.mean(estep[which])) * 1e3
            itr = float(np.mean(iters[which])) * 1e3
            row[which] = {"estep_ms": est, "iter_ms": itr,
                          "pairs_per_s": pairs / (itr / 1e3),
                          "estep_ms_runs": [x * 1e3 for x in estep[which]],
                          "iter_ms_runs": [x * 1e3 for x in iters[which]]}
            print(f"timing B1 [{name}] {which}: E-step {est:.4f} ms, "
                  f"EM iteration {itr:.4f} ms, {pairs / (itr / 1e3):.4g} "
                  f"pair-updates/s (runs: E-step "
                  f"{row[which]['estep_ms_runs']} ms, iteration "
                  f"{row[which]['iter_ms_runs']} ms)", flush=True)
        print(f"timing B1 [{name}] kernel device {dev_ms:.4f} ms; bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
              f"{row['sfu_ops']:.4g} SFU ops, {row['bytes']:.4g} bytes; "
              f"the kernel's carry scratch adds {row['scratch_bytes']:.4g} "
              f"bytes)", flush=True)
        out[name] = row
    return out


def vbem_iteration(bank, post, hyps, fb_fn):
    """One VBEM iteration with the forward-backward ``fb_fn``."""
    x, mask = vbhmm._views(bank, post.alpha.shape[:-1])
    log_rho = fb_plain.expected_log_gauss(x, post.niw)
    fb = fb_fn(e_log_dirichlet(post.alpha), e_log_dirichlet(post.epsilon),
               log_rho, mask)
    stats = vbhmm.suff_stats(bank, fb)
    ll = vbhmm.elbo(bank, post, fb, stats, hyps)
    return vbhmm.m_step(stats, hyps), ll


def timing_b2(device, vbem, n=10) -> dict:
    """B2 at the full-width launch (the VBEM path's own shape: every
    subject x restart lane of the bank, its learned-from-random-start
    posteriors): wrapper, kernel device time and plain; one VBEM
    iteration with the kernel and with the plain version."""
    bank, hyps = vbem["bank"], vbem["hyps"]
    gen = torch.Generator(device=device).manual_seed(3)
    post = vbhmm.random_init(gen, bank, 2, hyps,
                             lanes=(VB_CONFIG.numtrials,))
    x, mask = vbhmm._views(bank, post.alpha.shape[:-1])
    args = (e_log_dirichlet(post.alpha), e_log_dirichlet(post.epsilon),
            fb_plain.expected_log_gauss(x, post.niw).contiguous(), mask)
    fb_runs = interleaved({"kernel": lambda: fb_cuda.forward_backward_cuda(
        *args), "plain": lambda: fb_plain.forward_backward(*args)}, n,
        device, warmup=1)
    dev_ms = device_ms(lambda: fb_cuda.forward_backward_cuda(*args),
                       DEVICE_NAMES["B2"], 5)

    def stepper(f):
        state = [post]

        def step():
            state[0], _ = vbem_iteration(bank, state[0], hyps, f)
        return step
    it_runs = interleaved({"kernel": stepper(fb_cuda.forward_backward_auto),
                           "plain": stepper(fb_plain.forward_backward)},
                          3, device, warmup=1)
    row = {"kernel_device_ms": dev_ms, **b2_bound(*args)}
    for which in ("kernel", "plain"):
        row[which] = {"fb_ms": float(np.mean(fb_runs[which])) * 1e3,
                      "iter_ms": float(np.mean(it_runs[which])) * 1e3,
                      "fb_ms_runs": [v * 1e3 for v in fb_runs[which]],
                      "iter_ms_runs": [v * 1e3 for v in it_runs[which]]}
    lanes = tuple(args[2].shape[:-3])
    print(f"timing B2 [full width: {lanes} lanes x 25 sequences, T=50, "
          f"K=2, f32] kernel device {dev_ms:.4f} ms; wrapper "
          f"{row['kernel']['fb_ms']:.4f} ms (runs "
          f"{row['kernel']['fb_ms_runs']}); plain {row['plain']['fb_ms']:.4f}"
          f" ms (runs {row['plain']['fb_ms_runs']}); bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {row['bytes']:.4g} "
          f"bytes, {row['sfu_ops']:.4g} SFU ops)", flush=True)
    print(f"timing VBEM iteration [full width]: kernel "
          f"{row['kernel']['iter_ms']:.4f} ms (runs "
          f"{row['kernel']['iter_ms_runs']}), plain "
          f"{row['plain']['iter_ms']:.4f} ms (runs "
          f"{row['plain']['iter_ms_runs']})", flush=True)
    return row


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "only on an NVIDIA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    fails = Failures()
    t_start = time.perf_counter()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})", flush=True)
    print(f"nvidia-smi: {nvidia_smi_line()}", flush=True)

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

    results = {}

    def run(name, fn):
        t = time.perf_counter()
        try:
            results[name] = fn()
        except Exception:   # report the phase as failed, keep going
            traceback.print_exc()
            fails.check(False, f"phase {name} raised")
        torch.cuda.empty_cache()
        print(f"phase {name}: {time.perf_counter() - t:.1f}s", flush=True)

    run("parity B1", lambda: phase_parity_b1(fails, device))
    run("parity B2", lambda: phase_parity_b2(fails, device))
    run("VBHEM path", lambda: phase_vbhem_path(fails, device))
    run("VBEM path", lambda: phase_vbem_path(fails, device))
    if "VBEM path" in results:
        run("pipeline", lambda: phase_pipeline(fails, device,
                                               results["VBEM path"]))
        run("timing B2", lambda: timing_b2(device, results["VBEM path"]))
    else:
        fails.check(False, "pipeline and B2 timing need the VBEM path")
    run("timing B1", lambda: timing_b1(device))

    lines = []
    for key, parity, path, timing in (
            ("B1", "parity B1", "VBHEM path", "timing B1"),
            ("B2", "parity B2", "VBEM path", "timing B2")):
        t = results.get(timing, {})
        if key == "B1":   # the kernels line reads the main-path cell
            t = t.get(TIMING_SHAPES[-1][0], {})
            wrapper_ms = t.get("kernel", {}).get("estep_ms")
            plain_ms = t.get("plain", {}).get("estep_ms")
        else:
            wrapper_ms = t.get("kernel", {}).get("fb_ms")
            plain_ms = t.get("plain", {}).get("fb_ms")
        launches = results.get(path, {}).get("launches", {}).get(key)
        lines.append(dict(
            KERNELS[key], launches=launches,
            max_abs_err=results.get(parity), ms=t.get("kernel_device_ms"),
            wrapper_ms=wrapper_ms, plain_ms=plain_ms,
            bound_ms=t.get("bound_ms"), bound_by=t.get("bound_by"),
            library_ms=None))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f}s in all",
          flush=True)
    if fails.items:
        print(f"chip_smoke: {len(fails.items)} check(s) failed: "
              f"{fails.items}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": lines}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
