"""Drive the PyTorch / CUDA port (``vbhem_tpu_torch``) once on one NVIDIA
card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device and build: the card's name and power limit, and the build of
     every CUDA kernel from the sources in this checkout (one nvcc per
     source, all at once); ptxas's report of the padded grid's bodies (B1
     at (Sb, Sr, D) = (2, 5, 2) in float32, B3 at (2, 5) in float64, each
     design) must show no stack frame and no spills (NO_SPILL_BODIES);
  2. kernel parity: each kernel against its plain PyTorch version on the
     same CUDA tensors, the plain version evaluated in float64; the
     float32 kernel within 5e-5 and the float64 kernel within 1e-10 of
     max |got - want| / (|want| + 1), at small shapes and at the shapes the
     main paths launch.  B1 is the pair E-step, B2 the VBEM
     forward-backward (both of its entries: the forward-backward of given
     log_rho, in the resident and the streamed design, and the fused
     E-step that forms log_rho from x in the kernel), B3 the VHEM / DIC
     pair recursion; B1 and B3 in each of their designs (the recursion's
     state resident in shared memory, in checkpointed segments in shared
     memory, or in a device-memory scratch), at shapes that pick each and
     with each forced at the main paths' shapes, and on inputs that fire
     the recursion's underflow guard (masked reduced states, -inf log_a),
     in every body; past the register bodies (Sb,
     Sr above 8 in B1 and B3, K above 8 in B2: the wide bodies, whose
     vectors live in device memory) and past B1's emission dims (D=5:
     E3logN in PyTorch, then a B3 launch); B1 at the padded grid's launch
     (every lane its own cluster and state masks) and at the hyp
     objective's (Kb=40, 80 lanes), and B3 in float64 at the grid
     rescoring's launch;
  3. VBHEM path: ``vbhem.cluster`` over (K, S) in {1,2,3} x {2,3} on a
     planted bank of 8192 base HMMs with 8 restart trials per cell; the
     ELBOs must be finite, every EM iteration must have launched B1, in an
     on-chip design, and the (K=2, S=2) labels must recover the planted
     groups (Rand index 1.0); plus a 50-iteration ``em_trace`` whose ELBO
     must not decrease;
  4. VBEM path: ``batch.learn_bank`` on the synthetic protocol's data at
     8192 subjects (25 sequences of T=50, D=2), K=2, 20 restarts: every
     ELBO finite, B2's fused E-step launched on every EM iteration, the
     planted
     transition structure recovered for at least 99.9% of subjects, and a
     50-iteration VBEM ``em_trace`` whose ELBO never falls by more than
     1e-5 relative;
  5. pipeline: the bank phase 4 learned, through ``h3m_from_results`` and
     ``vbhem.cluster`` (K in {1,2,3}, S=2, the JAX package's test
     settings with 64 restarts, see PIPELINE_TRIALS); the (K=2, S=2)
     labels must recover the two groups;
  6. VHEM path: ``experiments.synthetic.run_vhem_grid`` at its defaults
     (20 restarts, Nv=100, tau=10, initmode 'auto') over K, S in {1,2,3}
     on the point-estimate bank phase 4 learned (Kb=8192, Sb=2): every LL
     and criterion finite, kernel B3 (the pair recursion on a precomputed
     emission matrix) launched on every EM iteration, the (K=2, S=2)
     labels recovering the groups; the AIC and BIC selections printed;
  7. DIC: ``run_vbhem_dic`` over the pipeline's grid, once in float32 and
     once with the same results and bank cast to float64 (B3's float64
     entry); every DIC finite, B3 launched once per cell and dtype, and
     each of those launches held against the plain version in float64 on
     its own inputs, with phase 2's tolerances; both tables and
     selections printed;
  8. grid: ``vbhem.cluster_batched`` on the bank phase 4 learned (Kb=8192,
     Sb=2), K=1..6 x S=1..5, tau=50, Nv=100, baseem, GRID_TRIALS
     restarts, float32 with the float64 rescoring of every cell winner:
     B1 launched on every EM iteration of every lane chunk, in the design
     ``pair_estep_cuda.design`` names for the chunk; B3 once per rescored
     cell; every score finite; the (K=2, S=2) labels recovering the
     groups; the chunks, peak memory, wall time, both score grids and each
     cell's float32-against-float64 gap printed.  Then B1 once at the
     grid's own chunk launch: no [tau-1, Sb*Sr, L*Kr, Kb] scratch (the
     launch's device memory below its outputs and a tenth of that
     scratch), seven of its lanes within 5e-5 of the plain version in
     float64 and exact zeros at their masked states.  Then padded equals
     unpadded: lanes of cell (2, 2), drawn as the grid draws them, run
     padded and sliced to (2, 2) from the same start, their ELBOs within
     5e-5 relative;
  9. protocol: ``experiments.synthetic.run_vbhem`` at
     ``default_vbhem_config()``'s settings with hyperparameter learning
     off, on 20 subjects per group of phase 4's bank: the (2, 2) cell's
     Rand index 1.0; the selected K, S and Rand index printed;
  10. timing (informational): each kernel's device time, its wrapper's
     time and its plain version's time at its main-path shape (B1 also at
     the bench shape and the pipeline's largest launch), and one EM
     iteration of each engine (VBHEM, VBEM, VHEM) with the kernel and
     with the plain version (the engine's own iteration, its kernel
     wrapper rebound to the plain version for the plain runs); for B2
     both entries, the fused E-step against ``expected_log_gauss``
     followed by entry 1; B1 at the grid's launch (one lane chunk, with
     and without masked states; the 344-lane chunk of the scratch design;
     the hyp objective's launch), B3 float64 at the rescoring's launch,
     one grid EM iteration, and the wide bodies at S=9 and K=9, each
     beside its bound;
  11. hyp gradient (after phase 9): each engine's hyperparameter objective
     (``vbhmm.neg_elbo_objective`` on 4 subjects of phase 4's bank, one
     lane each; ``vbhem.neg_elbo_objective`` on lanes of the padded
     protocol grid with their cells' masks), its value and theta-gradient
     at hyps0, from restart solutions (the starts run to convergence
     first, as on the hyp path; the objective's EM then runs
     HYP_GRAD_ITERS iterations), with the kernels in float64 and float32
     and with the kernel's dispatch rebound to its plain version; the
     gap is the value's relative one and the gradient's in max norm: within
     1e-10 of the plain float64 run (f64), and in f32 within twice the
     plain version's own float32 run's gap to it plus 5e-5 (an EM run and
     its bound in float32 stray from float64 whatever computes the
     E-step); B2 (VBEM) and B1 (VBHEM) launched
     once per EM iteration and final E-step of the objective;
  12. protocol with hyps on: 20 subjects per planted group drawn
     with a seed of their own (PROTOCOL_HYPS_SEED), then
     ``synthetic.learn_subject_hmms`` at ``default_vb_config()`` and
     ``synthetic.run_vbhem`` at ``default_vbhem_config()`` (K=1..6 x
     S=1..5, 50 restarts, tau=50, Nv=100), both with hyps on and their
     one cut: 25 L-BFGS steps (PROTOCOL_HYP_STEPS), not 50: B2 launched
     on every EM iteration of the VBEM stage, B1 on every one of the
     VBHEM stage (restarts, hyp objective, rerun), B3 float64 once per
     rescored cell; every kept lane's bound at least its pre-optimization
     bound minus the monotone contract's tolerance; the learned hyps
     inside their bounds; every score finite; the (2, 2) cell's Rand index
     1.0 and the selection K=2, S=[2, 2], Rand index 1.0; every cell's
     float32 bound under its learned hyps within GRID_GAP_LIMIT of its
     float64 rescoring; each stage's wall time, lanes, L-BFGS steps,
     objective calls, EM iterations (beside F32_TERMS_BEFORE), reverted
     lanes, the selected cell's hyps and each cell's gap printed;
  13. runner (after phase 12): ``experiments.runner.run_repeat`` for repeat
     0 with all four methods (VBHEM with DIC, VHEM with AIC/BIC, CCFD, PPK
     with AIC/BIC, and the Dunn index) at the reference data scale (20
     subjects per group, 25 sequences of T=50, K=1..6 x S=1..5), at
     ``default_vb_config()``, ``default_vbhem_config()`` and the CLI's
     ``HEMConfig(trials=20, nv=100, tau=50)``, float32, checkpointing under
     the ignored ``build/``.  Its one cut: hyperparameter learning off in
     both configs (five hyps-on VBEM banks would take minutes; phase 12
     drives hyps at this scale).  No stage may leave a ``*_error``; every
     score and Dunn index finite; B2 launched on every VBEM EM iteration of
     the five banks, B1 on every VBHEM one, B3 on every VHEM iteration and
     once per rescored cell and DIC cell; VBHEM's selection K=2, S=[2, 2]
     with Rand index 1.0.  Then ``run_repeat`` again on the same directory
     must load every stage, launch no kernel and return the same scores.
     Every method's selection and Rand index and each stage's wall time
     printed.

  14. initmodes (after phase 9): each VBHEM initializer (baseem, gmmNew,
     gmmNew2, wtkmeans, random) at full width, the (K=2, S=2) cell of
     phase 4's bank (Kb=8192, Sb=2), PIPELINE_TRIALS restarts at the
     pipeline's settings: the initializer's time and peak memory, the
     EM's iterations, wall time and B1 launches (one per iteration), the
     restarts that recover the groups and whether the best-ELBO restart
     does (findings); the ELBO of 30 EM iterations from the same starts
     never falling by more than 1e-5 relative, in float32 and in
     float64, the float32 bound (B1's float32 body) at each float64
     iterate within 1e-4 of the float64 one (each term's gap printed),
     and the best lane finite (gates).
     Then ``cluster`` under the default initmode 'auto' over K in {1,2,3}
     x S=2 (K=2 with Rand index 1.0) and ``cluster_batched`` under 'auto'
     over K, S in {1,2,3} with 8 restarts a mode ((2, 2), Rand index 1.0,
     every cell within 1e-4 of its float64 rescoring);
  15. grouped (after phase 13): ``vbhmm_groups.learn_grouped`` on two
     stimulus conditions with shared ROIs and different dynamics (4096
     sequences of T=50, D=2), K in {1,2,3}, 20 restarts, hyps off: K=2;
     B2's fused entry (per-sequence scores) once per EM iteration and
     standardized model; a 30-iteration grouped EM whose ELBO never falls
     by more than 1e-5 relative; B2 at this launch's own shape held
     against the plain version in float64 (5e-5 / 1e-10) and timed;
  16. demo: the `vbdemo_face.m` path as the demo CLI runs it on
     synthetic face-viewing data (40 viewers, 12 trials of 12 fixations
     on a 512 x 384 face; the reference's demodata.xls is not in the
     repository) written to a fixation CSV under the ignored ``build/``
     and read back by the native loader (gated); then
     ``demo_fixations.demo_path``: per-subject VBEM over S=1..3 with
     ``VBConfig(numtrials=10, learn_hyps=True)`` and mode 'd' hyps (the
     subjects as lanes of ``learn_bank``), ``cluster_batched`` over
     K=1..5 x S=1..3 at the demo's synthetic-data settings (the JAX
     example's: alpha0=1e6, Nv=50, tau=10, 'auto', 10 restarts, float32
     with the float64 rescoring) and ``vbh3m_remove_empty``: K_hat=2
     clusters after pruning with a Rand index of at least 0.9 (at most
     two viewers off their group's cluster, as the JAX package gives on
     the same banks) required.  Its cuts, printed: VBEM hyps on 5 survivors
     a subject with 10 L-BFGS steps; no plots on the card;
  17. spmd: the sharded engine (``vbhem_tpu_torch.parallel.spmd``) at the
     main-path cell (the 8192-HMM planted bank, 8 restarts of Kr=Sr=3,
     tau=10) in two gloo ranks sharing the card (spawned processes):
     ``replicate_to_mesh`` gives both rank 0's bank; mesh (1, 2), each
     rank B1 on its 4096 HMMs x 24 reduced clusters
     once an EM iteration, resident; the float64 run equal to the
     unsharded ``vbhem_em`` (same iterations, ll within 1e-9, posterior
     within 1e-7), the float32 one timed beside the unsharded run; mesh
     (2, 1): ``sharded_fit_trials`` and ``sharded_grid_sweep`` (K=1..3 x
     S=2..3, 8 trials) equal to ``fit_single_ks`` / ``fit_grid_batched``
     (same iterations, ll within 1e-10).  Then a one-rank NCCL world:
     mesh (1, 1), the EM loop under the world group and
     ``sharded_fit_trials``, each bit for bit its unsharded run.  A rank
     that fails or misses the deadline fails the phase;
  18. fb assoc (last): ``ops.fb.forward_backward_assoc`` (plain PyTorch,
     on no path) on CUDA tensors against B2's entry 1 at 256 ragged
     sequences of T=4096, K=2 and K=4, float64 (gamma and xi_sum within
     1e-9 and 1e-8 absolute, phi_norm within 1e-10 relative); both timed
     in float32 by CUDA events.

B3 is checked in phase 2 like B1 and B2.  Each of phases 3-9 and 11-18
sets every
kernel's launch count (B1's and B3's also by design) to 0 just before it
runs its path and reads the counts just after.  Prints a JSON line
describing each kernel, the ``nvidia-smi`` name and power-limit line, and
last ``{"ok": true, "device": {...}}``.  Exits non-zero, before any
result, when no CUDA device is available.  Imports neither JAX nor the
JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from vbhem_tpu_torch import HEMConfig, SeqBatch, VBConfig, VBHEMConfig, hyp
from vbhem_tpu_torch.containers import HMM, NIW, tree_map
from vbhem_tpu_torch.convert import to_numpy
from vbhem_tpu_torch.experiments import synthetic
from vbhem_tpu_torch.models import batch as vbem_batch
from vbhem_tpu_torch.models import dic as dic_model
from vbhem_tpu_torch.models import (hmm_tools, vbhem, vbhmm, vbhmm_groups,
                                    vhem)
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
           "source": "vbhem_tpu_torch/csrc/fb.cuh",
           "replaces": "vbhem_tpu/ops/fb_pallas.py:51"},
    "B3": {"name": "pair_bwd_fwd", "route": "cuda",
           "source": "vbhem_tpu_torch/csrc/pair_bwd_fwd.cu",
           "replaces": "vbhem_tpu/ops/pair_estep_pallas.py:110"},
}
# where each kernel's wide body (more than 8 states) lives
WIDE_SOURCES = {"B1": "vbhem_tpu_torch/csrc/pair_recursion.cuh",
                "B2": "vbhem_tpu_torch/csrc/fb_wide.cu",
                "B3": "vbhem_tpu_torch/csrc/pair_recursion.cuh"}
# each kernel's launch counters: (module, attribute); B2 counts its two
# entries apart (entry 1 and the fused E-step)
COUNTERS = {"B1": (pair_estep_cuda, "LAUNCHES"), "B2": (fb_cuda, "LAUNCHES"),
            "B2_fused": (fb_cuda, "FUSED_LAUNCHES"),
            "B3": (pair_estep_cuda, "BWD_FWD_LAUNCHES")}
# device kernel names; both B2 entries run fb_resident_kernel at the main
# path's shapes (fb_streamed_kernel serves long sequences)
DEVICE_NAMES = {"B1": "pair_estep_fused_kernel", "B2": "fb_resident_kernel",
                "B3": "pair_bwd_fwd_kernel"}

# Peak rates of one H100 SXM, from NVIDIA's published specifications:
# device memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s,
# float64 outside the tensor cores 34 TFLOP/s.  float32 special functions
# (exp, log) run on the SFUs: 16 results per clock per SM (NVIDIA's
# published arithmetic throughput table for compute capability 9.0) at
# the 1.98 GHz boost clock, over the card's SMs.  float64 ones have no
# SFU instruction and run as float64 arithmetic: counted as 16 flops each
# (8 FMAs: a range reduction and a short polynomial, fewer than any
# correctly rounded exp or log takes), so the bound stays a floor.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12
F64_FLOP_PER_SPECIAL = 16
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


@contextlib.contextmanager
def rebound(module, name, fn):
    """Bind ``module.name`` to ``fn`` for the duration of the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def reset_counts():
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
    for per in pair_estep_cuda.DESIGN_LAUNCHES.values():
        for kind in per:
            per[kind] = 0


def read_counts() -> dict:
    """Every counter; B1's and B3's launches by design as 'B1_resident'
    and so on."""
    counts = {k: getattr(mod, attr) for k, (mod, attr) in COUNTERS.items()}
    for kernel, per in pair_estep_cuda.DESIGN_LAUNCHES.items():
        for kind, n in per.items():
            counts[f"{kernel}_{kind}"] = n
    return counts


# The bodies the padded grid's launches take, whose ptxas report must show
# no stack frame and no spill stores or loads in every design built: B1 at
# (Sb, Sr, D) = (2, 5, 2) in float32, B3 at (2, 5) in float64 (the
# rescoring; float64 has no checkpointed build); the pattern's group is
# the design's code.
NO_SPILL_BODIES = {
    "B1 (2,5,2) f32": (r"pair_estep_fused_kernelIfLi2ELi5ELi2ELi(\d)ELb1E",
                       pair_estep_cuda.DESIGNS),
    "B3 (2,5) f64": (r"pair_bwd_fwd_kernelIdLi2ELi5ELi(\d)ELb1E",
                     ("resident", "scratch"))}


def check_ptxas(fails, lib) -> dict:
    """ptxas's report of the NO_SPILL_BODIES, printed and gated: each
    body's designs built, with no stack frame and no spills; returns
    {body: {design: report}}."""
    report = _build.ptxas_report(lib)
    out = {}
    for what, (pattern, designs) in NO_SPILL_BODIES.items():
        rows = {}
        for name, row in report.items():
            m = re.search(pattern, name)
            if m:
                rows[pair_estep_cuda.DESIGNS[int(m.group(1))]] = row
        for des, row in rows.items():
            print(f"ptxas {what} {des}: {json.dumps(row)}", flush=True)
        fails.check(
            sorted(rows) == sorted(designs) and all(
                row.get("stack") == row.get("spill_stores")
                == row.get("spill_loads") == 0 for row in rows.values()),
            f"ptxas: {what} in its designs {sorted(designs)} with 0 bytes "
            f"of stack frame, spill stores and spill loads (found "
            f"{sorted(rows)})")
        out[what] = rows
    return out


def check_on_chip(fails, what, launches, kernel, kind="resident"):
    """Every launch of ``kernel`` in ``launches`` took the design ``kind``:
    by default the resident design, the recursion's state on chip, none
    in the scratch; for the padded grid the design that
    ``pair_estep_cuda.design`` names for its launch."""
    other = [k for k in pair_estep_cuda.DESIGNS if k != kind]
    fails.check(launches[f"{kernel}_{kind}"] == launches[kernel] > 0
                and all(launches[f"{kernel}_{k}"] == 0 for k in other),
                f"{what}: {kernel}'s {launches[kernel]} launches all in "
                f"the {kind} design (" + ", ".join(
                    f"{k} {launches[f'{kernel}_{k}']}"
                    for k in pair_estep_cuda.DESIGNS) + ")")


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

def sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def bound(n_bytes: float, n_sfu: float, n_flop: float,
          itemsize: int = 4) -> dict:
    """The larger of the bytes time and the operations time: in float32
    the special functions on the SFUs, the rest at the float32 rate; in
    float64 both at the float64 rate, F64_FLOP_PER_SPECIAL flops for each
    special function."""
    sms = sm_count()
    t_bytes = n_bytes / HBM_BYTES_PER_S
    if itemsize == 8:
        t_ops = (n_sfu * F64_FLOP_PER_SPECIAL + n_flop) / F64_FLOP_PER_S
    else:
        t_ops = max(n_sfu / (sms * SFU_PER_SM_PER_CLOCK * BOOST_HZ),
                    n_flop / F32_FLOP_PER_S)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "sfu_ops": n_sfu, "flops": n_flop}


def pair_sfu(pairs, sb, sr, tau) -> int:
    """The special functions the pair recursion needs: per backward step
    Sb*Sr exp (w = exp(ell + carry - max), after which the log-sum-exps
    over the reduced state are sums of A w with A = exp(log_a) formed once
    per reduced model) and Sr*Sb log; the termination Sb*Sr exp and Sb
    log; none in the forward pass, whose Theta = A w / S needs only the
    stored w and sums."""
    return pairs * ((tau - 1) * 2 * sb * sr + sb * (sr + 1))


def pair_sfu_before(pairs, sb, sr, tau) -> int:
    """The earlier count: Sr*Sb*Sr exp and Sr*Sb log per backward step,
    Sb*(2 Sr + 1) for the termination; printed beside the recount."""
    return pairs * ((tau - 1) * (sr * sr * sb + sr * sb) + sb * (2 * sr + 1))


def _with_count_before(b, n_bytes, pairs, sb, sr, tau, flop,
                       itemsize) -> dict:
    before = bound(n_bytes, pair_sfu_before(pairs, sb, sr, tau), flop,
                   itemsize)
    return {**b, "bound_ms_before": before["bound_ms"],
            "sfu_ops_before": before["sfu_ops"]}


def b1_flop(pairs, sb, sr, d, tau) -> int:
    """B1's flops: the recursion's per step and E3logN's."""
    return pairs * ((tau - 1) * (5 * sr * sr * sb + 4 * sr * sb * sb)
                    + sb * sr * (4 * d * d + 4))


def b1_bound(kb, lkr, sb, sr, d, tau, itemsize) -> dict:
    """B1 per (base, reduced) pair, counting what the function needs: the
    special functions of :func:`pair_sfu` and the recursion's and E3logN's
    flops.  Bytes: the base bank and the reduced models read once, the
    four outputs written once; the per-step state is the kernel's choice
    and not counted."""
    pairs = kb * lkr
    flop = b1_flop(pairs, sb, sr, d, tau)
    n_bytes = itemsize * (kb * (sb + sb * sb + sb * d + sb * d * d)
                          + lkr * sr * (sr + d + d * d + 4)
                          + pairs * (1 + sr + sr * sr + sr * sb))
    return _with_count_before(
        bound(n_bytes, pair_sfu(pairs, sb, sr, tau), flop, itemsize),
        n_bytes, pairs, sb, sr, tau, flop, itemsize)


def b1_bound_live(kb, lane_cells, kmax, sb, smax, d, tau, itemsize) -> dict:
    """B1's bound at a padded grid launch with each lane's pairs counted at
    its own cell's S, the states whose statistics are not the exact zeros
    of a masked state; bytes as :func:`b1_bound` at the padded layout."""
    pairs = kb * kmax
    sfu = sum(pair_sfu(pairs, sb, s_, tau) for _, s_ in lane_cells)
    flop = sum(b1_flop(pairs, sb, s_, d, tau) for _, s_ in lane_cells)
    n_bytes = b1_bound(kb, len(lane_cells) * kmax, sb, smax, d, tau,
                       itemsize)["bytes"]
    return bound(n_bytes, sfu, flop, itemsize)


def b3_bound(kb, lkr, sb, sr, tau, itemsize) -> dict:
    """B3 per (base, reduced) pair: B1's special functions and recursion
    flops (no E3logN).  Bytes: ell [L*Kr, Sb, Sr, Kb] read once, the base
    prior and transitions and the reduced log_pi and log_a read once, the
    four outputs written once."""
    pairs = kb * lkr
    flop = pairs * (tau - 1) * (5 * sr * sr * sb + 4 * sr * sb * sb)
    n_bytes = itemsize * (kb * (sb + sb * sb) + lkr * sr * (1 + sr)
                          + pairs * sb * sr
                          + pairs * (1 + sr + sr * sr + sr * sb))
    return {**_with_count_before(
        bound(n_bytes, pair_sfu(pairs, sb, sr, tau), flop, itemsize),
        n_bytes, pairs, sb, sr, tau, flop, itemsize),
        "ell_bytes": itemsize * pairs * sb * sr}


def design_note(des, pairs, sb, sr, tau, itemsize) -> str:
    """The design a launch takes, and the scratch it allocates (only the
    scratch design has one)."""
    note = f"design {des.kind} ({des.threads} threads, " \
           f"{des.smem_bytes} B of shared memory a block"
    note += f", segments of {des.seg} steps)" if des.seg else ")"
    if des.kind == "scratch":
        note += (f"; its scratch {itemsize * (tau - 1) * sb * sr * pairs:.4g}"
                 f" bytes, written and read once")
    return note


def mask_bytes(m8) -> int:
    """Bytes of the mask rows m8 [..., T] held as T bits each."""
    return math.prod(m8.shape[:-1]) * -(-m8.shape[-1] // 8)


def b2_bound(log_pz1, log_trans, log_rho, mask) -> dict:
    """B2's entry 1 on these inputs: log_rho read once, the masked log_rho
    and gamma written once, the mask as the kernel reads it (one row of
    T bits per subject, shared by its restarts), the scores, xi_sum and
    phi_norm.
    Operations for the steps this mask makes valid: K exp and one log per
    valid step, the exp of the scores, and about 10 K^2 flops per valid
    step."""
    *lanes, n, t, k = log_rho.shape
    n_seq = math.prod(lanes) * n
    size = log_rho.element_size()
    m8, rep = fb_cuda._mask_lanes(mask, tuple(lanes))
    valid = float(torch.sum(m8.float())) * rep
    n_bytes = (size * (3 * n_seq * t * k + n_seq * (k * k + 1)
                       + log_pz1.numel() + log_trans.numel())
               + mask_bytes(m8))
    sfu = valid * (k + 1) + log_pz1.numel() + log_trans.numel()
    return bound(n_bytes, sfu, valid * 10 * k * k, size)


def b2_fused_bound(x, mask, log_pz1, log_trans, emis) -> dict:
    """B2's fused E-step on these inputs: x read once per subject (the
    rows the kernel reads, shared by the restarts), the emission
    constants, the scores and the mask rows (T bits) read once; the masked
    log_rho, gamma, xi_sum and phi_norm written once.  Operations: entry
    1's, plus the emission at each valid step (the output is 0 at padded
    ones): K (D + 2 D^2 + 1) flops."""
    lanes = tuple(emis.shape[:-2])
    *_, n, t, d = x.shape
    k = emis.shape[-2]
    n_seq = math.prod(lanes) * n
    size = emis.element_size()
    xr, _ = fb_cuda._lane_rows(x, lanes, 3)
    m8, rep = fb_cuda._mask_lanes(mask, lanes)
    valid = float(torch.sum(m8.float())) * rep
    n_bytes = (size * (xr.numel() + emis.numel() + log_pz1.numel()
                       + log_trans.numel() + 2 * n_seq * t * k
                       + n_seq * (k * k + 1)) + mask_bytes(m8))
    sfu = valid * (k + 1) + log_pz1.numel() + log_trans.numel()
    flop = valid * (10 * k * k + k * (d + 2 * d * d + 1))
    return bound(n_bytes, sfu, flop, size)


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


def device_ms(fn, kernel_name, n, attempts=3) -> float:
    """Mean device time (ms) of the kernels named ``kernel_name`` over
    ``n`` calls of ``fn``, read from a torch.profiler trace; a trace that
    holds none of them (the profiler drops a window now and then) is taken
    again, up to ``attempts`` times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
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
                if e.get("cat") == "kernel"
                and kernel_name in e.get("name", "")]
        if durs:
            return float(np.mean(durs)) / 1e3
    return float("nan")


def interleaved(fns: dict, n, device, warmup=2) -> dict:
    """{name: [seconds per call, ...]} for the fns in their order, then
    in the reverse order (kernel, plain, plain, kernel for two)."""
    runs = {name: [] for name in fns}
    for which in list(fns) + list(fns)[::-1]:
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


# the (K, S) cells of the grid_launch parity case's lanes, padded to
# (6, 5): single-cluster and single-state lanes among them
GRID_PARITY_CELLS = [(1, 1), (1, 5), (2, 2), (6, 1), (6, 5), (3, 4), (4, 3),
                     (5, 2)]

B1_CASES = [
    # name, kb, kr, sb, sr, d, tau, lanes, ragged, masking, forced design
    ("kb256_tau10", 256, 4, 3, 3, 2, 10, 1, False, None, None),
    ("tau1", 256, 4, 3, 3, 2, 1, 1, False, None, None),
    ("sb2_sr2_tau1", 256, 4, 2, 2, 2, 1, 1, False, None, None),
    ("ragged_sb", 256, 4, 3, 3, 2, 10, 1, True, None, None),
    ("d3", 256, 4, 3, 3, 3, 10, 1, False, None, None),
    ("sr1", 256, 4, 3, 1, 2, 10, 1, False, None, None),
    ("sr2", 256, 4, 3, 2, 2, 10, 1, False, None, None),
    ("lanes3", 256, 4, 3, 3, 2, 10, 3, False, None, None),
    # the underflow guard: a reduced state masked as the masked grid
    # masks it (-1e30), its E3logN 1000 nats above the others'
    ("masked_state_ragged", 256, 4, 3, 3, 2, 10, 1, True, "state", None),
    ("masked_column_tau50", 256, 4, 2, 2, 2, 50, 1, False, "column", None),
    ("masked_state_scratch", 256, 4, 3, 3, 2, 10, 1, True, "state",
     "scratch"),
    ("masked_state_tau50_scratch", 256, 4, 3, 3, 2, 50, 1, True, "state",
     "scratch"),
    ("masked_state_tau50_checkpointed", 256, 4, 3, 3, 2, 50, 1, True,
     "state", "checkpointed"),
    # the guard in the generic body (D=3 is not a specialization): without
    # kKeepZ (pair_recursion.cuh) nvcc 12.9's -O3 build got these wrong
    ("d3_masked_state_tau2", 256, 4, 3, 3, 3, 2, 1, False, "state", None),
    ("d3_masked_state_tau50", 256, 4, 3, 3, 3, 50, 1, False, "state", None),
    ("d3_masked_state_tau50_checkpointed", 256, 4, 3, 3, 3, 50, 1, False,
     "state", "checkpointed"),
    # the guard in the padded grid's (2, 5, 2) body, in each design: its
    # last state masked as 'state' masks it (so the body also runs it at
    # Sr = 4, live_states)
    ("grid_body_masked_state_tau2", 256, 4, 2, 5, 2, 2, 1, False, "state",
     None),
    ("grid_body_masked_state_tau50", 256, 4, 2, 5, 2, 50, 1, False, "state",
     None),
    ("grid_body_masked_state_tau50_checkpointed", 256, 4, 2, 5, 2, 50, 1,
     False, "state", "checkpointed"),
    ("grid_body_masked_state_tau50_scratch", 256, 4, 2, 5, 2, 50, 1, False,
     "state", "scratch"),
    ("grid_body_masked_column_tau50", 256, 4, 2, 5, 2, 50, 1, False,
     "column", None),
    ("grid_body_masked_state0_tau2", 256, 4, 2, 5, 2, 2, 1, False, "state0",
     None),
    ("grid_body_masked_state0_tau50", 256, 4, 2, 5, 2, 50, 1, False,
     "state0", None),
    ("grid_body_masked_state0_tau50_checkpointed", 256, 4, 2, 5, 2, 50, 1,
     False, "state0", "checkpointed"),
    # past the resident design: long tau picks the checkpointed design;
    # the generic body at Sb = Sr = 8 too in float32, and the scratch in
    # float64 (no block of 32 holds even its segments)
    ("tau200", 8192, 2, 2, 2, 2, 200, 2, False, None, None),
    ("s8_tau200", 256, 2, 8, 8, 2, 200, 1, False, None, None),
    ("bench_shape", 8192, 8, 3, 3, 2, 10, 1, False, None, None),
    # the launches of phase 3's largest cells: 8 restart lanes of Kr=3
    ("main_cell", 8192, 3, 3, 3, 2, 10, 8, False, None, None),
    ("main_cell_sr2", 8192, 3, 3, 2, 2, 10, 8, False, None, None),
    ("main_cell_scratch", 8192, 3, 3, 3, 2, 10, 8, False, None, "scratch"),
    ("main_cell_checkpointed", 8192, 3, 3, 3, 2, 10, 8, False, None,
     "checkpointed"),
    # the launches of phase 5: a learned bank of 2-state HMMs, tau=50
    ("pipeline_cell", 8192, 3, 2, 2, 2, 50, 8, False, None, None),
    ("pipeline_cell_64", 8192, 2, 2, 2, 2, 50, 64, False, None, None),
    ("pipeline_cell_64_resident", 8192, 2, 2, 2, 2, 50, 64, False, None,
     "resident"),
    ("pipeline_cell_64_scratch", 8192, 2, 2, 2, 2, 50, 64, False, None,
     "scratch"),
    ("pipeline_cell_64_checkpointed", 8192, 2, 2, 2, 2, 50, 64, False, None,
     "checkpointed"),
    # past the register bodies: at their cap (Sb = Sr = 8), then the wide
    # body (Sb or Sr above 8; its guard on a masked state); D at B1's cap
    # and past it (E3logN in PyTorch, then a B3 launch)
    ("s8_tau10", 256, 2, 8, 8, 2, 10, 1, False, None, None),
    ("s9", 256, 2, 9, 9, 2, 10, 1, False, None, None),
    ("s12", 256, 2, 12, 12, 2, 10, 1, False, None, None),
    ("s9_masked_state", 256, 2, 9, 9, 2, 10, 1, True, "state", None),
    ("sb2_sr9_tau50", 1024, 2, 2, 9, 2, 50, 2, False, None, None),
    ("d4", 256, 4, 3, 3, 4, 10, 1, False, None, None),
    ("d5", 256, 4, 3, 3, 5, 10, 1, False, None, None),
    # the padded grid's launch (phase 8): the learned bank's Sb=2, cells
    # padded to Kmax=6, Smax=5, tau=50; every lane its own masks (cycling
    # over GRID_PARITY_CELLS); in the design it takes and forced into the
    # others
    ("grid_launch", 8192, 6, 2, 5, 2, 50, len(GRID_PARITY_CELLS), False,
     "grid", None),
    ("grid_launch_resident", 8192, 6, 2, 5, 2, 50, len(GRID_PARITY_CELLS),
     False, "grid", "resident"),
    ("grid_launch_scratch", 8192, 6, 2, 5, 2, 50, len(GRID_PARITY_CELLS),
     False, "grid", "scratch"),
    # the hyp objective's launch (phase 12): Kb=40, 80 lanes at (6, 5)
    ("hyp_launch", 40, 6, 2, 5, 2, 50, 80, False, "grid", None),
]


def masked(args, what):
    """B1's arguments with reduced state Sr-1 masked: log_pi and its
    log_a column (with what='state' also its row) -1e30, and its E3logN
    raised by 1000 nats (E log|Lambda| by 2000), so that the argmax of
    ell + carry sits where exp(log_a) is 0: the case the recursion's
    underflow guard takes to the log domain.  what='state0' masks state 0
    so, which the (2, 5) body cannot drop as it drops trailing masked
    states (pair_recursion.cuh: live_states), so its guard fires."""
    args = [a.clone() for a in args]
    log_pi, log_a, log_lam = args[4], args[5], args[10]
    q = 0 if what == "state0" else -1
    log_pi[..., q] = -1e30
    log_a[..., :, q] = -1e30
    if what in ("state", "state0"):
        log_a[..., q, :] = -1e30
    log_lam[..., q] += 2000.0
    return tuple(args)


def cell_masks(cells, kmax, smax, device):
    """cmask [L, Kmax], smask [L, Smax] of lanes of the (K, S) ``cells``."""
    cm = torch.stack([torch.arange(kmax, device=device) < k
                      for k, _ in cells])
    sm = torch.stack([torch.arange(smax, device=device) < s
                      for _, s in cells])
    return cm, sm


def grid_kernel_args(base, post, cells):
    """B1's arguments as the padded grid's E-step forms them: lanes of
    ``post`` at (Kmax, Smax), each masked to its cell of ``cells`` (masked
    clusters' and states' log_pi, log_a at -1e30)."""
    cm, sm = cell_masks(cells, post.num_clusters, post.num_states,
                        post.alpha.device)
    exps = vbhem.reduced_expectations(post, cm, sm)
    return (base.hmm.prior, base.hmm.trans, base.hmm.mean, base.hmm.cov,
            exps.log_pi, exps.log_a, post.niw.m, post.niw.w, post.niw.v,
            post.niw.beta, exps.log_lam)


def forced_design(kind, sb, sr, tau, dtype):
    """None (the wrapper's choice) or design ``kind`` at this shape; a
    ValueError where the kernels have no such design, so that a forced
    case never runs the wrapper's choice under its name."""
    if kind is None:
        return None
    itemsize = torch.empty((), dtype=dtype).element_size()
    des = pair_estep_cuda.design_of(kind, sb, sr, tau, itemsize)
    if des is None:
        raise ValueError(f"no {kind} design at Sb={sb} Sr={sr} tau={tau} "
                         f"{dtype}")
    return des


def float32_only(kind, what, name, dtype) -> bool:
    """True, with a note, for a case forcing the checkpointed design in
    float64: the kernels build that design in float32 only."""
    if kind == "checkpointed" and dtype == torch.float64:
        print(f"info {what} {name} {dtype}: not run, the checkpointed "
              f"design is float32 only", flush=True)
        return True
    return False


def design_name(des, sb, sr, tau, dtype, pairs) -> str:
    """The design a launch takes: ``des`` or the wrapper's choice."""
    if des is None:
        itemsize = torch.empty((), dtype=dtype).element_size()
        des = pair_estep_cuda.design(sb, sr, tau, itemsize, pairs,
                                     sm_count())
    return f"{des.kind} t={des.threads}" + (f" seg={des.seg}" if des.seg
                                             else "")


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
        for (name, kb, kr, sb, sr, d, tau, lanes, ragged, masking,
             kind) in B1_CASES:
            if float32_only(kind, "B1", name, dtype):
                continue
            rng = np.random.default_rng(7)
            base = random_bank(rng, kb, sb, d, device, dtype, ragged)
            cfg = VBHEMConfig(m0=(0.0,) * d, w0=1.0, nv=100, tau=tau)
            hyps = vbhem.VBHEMHyps.from_config(cfg, d, dtype, device)
            gen = torch.Generator(device="cpu").manual_seed(11)
            post = random_posts(gen, base, hyps, lanes, kr, sr, cfg.nv)
            if masking == "grid":
                args = grid_kernel_args(base, post, [
                    GRID_PARITY_CELLS[q % len(GRID_PARITY_CELLS)]
                    for q in range(lanes)])
            else:
                args = kernel_args(base, post)
                if masking:
                    args = masked(args, masking)
            des = forced_design(kind, sb, sr, tau, dtype)
            pairs = kb * lanes * kr
            name += f" [{design_name(des, sb, sr, tau, dtype, pairs)}]"
            before = read_counts()
            got = pair_estep_cuda.pair_bwd_fwd_fused_cuda(*args, tau,
                                                          des=des)
            after = read_counts()
            want = _plain_pair(tuple(a.double() for a in args), tau)
            torch.cuda.synchronize()
            errs, max_abs = _errors(got, want)
            # which kernel and body ran: B3 for D past B1's cap, the
            # wide body (scratch only) past the register bodies' states
            kernel = "B3" if d > pair_estep_cuda.MAX_DIM else "B1"
            ran = {k: after[k] - before[k] for k in ("B1", "B3")}
            wide = pair_estep_cuda.is_wide(sb, sr)
            if d > pair_estep_cuda.MAX_DIM or wide:
                ok = ran[kernel] == 1 and sum(ran.values()) == 1
                if wide:
                    ok = ok and (after[f"{kernel}_scratch"]
                                 - before[f"{kernel}_scratch"]) == 1
                fails.check(ok, f"B1 {name} {dtype}: one launch of "
                                f"{kernel}{' (wide body)' if wide else ''}"
                                f" (launches {ran})")
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
# entry 1 only: tiles too large for shared memory, so the streamed design
B2_STREAMED_CASES = [
    ("long_t_streamed", (2,), 64, 2000, 8, False, True, False),
]
# entry 1 only: K past the register bodies (K = 8 is B2_CASES' k8), the
# wide body
B2_WIDE_CASES = [
    ("k9", (2,), 128, 20, 9, False, True, False),
    ("k12", (2,), 128, 20, 12, False, True, False),
    ("k9_lanes_per_seq", (4, 3), 25, 50, 9, True, True, True),
]
# the fused E-step at every case of B2_CASES with D=2, and these
B2_FUSED_EXTRA = [
    # name, lanes, N, T, K, per_seq, ragged, mask_per_lane, D
    ("d1", (4,), 128, 50, 3, False, True, False, 1),
    ("d3", (4,), 128, 50, 3, False, True, False, 3),
    ("d3_k8", (2,), 128, 20, 8, False, True, False, 3),
    ("d3_full_width", FULL, 25, 50, 2, False, False, False, 3),
]


def fused_inputs(seed, lanes, n, t, k, d, device, dtype, per_seq=False,
                 ragged=False, mask_per_lane=False):
    """The fused E-step's arguments drawn on the card: the scores and
    mask of :func:`fb_inputs`, x with the mask's rows (one per subject,
    shared by the restarts, unless ``mask_per_lane``) and a random NIW
    posterior per lane; returns (x, mask, log_pz1, log_trans, niw)."""
    log_pz1, log_trans, log_rho, mask = fb_inputs(
        seed, lanes, n, t, k, device, dtype, per_seq, ragged, mask_per_lane)
    del log_rho
    g = torch.Generator(device=device).manual_seed(seed + 1)

    def randn(shape):
        return torch.randn(shape, generator=g, device=device,
                           dtype=torch.float64)

    shp = lanes + (k,)
    a = randn(shp + (d, d)) * 0.3
    eye = torch.eye(d, dtype=torch.float64, device=device)
    niw = NIW(beta=1.0 + 4.0 * randn(shp).abs(),
              v=d + 1.5 + 8.0 * torch.rand(shp, generator=g, device=device,
                                           dtype=torch.float64),
              m=randn(shp + (d,)),
              w=a @ a.transpose(-1, -2) + 0.2 * eye)
    x = randn(tuple(mask.shape) + (d,))
    return (x.to(dtype), mask, log_pz1, log_trans,
            tree_map(lambda v: v.to(dtype), niw))


def _parity_fb(fails, name, dtype, got, want_fn, plain32_fn):
    """Gate ``got`` against the plain version in float64 (``want_fn``);
    for float32 also print the kernel against the plain version in
    float32.  Returns the largest absolute error."""
    want = want_fn()
    errs, max_abs = _errors(got, want)
    del want
    if dtype == torch.float32:
        p32 = plain32_fn()
        k_vs_p32, _ = _errors(got, p32)
        print(f"info {name} f32: kernel vs plain f32 "
              f"{max(k_vs_p32.values()):.3e}", flush=True)
        del p32
    _gate(fails, "B2", name, dtype, errs)
    torch.cuda.empty_cache()
    return max_abs


def _f64(a):
    return a.double() if a.is_floating_point() else a


def phase_parity_b2(fails: Failures, device) -> float:
    """Both B2 entries against the plain version in float64 on the
    kernel's inputs, as for B1, in all four FBStats fields: entry 1
    (forward_backward_cuda) at B2_CASES (resident design) and
    B2_STREAMED_CASES (streamed design); the fused E-step (e_step_fused,
    whose plain version is expected_log_gauss then forward_backward) at
    B2_CASES with D=2 and B2_FUSED_EXTRA.  Returns the largest absolute
    float32 error seen."""
    max_abs_f32 = 0.0
    for dtype in (torch.float32, torch.float64):
        for name, lanes, n, t, k, per_seq, ragged, mpl in \
                B2_CASES + B2_STREAMED_CASES + B2_WIDE_CASES:
            args = fb_inputs(1, lanes, n, t, k, device, dtype, per_seq,
                             ragged, mpl)
            des = fb_cuda.design(t, k, args[2].element_size())
            got = fb_cuda.forward_backward_cuda(*args)
            torch.cuda.synchronize()
            err = _parity_fb(
                fails, f"entry1 {name} ({des.kind})", dtype, got,
                lambda: fb_plain.forward_backward(*map(_f64, args)),
                lambda: fb_plain.forward_backward(*args))
            if dtype == torch.float32:
                max_abs_f32 = max(max_abs_f32, err)
            del got, args
        fused_cases = [c + (2,) for c in B2_CASES] + B2_FUSED_EXTRA
        for name, lanes, n, t, k, per_seq, ragged, mpl, d in fused_cases:
            x, mask, pz1, trans, niw = fused_inputs(
                1, lanes, n, t, k, d, device, dtype, per_seq, ragged, mpl)
            got = fb_cuda.e_step_fused(x, mask, pz1, trans,
                                       fb_plain.emission_constants(niw))
            torch.cuda.synchronize()

            def plain_fn(cast):
                n64 = tree_map(cast, niw)
                return fb_plain.forward_backward(
                    cast(pz1), cast(trans),
                    fb_plain.expected_log_gauss(cast(x), n64), mask)
            err = _parity_fb(fails, f"fused {name} D={d}", dtype, got,
                             lambda: plain_fn(_f64),
                             lambda: plain_fn(lambda a: a))
            if dtype == torch.float32:
                max_abs_f32 = max(max_abs_f32, err)
            del got, x, niw
        # the E-step's dispatch at K past the fused entry's: log_rho in
        # PyTorch, then entry 1's wide body
        x, mask, pz1, trans, niw = fused_inputs(
            2, (4,), 128, 50, 9, 2, device, dtype, ragged=True)
        before = read_counts()
        got = fb_cuda.e_step_auto(x, mask, pz1, trans, niw)
        after = read_counts()
        torch.cuda.synchronize()
        ran = {k: after[k] - before[k] for k in ("B2", "B2_fused")}
        fails.check(ran == {"B2": 1, "B2_fused": 0},
                    f"B2 e_step_auto K=9 {dtype}: entry 1 (wide body) "
                    f"launched ({ran})")
        err = _parity_fb(
            fails, "e_step_auto K=9 D=2 (wide)", dtype, got,
            lambda: fb_plain.forward_backward(
                _f64(pz1), _f64(trans), fb_plain.expected_log_gauss(
                    _f64(x), tree_map(_f64, niw)), mask),
            lambda: fb_plain.forward_backward(
                pz1, trans, fb_plain.expected_log_gauss(x, niw), mask))
        if dtype == torch.float32:
            max_abs_f32 = max(max_abs_f32, err)
        del got, x, niw
    return max_abs_f32


VHEM_FULL = (20, 8192, 3, 2, 3, 10)   # lanes, Kb, Kr, Sb, Sr, tau
B3_CASES = [
    # name, lanes, kb, kr, sb, sr, tau, ragged, inputs, forced design
    ("tau1", 1, 256, 3, 2, 3, 1, False, None, None),
    ("tau2", 1, 256, 3, 2, 3, 2, False, None, None),
    ("tau10", 1, 256, 3, 2, 3, 10, False, None, None),
    ("tau50", 1, 256, 3, 2, 3, 50, False, None, None),
    ("ragged_sb", 1, 256, 3, 3, 3, 10, True, None, None),
    ("sr1", 1, 256, 3, 2, 1, 10, False, None, None),
    ("sr2", 1, 256, 3, 2, 2, 10, False, None, None),
    ("log_a_neg_inf", 1, 256, 3, 2, 3, 10, False, "zeros", None),
    ("lanes3", 3, 256, 3, 2, 3, 10, False, None, None),
    # the underflow guard: -inf log_a or a -1e30 masked state where the
    # argmax of ell + carry sits, 1000 nats above the rest
    ("log_a_neg_inf_spread", 1, 256, 3, 2, 3, 10, False, "zeros_spread",
     None),
    ("log_a_neg_inf_spread_tau50", 1, 256, 3, 2, 3, 50, False,
     "zeros_spread", "scratch"),
    ("masked_state_ragged", 1, 256, 3, 3, 3, 10, True, "masked", None),
    ("masked_state_scratch", 1, 256, 3, 3, 3, 10, True, "masked",
     "scratch"),
    ("masked_state_tau50_checkpointed", 1, 256, 3, 3, 3, 50, True,
     "masked", "checkpointed"),
    # the padded grid's (2, 5) body, its last state masked (so it also
    # runs at Sr = 4)
    ("grid_body_masked_tau50", 1, 256, 3, 2, 5, 50, False, "masked", None),
    ("grid_body_masked_tau50_checkpointed", 1, 256, 3, 2, 5, 50, False,
     "masked", "checkpointed"),
    ("grid_body_masked_tau50_scratch", 1, 256, 3, 2, 5, 50, False,
     "masked", "scratch"),
    ("grid_body_log_a_neg_inf_spread_tau50", 1, 256, 3, 2, 5, 50, False,
     "zeros_spread", None),
    ("grid_body_log_a_neg_inf_spread_tau50_checkpointed", 1, 256, 3, 2, 5,
     50, False, "zeros_spread", "checkpointed"),
    # past the resident design: long tau picks the checkpointed design;
    # the generic body at Sb = Sr = 8 too in float32, the scratch in
    # float64
    ("tau200", 2, 8192, 2, 2, 2, 200, False, None, None),
    ("s8_tau200", 1, 256, 2, 8, 8, 200, False, None, None),
    ("vhem_full_width", *VHEM_FULL, False, None, None),
    ("vhem_full_width_scratch", *VHEM_FULL, False, None, "scratch"),
    # phase 7's launch: the (2, 2) instantiation at tau=50
    ("dic_cell", 1, 8192, 3, 2, 2, 50, False, None, None),
    ("dic_cell_resident", 1, 8192, 3, 2, 2, 50, False, None, "resident"),
    ("dic_cell_scratch", 1, 8192, 3, 2, 2, 50, False, None, "scratch"),
    ("dic_cell_checkpointed", 1, 8192, 3, 2, 2, 50, False, None,
     "checkpointed"),
    # past the register bodies: at their cap, then the wide body
    ("s8_tau10", 1, 256, 2, 8, 8, 10, False, None, None),
    ("s9", 1, 256, 2, 9, 9, 10, False, None, None),
    ("s12", 1, 256, 2, 12, 12, 10, False, None, None),
    ("s9_masked_state", 1, 256, 2, 9, 9, 10, True, "masked", None),
    # phase 8's float64 rescoring: one launch per cell winner, unpadded;
    # the largest cell (6, 5) on the learned bank's Sb=2, tau=50
    ("rescore_cell_6_5", 1, 8192, 6, 2, 5, 50, False, None, None),
    ("rescore_cell_6_5_resident", 1, 8192, 6, 2, 5, 50, False, None,
     "resident"),
    ("rescore_cell_6_5_scratch", 1, 8192, 6, 2, 5, 50, False, None,
     "scratch"),
]


def b3_inputs(seed, lanes, kb, kr, sb, sr, device, dtype, ragged=False,
              kind=None):
    """B3's arguments as the VHEM E-step forms them: a random bank, a
    random point-estimate reduced bank per lane, the point E3logN, and
    the logs of the reduced prior and transitions.  ``kind`` 'zeros':
    some transitions are exactly 0, so log_a holds -inf entries (into
    column Sr-1); 'zeros_spread': also state Sr-1's E3logN 1000 nats above
    the others'; 'masked': state Sr-1 masked (log_pi and its log_a row and
    column -1e30) and its E3logN 1000 nats above the others'."""
    rng = np.random.default_rng(seed)
    base = random_bank(rng, kb, sb, 2, device, dtype, ragged)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    shp = (lanes, kr, sr)
    a = rng.normal(size=shp + (2, 2)) * 0.3
    cov_r = t(np.einsum("...de,...fe->...df", a, a) + np.eye(2))
    ell = plain.expected_pair_ll_point(base.hmm.mean, base.hmm.cov,
                                       t(rng.normal(size=shp + (2,)) * 3.0),
                                       cov_r)
    trans = rng.dirichlet(np.ones(sr), shp)
    if kind in ("zeros", "zeros_spread") and sr > 1:
        trans[..., 0, -1] = 0.0
        trans = trans / trans.sum(-1, keepdims=True)
    log_pi = torch.log(t(rng.dirichlet(np.ones(sr), shp[:-1])))
    log_a = torch.log(t(trans))
    if kind in ("zeros_spread", "masked"):
        ell[..., -1] += 1000.0
    if kind == "masked":
        log_pi[..., -1] = -1e30
        log_a[..., :, -1] = -1e30
        log_a[..., -1, :] = -1e30
    return base.hmm.prior, base.hmm.trans, log_pi, log_a, ell


def phase_parity_b3(fails: Failures, device) -> float:
    """B3 against the plain version in float64 on the kernel's inputs, as
    for B1; returns the largest absolute float32 error seen."""
    max_abs_f32 = 0.0
    for dtype in (torch.float32, torch.float64):
        for (name, lanes, kb, kr, sb, sr, tau, ragged, inputs,
             kind) in B3_CASES:
            if float32_only(kind, "B3", name, dtype):
                continue
            args = b3_inputs(5, lanes, kb, kr, sb, sr, device, dtype, ragged,
                             inputs)
            des = forced_design(kind, sb, sr, tau, dtype)
            pairs = kb * lanes * kr
            name += f" [{design_name(des, sb, sr, tau, dtype, pairs)}]"
            before = read_counts()
            got = pair_estep_cuda.pair_bwd_fwd_cuda(*args, tau, des=des)
            after = read_counts()
            torch.cuda.synchronize()
            if pair_estep_cuda.is_wide(sb, sr):
                ran = {k: after[k] - before[k]
                       for k in ("B3", "B3_scratch", "B1")}
                fails.check(ran == {"B3": 1, "B3_scratch": 1, "B1": 0},
                            f"B3 {name} {dtype}: one launch of the wide "
                            f"body ({ran})")
            want = plain.pair_bwd_fwd(*[a.double() for a in args], tau)
            errs, max_abs = _errors(got, want)
            if dtype == torch.float32:
                max_abs_f32 = max(max_abs_f32, max_abs)
                k_vs_p32, _ = _errors(got, plain.pair_bwd_fwd(*args, tau))
                print(f"info B3 {name} f32: kernel vs plain f32 "
                      f"{max(k_vs_p32.values()):.3e}", flush=True)
            _gate(fails, "B3", name, dtype, errs)
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
    check_on_chip(fails, "VBHEM path", launches, "B1")
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
    fails.check(launches["B2_fused"] >= iters > 0,
                f"VBEM path launched B2's fused E-step "
                f"{launches['B2_fused']} times (entry 1: {launches['B2']}) "
                f"for {iters} EM iterations")
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
    check_on_chip(fails, "pipeline", launches, "B1")
    fails.check(bool(np.all(np.isfinite(info["model_ll"]))),
                "pipeline ELBOs finite")
    ri = rand_index(info["model_all"][(2, 2)].label.cpu().numpy(), labels)
    fails.check(ri == 1.0, f"pipeline (K=2, S=2) labels vs planted groups: "
                           f"Rand index {ri}")
    return {"launches": launches, "best_k": info["model_best_k"],
            "info": info, "base": base, "tau": cfg.tau}


# ---------------------------------------------------------------------------
# phases 6-7: the VHEM path and DIC
# ---------------------------------------------------------------------------

VHEM_GRID = ([1, 2, 3], [1, 2, 3])


def _selection(score) -> str:
    return (f"K={score.best_k} S={score.best_s} (per-cluster S "
            f"{score.s_list}) Rand index {score.rand_index:.6f}")


def phase_vhem_path(fails: Failures, device, vbem) -> dict:
    """run_vhem_grid() at its defaults on the bank phase 4 learned, as
    the synthetic protocol runs it (`experiments/synthetic.py:186-231`)."""
    labels = vbem["labels"]
    cfg = HEMConfig(trials=20, nv=100, tau=10)
    gen = torch.Generator(device=device).manual_seed(0)
    reset_counts()
    t0 = time.perf_counter()
    out = synthetic.run_vhem_grid(gen, vbem["results"], labels, *VHEM_GRID,
                                  cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    iters = sum(out["em_iters"].values())
    lls = [float(r.ll) for r in out["cells"].values()]
    print(f"VHEM path: Kb={len(vbem['results'])} trials={cfg.trials} "
          f"initmode={cfg.initmode} tau={cfg.tau} grid K={VHEM_GRID[0]} x "
          f"S={VHEM_GRID[1]} wall={wall:.3f}s em_iterations={iters} "
          f"launches={launches}", flush=True)
    print(f"VHEM path: per-cell EM iterations "
          f"{ {str(c): n for c, n in out['em_iters'].items()} }", flush=True)
    print(f"VHEM path: AIC selects {_selection(out['aic_score'])}; "
          f"AIC={out['aic'].tolist()}", flush=True)
    print(f"VHEM path: BIC selects {_selection(out['bic_score'])}; "
          f"BIC={out['bic'].tolist()}", flush=True)
    fails.check(bool(np.all(np.isfinite(lls)))
                and bool(np.all(np.isfinite(out["aic"])))
                and bool(np.all(np.isfinite(out["bic"]))),
                "VHEM path LLs, AIC and BIC finite")
    fails.check(launches["B3"] >= iters > 0,
                f"VHEM path launched B3 {launches['B3']} times for {iters} "
                f"EM iterations")
    check_on_chip(fails, "VHEM path", launches, "B3")
    ri = rand_index(out["cells"][(2, 2)].label.cpu().numpy(), labels)
    fails.check(ri == 1.0, f"VHEM (K=2, S=2) labels vs planted groups: "
                           f"Rand index {ri}")
    return {"launches": launches, "wall_s": wall, "iters": iters,
            "cell33": out["cells"][(3, 3)]}


def _to_f64(tree):
    return tree_map(lambda a: a.double() if a.is_floating_point() else a,
                    tree)


def phase_dic(fails: Failures, device, pipe, labels) -> dict:
    """run_vbhem_dic() over the pipeline's VBHEM grid in float32, and on
    the same results and bank cast to float64."""
    info, base, tau = pipe["info"], pipe["base"], pipe["tau"]
    n_cells = len(info["model_all"])
    out = {}
    for name, cast in (("f32", lambda x: x), ("f64", _to_f64)):
        inf = {"model_all": {c: cast(r)
                             for c, r in info["model_all"].items()}}
        calls = []

        def recorded(*args):
            got = pair_estep_cuda.pair_bwd_fwd_auto(*args)
            calls.append((args, got))
            return got
        reset_counts()
        t0 = time.perf_counter()
        with rebound(dic_model, "pair_bwd_fwd_auto", recorded):
            res = synthetic.run_vbhem_dic(inf, cast(base), tau, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        for c, ((*tensors, t), got) in enumerate(calls):
            want = plain.pair_bwd_fwd(*[a.double() for a in tensors], t)
            errs, _ = _errors(got, want)
            _gate(fails, "B3", f"DIC launch {c} (Kr={tensors[2].shape[-2]}, "
                  f"tau={t})", got.ll_elbo.dtype, errs)
        print(f"DIC {name}: tau={tau} cells={sorted(info['model_all'])} "
              f"DIC={res['dic'].ravel().tolist()} wall={wall:.3f}s "
              f"launches={launches}", flush=True)
        print(f"DIC {name}: selects {_selection(res['score'])}", flush=True)
        fails.check(bool(np.all(np.isfinite(res["dic"]))),
                    f"DIC {name}: every value finite")
        fails.check(launches["B3"] == n_cells,
                    f"DIC {name} launched B3 {launches['B3']} times for "
                    f"{n_cells} cells")
        out[name] = {"dic": res["dic"].ravel().tolist(),
                     "best_k": res["score"].best_k, "launches": launches}
    return out


# ---------------------------------------------------------------------------
# phases 8-9: the padded (K, S) grid and the synthetic protocol's VBHEM stage
# ---------------------------------------------------------------------------

# The grid of the synthetic protocol (`experiments/synthetic.py:119-140`)
# and its restarts on the 8192-subject bank: PIPELINE_TRIALS, for the
# reason given there.
GRID = (list(range(1, 7)), list(range(1, 6)))
GRID_TRIALS = PIPELINE_TRIALS
GRID_CONFIG = VBHEMConfig(alpha0=1e6, m0=(1.5, 1.5), w0=1.0,
                          trials=GRID_TRIALS, nv=100, tau=50,
                          initmode="baseem", learn_hyps=False)
GRID_SEED = 0
# the largest |float32 ELBO - float64 rescoring| / |float64| a cell may
# show: above the largest gap measured on an H100 (9.3e-7 on the grid's
# 8192-subject bank, 1.2e-4 on the protocol's 40 subjects, whose bound is
# 200 times smaller) and below the 1-3% the JAX package's float32 bound
# showed on the TPU
GRID_GAP_LIMIT = 1e-4
PROTOCOL_GAP_LIMIT = 1e-3


def grid_design(base, n_lanes, chunk) -> str:
    """The design ``pair_estep_cuda.design`` names for the grid's B1
    launches: a chunk of lanes at the padded shape."""
    kb, sb = base.state_mask.shape
    lanes = chunk or n_lanes
    return pair_estep_cuda.design(sb, max(GRID[1]), GRID_CONFIG.tau,
                                  base.hmm.mean.element_size(),
                                  kb * lanes * max(GRID[0]),
                                  sm_count()).kind


def _cell_gaps(info) -> dict:
    """Per cell, (device float32 ELBO - float64 rescoring) / |float64|."""
    gaps = {}
    for ki, k in enumerate(info["model_k"]):
        for si, s_ in enumerate(info["model_s"]):
            corr = math.lgamma(k + 1) + math.lgamma(s_ + 1)
            ll64 = info["model_ll"][ki, si] - corr
            ll32 = info["model_ll_device"][ki, si] - corr
            gaps[f"{k},{s_}"] = float((ll32 - ll64) / abs(ll64))
    return gaps


def _check_grid_launches(fails, what, launches, info, base, n_lanes):
    """B1 once per EM iteration of every chunk, all in the design named
    for the chunk's launch; B3 once per rescored cell (float32 banks)."""
    iters = sum(info["grid_chunk_iters"])
    fails.check(launches["B1"] == iters > 0,
                f"{what}: B1 launched {launches['B1']} times for the "
                f"{iters} EM iterations of its chunks "
                f"{info['grid_chunk_iters']}")
    check_on_chip(fails, what, launches, "B1",
                  grid_design(base, n_lanes, info["grid_trial_chunk"]))
    rescored = int(np.sum(np.isfinite(info["model_ll_device"])))
    fails.check(launches["B3"] == rescored,
                f"{what}: B3 (float64) launched {launches['B3']} times for "
                f"{rescored} rescored cells")


def phase_grid(fails: Failures, device, vbem) -> dict:
    """cluster_batched() over the protocol's (K, S) grid on the bank phase
    4 learned, with the float64 rescoring of every cell winner."""
    labels = vbem["labels"]
    base = vbhem.h3m_from_results(vbem["results"], device=device)
    n_lanes = len(GRID[0]) * len(GRID[1]) * GRID_CONFIG.trials
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res, info = vbhem.cluster_batched(
        torch.Generator(device="cpu").manual_seed(GRID_SEED), base, *GRID,
        GRID_CONFIG)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    chunk = info["grid_trial_chunk"]
    n_chunks = len(info["grid_chunk_iters"])
    print(f"grid: Kb={base.num_hmms} Sb={base.state_mask.shape[1]} "
          f"K={GRID[0]} x S={GRID[1]} tau={GRID_CONFIG.tau} "
          f"nv={GRID_CONFIG.nv} trials={GRID_CONFIG.trials} lanes={n_lanes} "
          f"f32; lane chunk {chunk or n_lanes} x {n_chunks} chunks, EM "
          f"iterations per chunk {info['grid_chunk_iters']}; "
          f"wall={wall:.3f}s peak_memory={peak:.2f} GiB "
          f"launches={launches}", flush=True)
    print(f"grid: selected K={info['model_best_k']} "
          f"S={info['model_best_s']}; per-K S* "
          f"{info['model_best_s_per_k']}", flush=True)
    print(f"grid: scores (float64 rescoring, selects) "
          f"{info['model_ll'].tolist()}", flush=True)
    print(f"grid: scores (device float32) "
          f"{info['model_ll_device'].tolist()}", flush=True)
    gaps = _cell_gaps(info)
    print(f"grid: per-cell (f32 - f64) / |f64| {json.dumps(gaps)}",
          flush=True)
    worst = max(abs(g) for g in gaps.values())
    fails.check(worst <= GRID_GAP_LIMIT,
                f"grid: every cell's float32 ELBO within {GRID_GAP_LIMIT:.0e}"
                f" of its float64 rescoring (largest gap {worst:.3e})")
    print(f"grid: per-cell EM iterations "
          f"{ {f'{k},{s_}': n for (k, s_), n in info['model_em_iters'].items()} }",
          flush=True)
    fails.check(bool(np.all(np.isfinite(info["model_ll"])))
                and bool(np.all(np.isfinite(info["model_ll_device"]))),
                "grid: every score finite (float32 and float64)")
    _check_grid_launches(fails, "grid", launches, info, base, n_lanes)
    ri = rand_index(info["model_all"][(2, 2)].label.cpu().numpy(), labels)
    fails.check(ri == 1.0, f"grid (K=2, S=2) labels vs planted groups: "
                           f"Rand index {ri}")
    return {"launches": launches, "wall_s": wall, "peak_gib": peak,
            "chunk": chunk or n_lanes, "n_chunks": n_chunks,
            "chunk_iters": info["grid_chunk_iters"], "gaps": gaps,
            "best": (info["model_best_k"], info["model_best_s"]),
            "base": base}


def phase_padded(fails: Failures, device, grid, lanes=8, iters=40) -> dict:
    """Padded equals unpadded on the card: the first ``lanes`` restarts of
    cell (2, 2), drawn as phase 8's grid draws them (the same generator
    seed, every lane at (Kmax, Smax)), each run padded under its masks
    and, from the same start sliced to (2, 2), unpadded, both for
    ``iters`` iterations (no early stop, so both take the same steps);
    the ELBOs must agree to 5e-5 relative."""
    base = grid["base"]
    kmax, smax = max(GRID[0]), max(GRID[1])
    cells = [(k, s_) for k in GRID[0] for s_ in GRID[1]]
    n_lanes = len(cells) * GRID_CONFIG.trials
    hyps = vbhem.VBHEMHyps.from_config(GRID_CONFIG, 2, torch.float32, device)
    post0 = vbhem.init_baseem(
        torch.Generator(device="cpu").manual_seed(GRID_SEED), base, kmax,
        smax, hyps, GRID_CONFIG.nv, lanes=(n_lanes,))
    first = cells.index((2, 2)) * GRID_CONFIG.trials
    post = tree_map(lambda a: a[first:first + lanes], post0)
    cm, sm = cell_masks([(2, 2)] * lanes, kmax, smax, device)
    kw = dict(nv=GRID_CONFIG.nv, tau=GRID_CONFIG.tau, max_iter=iters,
              min_diff=0.0)
    padded = vbhem.vbhem_em_masked(base, post, hyps, cmask=cm, smask=sm,
                                   **kw)
    sliced = tree_map(torch.Tensor.contiguous, vbhem.H3MPosterior(
        alpha=post.alpha[:, :2], eta=post.eta[:, :2, :2],
        epsilon=post.epsilon[:, :2, :2, :2],
        niw=NIW(*[f[:, :2, :2] for f in post.niw])))
    unpadded = vbhem.vbhem_em(base, sliced, hyps, **kw)
    a = padded.ll.double().cpu().numpy()
    b = unpadded.ll.double().cpu().numpy()
    rel = np.abs(a - b) / np.abs(b)
    print(f"padded vs unpadded: cell (2, 2), lanes {first}..{first + lanes - 1}"
          f" of the grid, {iters} iterations: padded {a.tolist()} unpadded "
          f"{b.tolist()}; relative gaps {rel.tolist()}", flush=True)
    fails.check(bool(np.all(np.isfinite(a))) and float(rel.max()) <= 5e-5,
                f"padded equals unpadded (f32, (6,5) padding of cell (2,2), "
                f"{lanes} lanes): largest relative gap {rel.max():.3e} "
                f"<= 5e-5")
    return {"max_rel": float(rel.max())}


def phase_protocol(fails: Failures, device, vbem, per_group=20) -> dict:
    """run_vbhem() at the protocol's size: ``per_group`` subjects of each
    planted group of phase 4's bank, default_vbhem_config()'s settings
    with hyperparameter learning off, the grid K=1..6 x S=1..5."""
    labels = vbem["labels"]
    idx = np.concatenate([np.flatnonzero(labels == g)[:per_group]
                          for g in (0, 1)])
    results = [vbem["results"][i] for i in idx]
    lab = labels[idx]
    cfg = dataclasses.replace(synthetic.default_vbhem_config(),
                              learn_hyps=False)
    reset_counts()
    t0 = time.perf_counter()
    res, info, score = synthetic.run_vbhem(
        torch.Generator(device="cpu").manual_seed(1), results, lab, *GRID,
        cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    base = vbhem.h3m_from_results(results, device=device)
    n_lanes = len(GRID[0]) * len(GRID[1]) * cfg.trials
    print(f"protocol: Kb={len(results)} ({per_group} subjects per group of "
          f"phase 4's bank) K={GRID[0]} x S={GRID[1]} trials={cfg.trials} "
          f"nv={cfg.nv} tau={cfg.tau} initmode={cfg.initmode} "
          f"learn_hyps={cfg.learn_hyps} wall={wall:.3f}s "
          f"chunks={info['grid_chunk_iters']} launches={launches}",
          flush=True)
    print(f"protocol: scores (float64) {info['model_ll'].tolist()}",
          flush=True)
    gaps = _cell_gaps(info)
    print(f"protocol: per-cell (f32 - f64) / |f64| {json.dumps(gaps)}",
          flush=True)
    worst = max(abs(g) for g in gaps.values())
    fails.check(worst <= PROTOCOL_GAP_LIMIT,
                f"protocol: every cell's float32 ELBO within "
                f"{PROTOCOL_GAP_LIMIT:.0e} of its float64 rescoring (largest "
                f"gap {worst:.3e})")
    sel_ri = rand_index(score.labels, lab)
    print(f"protocol: selected cell K={info['model_best_k']} "
          f"S={info['model_best_s']}; after vbh3m_remove_empty "
          f"{_selection(score)} (Rand index {sel_ri})", flush=True)
    fails.check(bool(np.all(np.isfinite(info["model_ll"]))),
                "protocol: every score finite")
    _check_grid_launches(fails, "protocol", launches, info, base, n_lanes)
    ri = rand_index(info["model_all"][(2, 2)].label.cpu().numpy(), lab)
    fails.check(ri == 1.0, f"protocol (K=2, S=2) labels vs planted groups: "
                           f"Rand index {ri}")
    return {"launches": launches, "wall_s": wall, "best_k": score.best_k,
            "best_s": score.best_s, "s_list": score.s_list,
            "rand_index": sel_ri, "adjusted_rand_index": score.rand_index}


# ---------------------------------------------------------------------------
# hyperparameter learning (ROADMAP A4): the objective's gradient on the
# card, and the protocol with hyps on in both stages
# ---------------------------------------------------------------------------

# The gradient phase runs each objective's EM for a fixed number of
# iterations (min_diff 0): the kernel and the plain runs then take the same
# steps, so their gap is the arithmetic's, not a convergence test's flip.
# Its VBHEM lanes keep the config's default alpha0=1: at the protocol's
# alpha0=1e6 the float32 bound's lgamma(K alpha0) - K lgamma(alpha0) and
# its derivative cancel to noise (the alpha0 gradient off by 3.4 against
# float64 in the plain version alone, on the CPU), whatever the kernel does.
HYP_GRAD_ITERS = 30
HYP_GRAD_VB = VBConfig(mu0=(1.5, 1.5), w0=1.0, max_iter=HYP_GRAD_ITERS,
                       min_diff=0.0)
HYP_GRAD_VBHEM = VBHEMConfig(m0=(1.5, 1.5), w0=1.0, nv=100, tau=50,
                             max_iter=HYP_GRAD_ITERS, min_diff=0.0)
# the padded grid's cells of the VBHEM lanes (at the grid's (6, 5))
HYP_GRAD_CELLS = [(2, 2), (1, 1), (6, 5), (3, 2)]
HYP_GRAD_SEED = 3
PROTOCOL_HYPS_SEED = 7     # the hyps-on protocol's own data draw
# the hyps-on protocol's one cut: both stages' L-BFGS steps, 25 of the
# reference's 50 (every lane runs them all, so the stage's time falls with
# them; at 15 the selection fails, PERF.md §6); the 5 survivors a subject
# or cell are the reference configuration's cap already
PROTOCOL_HYP_STEPS = 25
# the hyps-on stages' counts on an H100 (NVIDIA H100 80GB HBM3, 700 W) at
# PROTOCOL_HYP_STEPS before the bounds' prior and posterior terms were
# evaluated in float64: float32's rounding of them made the EM stopping
# test fire by chance (tools/hyp_stage_dtype.py; float64 runs took 3,682
# EM iterations in the VBHEM stage)
F32_TERMS_BEFORE = {"VBHEM": "10,471 EM iterations, 10,738 B1 launches",
                    "VBEM": "12,330 B2 launches"}


def _value_grad(fun, hyps0, specs, n, dtype):
    """Every lane's objective value and theta-gradient at hyps0 (theta in
    float64, the hyps in ``dtype``)."""
    t0 = torch.as_tensor(hyp.pack(hyps0, specs), device=hyps0.alpha0.device)
    theta = t0.expand(n, -1).clone().requires_grad_(True)
    h = tree_map(lambda a: a.to(dtype), hyps0)
    v = fun(hyp.unpack(theta, h, specs),
            torch.arange(n, device=theta.device))
    (g,) = torch.autograd.grad(v.sum(), theta)
    return torch.cat([v.detach().double()[:, None], g.double()], dim=1)


def _objective_runs(make, hyps0, specs, n, module, name, plain_fn):
    """The objective's [value, gradient] per lane: with the kernel in
    float64 and float32, and with the kernel's dispatch rebound to its
    plain version in float64 and float32; with the kernel runs' launch
    counts and the objective's own counts of its EM iterations and
    E-steps."""
    out = {}
    for dtype in (torch.float64, torch.float32):
        stats = {}
        reset_counts()
        out[dtype] = _value_grad(make(dtype, stats), hyps0, specs, n, dtype)
        out[f"launches_{dtype}"] = read_counts()
        out[f"stats_{dtype}"] = stats
        with rebound(module, name, plain_fn):
            out[f"plain_{dtype}"] = _value_grad(make(dtype, {}), hyps0,
                                                specs, n, dtype)
    return out


def _rel_err(got, want) -> float:
    """[value, gradient] rows: the larger, over lanes, of the value's
    |got - want| / (|want| + 1) and the gradient's max-norm error over its
    max norm plus 1 (the direction L-BFGS steps along; a component far
    below the others, such as m0's near a fixed point, is a difference of
    nearly cancelling per-state sums, and float32 leaves no relative
    digits in it)."""
    v = torch.abs(got[:, 0] - want[:, 0]) / (torch.abs(want[:, 0]) + 1.0)
    g = torch.amax(torch.abs(got[:, 1:] - want[:, 1:]), dim=1) / (
        torch.amax(torch.abs(want[:, 1:]), dim=1) + 1.0)
    return float(torch.max(torch.maximum(v, g)))


def _gate_objective(fails, what, runs, counter):
    """By :func:`_rel_err`: float64, the kernel run within 1e-10 of the
    plain run; float32, an objective is a whole EM run and a bound summed
    over every observation, so the plain version's own float32 run
    strays from float64 too, and the E-step is one float32 stage of
    several: the kernel's float32 run may stray up to twice the plain
    float32 run's gap, plus 5e-5.  The element-wise gaps are printed."""
    want = runs[f"plain_{torch.float64}"]
    for dtype in (torch.float64, torch.float32):
        err = _rel_err(runs[dtype], want)
        allowed = TOL[dtype]
        own = ""
        if dtype == torch.float32:
            plain32 = _rel_err(runs[f"plain_{dtype}"], want)
            allowed += 2.0 * plain32
            own = f" (the plain version's float32 run: {plain32:.3e})"
        fails.check(bool(torch.all(torch.isfinite(runs[dtype])))
                    and err <= allowed,
                    f"hyp gradient {what} {str(dtype)[6:]}: value and theta-"
                    f"gradient of {want.shape[0]} lanes vs the plain version"
                    f" in float64, value and gradient-norm relative gap "
                    f"{err:.3e} <= {allowed:.3e}{own}")
        for key, name in ((dtype, "kernel"), (f"plain_{dtype}", "plain")):
            elem = torch.amax(torch.abs(runs[key] - want)
                              / (torch.abs(want) + 1.0), dim=0)
            print(f"hyp gradient {what} {str(dtype)[6:]} {name}: element-"
                  f"wise |got - want| / (|want| + 1) by [value, theta] "
                  f"{elem.cpu().numpy().tolist()}", flush=True)
        st = runs[f"stats_{dtype}"]
        n = sum(runs[f"launches_{dtype}"][c] for c in counter)
        want_n = st["em_iters"] + st["e_steps"]
        fails.check(n == want_n > 0,
                    f"hyp gradient {what} {str(dtype)[6:]}: {n} kernel "
                    f"launches for the objective's {st['em_iters']} EM "
                    f"iterations and {st['e_steps']} final E-steps")
    print(f"hyp gradient {what}: [value, d/dtheta] per lane (plain, float64)"
          f" {want.cpu().numpy().round(6).tolist()}", flush=True)
    return {str(dtype)[6:]: _rel_err(runs[dtype], want)
            for dtype in (torch.float64, torch.float32)}


def phase_hyp_gradient(fails: Failures, device, vbem, n_vb=4,
                       per_group=20) -> dict:
    """The hyp objective of each engine, value and theta-gradient at hyps0,
    through the kernels and through their plain versions: VBEM on
    ``n_vb`` subjects of phase 4's bank (one lane each, random starts;
    kernel B2), VBHEM on lanes of the padded protocol grid (HYP_GRAD_CELLS,
    baseem starts on the protocol's 40-subject bank; kernel B1 with
    per-lane masks).  The objective's EM runs HYP_GRAD_ITERS iterations."""
    f64 = torch.float64
    bank = vbem["bank"]
    data = SeqBatch(x=bank.x[:n_vb].to(f64), lengths=bank.lengths[:n_vb])
    gen = torch.Generator(device="cpu").manual_seed(HYP_GRAD_SEED)
    h64 = vbhmm.VBHyps.from_config(HYP_GRAD_VB, 2, f64, device)
    posts = tree_map(lambda a: a[:, 0], vbhmm.random_init(
        gen, data, 2, h64, lanes=(1,)))
    # the objective starts from restart solutions, as on the hyp path
    posts = vbhmm.vbem_em(data, posts, h64).post
    specs = hyp.vb_specs(2, HYP_GRAD_VB.bounds, HYP_GRAD_VB.learn_hyps_keys)

    def make_vb(dtype, stats):
        d = SeqBatch(x=data.x.to(dtype), lengths=data.lengths)
        return vbhmm.neg_elbo_objective(
            d, tree_map(lambda a: a.to(dtype), posts), HYP_GRAD_VB,
            per_lane_data=True, stats=stats)

    vb = _objective_runs(make_vb, h64, specs, n_vb, vbhmm, "e_step",
                         plain_vbem_e_step)
    errs = {"VBEM": _gate_objective(fails, "VBEM", vb, ("B2", "B2_fused"))}

    labels = vbem["labels"]
    idx = np.concatenate([np.flatnonzero(labels == g)[:per_group]
                          for g in (0, 1)])
    base = tree_map(lambda a: a.to(f64) if a.is_floating_point() else a,
                    vbhem.h3m_from_results([vbem["results"][i] for i in idx],
                                           device=device))
    kmax, smax = max(GRID[0]), max(GRID[1])
    hh = vbhem.VBHEMHyps.from_config(HYP_GRAD_VBHEM, 2, f64, device)
    n = len(HYP_GRAD_CELLS)
    hposts = vbhem.init_baseem(gen, base, kmax, smax, hh, HYP_GRAD_VBHEM.nv,
                               lanes=(n,))
    cm, sm = cell_masks(HYP_GRAD_CELLS, kmax, smax, device)
    hposts = vbhem.vbhem_em_masked(base, hposts, hh, HYP_GRAD_VBHEM.nv,
                                   HYP_GRAD_VBHEM.tau, cm, sm).post
    hspecs = hyp.vbhem_specs(2, HYP_GRAD_VBHEM.bounds,
                             HYP_GRAD_VBHEM.learn_hyps_keys)

    def make_vbhem(dtype, stats):
        b = tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a,
                     base)
        return vbhem.neg_elbo_objective(
            b, tree_map(lambda a: a.to(dtype), hposts), HYP_GRAD_VBHEM,
            cmask=cm, smask=sm, stats=stats)

    vh = _objective_runs(make_vbhem, hh, hspecs, n, vbhem, "e_step",
                         plain_e_step)
    errs["VBHEM"] = _gate_objective(fails, "VBHEM (masked)", vh, ("B1",))
    return {"launches": vb[f"launches_{torch.float32}"],
            "launches_vbhem": vh[f"launches_{torch.float32}"],
            "errors": errs}


def _hyps_in_bounds(hyps_lanes, specs) -> bool:
    """Every learned leaf of every lane within its box (hyp space)."""
    ok = True
    for s in specs:
        v = getattr(hyps_lanes, s.name).double()
        ok &= bool(torch.all((v >= s.lo * (1 - 1e-6))
                             & (v <= s.hi * (1 + 1e-6))))
    return ok


def _monotone(pre, post) -> tuple:
    """(every lane's post >= pre - max(1e-6 |pre|, 1e-3), the largest
    shortfall)."""
    tol = np.maximum(1e-6 * np.abs(pre), 1e-3)
    short = float(np.max(pre - post))
    return bool(np.all(post >= pre - tol)), short


def _hyp_stage_line(what, st) -> str:
    steps = np.asarray(st["hyp_steps"])
    return (f"{what}: {st['hyp_lanes']} lanes, L-BFGS steps per lane max "
            f"{int(steps.max())} median {float(np.median(steps))}, "
            f"objective calls {st['hyp_calls']} ({st['hyp_lane_evals']} lane"
            f" evaluations), EM iterations {st['hyp_em_iters']} + "
            f"{st['hyp_e_steps']} final E-steps, reverted lanes "
            f"{st['hyp_reverted']}")


def phase_protocol_hyps(fails: Failures, device,
                        per_group=20) -> dict:
    """The synthetic protocol at its reference settings with hyps on in both
    stages: ``per_group`` subjects per planted group drawn with a seed of
    their own (PROTOCOL_HYPS_SEED), ``synthetic.learn_subject_hmms`` at
    ``default_vb_config()``, then ``synthetic.run_vbhem`` at
    ``default_vbhem_config()`` over K=1..6 x S=1..5, both with their L-BFGS
    steps cut to PROTOCOL_HYP_STEPS."""
    batches, labels = synthetic_subjects(per_group, seed=PROTOCOL_HYPS_SEED,
                                         device=device)
    vcfg = dataclasses.replace(synthetic.default_vb_config(),
                               hyp_max_steps=PROTOCOL_HYP_STEPS)
    reset_counts()
    t0 = time.perf_counter()
    vinfo = {}
    results = synthetic.learn_subject_hmms(
        torch.Generator(device=device).manual_seed(PROTOCOL_HYPS_SEED),
        batches, 2, vcfg, info=vinfo)
    torch.cuda.synchronize()
    vb_wall = time.perf_counter() - t0
    vb_launches = read_counts()
    vb_iters = vinfo["model_em_iters"] + vinfo["hyp_em_iters"]
    print(f"protocol hyps VBEM: {len(results)} subjects x {vcfg.numtrials} "
          f"restarts (25 sequences, T=50, D=2, K=2, float32), hyps on, "
          f"max_hyp_solutions={vcfg.max_hyp_solutions} hyp_max_steps="
          f"{vcfg.hyp_max_steps}: wall={vb_wall:.3f}s restarts' EM "
          f"iterations {vinfo['model_em_iters']} launches={vb_launches}",
          flush=True)
    print(_hyp_stage_line("protocol hyps VBEM", vinfo), flush=True)
    b2 = vb_launches["B2"] + vb_launches["B2_fused"]
    print(f"protocol hyps VBEM: the stage's EM iterations "
          f"{vinfo['hyp_em_iters']} + {vinfo['hyp_e_steps']} final E-steps, "
          f"B2 launches {b2}; before the float64 bound terms "
          f"{F32_TERMS_BEFORE['VBEM']}", flush=True)
    fails.check(b2 >= vb_iters + vinfo["hyp_e_steps"] > 0,
                f"protocol hyps VBEM: B2 launched {b2} times for the "
                f"stage's {vb_iters} EM iterations (restarts and hyp "
                f"objective) and {vinfo['hyp_e_steps']} final E-steps")
    ok, short = _monotone(vinfo["hyp_ll_pre"], vinfo["hyp_ll_post"])
    fails.check(ok, f"protocol hyps VBEM: every kept lane's bound at least "
                    f"its pre-optimization bound minus the C2 tolerance "
                    f"(largest shortfall {short:.3e})")
    vspecs = hyp.vb_specs(2, vcfg.bounds, vcfg.learn_hyps_keys)
    fails.check(_hyps_in_bounds(vinfo["learned_hyps"], vspecs),
                "protocol hyps VBEM: every subject's learned hyps inside "
                "their bounds")
    fails.check(bool(torch.all(torch.isfinite(
        torch.stack([r.ll for r in results])))),
        f"protocol hyps VBEM: all {len(results)} ELBOs finite")

    hcfg = dataclasses.replace(synthetic.default_vbhem_config(),
                               hyp_max_steps=PROTOCOL_HYP_STEPS)
    reset_counts()
    t0 = time.perf_counter()
    res, info, score = synthetic.run_vbhem(
        torch.Generator(device="cpu").manual_seed(PROTOCOL_HYPS_SEED),
        results, labels, *GRID, hcfg)
    torch.cuda.synchronize()
    vh_wall = time.perf_counter() - t0
    launches = read_counts()
    st = info["hyp"]
    print(f"protocol hyps VBHEM: Kb={len(results)} K={GRID[0]} x S={GRID[1]}"
          f" trials={hcfg.trials} nv={hcfg.nv} tau={hcfg.tau} "
          f"initmode={hcfg.initmode} hyps on, max_hyp_solutions="
          f"{hcfg.max_hyp_solutions} hyp_max_steps={hcfg.hyp_max_steps}: "
          f"wall={vh_wall:.3f}s restarts' chunks "
          f"{info['grid_chunk_iters']} launches={launches}", flush=True)
    print(_hyp_stage_line("protocol hyps VBHEM", st), flush=True)
    b1_want = sum(info["grid_chunk_iters"]) + st["hyp_em_iters"] \
        + st["hyp_e_steps"]
    print(f"protocol hyps VBHEM: the hyp stage's EM iterations "
          f"{st['hyp_em_iters']}, B1 launches "
          f"{st['hyp_em_iters'] + st['hyp_e_steps']}; before the float64 "
          f"bound terms {F32_TERMS_BEFORE['VBHEM']}", flush=True)
    fails.check(launches["B1"] == b1_want > 0,
                f"protocol hyps VBHEM: B1 launched {launches['B1']} times "
                f"for the {sum(info['grid_chunk_iters'])} EM iterations of "
                f"the restarts, {st['hyp_em_iters']} of the hyp objective and"
                f" rerun and {st['hyp_e_steps']} final E-steps")
    rescored = int(np.sum(np.isfinite(info["model_ll_device"])))
    fails.check(launches["B3"] == rescored,
                f"protocol hyps VBHEM: B3 (float64) launched "
                f"{launches['B3']} times for {rescored} rescored cells")
    ok, short = _monotone(st["hyp_ll_pre"], st["hyp_ll_post"])
    fails.check(ok, f"protocol hyps VBHEM: every kept lane's bound at least"
                    f" its pre-optimization bound minus the C2 tolerance "
                    f"(largest shortfall {short:.3e})")
    hspecs = hyp.vbhem_specs(2, hcfg.bounds, hcfg.learn_hyps_keys)
    cell_hyps = info["model_hyps"]
    fails.check(all(_hyps_in_bounds(h, hspecs) for h in cell_hyps.values()),
                "protocol hyps VBHEM: every cell's learned hyps inside "
                "their bounds")
    fails.check(bool(np.all(np.isfinite(info["model_ll"])))
                and bool(np.all(np.isfinite(info["model_ll_device"]))),
                "protocol hyps VBHEM: every score finite (float32 and "
                "float64)")
    print(f"protocol hyps VBHEM: scores (float64, select) "
          f"{info['model_ll'].tolist()}", flush=True)
    print(f"protocol hyps VBHEM: scores (device float32) "
          f"{info['model_ll_device'].tolist()}", flush=True)
    gaps = _cell_gaps(info)
    print(f"protocol hyps VBHEM: per-cell (f32 - f64) / |f64| under each "
          f"cell's learned hyps {json.dumps(gaps)}", flush=True)
    worst = max(abs(g) for g in gaps.values())
    fails.check(worst <= GRID_GAP_LIMIT,
                f"protocol hyps VBHEM: every cell's float32 ELBO under its "
                f"learned hyps within {GRID_GAP_LIMIT:.0e} of its float64 "
                f"rescoring (largest gap {worst:.3e})")
    sel = (info["model_best_k"], info["model_best_s"])
    print(f"protocol hyps VBHEM: selected cell's learned hyps "
          f"{ {f: getattr(cell_hyps[sel], f).double().cpu().numpy().tolist() for f in cell_hyps[sel]._fields} }",
          flush=True)
    print(f"protocol hyps VBHEM: per-cell learned hyps "
          f"{ {f'{k},{s_}': {f: getattr(h, f).double().cpu().numpy().tolist() for f in ('alpha0', 'eta0', 'epsilon0', 'lambda0', 'v0')} for (k, s_), h in cell_hyps.items()} }",
          flush=True)
    ri22 = rand_index(info["model_all"][(2, 2)].label.cpu().numpy(), labels)
    fails.check(ri22 == 1.0, f"protocol hyps (K=2, S=2) labels vs planted "
                             f"groups: Rand index {ri22}")
    sel_ri = rand_index(score.labels, labels)
    print(f"protocol hyps: selected cell K={sel[0]} S={sel[1]}; after "
          f"vbh3m_remove_empty {_selection(score)} (Rand index {sel_ri})",
          flush=True)
    fails.check((score.best_k, list(score.s_list)) == (2, [2, 2])
                and sel_ri == 1.0,
                f"protocol hyps: selection K={score.best_k} "
                f"S={score.s_list}, Rand index {sel_ri} (want K=2, S=[2, 2],"
                f" Rand index 1.0)")
    return {"launches": launches, "vbem_launches": vb_launches,
            "vbem_wall_s": vb_wall, "vbhem_wall_s": vh_wall,
            "best_k": score.best_k, "s_list": score.s_list,
            "rand_index": sel_ri}


RUNNER_METHODS = ("vbhem", "vhem", "ccfd", "ppk")
RUNNER_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_runner"


def _score_finite(sc) -> bool:
    return all(np.isfinite(float(v)) for v in (
        sc.rand_index, sc.purity, sc.best_k, sc.best_s))


def _same_score(a, b) -> bool:
    return (a.rand_index == b.rand_index and a.purity == b.purity
            and a.best_k == b.best_k and a.best_s == b.best_s
            and np.array_equal(np.asarray(a.labels), np.asarray(b.labels))
            and a.s_list == b.s_list)


def phase_runner(fails: Failures, device) -> dict:
    """The synthetic benchmark's runner, one repeat of all four methods:
    ``runner.run_repeat(0, ...)`` at the reference data scale (20 subjects
    per group, 25 sequences of T=50, K=1..6 x S=1..5), at
    ``default_vb_config()``, ``default_vbhem_config()`` and the CLI's
    ``HEMConfig(trials=20, nv=100, tau=50)``, in float32, checkpointing
    into RUNNER_DIR.  Its one cut: hyperparameter learning is off in both
    configs (the runner learns five VBEM banks, and phase "protocol hyps"
    drives hyps at this scale already).  Then ``run_repeat`` again on the
    same directory, which must load every stage, launch no kernel and
    return the same scores."""
    from vbhem_tpu_torch.experiments import runner
    import shutil
    shutil.rmtree(RUNNER_DIR, ignore_errors=True)
    RUNNER_DIR.mkdir(parents=True)
    kw = dict(
        vb_config=dataclasses.replace(synthetic.default_vb_config(),
                                      learn_hyps=False),
        vbhem_config=dataclasses.replace(synthetic.default_vbhem_config(),
                                         learn_hyps=False),
        hem_config=HEMConfig(trials=20, nv=100, tau=50),
        methods=RUNNER_METHODS, verbose=False, dtype="f32", device=device)
    try:
        reset_counts()
        t0 = time.perf_counter()
        out = runner.run_repeat(0, str(RUNNER_DIR), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        reset_counts()
        t1 = time.perf_counter()
        again = runner.run_repeat(0, str(RUNNER_DIR), **kw)
        torch.cuda.synchronize()
        resume_wall = time.perf_counter() - t1
        resume_launches = read_counts()
        files = sorted(p.name for p in RUNNER_DIR.iterdir())
    finally:
        shutil.rmtree(RUNNER_DIR, ignore_errors=True)
    work, timings, scores = out["work"], out["timings"], out["scores"]
    print(f"runner: repeat 0, {', '.join(RUNNER_METHODS)}, hyps off, "
          f"float32: wall={wall:.3f}s stage wall times (s) "
          f"{json.dumps(timings)} work {json.dumps(work)} "
          f"launches={launches}; checkpoints {files}", flush=True)
    errors = {k: v for k, v in timings.items() if k.endswith("_error")}
    fails.check(not errors, f"runner: no stage error ({errors})")
    want = {"vbhem", "vbhem_dic", "vhem_aic", "vhem_bic", "ccfd",
            "ppk_aic", "ppk_bic"}
    fails.check(set(scores) == want, f"runner: every method scored "
                                     f"({sorted(scores)})")
    fails.check(all(_score_finite(sc) for sc in scores.values())
                and all(np.isfinite(v) for v in out["dunn"].values()),
                "runner: every score and Dunn index finite")
    for m, sc in sorted(scores.items()):
        print(f"runner {m}: {_selection(sc)}; Dunn "
              f"{out['dunn'].get(m)}", flush=True)
    vb, vh, hm = (work.get(k, {}) for k in ("vbem", "vbhem", "vhem"))
    b2 = launches["B2"] + launches["B2_fused"]
    b2_want = vb.get("em_iters", 0) + vb.get("e_steps", 0)
    fails.check(b2 >= b2_want > 0,
                f"runner: B2 launched {b2} times for the VBEM banks' "
                f"{vb.get('em_iters')} EM iterations and "
                f"{vb.get('e_steps')} final E-steps")
    b1_want = vh.get("em_iters", 0) + vh.get("e_steps", 0)
    fails.check(launches["B1"] == b1_want > 0,
                f"runner: B1 launched {launches['B1']} times for the VBHEM "
                f"grid's {vh.get('em_iters')} EM iterations and "
                f"{vh.get('e_steps')} final E-steps")
    b3_fixed = vh.get("rescored", 0) + vh.get("dic_cells", 0)
    fails.check(launches["B3"] >= hm.get("em_iters", 0) + b3_fixed
                and hm.get("em_iters", 0) > 0 and b3_fixed > 0,
                f"runner: B3 launched {launches['B3']} times for the VHEM "
                f"grid's {hm.get('em_iters')} EM iterations, "
                f"{vh.get('rescored')} rescored VBHEM cells and "
                f"{vh.get('dic_cells')} DIC cells")
    sc = scores.get("vbhem")
    ri = rand_index(sc.labels, np.asarray([0] * 20 + [1] * 20)) \
        if sc is not None else None
    fails.check(sc is not None and (sc.best_k, list(sc.s_list)) == (2, [2, 2])
                and ri == 1.0,
                f"runner: VBHEM selection "
                f"{None if sc is None else (sc.best_k, sc.s_list)}, Rand "
                f"index {ri} (want K=2, S=[2, 2], Rand index 1.0)")
    print(f"runner resume: wall={resume_wall:.3f}s work "
          f"{json.dumps(again['work'])} launches={resume_launches}",
          flush=True)
    fails.check(again["work"] == {}
                and all(v == 0 for v in resume_launches.values()),
                f"runner resume: every stage loaded, no kernel launched "
                f"({resume_launches})")
    fails.check(set(again["scores"]) == set(scores) and all(
        _same_score(again["scores"][m], scores[m]) for m in scores)
        and again["dunn"] == out["dunn"],
        "runner resume: the same scores and Dunn indices")
    return {"launches": launches, "wall_s": wall, "timings": timings,
            "work": work, "resume_wall_s": resume_wall,
            "selections": {m: (sc.best_k, sc.best_s, sc.s_list,
                               sc.rand_index)
                           for m, sc in scores.items()}}


# ---------------------------------------------------------------------------
# phases 14-16: the initializers and 'auto', grouped VBEM, the demo path
# ---------------------------------------------------------------------------

INIT_MODES = ("baseem", "gmmNew", "gmmNew2", "wtkmeans", "random")
INIT_CONFIG = VBHEMConfig(alpha0=1e6, m0=(1.5, 1.5), w0=1.0,
                          trials=PIPELINE_TRIALS, nv=100, tau=50,
                          learn_hyps=False)
INIT_TRACE_ITERS = 30
# the largest relative decrease of the initmodes phase's ELBO traces, in
# float32 (the path's dtype, as phases 3 and 4 gate theirs) and in float64
INIT_MONOTONE = 1e-5
AUTO_GRID = ([1, 2, 3], [1, 2, 3])
AUTO_GRID_TRIALS = 8


def _rel_drops(trace) -> float:
    """The largest relative decrease of an ELBO trace [iters, ...]."""
    tr = trace.double().cpu().numpy()
    return float(np.max((tr[:-1] - tr[1:]) / np.abs(tr[:-1])))


def _bound_terms(base, post, hyps, cfg):
    """The bound of ``post`` and its ten terms, as an EM iteration
    evaluates them: the pair E-step (kernel B1 in the bank's dtype), the
    soft assignments and ``vbhem.elbo``."""
    tilde_n = (cfg.nv * base.num_hmms) * base.omega
    post_w, exps_w, exps = vbhem.wide_expectations(post)
    pair = vbhem.e_step(base, post, exps, cfg.tau)
    hat_z, z_ni, nj = vbhem.soft_assignments(tilde_n, exps.log_omega,
                                             pair.ll_elbo)
    return vbhem.elbo(post_w, exps_w, pair, hat_z, z_ni, nj, hyps,
                      return_terms=True)


def f32_bound_gaps(base, post0, hyps, cfg, iters) -> dict:
    """``iters`` EM iterations in float64 from ``post0``, and at each
    iteration's posterior the float32 bound (B1's float32 body) beside the
    float64 one: returns the float64 trace [iters, lanes], the largest
    relative gap of the float32 bound over lanes and iterations, and each
    term's largest absolute gap."""
    base64 = _to_f64(base)
    hyps64 = vbhem.VBHEMHyps.from_config(cfg, base.hmm.mean.shape[-1],
                                         torch.float64, base.hmm.mean.device)
    tilde_n = (cfg.nv * base.num_hmms) * base64.omega
    post = tree_map(_f64, post0)
    trace, rel, terms = [], 0.0, {}
    for _ in range(iters):
        ll64, t64 = _bound_terms(base64, post, hyps64, cfg)
        ll32, t32 = _bound_terms(base, tree_map(lambda x: x.float(), post),
                                 hyps, cfg)
        rel = max(rel, float(torch.max(torch.abs(ll32.double() - ll64)
                                       / torch.abs(ll64))))
        for k in t64:
            terms[k] = max(terms.get(k, 0.0), float(torch.max(torch.abs(
                t32[k].double() - t64[k]))))
        trace.append(ll64)
        post = vbhem._em_iteration(base64, post, hyps64, tilde_n,
                                   cfg.tau)[0]
    return {"trace": torch.stack(trace), "rel_gap": rel, "terms": terms}


def phase_initmodes(fails: Failures, device, vbem) -> dict:
    """Each initializer at full width: the (K=2, S=2) cell of the bank
    phase 4 learned (Kb=8192, Sb=2), PIPELINE_TRIALS restarts, the
    pipeline's settings.  Per mode: the initializer's own time and peak
    memory, the restarts' EM (iterations, wall time, B1 launches), the
    restarts whose labels recover the planted groups and whether the
    best-ELBO restart is one of them (findings, not gates); an
    INIT_TRACE_ITERS-iteration ``em_trace`` from the same starts in
    float32 and the same iterations in float64 (:func:`f32_bound_gaps`),
    neither of whose ELBO may fall by more than INIT_MONOTONE relative on
    any lane; the float32 bound (B1's float32 body) at each float64
    iterate within GRID_GAP_LIMIT of the float64 one (each term's gap
    printed); and the best lane finite.  Then ``cluster``
    under the default initmode 'auto' over K in {1,2,3} x S=2
    (PIPELINE_TRIALS restarts a mode) must select K=2 with Rand index
    1.0, and ``cluster_batched`` under 'auto' over
    AUTO_GRID (AUTO_GRID_TRIALS restarts a mode) must select (2, 2) with
    every cell within GRID_GAP_LIMIT of its float64 rescoring."""
    labels = vbem["labels"]
    base = vbhem.h3m_from_results(vbem["results"], device=device)
    cfg = INIT_CONFIG
    assert cfg.initmode == "auto"
    hyps = vbhem.VBHEMHyps.from_config(cfg, 2, torch.float32, device)
    n = cfg.trials
    out = {"modes": {}}
    # the path's launches: the modes' EM runs, cluster() and the grid
    # (not the em_trace checks)
    path = {k: 0 for k in read_counts()}
    for mode in INIT_MODES:
        gen = torch.Generator(device="cpu").manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        post0 = vbhem.draw_lanes(mode, gen, base, 2, 2, hyps, cfg.nv, n)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_gib = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 30
        reset_counts()
        t0 = time.perf_counter()
        st = vbhem.vbhem_em(base, post0, hyps, nv=cfg.nv, tau=cfg.tau,
                            max_iter=cfg.max_iter, min_diff=cfg.min_diff)
        torch.cuda.synchronize()
        em_s = time.perf_counter() - t0
        launches = read_counts()
        path = {k: path[k] + launches[k] for k in path}
        iters = int(torch.max(st.it))
        lab = torch.argmax(st.hat_z, dim=-1).cpu().numpy()
        ris = np.asarray([rand_index(lab[i], labels) for i in range(n)])
        ll = st.ll.double().cpu().numpy()
        best = int(np.argmax(ll))
        _, trace32 = vbhem.em_trace(base, post0, hyps, cfg.nv, cfg.tau,
                                    n_iter=INIT_TRACE_ITERS)
        gaps = f32_bound_gaps(base, post0, hyps, cfg, INIT_TRACE_ITERS)
        trace = gaps["trace"]
        drop, drop32 = _rel_drops(trace), _rel_drops(trace32)
        rec = int(np.sum(ris == 1.0))
        print(f"initmodes {mode}: Kb={base.num_hmms} (K=2, S=2) {n} "
              f"restarts: init {init_s:.3f}s peak {init_gib:.3f} GiB; EM "
              f"{iters} iterations {em_s:.3f}s B1 {launches['B1']} "
              f"launches; {rec}/{n} restarts recover the groups "
              f"(Rand index 1.0); best-ELBO restart {best} "
              f"ll={ll[best]:.6g} Rand index {ris[best]:.6f}; trace "
              f"largest relative decrease f32 {drop32:.3e}, f64 {drop:.3e}; "
              f"f32 bound at the f64 iterates: largest relative gap "
              f"{gaps['rel_gap']:.3e}, largest absolute gap by term "
              f"{ {k: float(f'{v:.3g}') for k, v in gaps['terms'].items()} }",
              flush=True)
        fails.check(bool(np.isfinite(ll[best])),
                    f"initmodes {mode}: best lane's ELBO finite")
        fails.check(launches["B1"] == iters > 0,
                    f"initmodes {mode}: B1 launched {launches['B1']} times "
                    f"for {iters} EM iterations")
        for what, tr, dr in (("float32", trace32, drop32),
                             ("float64", trace, drop)):
            fails.check(bool(torch.all(torch.isfinite(tr)))
                        and dr <= INIT_MONOTONE,
                        f"initmodes {mode}: {INIT_TRACE_ITERS} EM iterations "
                        f"on {n} lanes in {what}, largest relative decrease "
                        f"{dr:.3e} <= {INIT_MONOTONE:.0e}")
        fails.check(gaps["rel_gap"] <= GRID_GAP_LIMIT,
                    f"initmodes {mode}: float32 bound within "
                    f"{GRID_GAP_LIMIT:.0e} of the float64 one at every "
                    f"float64 iterate (largest {gaps['rel_gap']:.3e})")
        out["modes"][mode] = {
            "recovered": rec, "best_recovers": bool(ris[best] == 1.0),
            "init_s": init_s, "init_peak_gib": init_gib, "em_s": em_s,
            "em_iters": iters, "b1_launches": launches["B1"],
            "trace_drop_f64": drop, "trace_drop_f32": drop32,
            "f32_bound_gap": gaps["rel_gap"], "term_gaps": gaps["terms"]}
        del st, post0, trace, trace32
        torch.cuda.empty_cache()

    gen = torch.Generator(device="cpu").manual_seed(1)
    reset_counts()
    t0 = time.perf_counter()
    res, info = vbhem.cluster(gen, base, AUTO_GRID[0], 2, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    iters = sum(info["model_em_iters"].values())
    ri = rand_index(res.label.cpu().numpy(), labels)
    print(f"initmodes cluster auto: K={AUTO_GRID[0]} S=2, {n} restarts a "
          f"mode: wall {wall:.3f}s, {iters} EM iterations, B1 "
          f"{launches['B1']}; selected K={info['model_best_k']} Rand index "
          f"{ri:.6f}; kept modes {info['model_initmode']}; scores "
          f"{np.asarray(info['model_ll']).ravel().tolist()}", flush=True)
    fails.check(launches["B1"] == iters > 0,
                f"initmodes cluster auto: B1 launched {launches['B1']} "
                f"times for {iters} EM iterations")
    fails.check(info["model_best_k"] == 2 and ri == 1.0,
                f"initmodes cluster auto: K={info['model_best_k']} "
                f"(want 2), Rand index {ri}")
    out["cluster"] = {"wall_s": wall, "launches": launches,
                      "kept": {f"{k},{s_}": m for (k, s_), m
                               in info["model_initmode"].items()}}

    gcfg = dataclasses.replace(cfg, trials=AUTO_GRID_TRIALS)
    gen = torch.Generator(device="cpu").manual_seed(2)
    reset_counts()
    t0 = time.perf_counter()
    res, info = vbhem.cluster_batched(gen, base, *AUTO_GRID, gcfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    glaunches = read_counts()
    gaps = _cell_gaps(info)
    worst = max(abs(g) for g in gaps.values())
    ri = rand_index(res.label.cpu().numpy(), labels)
    best = (info["model_best_k"], info["model_best_s"])
    print(f"initmodes cluster_batched auto: K={AUTO_GRID[0]} x "
          f"S={AUTO_GRID[1]}, {AUTO_GRID_TRIALS} restarts a mode: wall "
          f"{wall:.3f}s, chunks {info['grid_chunk_iters']}, launches "
          f"{glaunches}; selected {best} Rand index {ri:.6f}; f32-f64 gaps "
          f"{gaps}", flush=True)
    iters = sum(info["grid_chunk_iters"])
    fails.check(glaunches["B1"] == iters > 0,
                f"initmodes cluster_batched auto: B1 launched "
                f"{glaunches['B1']} times for {iters} EM iterations")
    rescored = int(np.sum(np.isfinite(info["model_ll_device"])))
    fails.check(glaunches["B3"] == rescored,
                f"initmodes cluster_batched auto: B3 launched "
                f"{glaunches['B3']} times for {rescored} rescored cells")
    fails.check(best == (2, 2) and ri == 1.0,
                f"initmodes cluster_batched auto: selected {best} (want "
                f"(2, 2)), Rand index {ri}")
    fails.check(worst <= GRID_GAP_LIMIT,
                f"initmodes cluster_batched auto: every cell's f32-f64 gap "
                f"within {GRID_GAP_LIMIT:.0e} (largest {worst:.3e})")
    out["grid"] = {"wall_s": wall, "launches": glaunches, "gaps": gaps}
    out["launches"] = {k: path[k] + launches[k] + glaunches[k]
                       for k in path}
    return out


GROUPED_N, GROUPED_T = 4096, 50
GROUPED_TRANS = ([[0.8, 0.2], [0.2, 0.8]], [[0.2, 0.8], [0.8, 0.2]])
GROUPED_CONFIG = VBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=20,
                          learn_hyps=False)


def grouped_data(device, dtype=torch.float32, seed=3):
    """Two stimulus conditions, GROUPED_N / 2 sequences of GROUPED_T
    fixations each, from 2-state HMMs with shared ROIs (means (0, 0) and
    (3, 3)) and different dynamics (GROUPED_TRANS: sticky, alternating).
    Returns (SeqBatch, group_map [GROUPED_N])."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    xs = []
    for trans in GROUPED_TRANS:
        hmm = HMM(prior=torch.tensor([0.5, 0.5], dtype=torch.float64),
                        trans=torch.tensor(trans, dtype=torch.float64),
                        mean=torch.tensor([[0.0, 0.0], [3.0, 3.0]],
                                          dtype=torch.float64),
                        cov=torch.eye(2, dtype=torch.float64).expand(2, 2, 2))
        xs.append(hmm_tools.sample(gen, hmm, GROUPED_T, GROUPED_N // 2)[1])
    x = torch.cat(xs).to(device=device, dtype=dtype)
    lengths = torch.full((GROUPED_N,), GROUPED_T, dtype=torch.int32,
                         device=device)
    gm = torch.arange(GROUPED_N, device=device) >= GROUPED_N // 2
    return SeqBatch(x=x, lengths=lengths), gm.long()


def grouped_launch_args(batch, post, group_map):
    """Kernel B2's fused entry's arguments at the grouped E-step's launch:
    x and the mask shared by the lanes, each sequence's group scores
    log_pz1 [L, N, K] and log_trans [L, N, K, K], the emission
    constants."""
    x, mask = vbhmm._views(batch, post.alpha.shape[:-2])
    pz1 = e_log_dirichlet(post.alpha).index_select(-2, group_map)
    trans = e_log_dirichlet(post.epsilon).index_select(-3, group_map)
    return x, mask, pz1, trans, fb_plain.emission_constants(post.niw)


def phase_grouped(fails: Failures, device) -> dict:
    """``vbhmm_groups.learn_grouped`` on two stimulus conditions with
    shared ROIs and different dynamics (:func:`grouped_data`: GROUPED_N
    sequences of T=50, D=2), K in {1,2,3}, 20 restarts, hyps off, float32:
    it must select K=2; B2 (per-sequence scores, the fused entry) launched
    once per EM iteration and once for the standardized model of each K;
    an ``INIT_TRACE_ITERS``-iteration grouped EM from the K=2 starts whose
    ELBO never falls by more than 1e-5 relative; and B2 at this launch's
    own shape (20 lanes of the K=2 starts) held against the plain version
    in float64 at phase 2's gates, in float32 and float64, and timed."""
    batch, gm = grouped_data(device)
    cfg = GROUPED_CONFIG
    gen = torch.Generator(device="cpu").manual_seed(0)
    reset_counts()
    t0 = time.perf_counter()
    res, info = vbhmm_groups.learn_grouped(gen, batch, [1, 2, 3], gm, 2, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    iters = [inf["em_iters"] for inf in info["model_infos"]]
    trans = [m.trans.cpu().numpy().round(3).tolist()
             for m in res.group_models]
    print(f"grouped: {GROUPED_N} sequences (2 conditions) T={GROUPED_T} "
          f"D=2, K=[1,2,3], {cfg.numtrials} restarts: wall {wall:.3f}s, "
          f"EM iterations {iters}, launches {launches}; selected "
          f"K={info['model_best_k']}; scores {info['model_ll'].tolist()}; "
          f"group transitions {trans}", flush=True)
    fails.check(info["model_best_k"] == 2,
                f"grouped: selected K={info['model_best_k']} (want 2)")
    want = sum(iters) + len(iters)
    fails.check(launches["B2_fused"] == want and launches["B2"] == 0,
                f"grouped: B2's fused entry launched "
                f"{launches['B2_fused']} times (entry 1 {launches['B2']}) "
                f"for {sum(iters)} EM iterations + {len(iters)} "
                f"standardized models")

    hyps = vbhmm.VBHyps.from_config(cfg, 2, torch.float32, device)
    post0 = vbhmm_groups.from_ungrouped(vbhmm.random_init(
        torch.Generator(device="cpu").manual_seed(1), batch, 2, hyps,
        lanes=(cfg.numtrials,)), 2)
    post, lls = post0, []
    for _ in range(INIT_TRACE_ITERS):
        fb = vbhmm_groups.e_step(batch, post, gm)
        stats = vbhmm_groups.grouped_stats(batch, fb, gm, 2)
        lls.append(vbhmm_groups.elbo(batch, post, fb, stats, hyps))
        post = vbhmm_groups.m_step(stats, hyps)
    drop = _rel_drops(torch.stack(lls))
    fails.check(bool(torch.all(torch.isfinite(torch.stack(lls))))
                and drop <= 1e-5,
                f"grouped: EM trace {INIT_TRACE_ITERS} iterations on "
                f"{cfg.numtrials} lanes, largest relative decrease "
                f"{drop:.3e} <= 1e-5")

    max_abs = 0.0
    for dtype in (torch.float32, torch.float64):
        cast = tree_map(lambda a: a.to(dtype), post0)
        b = SeqBatch(x=batch.x.to(dtype), lengths=batch.lengths)
        args = grouped_launch_args(b, cast, gm)
        got = fb_cuda.e_step_fused(*args)
        torch.cuda.synchronize()
        x, mask, pz1, trans_, _ = args

        def plain_fn(c):
            return fb_plain.forward_backward(
                c(pz1), c(trans_), fb_plain.expected_log_gauss(
                    c(x), tree_map(c, cast.niw)), mask)
        err = _parity_fb(fails, f"fused grouped launch L={cfg.numtrials} "
                                f"N={GROUPED_N} per-sequence scores", dtype,
                         got, lambda: plain_fn(_f64),
                         lambda: plain_fn(lambda a: a))
        if dtype == torch.float32:
            max_abs = err
        del got
    args = grouped_launch_args(batch, post0, gm)
    kernel_ms = device_ms(lambda: fb_cuda.e_step_fused(*args),
                          DEVICE_NAMES["B2"], 20)
    plain_s = _time(lambda: fb_plain.forward_backward(
        args[2], args[3], fb_plain.expected_log_gauss(args[0], post0.niw),
        args[1]), 3, device)
    b = b2_fused_bound(*args)
    print(f"grouped launch: B2 fused, {cfg.numtrials} lanes x {GROUPED_N} "
          f"sequences T={GROUPED_T} K=2 D=2, per-sequence scores: device "
          f"{kernel_ms:.4f} ms, plain {plain_s * 1e3:.2f} ms; "
          f"{_bound_line(b)}", flush=True)
    return {"launches": launches, "wall_s": wall, "max_abs_f32": max_abs,
            "grouped_launch": {"kernel_device_ms": kernel_ms,
                               "plain_ms": plain_s * 1e3,
                               "bound_ms": b["bound_ms"],
                               "bound_by": b["bound_by"],
                               "launches": launches["B2_fused"]}}


DEMO_PER_GROUP = 20
# The demo's Rand index against the two groups must reach this: K_hat=2
# with at most two of the 40 viewers outside their group's cluster.  On
# the banks the demo's path learned from data seeds 0-5 (twelve runs of
# tools/demo_seeds.py, with and without the cut below), the port selected
# K_hat=2 every time and put 0, 1 or 2 viewers outside their group, and
# the JAX package's cluster_batched on the same banks
# (tools/demo_witness_jax.py) put the same viewers there: the misses are
# the banks', viewers whose learned HMM has fewer ROIs than their group's
# (PERF.md §6).
DEMO_MIN_RAND_INDEX = 0.9
# the demo's cut (depth): its VBEM stage learns hyps on this many
# survivors a subject with this many L-BFGS steps (the CLI: every
# survivor, 50 steps); 10 steps keep chip_smoke under 700 s
# (tools/demo_seeds.py runs 25 by default, the cut its seeds were counted
# at)
DEMO_HYP_SOLUTIONS, DEMO_HYP_STEPS = 5, 10
DEMO_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_demo"


def phase_demo(fails: Failures, device) -> dict:
    """The face demo's path (`vbdemo_face.m`) as its CLI runs it on
    synthetic data (the reference's demodata.xls is not in the
    repository): DEMO_PER_GROUP viewers in each of two groups
    (``demo_fixations.synth_subjects``: 12 trials of 12 fixations on a
    512 x 384 face) written to a fixation CSV and read back, float32, by
    ``read_fixations_auto``, which must run the native loader; then
    ``demo_fixations.demo_path`` with the CLI's synthetic-data settings:
    per-subject VBEM over S=1..3 with ``VBConfig(numtrials=10,
    learn_hyps=True)`` and mode 'd' hyps (the subjects as lanes of
    ``batch.learn_bank``), then ``cluster_batched`` over K=1..5 x S=1..3
    with ``synthetic_vbhem_config`` (alpha0=1e6, Nv=50, tau=10, 'auto',
    10 restarts; float32 with the float64 rescoring) and
    ``vbh3m_remove_empty``.  Gates: K_hat (the clusters that survive
    pruning, as ``synthetic.run_vbhem`` scores it) = 2 with a Rand index
    against the groups of at least DEMO_MIN_RAND_INDEX; every cell's
    score finite; B2's fused entry, B1 and B3 launched.  The reference demo's VBHEM settings are measured
    over data seeds by ``tools/demo_seeds.py`` (PERF.md §6), not here.
    Its cuts (depth, printed): the VBEM stage learns hyps on
    DEMO_HYP_SOLUTIONS survivors a subject with DEMO_HYP_STEPS L-BFGS
    steps; no plots on the card."""
    from vbhem_tpu_torch.experiments import demo_fixations as demo
    from vbhem_tpu_torch.utils import io as fix_io
    from vbhem_tpu_torch.utils import native_io
    print(f"demo: cut: VBEM hyps on {DEMO_HYP_SOLUTIONS} survivors per "
          f"subject, {DEMO_HYP_STEPS} L-BFGS steps (the CLI: every "
          f"survivor, 50 steps); no plots", flush=True)
    gen = torch.Generator(device="cpu").manual_seed(0)
    batches, labels = demo.synth_subjects(gen, DEMO_PER_GROUP, device="cpu")
    names = [f"viewer{i:02d}" for i in range(len(batches))]
    DEMO_DIR.mkdir(parents=True, exist_ok=True)
    table = DEMO_DIR / "fixations.csv"
    fix_io.write_fixations(str(table), dict(zip(names, batches)))
    t0 = time.perf_counter()
    subjects, reader = native_io.read_fixations_auto(
        str(table), dtype=np.float32, device=device)
    t_read = time.perf_counter() - t0
    fails.check(reader == "native" and list(subjects) == names,
                f"demo: {len(subjects)} subjects read by the {reader} "
                f"reader (want native; {native_io.unavailable_reason()})")
    batches = [subjects[n] for n in names]
    stage_launches = {}

    def stage_end(name):
        torch.cuda.synchronize()
        stage_launches[name] = read_counts()
        reset_counts()
    reset_counts()
    run = demo.demo_path(gen, batches, table=False, stage_end=stage_end,
                         max_hyp_solutions=DEMO_HYP_SOLUTIONS,
                         hyp_max_steps=DEMO_HYP_STEPS)
    cfg, vcfg, info = run["vb_config"], run["vbhem_config"], run["info"]
    vb_launches, launches = stage_launches["vbem"], stage_launches["vbhem"]
    print(f"demo VBEM: {len(batches)} viewers, S=1..3, numtrials="
          f"{cfg.numtrials} hyps {'on' if cfg.learn_hyps else 'off'}, "
          f"mu0={tuple(round(float(m), 3) for m in cfg.mu0)} "
          f"W0={cfg.w0:.6g}: wall {run['wall_s']['vbem']:.3f}s, launches "
          f"{vb_launches}; S per viewer {run['s_sel']}", flush=True)
    fails.check(vb_launches["B2_fused"] > 0,
                f"demo VBEM: B2's fused entry launched "
                f"{vb_launches['B2_fused']} times")
    res, group_hmms = run["res"], run["group_hmms"]
    ri = rand_index(res.label.cpu().numpy(), labels)
    s_hat = [int(h.model.prior.shape[0]) for h in group_hmms]
    print(f"demo VBHEM: K={run['grid'][0]} x S={run['grid'][1]} "
          f"{vcfg.initmode} Nv={vcfg.nv} tau={vcfg.tau} alpha0="
          f"{vcfg.alpha0:g} {vcfg.trials} restarts hyps "
          f"{'on' if vcfg.learn_hyps else 'off'}: wall "
          f"{run['wall_s']['vbhem']:.3f}s, launches {launches}; grid "
          f"selection K={info['model_best_k']} S={info['model_best_s']}; "
          f"pruned: K_hat={len(group_hmms)} clusters of S_hat={s_hat} "
          f"states; groups {[len(g) for g in res.groups]}; Rand index "
          f"{ri:.6f}; per-K best scores "
          f"{np.max(info['model_ll'], axis=1).tolist()}; f32-f64 gaps "
          f"{_cell_gaps(info)}", flush=True)
    rescored = int(np.sum(np.isfinite(info["model_ll_device"])))
    fails.check(bool(np.all(np.isfinite(info["model_ll"])))
                and launches["B1"] > 0 and launches["B3"] == rescored,
                f"demo VBHEM: every score finite; B1 launched "
                f"{launches['B1']} times, B3 {launches['B3']} for "
                f"{rescored} rescored cells")
    fails.check(len(group_hmms) == 2 and ri >= DEMO_MIN_RAND_INDEX,
                f"demo: K_hat={len(group_hmms)} after pruning (want 2), "
                f"Rand index {ri} (want >= {DEMO_MIN_RAND_INDEX})")
    walls = {"read": t_read, **run["wall_s"]}
    print(f"demo: K_hat={len(group_hmms)} S_hat={s_hat} Rand index "
          f"{ri:.6f}; wall {walls}", flush=True)
    return {"launches": launches, "vbem_launches": vb_launches,
            "wall_s": walls, "k_hat": len(group_hmms), "s_hat": s_hat,
            "rand_index": ri}


# ---------------------------------------------------------------------------
# phase 10: timing
# ---------------------------------------------------------------------------

def em_iteration(base, post, hyps, tilde_n, tau, pair_fn):
    post_w, exps_w, exps = vbhem.wide_expectations(post)
    pair = pair_fn(base, post, exps, tau)
    hat_z, z_ni, nj = vbhem.soft_assignments(tilde_n, exps.log_omega,
                                             pair.ll_elbo)
    ll = vbhem.elbo(post_w, exps_w, pair, hat_z, z_ni, nj, hyps)
    stats = vbhem.aggregate_stats(base, pair, z_ni, nj)
    return vbhem.m_step(stats, hyps), ll


MAIN_CELL = "main-path cell Kb=8192 L=8 Kr=3 Sb=Sr=3 D=2 tau=10"
TIMING_SHAPES = [
    # name, kb, lanes, kr, sb, sr, tau, timed calls
    ("bench Kb=8192 L=1 Kr=8 Sb=Sr=3 D=2 tau=10", 8192, 1, 8, 3, 3, 10, 50),
    # the pipeline's largest launch (phase 5: a learned bank of 2-state
    # HMMs, 64 restart lanes of Kr=3, tau=50)
    ("pipeline Kb=8192 L=64 Kr=3 Sb=Sr=2 D=2 tau=50", 8192, 64, 3, 2, 2, 50,
     10),
    (MAIN_CELL, 8192, 8, 3, 3, 3, 10, 50),
]


def timing_b1(device) -> dict:
    """B1: E-step (wrapper and kernel) and EM iteration times, kernel and
    plain, in the order kernel, plain, plain, kernel; the kernel's device
    time by the profiler; the bound; the design the wrapper takes.
    MAIN_CELL is the kernels line's shape."""
    out = {}
    d = 2
    for name, kb, lanes, kr, sb, sr, tau, n in TIMING_SHAPES:
        rng = np.random.default_rng(0)
        base = random_bank(rng, kb, sb, d, device, torch.float32)
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
        des = pair_estep_cuda.design(sb, sr, tau, 4, pairs, sm_count())
        row = {"kernel_device_ms": dev_ms, "design": des._asdict(),
               **b1_bound(kb, lanes * kr, sb, sr, d, tau, 4)}
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
              f"in the earlier count {row['bound_ms_before']:.4f} ms, "
              f"{row['sfu_ops_before']:.4g} SFU ops); "
              f"{design_note(des, pairs, sb, sr, tau, 4)}", flush=True)
        out[name] = row
    return out


def plain_vbem_e_step(batch, post):
    """The VBEM E-step's plain version (what the CPU path runs):
    expected_log_gauss, then the plain forward-backward."""
    x, mask = vbhmm._views(batch, post.alpha.shape[:-1])
    return fb_plain.forward_backward(
        e_log_dirichlet(post.alpha), e_log_dirichlet(post.epsilon),
        fb_plain.expected_log_gauss(x, post.niw), mask)


def entry1_vbem_e_step(batch, post):
    """The VBEM E-step through B2's entry 1 (the path before the fused
    entry): log_rho by expected_log_gauss in PyTorch, then
    forward_backward_cuda."""
    x, mask = vbhmm._views(batch, post.alpha.shape[:-1])
    return fb_cuda.forward_backward_cuda(
        e_log_dirichlet(post.alpha), e_log_dirichlet(post.epsilon),
        fb_plain.expected_log_gauss(x, post.niw).contiguous(), mask)


def timing_b2(device, vbem, n=10) -> dict:
    """B2 at the full-width launch (the VBEM path's own shape: every
    subject x restart lane of the bank, random-start posteriors).  The
    E-step three ways, in the order fused, entry 1, plain, plain, entry 1,
    fused: ``vbhmm.e_step`` (the fused entry, emission constants
    included), expected_log_gauss followed by entry 1, and the plain
    version; each entry's device time; each entry's bound; one VBEM
    iteration (``vbhmm._iteration``) with each of the three E-steps."""
    bank, hyps = vbem["bank"], vbem["hyps"]
    gen = torch.Generator(device=device).manual_seed(3)
    post = vbhmm.random_init(gen, bank, 2, hyps,
                             lanes=(VB_CONFIG.numtrials,))
    x, mask = vbhmm._views(bank, post.alpha.shape[:-1])
    pz1, trans = e_log_dirichlet(post.alpha), e_log_dirichlet(post.epsilon)
    emis = fb_plain.emission_constants(post.niw)
    log_rho = fb_plain.expected_log_gauss(x, post.niw).contiguous()
    e_steps = {"kernel": vbhmm.e_step, "entry1": entry1_vbem_e_step,
               "plain": plain_vbem_e_step}
    es_runs = interleaved({w: (lambda f=f: f(bank, post))
                           for w, f in e_steps.items()}, n, device, warmup=1)
    dev_fused = device_ms(
        lambda: fb_cuda.e_step_fused(x, mask, pz1, trans, emis),
        DEVICE_NAMES["B2"], 5)
    dev_entry1 = device_ms(
        lambda: fb_cuda.forward_backward_cuda(pz1, trans, log_rho, mask),
        DEVICE_NAMES["B2"], 5)
    entry1_bound = b2_bound(pz1, trans, log_rho, mask)
    del log_rho

    def stepper(e_step):
        state = [post]

        def step():
            with rebound(vbhmm, "e_step", e_step):
                state[0] = vbhmm._iteration(bank, state[0], hyps)[0]
        return step
    it_runs = interleaved({w: stepper(f) for w, f in e_steps.items()}, 3,
                          device, warmup=1)
    row = {"kernel_device_ms": dev_fused, "entry1_device_ms": dev_entry1,
           **b2_fused_bound(x, mask, pz1, trans, emis),
           "entry1_bound": entry1_bound}
    for which in e_steps:
        row[which] = {"estep_ms": float(np.mean(es_runs[which])) * 1e3,
                      "iter_ms": float(np.mean(it_runs[which])) * 1e3,
                      "estep_ms_runs": [v * 1e3 for v in es_runs[which]],
                      "iter_ms_runs": [v * 1e3 for v in it_runs[which]]}
    lanes = tuple(post.alpha.shape[:-1])
    shape = f"{lanes} lanes x 25 sequences, T=50, K=2, D=2, f32"
    print(f"timing B2 fused E-step [full width: {shape}] kernel device "
          f"{dev_fused:.4f} ms; bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}: {row['bytes']:.4g} bytes, "
          f"{row['sfu_ops']:.4g} SFU ops)", flush=True)
    print(f"timing B2 entry 1 [full width] kernel device {dev_entry1:.4f} "
          f"ms; bound {entry1_bound['bound_ms']:.4f} ms "
          f"({entry1_bound['bound_by']}: {entry1_bound['bytes']:.4g} "
          f"bytes)", flush=True)
    for which, what in (("kernel", "e_step (fused entry)"),
                        ("entry1", "expected_log_gauss + entry 1"),
                        ("plain", "plain")):
        print(f"timing VBEM E-step [full width] {what}: "
              f"{row[which]['estep_ms']:.4f} ms (runs "
              f"{row[which]['estep_ms_runs']}); VBEM iteration "
              f"{row[which]['iter_ms']:.4f} ms (runs "
              f"{row[which]['iter_ms_runs']})", flush=True)
    return row


def timing_b3(device, vbem, n=50) -> dict:
    """B3 at the VHEM path's largest launch (20 restart lanes of Kr=3,
    Sr=3 on the Kb=8192, Sb=2 bank phase 4 learned, tau=10, float32, from
    baseem starts): wrapper, kernel device time and plain; one VHEM EM
    iteration with the kernel and with the plain version; and the gap of
    ll_elbo and of the assignment logits log_z between B3 in float32 and
    B3 in float64 on the same inputs."""
    lanes, kb, kr, sb, sr, tau = VHEM_FULL
    base = vbhem.h3m_from_results(vbem["results"], use_post=False)
    cfg = HEMConfig(trials=lanes, nv=100, tau=tau)
    gen = torch.Generator(device=device).manual_seed(4)
    h3m = vhem.init_baseem(gen, base, kr, sr, cfg, lanes=(lanes,))
    args = (base.hmm.prior, base.hmm.trans, vhem._log_floor(h3m.hmm.prior),
            vhem._log_floor(h3m.hmm.trans),
            plain.expected_pair_ll_point(base.hmm.mean, base.hmm.cov,
                                         h3m.hmm.mean, h3m.hmm.cov))
    bf_runs = interleaved({
        "kernel": lambda: pair_estep_cuda.pair_bwd_fwd_cuda(*args, tau),
        "plain": lambda: plain.pair_bwd_fwd(*args, tau)}, n, device)
    dev_ms = device_ms(lambda: pair_estep_cuda.pair_bwd_fwd_cuda(*args, tau),
                       DEVICE_NAMES["B3"], 20)
    n_i = (cfg.nv * kb) * base.omega
    inf_norm = vhem._inf_norm(cfg.inf_norm, cfg.nv, tau, kb)

    def stepper(bwd_fwd):
        """vhem._iteration with its pair recursion bound to ``bwd_fwd``."""
        state = [h3m]

        def step():
            with rebound(vhem, "pair_bwd_fwd_auto", bwd_fwd):
                state[0] = vhem._iteration(base, state[0], cfg, n_i,
                                           inf_norm, gen)[0]
        return step
    it_runs = interleaved({"kernel": stepper(pair_estep_cuda.pair_bwd_fwd_auto),
                           "plain": stepper(plain.pair_bwd_fwd)}, 20, device)

    # float32 against float64 on the same inputs, both through B3
    p32 = pair_estep_cuda.pair_bwd_fwd_cuda(*args, tau)
    p64 = pair_estep_cuda.pair_bwd_fwd_cuda(*[a.double() for a in args], tau)
    log_w = vhem._log_floor(h3m.omega.double())[..., None, :]
    z32 = log_w + n_i.double()[:, None] * (p32.ll_elbo.double() / inf_norm)
    z64 = log_w + n_i.double()[:, None] * (p64.ll_elbo / inf_norm)
    d_ll = torch.abs(p32.ll_elbo.double() - p64.ll_elbo)
    gap = {"ll_elbo_max_abs": float(d_ll.max()),
           "ll_elbo_max_rel": float(torch.max(d_ll / p64.ll_elbo.abs())),
           "log_z_max_abs": float(torch.abs(z32 - z64).max()),
           "log_z_factor": float(n_i.max()) / inf_norm}

    des = pair_estep_cuda.design(sb, sr, tau, 4, kb * lanes * kr,
                                 sm_count())
    row = {"kernel_device_ms": dev_ms, "f32_vs_f64": gap,
           "design": des._asdict(),
           **b3_bound(kb, lanes * kr, sb, sr, tau, 4)}
    for which in ("kernel", "plain"):
        row[which] = {"bf_ms": float(np.mean(bf_runs[which])) * 1e3,
                      "iter_ms": float(np.mean(it_runs[which])) * 1e3,
                      "bf_ms_runs": [v * 1e3 for v in bf_runs[which]],
                      "iter_ms_runs": [v * 1e3 for v in it_runs[which]]}
    print(f"timing B3 [VHEM full width: L={lanes} Kb={kb} Kr={kr} Sb={sb} "
          f"Sr={sr} tau={tau} f32] kernel device {dev_ms:.4f} ms; wrapper "
          f"{row['kernel']['bf_ms']:.4f} ms (runs {row['kernel']['bf_ms_runs']})"
          f"; plain {row['plain']['bf_ms']:.4f} ms (runs "
          f"{row['plain']['bf_ms_runs']}); bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}: {row['sfu_ops']:.4g} SFU ops, "
          f"{row['bytes']:.4g} bytes of which ell {row['ell_bytes']:.4g}; "
          f"in the earlier count {row['bound_ms_before']:.4f} ms, "
          f"{row['sfu_ops_before']:.4g} SFU ops); "
          f"{design_note(des, kb * lanes * kr, sb, sr, tau, 4)}",
          flush=True)
    print(f"timing VHEM iteration [full width]: kernel "
          f"{row['kernel']['iter_ms']:.4f} ms (runs "
          f"{row['kernel']['iter_ms_runs']}), plain "
          f"{row['plain']['iter_ms']:.4f} ms (runs "
          f"{row['plain']['iter_ms_runs']})", flush=True)
    print(f"B3 f32 vs f64 [full width]: {json.dumps(gap)}", flush=True)
    return row


def _bound_line(row) -> str:
    return (f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
            f"{row['sfu_ops']:.4g} SFU ops, {row['bytes']:.4g} bytes)")


def grid_chunk(base, lanes, device, seed=5):
    """The grid's B1 launch at a lane chunk of ``lanes``: baseem starts at
    (Kmax, Smax) = (6, 5), the lanes cycling over the grid's cells; returns
    (posterior, each lane's cell, float32 hyperparameters, the generator
    after its draws)."""
    kmax, smax = max(GRID[0]), max(GRID[1])
    cells = [(k, s_) for k in GRID[0] for s_ in GRID[1]]
    lane_cells = [cells[i % len(cells)] for i in range(lanes)]
    hyps = vbhem.VBHEMHyps.from_config(GRID_CONFIG, 2, torch.float32, device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    post = vbhem.init_baseem(gen, base, kmax, smax, hyps, GRID_CONFIG.nv,
                             lanes=(lanes,))
    return post, lane_cells, hyps, gen


def _masked_state_values(stats, lane, s_):
    """The entries of one lane's pair statistics at reduced states s_ and
    above (masked in a cell of S = s_): nu_1, sum_xi's rows and columns,
    sum_t_nu."""
    return torch.cat([stats.nu_1[lane, ..., s_:].flatten(),
                      stats.sum_xi[lane, ..., s_:, :].flatten(),
                      stats.sum_xi[lane, ..., :, s_:].flatten(),
                      stats.sum_t_nu[lane, ..., s_:, :].flatten()])


def parity_grid_chunk(fails: Failures, device, grid) -> dict:
    """B1 checked at the launch the grid runs: one launch at phase 8's lane
    chunk (its lane count, each lane masked to its cell, Kb=8192, Sb=2,
    Kmax=6, Smax=5, tau=50, float32), in the design ``design()`` names,
    which allocates no scratch (the device memory the launch takes stays
    below its outputs and a tenth of what the scratch would be), and a
    spread of its lanes (the first, the middle and the last, and the first
    lane of K=1, of S=1, of (6, 5) and of the other cells) held against
    the plain version in float64 on those lanes' inputs at the float32
    tolerance, with exact zeros at each lane's masked states where the
    plain version has them."""
    base = grid["base"]
    kb, sb = base.state_mask.shape
    kmax, smax = max(GRID[0]), max(GRID[1])
    lanes, tau = grid["chunk"], GRID_CONFIG.tau
    post, lane_cells, _, _ = grid_chunk(base, lanes, device)
    args = grid_kernel_args(base, post, lane_cells)
    des = grid_design(base, lanes, lanes)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = read_counts()
    got = pair_estep_cuda.pair_bwd_fwd_fused_cuda(*args, tau)
    torch.cuda.synchronize()
    after = read_counts()
    grew = torch.cuda.max_memory_allocated() - held
    ran = {k: after[k] - before[k] for k in ("B1", f"B1_{des}")}
    fails.check(ran == {"B1": 1, f"B1_{des}": 1},
                f"grid chunk launch: one B1 launch of {lanes} lanes in the "
                f"{des} design (launches {ran})")
    pairs = kb * lanes * kmax
    out_bytes = 4 * pairs * (1 + smax + smax * smax + smax * sb)
    scratch_bytes = 4 * pairs * (tau - 1) * sb * smax
    fails.check(des != "scratch" and grew <= out_bytes + scratch_bytes // 10,
                f"grid chunk launch: no scratch: the launch took {grew} B of "
                f"device memory (its outputs {out_bytes} B; the scratch "
                f"[tau-1, Sb*Sr, L*Kr, Kb] would be {scratch_bytes} B)")
    first = {}
    for i, (k, s_) in enumerate(lane_cells):
        first.setdefault("K=1, S>1" if k == 1 and s_ > 1 else
                         "S=1, K>1" if s_ == 1 and k > 1 else
                         "K=1, S=1" if k == s_ == 1 else
                         "(6, 5)" if (k, s_) == (6, 5) else "other", i)
    picks = sorted({0, lanes // 2, lanes - 1, *first.values()})
    worst = 0.0
    for lane in picks:
        lane_args = args[:4] + tuple(a[lane:lane + 1] for a in args[4:])
        want = _plain_pair(tuple(a.double() for a in lane_args), tau)
        got_l = type(got)(*[f[lane:lane + 1] for f in got])
        errs, _ = _errors(got_l, want)
        worst = max(worst, max(errs.values()))
        _gate(fails, "B1", f"grid chunk launch [{des}, L={lanes}] lane "
                           f"{lane} of cell {lane_cells[lane]}",
              torch.float32, errs)
        s_ = lane_cells[lane][1]
        if s_ < smax:
            zero = _masked_state_values(want, 0, s_) == 0
            fails.check(bool(torch.all(zero)) and bool(torch.all(
                _masked_state_values(got_l, 0, s_) == 0)),
                f"grid chunk launch lane {lane} of cell {lane_cells[lane]}: "
                f"exact zeros at the masked states {s_}..{smax - 1}, as the "
                f"plain version gives")
    return {"lanes": lanes, "checked": picks, "worst": worst,
            "device_bytes": grew, "output_bytes": out_bytes,
            "scratch_bytes_avoided": scratch_bytes}


# the hyp objective's B1 launch in phase 12 (PERF.md section 6): Kb=40
# subjects, 80 lanes at the padded (6, 5)
HYP_LAUNCH = (40, 80)


def _grid_launch_row(device, base, lanes, n, launches_per_run) -> dict:
    """B1's device time at a padded grid launch of ``lanes`` lanes of
    ``base`` (cycling over the grid's cells, each masked to its cell,
    baseem starts at (6, 5), tau=50, float32), its design, its bound at
    each lane's own S (the body writes the masked states' exact zeros and
    does no work there) and, ``padded_bound_ms``, at the padded Smax."""
    kb, sb = base.state_mask.shape
    kmax, smax, tau = max(GRID[0]), max(GRID[1]), GRID_CONFIG.tau
    post, lane_cells, _, _ = grid_chunk(base, lanes, device)
    args = grid_kernel_args(base, post, lane_cells)
    dev = device_ms(lambda: pair_estep_cuda.pair_bwd_fwd_fused_cuda(
        *args, tau), DEVICE_NAMES["B1"], n)
    pairs = kb * lanes * kmax
    des = pair_estep_cuda.design(sb, smax, tau, 4, pairs, sm_count())
    padded = b1_bound(kb, lanes * kmax, sb, smax, 2, tau, 4)
    row = {"kernel_device_ms": dev, "lanes": lanes, "kb": kb,
           "design": des._asdict(), "launches_per_run": launches_per_run,
           **b1_bound_live(kb, lane_cells, kmax, sb, smax, 2, tau, 4),
           "padded_bound_ms": padded["bound_ms"]}
    print(f"timing B1 [grid launch: Kb={kb} L={lanes} Kmax={kmax} Sb={sb} "
          f"Smax={smax} D=2 tau={tau} f32, lanes masked to their cells] "
          f"kernel device {dev:.4f} ms; {_bound_line(row)} at each lane's "
          f"own S, share {row['bound_ms'] / dev:.4f}; bound at the padded "
          f"Smax {padded['bound_ms']:.4f} ms, share "
          f"{padded['bound_ms'] / dev:.4f}; "
          f"{design_note(des, pairs, sb, smax, tau, 4)}", flush=True)
    return row


def timing_grid(device, grid, n=3) -> dict:
    """B1 at the grid's launch: one lane chunk of phase 8 (its lane count,
    the lanes cycling over the grid's cells, each masked to its cell,
    baseem starts at (Kmax, Smax) = (6, 5), Sb=2, tau=50, float32), its
    device time in the design the wrapper takes; the same launch with no
    masked state (every lane (6, 5)); the launch at the hyp
    objective's (HYP_LAUNCH: the bank's first 40 HMMs); one grid EM
    iteration (``vbhem._em_iteration`` with the lanes' masks) at the chunk;
    B3 in float64 at the rescoring's largest launch, cell (6, 5) unpadded,
    against its plain version."""
    base = grid["base"]
    kb, sb = base.state_mask.shape
    kmax, smax, tau = max(GRID[0]), max(GRID[1]), GRID_CONFIG.tau
    lanes = grid["chunk"]
    row = _grid_launch_row(device, base, lanes, n, grid["launches"]["B1"])
    dev_masked = row["kernel_device_ms"]
    post, lane_cells, hyps, gen = grid_chunk(base, lanes, device)
    open_args = kernel_args(base, post)
    dev_open = device_ms(lambda: pair_estep_cuda.pair_bwd_fwd_fused_cuda(
        *open_args, tau), DEVICE_NAMES["B1"], n)
    del open_args
    row["unmasked_device_ms"] = dev_open
    hyp_kb, hyp_lanes = HYP_LAUNCH
    row["hyp_launch"] = _grid_launch_row(
        device, tree_map(lambda a: a[:hyp_kb], base), hyp_lanes, 20, None)
    pairs = kb * lanes * kmax
    des = pair_estep_cuda.design(sb, smax, tau, 4, pairs, sm_count())
    cm, sm = cell_masks(lane_cells, kmax, smax, device)
    tilde_n = (GRID_CONFIG.nv * kb) * base.omega
    it_runs = interleaved({"kernel": lambda: vbhem._em_iteration(
        base, post, hyps, tilde_n, tau, "full", (cm, sm))}, n, device,
        warmup=1)
    row["iter_ms_runs"] = [v * 1e3 for v in it_runs["kernel"]]
    row["iter_ms"] = float(np.mean(row["iter_ms_runs"]))
    print(f"timing B1 [grid launch at the chunk, L={lanes}] masked "
          f"{dev_masked:.4f} ms; unmasked (every lane (6,5)) "
          f"{dev_open:.4f} ms; {grid['launches']['B1']} launches in phase "
          f"8; plain version not run (its per-step Theta at this launch "
          f"would take {4 * (tau - 1) * pairs * smax * sb * smax / 1e9:.1f} "
          f"GB)", flush=True)
    print(f"timing grid EM iteration [L={lanes} lanes]: {row['iter_ms']:.2f} "
          f"ms (runs {row['iter_ms_runs']})", flush=True)
    del post, cm, sm

    row["b3_f64"] = rescore_launch_row(device, base, gen,
                                       grid["launches"]["B3"])
    return row


def rescore_launch_row(device, base, gen, launches_per_run) -> dict:
    """B3 in float64 at the grid rescoring's largest launch, cell (6, 5)
    unpadded on ``base`` (Sb=2, tau=50), from baseem starts drawn from
    ``gen``: its device time, its wrapper's and the plain version's."""
    kb, sb = base.state_mask.shape
    kmax, smax, tau = max(GRID[0]), max(GRID[1]), GRID_CONFIG.tau
    hyps64 = vbhem.VBHEMHyps.from_config(GRID_CONFIG, 2, torch.float64,
                                         device)
    base64 = _to_f64(base)
    post64 = vbhem.init_baseem(gen, base64, kmax, smax, hyps64,
                               GRID_CONFIG.nv)
    exps = vbhem.reduced_expectations(post64)
    ell = plain.expected_pair_ll_variational(
        base64.hmm.mean, base64.hmm.cov, post64.niw.m, post64.niw.w,
        post64.niw.v, post64.niw.beta, exps.log_lam)
    args = (base64.hmm.prior, base64.hmm.trans, exps.log_pi, exps.log_a, ell)
    runs = interleaved({
        "kernel": lambda: pair_estep_cuda.pair_bwd_fwd_cuda(*args, tau),
        "plain": lambda: plain.pair_bwd_fwd(*args, tau)}, 10, device)
    dev64 = device_ms(lambda: pair_estep_cuda.pair_bwd_fwd_cuda(*args, tau),
                      DEVICE_NAMES["B3"], 10)
    des64 = pair_estep_cuda.design(sb, smax, tau, 8, kb * kmax, sm_count())
    b3row = {"kernel_device_ms": dev64, "design": des64._asdict(),
             "wrapper_ms": float(np.mean(runs["kernel"])) * 1e3,
             "plain_ms": float(np.mean(runs["plain"])) * 1e3,
             "launches_per_run": launches_per_run,
             **b3_bound(kb, kmax, sb, smax, tau, 8)}
    print(f"timing B3 f64 [rescoring launch: cell (6,5) unpadded, Kb={kb} "
          f"Sb={sb} tau={tau}] kernel device {dev64:.4f} ms; wrapper "
          f"{b3row['wrapper_ms']:.4f} ms; plain {b3row['plain_ms']:.4f} ms; "
          f"{_bound_line(b3row)}, share {b3row['bound_ms'] / dev64:.3f}; "
          f"{design_note(des64, kb * kmax, sb, smax, tau, 8)}; "
          f"{launches_per_run} launches in phase 8", flush=True)
    return b3row


def timing_wide(device, n=10) -> dict:
    """The wide bodies (vectors in device memory) at S=9 and K=9, float32:
    B1 and B3 at Kb=8192, L=1, Kr=2, Sb=Sr=9, tau=10; B2's entry 1 at 64
    lanes x 25 sequences, T=50, K=9; each beside its bound and the plain
    version's time."""
    out = {}
    kb, kr, s9, tau = 8192, 2, 9, 10
    rng = np.random.default_rng(9)
    base = random_bank(rng, kb, s9, 2, device, torch.float32)
    cfg = VBHEMConfig(m0=(0.0, 0.0), w0=1.0, nv=100, tau=tau)
    hyps = vbhem.VBHEMHyps.from_config(cfg, 2, torch.float32, device)
    post = random_posts(torch.Generator(device="cpu").manual_seed(2), base,
                        hyps, 1, kr, s9, cfg.nv)
    args = kernel_args(base, post)
    ell = plain.expected_pair_ll_variational(*args[2:4], *args[6:])
    b3_args = (*args[:2], *args[4:6], ell)
    for key, fn, plain_fn, bnd in (
            ("B1", lambda: pair_estep_cuda.pair_bwd_fwd_fused_cuda(*args,
                                                                   tau),
             lambda: _plain_pair(args, tau),
             b1_bound(kb, kr, s9, s9, 2, tau, 4)),
            ("B3", lambda: pair_estep_cuda.pair_bwd_fwd_cuda(*b3_args, tau),
             lambda: plain.pair_bwd_fwd(*b3_args, tau),
             b3_bound(kb, kr, s9, s9, tau, 4))):
        dev = device_ms(fn, DEVICE_NAMES[key].replace("_kernel",
                                                      "_wide_kernel"), n)
        runs = interleaved({"plain": plain_fn}, 3, device, warmup=1)
        row = {"kernel_device_ms": dev,
               "plain_ms": float(np.mean(runs["plain"])) * 1e3, **bnd}
        print(f"timing {key} wide body [Kb={kb} L=1 Kr={kr} Sb=Sr={s9} "
              f"tau={tau} f32] kernel device {dev:.4f} ms; plain "
              f"{row['plain_ms']:.4f} ms; {_bound_line(row)}, share "
              f"{row['bound_ms'] / dev:.4f}", flush=True)
        out[key] = row
    pz1, trans, log_rho, mask = fb_inputs(3, (64,), 25, 50, 9, device,
                                          torch.float32)
    dev = device_ms(lambda: fb_cuda.forward_backward_cuda(pz1, trans,
                                                          log_rho, mask),
                    "fb_wide_kernel", n)
    runs = interleaved({"plain": lambda: fb_plain.forward_backward(
        pz1, trans, log_rho, mask)}, 3, device, warmup=1)
    row = {"kernel_device_ms": dev,
           "plain_ms": float(np.mean(runs["plain"])) * 1e3,
           **b2_bound(pz1, trans, log_rho, mask)}
    print(f"timing B2 wide body [entry 1: 64 lanes x 25 sequences, T=50, "
          f"K=9, f32] kernel device {dev:.4f} ms; plain "
          f"{row['plain_ms']:.4f} ms; {_bound_line(row)}, share "
          f"{row['bound_ms'] / dev:.4f}", flush=True)
    out["B2"] = row
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phases 17-18: the sharded engine and the log-depth forward-backward
# ---------------------------------------------------------------------------

SPMD_CONFIG = VBHEMConfig(trials=8, learn_hyps=False, initmode="baseem",
                          nv=100, tau=10, m0=(13.0, 10.0), w0=1.0)
SPMD_KB, SPMD_KR, SPMD_SR = 8192, 3, 3     # the main-path cell
SPMD_GRID = ([1, 2, 3], [2, 3])
SPMD_SEED = 11
SPMD_DEADLINE_S = 300
SPMD_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_spmd"


def spmd_inputs(device, dtype):
    """The main-path cell: the planted bank, its hyps and 8 baseem starts
    of Kr=Sr=3 drawn from SPMD_SEED (the same on every rank)."""
    base, _ = planted_bank(SPMD_KB, device, dtype)
    hyps = vbhem.VBHEMHyps.from_config(SPMD_CONFIG, 2, dtype, device)
    post0 = vbhem.draw_lanes(
        "baseem", torch.Generator().manual_seed(SPMD_SEED), base, SPMD_KR,
        SPMD_SR, hyps, SPMD_CONFIG.nv, SPMD_CONFIG.trials)
    return base, hyps, post0


SPMD_EM = dict(nv=SPMD_CONFIG.nv, tau=SPMD_CONFIG.tau,
               max_iter=SPMD_CONFIG.max_iter, min_diff=SPMD_CONFIG.min_diff)


def _spmd_gloo_work(device) -> dict:
    """One of two gloo ranks sharing the card: ``replicate_to_mesh`` of a
    bank that differs by rank; the bank split in two (mesh (1, 2)) in
    float64 with each pair E-step's pairs recorded, then timed in float32;
    the trials split in two (mesh (2, 1)) for ``sharded_fit_trials`` and
    ``sharded_grid_sweep``."""
    import torch.distributed as dist
    from vbhem_tpu_torch.parallel import spmd
    out = {}
    base, hyps, post0 = spmd_inputs(device, torch.float64)
    mesh = spmd.make_mesh(1, 2)
    rank = dist.get_rank()
    mine = base._replace(omega=torch.full_like(base.omega, float(rank)),
                         state_mask=base.state_mask & (rank == 0))
    got = spmd.replicate_to_mesh(mesh, mine)
    out["replicated"] = (bool(torch.all(got.omega == 0))
                         and torch.equal(got.state_mask, base.state_mask))
    pairs = []
    e_step = vbhem.e_step

    def recording(shard, post, exps, tau):
        pairs.append((shard.num_hmms, post.alpha.numel()))
        return e_step(shard, post, exps, tau)

    reset_counts()
    with rebound(vbhem, "e_step", recording):
        st = spmd.sharded_vbhem_em(mesh, base, post0, hyps,
                                   **SPMD_EM)
        torch.cuda.synchronize()
    out["launches"] = read_counts()
    out["pairs"] = pairs
    out["em64"] = to_numpy(st)

    base32, hyps32, post32 = spmd_inputs(device, torch.float32)
    for _ in range(2):   # the second run is timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = spmd.sharded_vbhem_em(mesh, base32, post32, hyps32, **SPMD_EM)
        torch.cuda.synchronize()
    out["em32"] = (time.perf_counter() - t0, int(torch.max(st.it)))

    mesh = spmd.make_mesh(2, 1)
    out["fit"] = to_numpy(spmd.sharded_fit_trials(
        mesh, base, SPMD_KR, SPMD_SR, SPMD_CONFIG, hyps,
        torch.Generator().manual_seed(SPMD_SEED + 1)))
    out["grid"] = to_numpy(spmd.sharded_grid_sweep(
        mesh, base, *SPMD_GRID, SPMD_CONFIG, hyps,
        torch.Generator().manual_seed(SPMD_SEED + 2))[0])
    return out


def _bitwise(a, b) -> bool:
    same = []
    tree_map(lambda x, y: same.append(torch.equal(x, y)), a, b)
    return all(same)


def _spmd_nccl_work(device) -> dict:
    """A one-rank NCCL world: ``sharded_vbhem_em`` on mesh (1, 1), the EM
    loop with the world as its group (an NCCL all-reduce at every
    reduction) and ``sharded_fit_trials`` (an all-reduce checks the
    generators), each bit for bit its unsharded run."""
    import torch.distributed as dist
    from vbhem_tpu_torch.parallel import spmd
    base, hyps, post0 = spmd_inputs(device, torch.float64)
    ref = vbhem.vbhem_em(base, post0, hyps, **SPMD_EM)
    mesh = spmd.make_mesh(1, 1)
    st = spmd.sharded_vbhem_em(mesh, base, post0, hyps,
                               **SPMD_EM)
    world = vbhem.vbhem_em(base, post0, hyps, **SPMD_EM,
                           group=dist.group.WORLD, kb_total=SPMD_KB)
    fit = spmd.sharded_fit_trials(mesh, base, SPMD_KR, SPMD_SR, SPMD_CONFIG,
                                  hyps, torch.Generator().manual_seed(1))
    fit_ref = vbhem.fit_single_ks(torch.Generator().manual_seed(1), base,
                                  SPMD_KR, SPMD_SR, SPMD_CONFIG, hyps)
    return {"mesh (1, 1)": _bitwise(st, ref),
            "world group": _bitwise(world, ref),
            "fit_trials": _bitwise(fit, fit_ref),
            "backend": dist.get_backend()}


def _spmd_rank(rank, world, backend, store, results):
    """A rank of phase "spmd" on the card (every rank on cuda:0): join the
    world, run its work, send back (rank, outputs, error)."""
    try:
        import datetime
        import torch.distributed as dist
        torch.cuda.set_device(0)
        device = torch.device("cuda", 0)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=120))
        try:
            work = _spmd_gloo_work if backend == "gloo" else _spmd_nccl_work
            out = work(device)
        finally:
            dist.destroy_process_group()
        results.put((rank, out, None))
    except BaseException:
        results.put((rank, None, traceback.format_exc()))


def run_ranks(fails, world: int, backend: str):
    """Start ``world`` ranks of ``backend`` on the card (spawned
    processes meeting at a file store under the ignored ``build/``) and
    collect their outputs by SPMD_DEADLINE_S; a rank that fails or does
    not answer is a failed check and no rank outlives the call.  Returns
    {rank: outputs}, or None."""
    import multiprocessing
    import queue as queue_mod
    SPMD_DIR.mkdir(parents=True, exist_ok=True)
    store = Path(tempfile.mkdtemp(dir=SPMD_DIR)) / "store"
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_spmd_rank,
                         args=(r, world, backend, str(store), results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + SPMD_DEADLINE_S
    outs, errors = {}, []
    try:
        while len(outs) + len(errors) < world:
            try:
                rank, out, err = results.get(
                    timeout=max(0.1, end - time.monotonic()))
            except queue_mod.Empty:
                break
            if err:
                errors.append(f"rank {rank}: {err}")
            else:
                outs[rank] = out
        for p in procs:
            p.join(timeout=max(0.1, end - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    for e in errors:
        print(e, flush=True)
    missing = sorted(set(range(world)) - set(outs))
    fails.check(not missing,
                f"spmd: {world} {backend} rank(s) answered by the "
                f"{SPMD_DEADLINE_S} s deadline (missing or failed: "
                f"{missing})")
    return None if missing else outs


def _rel(a, b) -> float:
    """The largest relative gap; entries below 1e-30 (round-off zeros,
    such as an empty cluster's off-diagonal W) count absolutely."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _state_gaps(st, ref) -> dict:
    """Iterations equal, and the largest relative gaps of ll and of every
    posterior leaf."""
    post = []
    tree_map(lambda a, b: post.append(_rel(a, b)), st.post, to_numpy(ref.post))
    return {"it": bool(np.array_equal(st.it, ref.it.cpu().numpy())),
            "ll": _rel(st.ll, ref.ll.cpu().numpy()), "post": max(post)}


def phase_spmd(fails: Failures, device) -> dict:
    """The sharded engine (``vbhem_tpu_torch.parallel.spmd``) at the
    main-path cell, two gloo ranks sharing the card: on mesh (1, 2) each
    rank runs B1 on its Kb/2 = 4096 HMMs x 24 reduced clusters, and the
    float64 run must match the unsharded ``vbhem_em`` (same iterations, ll
    within 1e-9, posterior within 1e-7); both runs are timed in float32
    (two ranks on one card: not a speed-up, the cost of the collectives);
    on mesh (2, 1) ``sharded_fit_trials`` and ``sharded_grid_sweep`` (K=1..3
    x S=2..3, 8 trials) must equal ``fit_single_ks`` / ``fit_grid_batched``
    (same iterations, ll within 1e-10).  Then a one-rank NCCL world."""
    base, hyps, post0 = spmd_inputs(device, torch.float64)
    ref = vbhem.vbhem_em(base, post0, hyps, **SPMD_EM)
    fit_ref = vbhem.fit_single_ks(torch.Generator().manual_seed(SPMD_SEED + 1),
                                  base, SPMD_KR, SPMD_SR, SPMD_CONFIG, hyps)
    grid_ref = vbhem.fit_grid_batched(
        torch.Generator().manual_seed(SPMD_SEED + 2), base, *SPMD_GRID,
        SPMD_CONFIG, hyps)[0]
    base32, hyps32, post32 = spmd_inputs(device, torch.float32)
    vbhem.vbhem_em(base32, post32, hyps32, **SPMD_EM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st32 = vbhem.vbhem_em(base32, post32, hyps32,
                          **SPMD_EM)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3 / int(torch.max(st32.it))
    del base32, hyps32, post32, st32
    torch.cuda.empty_cache()

    outs = run_ranks(fails, 2, "gloo")
    launches = dict.fromkeys(read_counts(), 0)
    if outs is not None:
        for rank, out in sorted(outs.items()):
            cnt = out["launches"]
            for k, v in cnt.items():
                launches[k] = launches.get(k, 0) + v
            iters = int(np.max(out["em64"].it))
            want = (SPMD_KB // 2, SPMD_CONFIG.trials * SPMD_KR)
            fails.check(cnt["B1"] == len(out["pairs"]) == iters > 0
                        and set(out["pairs"]) == {want},
                        f"spmd rank {rank}: B1 launched {cnt['B1']} times "
                        f"for {iters} EM iterations, each on "
                        f"{sorted(set(out['pairs']))} (Kb shard, L*Kr) "
                        f"pairs (want {want})")
            check_on_chip(fails, f"spmd rank {rank}", cnt, "B1")
            fails.check(out["replicated"],
                        f"spmd rank {rank}: replicate_to_mesh (a gloo "
                        f"broadcast of CUDA tensors, floats and bools) gave "
                        f"rank 0's values")
            g = _state_gaps(out["em64"], ref)
            fails.check(g["it"] and g["ll"] <= 1e-9 and g["post"] <= 1e-7,
                        f"spmd rank {rank}: mesh (1, 2) float64 vs vbhem_em:"
                        f" iterations equal {g['it']}, ll {g['ll']:.3e} "
                        f"(<= 1e-9), posterior {g['post']:.3e} (<= 1e-7)")
            for what, st, want_st in (("sharded_fit_trials", out["fit"],
                                       fit_ref),
                                      ("sharded_grid_sweep", out["grid"],
                                       grid_ref)):
                g = _state_gaps(st, want_st)
                fails.check(g["it"] and g["ll"] <= TOL[torch.float64],
                            f"spmd rank {rank}: {what} on mesh (2, 1) vs "
                            f"the unsharded run: iterations equal "
                            f"{g['it']}, ll {g['ll']:.3e} (<= 1e-10), "
                            f"posterior {g['post']:.3e}")
            wall, it32 = out["em32"]
            print(f"spmd rank {rank} on {nvidia_smi_line()}: mesh (1, 2)"
                  f" float32 {it32} EM iterations, "
                  f"{wall * 1e3 / it32:.3f} ms an iteration "
                  f"(unsharded on the card alone: {one_ms:.3f} ms; two "
                  f"gloo ranks share one card, so this is the cost of the "
                  f"collectives, not a speed-up)", flush=True)
    nccl = run_ranks(fails, 1, "nccl")
    if nccl is not None:
        res = nccl[0]
        print(f"spmd nccl: {res}", flush=True)
        fails.check(res.pop("backend") == "nccl" and all(res.values()),
                    f"spmd: one-rank NCCL world bit for bit the unsharded "
                    f"runs: {res}")
    return {"launches": launches, "unsharded_ms": one_ms}


FB_ASSOC_CASES = [("k2", 256, 4096, 2), ("k4", 256, 4096, 4)]
FB_ASSOC_TOL = {"gamma": 1e-9, "xi_sum": 1e-8, "phi_norm": 1e-10}


def phase_fb_assoc(fails: Failures, device) -> dict:
    """``ops.fb.forward_backward_assoc`` (plain PyTorch, the log-depth scan
    over T; on no call path) on CUDA tensors against B2's entry 1 at long
    T, ragged, float64, at the CPU test's tolerances (gamma and xi_sum
    absolute 1e-9 and 1e-8, phi_norm relative 1e-10); then both timed in
    float32 by CUDA events."""
    launches, cases = {}, {}
    for name, n, t, k in FB_ASSOC_CASES:
        args = fb_inputs(17, (), n, t, k, device, torch.float64, ragged=True)
        reset_counts()
        got = fb_plain.forward_backward_assoc(*args)
        torch.cuda.synchronize()
        cnt = read_counts()
        for key, v in cnt.items():
            launches[key] = launches.get(key, 0) + v
        want = fb_cuda.forward_backward_cuda(*args)
        errs = {f: float(torch.max(torch.abs(getattr(got, f)
                                             - getattr(want, f))))
                for f in ("gamma", "xi_sum")}
        errs["phi_norm"] = float(torch.max(torch.abs(
            (got.phi_norm - want.phi_norm) / want.phi_norm)))
        fails.check(all(errs[f] <= FB_ASSOC_TOL[f] for f in errs),
                    f"fb assoc {name} (N={n}, T={t}, K={k}, ragged) float64"
                    f" vs B2 entry 1: {errs} (within {FB_ASSOC_TOL})")
        del got, want
        a32 = [a.float() if a.is_floating_point() else a for a in args]
        runs = interleaved({
            "assoc": lambda: fb_plain.forward_backward_assoc(*a32),
            "B2 entry 1": lambda: fb_cuda.forward_backward_cuda(*a32)},
            3, device)
        ms = {w: [round(x * 1e3, 4) for x in v] for w, v in runs.items()}
        b = b2_bound(*a32)
        print(f"fb assoc {name} float32 ms (assoc, entry 1, entry 1, "
              f"assoc by CUDA events) on {nvidia_smi_line()}: {ms}; entry "
              f"1's bound {b['bound_ms']:.4f} ms ({b['bound_by']})",
              flush=True)
        cases[name] = {"errors": errs, "ms": ms, "entry1_bound": b}
        del args, a32
        torch.cuda.empty_cache()
    fails.check(all(v == 0 for v in launches.values()),
                f"fb assoc: forward_backward_assoc launched no kernel "
                f"({launches})")
    return {"launches": launches, "cases": cases}


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

    results = {"ptxas": check_ptxas(fails, lib)}

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
    run("parity B3", lambda: phase_parity_b3(fails, device))
    run("VBHEM path", lambda: phase_vbhem_path(fails, device))
    run("VBEM path", lambda: phase_vbem_path(fails, device))
    vbem = results.get("VBEM path")
    if vbem is not None:
        run("pipeline", lambda: phase_pipeline(fails, device, vbem))
        run("VHEM path", lambda: phase_vhem_path(fails, device, vbem))
        if "pipeline" in results:
            run("DIC", lambda: phase_dic(fails, device, results["pipeline"],
                                         vbem["labels"]))
        else:
            fails.check(False, "DIC needs the pipeline's grid")
        run("grid", lambda: phase_grid(fails, device, vbem))
        if "grid" in results:
            run("parity grid chunk",
                lambda: parity_grid_chunk(fails, device, results["grid"]))
            run("padded vs unpadded",
                lambda: phase_padded(fails, device, results["grid"]))
        else:
            fails.check(False, "the grid chunk's parity and padded vs "
                               "unpadded need the grid's bank")
        run("protocol", lambda: phase_protocol(fails, device, vbem))
        run("initmodes", lambda: phase_initmodes(fails, device, vbem))
        run("hyp gradient", lambda: phase_hyp_gradient(fails, device, vbem))
        run("timing B2", lambda: timing_b2(device, vbem))
        run("timing B3", lambda: timing_b3(device, vbem))
        if "grid" in results:
            run("timing grid", lambda: timing_grid(device, results["grid"]))
        else:
            fails.check(False, "the grid timing needs the grid's chunk")
    else:
        fails.check(False, "the pipeline, VHEM, DIC, grid and protocol "
                           "phases and the B2, B3 and grid timings need the "
                           "VBEM path")
    run("timing B1", lambda: timing_b1(device))
    run("timing wide bodies", lambda: timing_wide(device))
    run("protocol hyps", lambda: phase_protocol_hyps(fails, device))
    run("runner", lambda: phase_runner(fails, device))
    run("grouped", lambda: phase_grouped(fails, device))
    run("demo", lambda: phase_demo(fails, device))
    run("spmd", lambda: phase_spmd(fails, device))
    run("fb assoc", lambda: phase_fb_assoc(fails, device))

    lines = []
    for key, parity, path, timing, field in (
            ("B1", "parity B1", "VBHEM path", "timing B1", "estep_ms"),
            ("B2", "parity B2", "VBEM path", "timing B2", "estep_ms"),
            ("B3", "parity B3", "VHEM path", "timing B3", "bf_ms")):
        t = results.get(timing, {})
        if key == "B1":   # the kernels line reads the main-path cell
            t = t.get(MAIN_CELL, {})
        wrapper_ms = t.get("kernel", {}).get(field)
        plain_ms = t.get("plain", {}).get(field)
        counts = results.get(path, {}).get("launches", {})
        launches = counts.get(key)
        if key == "B2" and launches is not None:   # both entries
            launches += counts["B2_fused"]
        lines.append(dict(
            KERNELS[key], launches=launches,
            max_abs_err=results.get(parity), ms=t.get("kernel_device_ms"),
            wrapper_ms=wrapper_ms, plain_ms=plain_ms,
            bound_ms=t.get("bound_ms"), bound_by=t.get("bound_by"),
            library_ms=None))
        if key in ("B1", "B3"):   # the main path's launches by design
            lines[-1]["designs"] = {kind: counts.get(f"{key}_{kind}")
                                    for kind in pair_estep_cuda.DESIGNS}
        # each path's own run: launches counted from 0 just before it
        lines[-1]["launches_by_path"] = {
            path: results[path]["launches"].get(key) + (
                results[path]["launches"]["B2_fused"] if key == "B2" else 0)
            for path in ("VBHEM path", "VBEM path", "pipeline", "VHEM path",
                         "grid", "protocol", "protocol hyps", "runner",
                         "initmodes", "grouped", "demo", "spmd",
                         "fb assoc")
            if path in results}
        for path in ("protocol hyps", "demo"):   # their VBEM stages
            if path in results:
                vb = results[path]["vbem_launches"]
                lines[-1]["launches_by_path"][f"{path} VBEM"] = (
                    vb.get(key) + (vb["B2_fused"] if key == "B2" else 0))
        grid_t = results.get("timing grid", {})
        wide_t = results.get("timing wide bodies", {}).get(key, {})
        if key == "B1" and grid_t:   # the grid's own launch
            keep = ("kernel_device_ms", "bound_ms", "bound_by",
                    "padded_bound_ms", "lanes", "kb", "launches_per_run")
            lines[-1]["grid_launch"] = {
                **{f: grid_t.get(f) for f in keep},
                "unmasked_device_ms": grid_t.get("unmasked_device_ms"),
                "design": grid_t["design"]["kind"],
                "hyp_launch": {
                    **{f: grid_t["hyp_launch"].get(f) for f in keep},
                    # the hyps-on protocol's B1 launches, most of them
                    # this launch's shape
                    "launches_per_run": results.get("protocol hyps", {})
                    .get("launches", {}).get("B1")}}
        if key == "B3" and grid_t:   # the float64 rescoring's launch
            lines[-1]["rescore_launch"] = {
                **{f: grid_t["b3_f64"].get(f) for f in (
                    "kernel_device_ms", "plain_ms", "bound_ms", "bound_by",
                    "launches_per_run")},
                "design": grid_t["b3_f64"]["design"]["kind"]}
        if wide_t:   # the wide body, S=9 or K=9
            lines[-1]["wide_body"] = {
                "source": WIDE_SOURCES[key],
                **{f: wide_t.get(f) for f in ("kernel_device_ms", "plain_ms",
                                              "bound_ms", "bound_by")}}
        if key == "B2" and "grouped" in results:   # per-sequence scores
            lines[-1]["grouped_launch"] = results["grouped"][
                "grouped_launch"]
        if key == "B2":   # the main path runs the fused entry; entry 1 too
            lines[-1].update(
                entry1_ms=t.get("entry1_device_ms"),
                entry1_bound_ms=t.get("entry1_bound", {}).get("bound_ms"),
                entry1_wrapper_ms=t.get("entry1", {}).get("estep_ms"))
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
