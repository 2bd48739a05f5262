"""Run the hyps-on VBHEM stage of chip_smoke's phase "protocol hyps" in
float32 and in float64 on one NVIDIA card, from the same VBEM bank and
the same restarts, and print each run's EM iterations.

    python3 tools/hyp_stage_dtype.py [--steps 50] [--out FILE]

The bank is chip_smoke's: 20 subjects per planted group drawn with
PROTOCOL_HYPS_SEED, learned by ``synthetic.learn_subject_hmms`` at
``default_vb_config()`` with hyps on (float32).  Each run is
``synthetic.run_vbhem`` at ``default_vbhem_config()`` (K=1..6 x S=1..5,
50 restarts, tau=50, Nv=100, hyps on) with ``--steps`` L-BFGS steps a
stage (50 is the reference's; chip_smoke cuts to 25), on the bank as
learned and on the bank cast to float64 (``--dtypes`` picks them).
Whether the hyp stage's EM runs converge as slowly in float64 as in
float32 tells a float32 fault from slow convergence of the method itself.

For each run it records the hyp stage alone (``optimize_hyps_grid_batched``:
its wall time and its kernel B1 launches, one an EM iteration) and, for
every cell, the bound the run converged to: ``model_ll`` (rescored in
float64 on a float32 run) and ``model_ll_device``, and their relative gap.
Placed in an earlier checkout whose chip_smoke.py has the same helpers, it
runs that checkout's kernels, so two checkouts' runs on one card compare
their iterations, their stage times and their bounds.  Prints one line
per run and one JSON object; ``--out`` also writes it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from vbhem_tpu_torch.experiments import synthetic  # noqa: E402
from vbhem_tpu_torch.models import vbhem  # noqa: E402
from vbhem_tpu_torch.utils.planted import synthetic_subjects  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--dtypes", default="float32,float64",
                    help="the runs, comma-separated")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hyp_stage_dtype: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    batches, labels = synthetic_subjects(20, seed=cs.PROTOCOL_HYPS_SEED,
                                         device=device)
    vcfg = dataclasses.replace(synthetic.default_vb_config(),
                               hyp_max_steps=args.steps)
    t0 = time.perf_counter()
    results = synthetic.learn_subject_hmms(
        torch.Generator(device=device).manual_seed(cs.PROTOCOL_HYPS_SEED),
        batches, 2, vcfg, info={})
    torch.cuda.synchronize()
    print(f"VBEM stage: {len(results)} subjects, {args.steps} L-BFGS steps, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    hcfg = dataclasses.replace(synthetic.default_vbhem_config(),
                               hyp_max_steps=args.steps)
    out = {"steps": args.steps, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi_line(),
           # equal on two checkouts whose VBEM stages agree
           "bank_checksum": float(sum(r.post.niw.m.double().sum()
                                      for r in results)),
           "runs": {}}
    stage = {}
    optimize = vbhem.optimize_hyps_grid_batched

    def timed_stage(*a, **k):   # the hyp stage alone
        torch.cuda.synchronize()
        b1, t = cs.read_counts()["B1"], time.perf_counter()
        res = optimize(*a, **k)
        torch.cuda.synchronize()
        stage.update(s=time.perf_counter() - t,
                     b1=cs.read_counts()["B1"] - b1)
        return res

    vbhem.optimize_hyps_grid_batched = timed_stage
    banks = {"float32": lambda: results,
             "float64": lambda: [cs._to_f64(r) for r in results]}
    for name in args.dtypes.split(","):
        bank = banks[name]()
        cs.reset_counts()
        t0 = time.perf_counter()
        _, info, score = synthetic.run_vbhem(
            torch.Generator(device="cpu").manual_seed(cs.PROTOCOL_HYPS_SEED),
            bank, labels, *cs.GRID, hcfg)
        torch.cuda.synchronize()
        st = info["hyp"]
        ll, ll_dev = info["model_ll"], info["model_ll_device"]
        cells = {f"{k},{s_}": {
            "model_ll": float(ll[ki, si]),
            "model_ll_device": float(ll_dev[ki, si]),
            "gap": float((ll_dev[ki, si] - ll[ki, si]) / abs(ll[ki, si]))}
            for ki, k in enumerate(info["model_k"])
            for si, s_ in enumerate(info["model_s"])}
        row = {"wall_s": time.perf_counter() - t0,
               "hyp_stage_s": stage["s"], "hyp_stage_b1": stage["b1"],
               "restart_chunk_iters": info["grid_chunk_iters"],
               "hyp_em_iters": st["hyp_em_iters"],
               "hyp_e_steps": st["hyp_e_steps"], "hyp_calls": st["hyp_calls"],
               "hyp_lanes": st["hyp_lanes"],
               "hyp_lane_evals": st["hyp_lane_evals"],
               "hyp_reverted": st["hyp_reverted"],
               "selection": [score.best_k, list(score.s_list)],
               "rand_index": score.rand_index,
               "b1_launches": cs.read_counts()["B1"], "cells": cells}
        out["runs"][name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
