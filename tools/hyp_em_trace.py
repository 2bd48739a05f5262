"""Where the hyps-on VBHEM stage spends its EM iterations, in float32 and
in float64, on one NVIDIA card.

    python3 tools/hyp_em_trace.py [--steps 50] [--replay 12] [--out FILE]

Learns chip_smoke's hyps-on protocol bank (as tools/hyp_stage_dtype.py
does: 20 subjects per planted group, PROTOCOL_HYPS_SEED, float32), then
runs ``synthetic.run_vbhem`` at ``default_vbhem_config()`` with ``--steps``
L-BFGS steps on the bank in float32 and on the bank cast to float64.
Every ``vbhem_em`` call of the hyp stage (the objective's EM runs and the
final rerun) is recorded: each lane's EM iterations and its inputs.  For
each run it prints the distribution of the lanes' iterations (how many
lanes reach ``max_iter``, how many end on a non-finite bound: a lane
whose bound is -inf never meets the stopping test and runs to
``max_iter``) and the calls' slowest lanes (what the stage pays: a chunk
waits for its slowest lane).

Then it replays the float32 run's ``--replay`` slowest lanes (one lane
each, the lane's start, hyps and masks) for ``max_iter`` EM iterations in
float32, in float64 (bank, start and hyps cast), and evaluates the
float64 bound of each float32 iterate.  For each it prints where the
stopping test ``|(ll - last) / last| <= min_diff`` first fires in each, and
the trace's non-finite bounds and the largest and median relative
change between finite bounds over the trace's last half: a
float32 lane whose float64-rescored iterates converge while its own
bound does not is held by float32 rounding in the bound; one whose
iterates do not converge either is held by its float32 posterior.

Prints the card's ``nvidia-smi`` name and power limit, a line per run and
per replayed lane, and one JSON object; ``--out`` also writes it.
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

import chip_smoke as cs  # noqa: E402
from vbhem_tpu_torch.containers import tree_map  # noqa: E402
from vbhem_tpu_torch.experiments import synthetic  # noqa: E402
from vbhem_tpu_torch.models import vbhem  # noqa: E402
from vbhem_tpu_torch.utils.planted import synthetic_subjects  # noqa: E402


def lane(tree, i):
    return tree_map(lambda a: a[i:i + 1] if a.dim() else a, tree)


def first_stop(lls: np.ndarray, min_diff: float) -> int:
    """The iteration count at which vbhem_em's stopping test first fires
    on the trace ``lls`` (ll before each M-step), or len + 1 if never."""
    with np.errstate(invalid="ignore"):
        rel = np.abs((lls[1:] - lls[:-1]) / lls[:-1])
    hit = np.flatnonzero(rel <= min_diff)
    return int(hit[0]) + 2 if len(hit) else len(lls) + 1


def trace(base, post, hyps, masks, cfg, rescore_base=None):
    """``cfg.max_iter`` EM iterations of one lane: its ll trace, and with
    ``rescore_base`` (a float64 bank) the float64 bound of each
    iterate."""
    tilde_n = (cfg.nv * base.num_hmms) * base.omega
    lls, lls64 = [], []
    h64 = cs._to_f64(hyps)
    for _ in range(cfg.max_iter):
        if rescore_base is not None:
            t64 = (cfg.nv * rescore_base.num_hmms) * rescore_base.omega
            lls64.append(float(vbhem._em_iteration(
                rescore_base, cs._to_f64(post), h64, t64, cfg.tau,
                masks=masks)[1]))
        post, ll = vbhem._em_iteration(base, post, hyps, tilde_n, cfg.tau,
                                       masks=masks)[:2]
        lls.append(float(ll))
    return np.asarray(lls), np.asarray(lls64)


def changes(lls: np.ndarray) -> dict:
    """The trace's non-finite bounds and, over its last half, the largest
    and median relative change between finite bounds (None if none)."""
    with np.errstate(invalid="ignore"):
        rel = np.abs((lls[1:] - lls[:-1]) / lls[:-1])
    tail = rel[len(rel) // 2:]
    tail = tail[np.isfinite(tail)]
    return {"nonfinite_iters": int(np.sum(~np.isfinite(lls))),
            "first_ll": float(lls[0]), "last_ll": float(lls[-1]),
            "max_rel_change_last_half":
                float(tail.max()) if tail.size else None,
            "median_rel_change_last_half":
                float(np.median(tail)) if tail.size else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--replay", type=int, default=12)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hyp_em_trace: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    batches, labels = synthetic_subjects(20, seed=cs.PROTOCOL_HYPS_SEED,
                                         device=device)
    vcfg = dataclasses.replace(synthetic.default_vb_config(),
                               hyp_max_steps=args.steps)
    results = synthetic.learn_subject_hmms(
        torch.Generator(device=device).manual_seed(cs.PROTOCOL_HYPS_SEED),
        batches, 2, vcfg, info={})
    hcfg = dataclasses.replace(synthetic.default_vbhem_config(),
                               hyp_max_steps=args.steps)
    out = {"steps": args.steps, "nvidia_smi": cs.nvidia_smi_line(),
           "device": torch.cuda.get_device_name(0), "runs": {}}
    orig_em, orig_stage = vbhem.vbhem_em, vbhem.optimize_hyps_grid_batched
    calls, in_stage = [], [False]

    def traced_em(base, init_post, hyps, *a, **k):
        st = orig_em(base, init_post, hyps, *a, **k)
        if in_stage[0]:
            calls.append({"it": st.it.cpu().numpy(),
                          "finite": torch.isfinite(st.ll).cpu().numpy(),
                          "post": init_post,
                          "hyps": hyps, "base": base,
                          "masks": (k.get("cmask"), k.get("smask"))})
        return st

    def traced_stage(*a, **k):
        in_stage[0] = True
        try:
            return orig_stage(*a, **k)
        finally:
            in_stage[0] = False

    vbhem.vbhem_em, vbhem.optimize_hyps_grid_batched = traced_em, \
        traced_stage
    banks = {"float32": results, "float64": [cs._to_f64(r)
                                             for r in results]}
    recorded = {}
    for name, bank in banks.items():
        calls.clear()
        t0 = time.perf_counter()
        _, info, score = synthetic.run_vbhem(
            torch.Generator(device="cpu").manual_seed(cs.PROTOCOL_HYPS_SEED),
            bank, labels, *cs.GRID, hcfg)
        torch.cuda.synchronize()
        its = np.concatenate([c["it"] for c in calls])
        finite = np.concatenate([c["finite"] for c in calls])
        slowest = np.asarray([int(c["it"].max()) for c in calls])
        row = {"wall_s": time.perf_counter() - t0, "em_calls": len(calls),
               "lane_runs": int(its.size),
               "stage_em_iters": int(slowest.sum()),
               "hyp_em_iters": info["hyp"]["hyp_em_iters"],
               "lanes_at_max_iter": int(np.sum(its >= hcfg.max_iter)),
               "lanes_with_nonfinite_bound": int(np.sum(~finite)),
               "lanes_at_max_iter_with_nonfinite_bound": int(np.sum(
                   (its >= hcfg.max_iter) & ~finite)),
               "calls_whose_slowest_lane_hit_max_iter":
                   int(np.sum(slowest >= hcfg.max_iter)),
               "lane_iters_quantiles": np.quantile(
                   its, [0.5, 0.9, 0.99, 1.0]).tolist(),
               "mean_lane_iters": float(its.mean()),
               "mean_slowest_lane_iters": float(slowest.mean()),
               "selection": [score.best_k, list(score.s_list)],
               "rand_index": score.rand_index}
        out["runs"][name] = row
        recorded[name] = list(calls)
        print(f"{name}: {json.dumps(row)}", flush=True)
    vbhem.vbhem_em, vbhem.optimize_hyps_grid_batched = orig_em, orig_stage

    # replay the float32 run's slowest lanes
    runs = [(int(c["it"][i]), ci, i) for ci, c in enumerate(
        recorded["float32"]) for i in range(len(c["it"]))]
    runs.sort(reverse=True)
    base64 = None
    out["replays"] = []
    for it, ci, i in runs[:args.replay]:
        c = recorded["float32"][ci]
        base = c["base"]
        if base64 is None:
            base64 = cs._to_f64(base)
        masks = tuple(None if m is None else m[i:i + 1] for m in c["masks"])
        post, hyps = lane(c["post"], i), lane(c["hyps"], i)
        l32, l32_64 = trace(base, post, hyps, masks, hcfg, base64)
        l64, _ = trace(base64, cs._to_f64(post), cs._to_f64(hyps), masks,
                       hcfg)
        rep = {"call": ci, "lane": i, "recorded_iters": it,
               "hyps": {f: float(getattr(hyps, f).reshape(-1)[0])
                        for f in ("alpha0", "eta0", "epsilon0", "lambda0",
                                  "v0")},
               "stop_f32": first_stop(l32, hcfg.min_diff),
               "stop_f32_iterates_rescored_f64":
                   first_stop(l32_64, hcfg.min_diff),
               "stop_f64": first_stop(l64, hcfg.min_diff),
               "f32": changes(l32), "f32_iterates_f64": changes(l32_64),
               "f64": changes(l64),
               "final_rel_gap_f32_vs_f64":
                   float((l32[-1] - l64[-1]) / abs(l64[-1]))
                   if np.isfinite(l32[-1]) and np.isfinite(l64[-1])
                   else None}
        out["replays"].append(rep)
        print(f"replay: {json.dumps(rep)}", flush=True)
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
