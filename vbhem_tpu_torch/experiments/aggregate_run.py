"""Summarize a (possibly partial) synthetic benchmark run from its
checkpoint directory without recomputing anything, and emit a compact
JSON artifact: recovery statistics per method
(`evaluate_vbhem_jounarl.m:450-655` aggregation) plus per-stage
wall-clock statistics — the counterpart of the JAX package's
``examples/aggregate_run.py``.  The VBHEM stage's "elapsed" is the (K,S)
grid sweep only; its extra DIC pass is reported as "elapsed_with_dic".

Repeats checkpointed at different scales (r*_meta.json sidecars) are
segregated into per-config groups rather than pooled.

Usage:
  python -m vbhem_tpu_torch.experiments.aggregate_run syn10 --repeats 10 \\
      --out RESULTS_syn10.json
"""
import argparse
import json

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--out", default=None,
                    help="write the summary JSON here (default stdout)")
    ap.add_argument("--exclude", default=None,
                    help="comma list of repeat ids to exclude from the "
                         "summaries (reported separately under "
                         "'excluded'), e.g. known-tainted banks")
    args = ap.parse_args(argv)

    from vbhem_tpu_torch.experiments import runner

    exclude = ([int(v) for v in args.exclude.split(",")]
               if args.exclude else ())
    summary = runner.aggregate_from_checkpoints(args.outdir, args.repeats,
                                                exclude_repeats=exclude)

    # stage wall-clocks from the per-stage checkpoints ("elapsed" field)
    stages = {}
    for stage in ("vbem", "vbhem", "vhem", "ccfd", "ppk"):
        ts, ts_dic = [], []
        for r in range(args.repeats):
            st = runner.load_checkpoint(args.outdir, r, stage)
            if st is not None and "elapsed" in st:
                ts.append(float(st["elapsed"]))
                if "elapsed_with_dic" in st:
                    ts_dic.append(float(st["elapsed_with_dic"]))
        if ts:
            stages[stage] = {"mean_s": float(np.mean(ts)),
                             "min_s": float(np.min(ts)),
                             "max_s": float(np.max(ts)), "n": len(ts)}
            if ts_dic:
                stages[stage]["mean_s_with_dic"] = float(np.mean(ts_dic))
    done = [r for r in range(args.repeats)
            if runner.load_checkpoint(args.outdir, r, "vbhem") is not None]
    out = {"outdir": args.outdir, "repeats_with_vbhem": done,
           "methods": summary, "stage_wall_clock": stages}
    text = json.dumps(out, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return out


if __name__ == "__main__":
    main()
