"""Sets of runs of one cell, each run a process of ``gpubench/run.py``,
and the spread of every metric in each set: the distance between the
first and third quartiles (``statistics.quantiles(values, n=4)``) as a
share of the median.

    python3 gpubench/tools/sets.py --workload <cell> --seeds 11,12,13 \\
        --sets 2 --seconds 40 [--trace 0] --out chiprun_out/sets.json

Every set runs the same seeds, in order.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = []
    for k in range(args.sets):
        for seed in seeds:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, str(ROOT / "gpubench" / "run.py"),
                 "--workload", args.workload, "--seed", str(seed),
                 "--seconds", str(args.seconds), "--trace", str(args.trace)],
                cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            lines = proc.stdout.strip().splitlines()
            result = json.loads(lines[-1]) if proc.returncode == 0 and lines \
                else None
            runs.append({"set": k, "seed": seed, "rc": proc.returncode,
                         "wall_s": wall, "result": result,
                         "stderr_tail": proc.stderr[-3000:]})
            print(json.dumps({"set": k, "seed": seed, "rc": proc.returncode,
                              "wall_s": round(wall, 1),
                              "correct": result and result["correct"],
                              "metrics": result and {
                                  m: v["value"] for m, v in
                                  result["metrics"].items()}}), flush=True)
    summary = {}
    for k in range(args.sets):
        ok = [r["result"] for r in runs if r["set"] == k and r["result"]]
        names = sorted({m for r in ok for m in r["metrics"]})
        summary[k] = {}
        for m in names:
            vals = [r["metrics"][m]["value"] for r in ok if m in r["metrics"]]
            if len(vals) >= 2:
                summary[k][m] = {"median": statistics.median(vals),
                                 "spread": spread(vals), "n": len(vals)}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"runs": runs, "summary": summary},
                                         indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
