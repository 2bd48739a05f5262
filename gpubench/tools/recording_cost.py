"""What the program's recorder costs on a cell's job, and the job's phase
split from its spans.

    python3 gpubench/tools/recording_cost.py --workload <cell> --seed <n> \\
        --pairs 5 --out cost.json

After set-up (the job kind's ``Job`` and one warm job), runs job 0 of
``--seed`` (the same inputs and restarts each time) with the program's
``profiling.recording()`` on and off, in turns, ``--pairs`` times each,
the side that goes first alternating; prints the median seconds of each
side, the phase split of each recorded job (``PhaseTimer`` over the
recorder) and the last one's counters, and the cost of one span on the
host with recording on and off.
"""
import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def span_cost_ns(n: int = 200_000) -> dict:
    """Nanoseconds of host time per ``with span(...)`` site, recording on
    and off (no profiler window)."""
    from vbhem_tpu_torch.utils import profiling
    out = {}
    for side in ("off", "on"):
        with profiling.recording() if side == "on" else \
                contextlib.nullcontext():
            with profiling.span("cost"):
                t0 = time.perf_counter_ns()
                for _ in range(n):
                    with profiling.span("cost.site"):
                        pass
                out[side] = (time.perf_counter_ns() - t0) / n
    profiling.RECORDER.clear()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=5)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch
    from gpubench.lib import registry
    from vbhem_tpu_torch.utils import profiling
    bench = registry.load_benchmark()
    cell = registry.cell(bench, args.workload)
    config = registry.load_json(registry.config_file(bench, cell["config"]))
    traffic = registry.load_json(registry.traffic_file(cell["traffic"]))
    kind = registry.job_module(traffic["job"])
    job = kind.Job(config, traffic, args.seed, torch.device("cuda", 0))
    job.run(-1)
    seconds = {"on": [], "off": []}
    phases = []
    for k in range(args.pairs):
        for side in (("on", "off") if k % 2 == 0 else ("off", "on")):
            if side == "on":
                with profiling.recording() as rec:
                    _, r = job.run(0)
                split = profiling.PhaseTimer(rec)
                phases.append(split.totals)
                counters = dict(rec.counters)
                spans = len(rec.spans)
            else:
                _, r = job.run(0)
            seconds[side].append(r["seconds"])
            print(f"pair {k} {side}: {r['seconds']:.4f} s", flush=True)
    result = {"workload": args.workload, "seed": args.seed,
              "seconds": seconds,
              "median_s": {s: statistics.median(v)
                           for s, v in seconds.items()},
              "phases": {n: [split.totals[n], split.counts[n]]
                         for n in split.totals},
              "phases_each_on_job": phases,
              "counters": counters, "spans_a_job": spans,
              "span_cost_ns": span_cost_ns()}
    print(split.summary())
    print(json.dumps({k: v for k, v in result.items()
                      if not k.startswith("phases")}))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
