"""The correctness readings of one cell over many seeds, in one process
on the card: for each seed the cell's job 0 of a run with that seed, its
numbers as the program produced them (the lower readings), and with
``--control`` the same numbers with the reference one step below the
stated precision put in the program's place (the upper readings).

    python3 gpubench/tools/readings.py --workload <cell> \\
        --seeds 1,2,3 [--control] [--fault <name>] \\
        --out chiprun_out/readings.json

``--fault`` plants one of the job kind's ``FAULTS`` under the program
first, for the readings of that fault at the cell's own size.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from gpubench.lib import registry
    bench = registry.load_benchmark()
    cell = registry.cell(bench, args.workload)
    config = registry.load_json(registry.config_file(bench, cell["config"]))
    traffic = registry.load_json(registry.traffic_file(cell["traffic"]))
    kind = registry.job_module(traffic["job"])
    if args.fault:
        import pytest
        kind.FAULTS[args.fault](pytest.MonkeyPatch())
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        job = kind.Job(config, traffic, seed, torch.device("cuda"))
        answer, rec = job.run(0)
        t1 = time.perf_counter()
        row = {"seed": seed, "job_s": rec["seconds"],
               "em_iters": rec["work"]["em_iters"],
               "program": kind.readings(job, answer)}
        row["check_s"] = time.perf_counter() - t1
        if args.control:
            row["control"] = kind.readings(job, answer,
                                           kind.control(job, answer))
        row["wall_s"] = time.perf_counter() - t0
        row["lane_iters"] = rec["work"].get("lane_iters")
        rows.append(row)
        print(json.dumps(row), flush=True)
        del job, answer
        torch.cuda.empty_cache()
    summary = {side: {k: max(r[side][k] for r in rows)
                      for k in rows[0][side]}
               for side in ("program",) + (("control",) if args.control
                                            else ())}
    if args.control:
        summary["control_min"] = {k: min(r["control"][k] for r in rows)
                                  for k in rows[0]["control"]}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary},
                                         indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
