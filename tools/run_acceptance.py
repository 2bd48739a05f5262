"""The synthetic experiment's acceptance on one card: 10 repeats at the
reference settings with hyperparameter learning on (``--trials 100
--hyp-steps 50 --dtype f32``: ``default_vb_config()`` and
``default_vbhem_config()`` with 100 restarts), split over processes of
``vbhem_tpu_torch.experiments.synthetic_experiment`` that share one
outdir (the stages are host-bound, so several processes share the card),
then ``aggregate_run`` and ``tools/acceptance_table.py`` on the outdir.

    python3 tools/run_acceptance.py [--out syn_out_accept]
        [--processes 5] [--deadline 3300] [--resume-from DIR]

Workers still running at ``--deadline`` seconds are stopped; their
completed stages stay checkpointed, and a later run given the outdir's
files through ``--resume-from`` continues from them.
"""
import argparse
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="syn_out_accept")
    ap.add_argument("--processes", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--deadline", type=float, default=3300.0)
    ap.add_argument("--resume-from", default=None,
                    help="copy this directory's checkpoints into --out first")
    args = ap.parse_args()
    os.chdir(ROOT)
    t_start = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print("nvidia-smi:", smi, flush=True)
    os.makedirs(args.out, exist_ok=True)
    if args.resume_from:
        for f in os.listdir(args.resume_from):
            if f.endswith((".pkl", ".json")):
                shutil.copy(os.path.join(args.resume_from, f), args.out)
    sys.path.insert(0, ROOT)
    from vbhem_tpu_torch.ops import _build
    t = time.time()
    _build.build()     # once, before the workers start
    print(f"build {time.time() - t:.1f}s", flush=True)
    repeats = list(range(args.repeats))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for i in range(args.processes):
        ids = repeats[i::args.processes]
        if not ids:
            continue
        log = open(os.path.join(args.out, f"log_w{i}.txt"), "a")
        cmd = [sys.executable, "-m",
               "vbhem_tpu_torch.experiments.synthetic_experiment",
               "--out", args.out, "--repeats", str(args.repeats),
               "--repeat-ids", ",".join(map(str, ids)), "--trials", "100",
               "--hyp-steps", "50", "--dtype", "f32", "--device", "cuda"]
        print("start", " ".join(cmd), flush=True)
        procs.append((subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT, env=env),
                      log, ids))
    try:
        while any(p.poll() is None for p, _, _ in procs):
            if time.time() - t_start > args.deadline:
                print("deadline: stopping the workers", flush=True)
                break
            time.sleep(10)
    finally:
        for p, _, _ in procs:
            if p.poll() is None:
                p.terminate()
        for p, log, ids in procs:
            try:
                p.wait(60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            log.close()
            print("worker", ids, "rc", p.returncode, flush=True)
    print(f"workers done at {time.time() - t_start:.1f}s", flush=True)
    for script in (["-m", "vbhem_tpu_torch.experiments.aggregate_run",
                    args.out, "--repeats", str(args.repeats), "--out",
                    os.path.join(args.out, "aggregate.json")],
                   [os.path.join("tools", "acceptance_table.py"), args.out,
                    "--repeats", str(args.repeats)]):
        out = subprocess.run([sys.executable, *script], capture_output=True,
                             text=True)
        print(out.stdout[-8000:], out.stderr[-2000:], flush=True)
    print("nvidia-smi:", smi, flush=True)
    print(f"total {time.time() - t_start:.1f}s", flush=True)


if __name__ == "__main__":
    main()
