"""Run one benchmark cell of the PyTorch / CUDA port on the card:

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell's traffic file names its job kind
(``jobs/<kind>.py``).  Set-up builds the job and runs one warm job of the
cell's shapes (in a fresh checkout the program's kernels build then,
into the checkout's ``build/``).  The measured window is one closed-loop
client: jobs back to back until ``--seconds`` have passed, the job in
flight finishing; job ``j`` draws its inputs and restarts on the device
from ``--seed`` and ``j``.  With ``--trace 1`` one job runs under the
profiler instead and the per-layer metrics are read from it.  Then the
answers checked (one job drawn from the seed, and the last) are held
against the plain reference, and the last line of standard output is the
result's JSON object.  Exits 2 without enough CUDA devices, 3 where the
program cannot be imported and 4 where the process holds a forbidden
module after the window, printing no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# packages the process may not hold once the window has closed, compared
# by whole top-level name (the program's own name begins with the last)
FORBIDDEN = ("jax", "jaxlib", "flax", "vbhem_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and \
        out.stdout.strip() else f"nvidia-smi failed: {out.stderr.strip()}"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def say(*a):
    print(*a, file=sys.stderr, flush=True)


def window(job, seconds: float, check: set):
    """Jobs back to back until ``seconds`` have passed; returns (records,
    window seconds, attempted, failed, answers kept for the check: those
    of the indices in ``check`` and the last)."""
    records, kept, attempted, failed = [], {}, 0, 0
    last = None
    t0 = time.perf_counter()
    i = 0
    while True:
        attempted += 1
        try:
            answer, rec = job.run(i)
        except Exception:  # a failed job is counted and the window goes on
            failed += 1
            say(f"job {i} failed:\n{traceback.format_exc()}")
        else:
            say(f"job {i}: {rec['seconds']:.4f} s, EM iterations "
                f"{rec['work']['em_iters']}")
            records.append(rec)
            last = answer
            if i in check:
                kept[i] = answer
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    if last is not None:
        kept[last["index"]] = last
    return records, window_s, attempted, failed, [kept[k] for k in
                                                  sorted(kept)]


def measure(bench: dict, cell: dict, config: dict, traffic: dict,
            limits: dict, seed: int, seconds: float, trace: int,
            device) -> dict:
    """Set-up, the window (or the traced job) and the comparison of one
    run of ``cell`` on ``device``; returns the result's object.  The
    caller has checked the device and imported the program."""
    import torch
    from gpubench.lib import data, judge, registry
    from gpubench.lib import trace as tracemod

    kind = registry.job_module(traffic["job"])
    job = kind.Job(config, traffic, seed, device)
    t_warm = time.perf_counter()
    _, warm = job.run(-1)
    warm_s = time.perf_counter() - t_warm
    setup_s = time.perf_counter() - T_START
    say(f"set-up {setup_s:.3f} s (warm job {warm_s:.3f} s)")

    traced = tw = None
    if trace:
        try:
            (answer, traced), tw = tracemod.traced(lambda: job.run(0))
        except Exception:
            say(f"traced job failed:\n{traceback.format_exc()}")
            records, window_s, attempted, failed, answers = [], 0.0, 1, 1, []
        else:
            records, window_s, attempted, failed = [traced], tw.window_s, 1, 0
            answers = [answer]
    else:
        n_guess = max(1, int(seconds / max(warm_s, 1e-3)))
        sample = data.derive_seed(seed, 3) % n_guess
        records, window_s, attempted, failed, answers = window(
            job, seconds, {sample})
    memory_peak = max([warm["peak_bytes"]]
                      + [r["peak_bytes"] for r in records])

    ctx = SimpleNamespace(jobs=records, window_s=window_s, setup_s=setup_s,
                          trace=tw, traced=traced)
    metrics = {}
    wanted = registry.per_layer(bench, cell["name"]) if trace else \
        registry.end_to_end(bench, cell["name"])
    for m in wanted:
        value = registry.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        else:
            say(f"metric {m['name']}: nothing to read in this run")

    # the comparison with the reference, after the window and the peak,
    # with the allocator's cached blocks handed back
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = [kind.readings(job, a) for a in answers]
    worst = judge.worst(readings) if readings else {}
    correct = bool(readings) and failed == 0 and judge.verdict(worst,
                                                               limits)
    checks = {k: {"value": worst.get(k, float("nan")), "limit": v}
              for k, v in limits.items()}
    card = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else str(device)
    device_info = {"platform": "gpu", "kind": card, "count": cell["chips"],
                   "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if tw is not None:
        device_info.update(busy_s=tw.busy_s, window_s=tw.window_s)
        result["breakdown"] = tw.breakdown()
    result["checks"] = checks
    say(f"answers checked: {[a['index'] for a in answers]}")
    for k, c in checks.items():
        say(f"{k} {c['value']!r} limit {c['limit']!r}")
    return result


def main(argv=None) -> int:
    args = parse(argv)
    from gpubench.lib import registry
    bench = registry.load_benchmark()
    cell = registry.cell(bench, args.workload)
    config = registry.load_json(registry.config_file(bench, cell["config"]))
    traffic = registry.load_json(registry.traffic_file(cell["traffic"]))
    limits = registry.load_json(registry.limits_file(cell["name"]))
    # the program's kernel caches stay inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "gpubench" / sub)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        say(f"{cell['name']} needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import vbhem_tpu_torch  # noqa: F401
    except ImportError as e:
        say(f"the program vbhem_tpu_torch cannot be imported: {e}")
        return 3
    say(f"card: {card_line()}")
    result = measure(bench, cell, config, traffic, limits, args.seed,
                     args.seconds, args.trace, torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        say(f"the process holds forbidden modules after the window: {found}")
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
