"""Time the EM iterations and bounds of two checkouts of the port in one
process, in turns, on one NVIDIA card.

    python3 tools/ab_em_iteration.py OTHER [--rounds 10] [--n 40]
        [--out FILE]

OTHER is the root of another checkout (an earlier commit unpacked with
``git archive`` into the ignored ``build/``).  Its package is copied to
``build/ab/`` under another name and imported beside this checkout's, so
that both run in one process on one card and the host's drift between
processes does not enter the comparison.  In float32, at

  * the VBHEM bench cell (Kb=8192, one lane of Kr=8, Sb=Sr=3, D=2,
    tau=10) and the main-path cell (8 lanes of Kr=3),
  * the VBEM path's width (8192 synthetic subjects x 20 restarts, 25
    sequences of T=50, D=2, K=2),

it times by CUDA events over ``n`` calls the whole EM iteration as each
package's own loop runs it (``vbhem._em_iteration``,
``vbhmm._iteration``) and the bound as that iteration evaluates it
(``vbhem.elbo`` on the expectations its iteration gives it,
``vbhmm.elbo``), each package in turn (this, other, other, this, ...)
for ``rounds`` rounds.  Prints the card's ``nvidia-smi`` line, per stage
each package's median, min and max over the rounds and the rounds this
checkout won, and one JSON object; ``--out`` also writes it.
"""
from __future__ import annotations

import argparse
import importlib
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

OTHER_NAME = "vbhem_tpu_torch_other"
VBHEM_CELLS = [("bench", 8192, 1, 8, 3), ("main-path cell", 8192, 8, 3, 3)]


def packages(other: Path) -> dict:
    """{'this': package modules, 'other': ...}: the other checkout's
    package copied under OTHER_NAME into build/ab/ and imported."""
    dst = REPO / "build" / "ab"
    shutil.rmtree(dst / OTHER_NAME, ignore_errors=True)
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copytree(other / "vbhem_tpu_torch", dst / OTHER_NAME)
    sys.path.insert(0, str(dst))
    out = {}
    for key, name in (("this", "vbhem_tpu_torch"), ("other", OTHER_NAME)):
        mods = {m: importlib.import_module(f"{name}.{m}") for m in (
            "config", "containers", "models.vbhem", "models.vbhmm",
            "utils.planted")}
        out[key] = mods
    return out


def time_fn(fn, n) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def vbhem_stages(m, device, kb, lanes, kr, sr) -> dict:
    vb, pl = m["models.vbhem"], m["utils.planted"]
    tau, d = 10, 2
    base = pl.random_bank(np.random.default_rng(0), kb, 3, d, device,
                          torch.float32)
    cfg = m["config"].VBHEMConfig(m0=(0.0,) * d, w0=1.0, nv=100, tau=tau)
    hyps = vb.VBHEMHyps.from_config(cfg, d, torch.float32, device)
    gen = torch.Generator(device="cpu").manual_seed(1)
    post = vb.stack_lanes([vb.init_baseem(gen, base, kr, sr, hyps, cfg.nv)
                           for _ in range(lanes)])
    tilde_n = (cfg.nv * kb) * base.omega
    if hasattr(vb, "wide_expectations"):
        post_w, exps_w, exps = vb.wide_expectations(post)
    else:
        exps = vb.reduced_expectations(post)
        post_w, exps_w = post, exps
    pair = vb.e_step(base, post, exps, tau)
    soft = vb.soft_assignments(tilde_n, exps.log_omega, pair.ll_elbo)
    return {"elbo": lambda: vb.elbo(post_w, exps_w, pair, *soft, hyps),
            "em_iteration": lambda: vb._em_iteration(base, post, hyps,
                                                     tilde_n, tau)}


def vbem_stages(m, device, n_per_group=4096, trials=20) -> dict:
    vm, ct, pl = m["models.vbhmm"], m["containers"], m["utils.planted"]
    batches, _ = pl.synthetic_subjects(n_per_group, seed=1, device=device)
    bank = ct.SeqBatch(x=torch.stack([b.x for b in batches]),
                       lengths=torch.stack([b.lengths for b in batches]))
    cfg = m["config"].VBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=trials)
    hyps = vm.VBHyps.from_config(cfg, 2, torch.float32, device)
    gen = torch.Generator(device=device).manual_seed(0)
    post = vm.random_init(gen, bank, 2, hyps, lanes=(trials,))
    fb = vm.e_step(bank, post)
    stats = vm.suff_stats(bank, fb)
    return {"elbo": lambda: vm.elbo(bank, post, fb, stats, hyps),
            "em_iteration": lambda: vm._iteration(bank, post, hyps)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--n", type=int, default=40)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_em_iteration: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    pkgs = packages(args.other.resolve())
    stages = {}
    for key, m in pkgs.items():
        for name, kb, lanes, kr, sr in VBHEM_CELLS:
            for s, fn in vbhem_stages(m, device, kb, lanes, kr, sr).items():
                stages[(f"VBHEM {name}", s, key)] = (fn, args.n)
        for s, fn in vbem_stages(m, device).items():
            stages[("VBEM full width", s, key)] = (fn, max(args.n // 8, 3))
    times = {k: [] for k in stages}
    t0 = time.perf_counter()
    for r in range(args.rounds):
        order = ("this", "other") if r % 2 == 0 else ("other", "this")
        for key in order:
            for k, (fn, n) in stages.items():
                if k[2] == key:
                    times[k].append(time_fn(fn, n))
    out = {"nvidia_smi": cs.nvidia_smi_line(),
           "device": torch.cuda.get_device_name(0), "other": str(args.other),
           "rounds": args.rounds, "wall_s": time.perf_counter() - t0,
           "stages": {}}
    for where, s in sorted({k[:2] for k in stages}):
        this = np.asarray(times[(where, s, "this")])
        other = np.asarray(times[(where, s, "other")])
        row = {f"{key}_ms": {"median": float(np.median(t)),
                             "min": float(t.min()), "max": float(t.max()),
                             "all": t.tolist()}
               for key, t in (("this", this), ("other", other))}
        row["this_faster_rounds"] = int(np.sum(this < other))
        row["median_ratio_this_over_other"] = float(np.median(this)
                                                    / np.median(other))
        out["stages"][f"{where}: {s}"] = row
        print(f"{where}: {s}: this median {np.median(this):.4f} ms, other "
              f"{np.median(other):.4f} ms, ratio "
              f"{row['median_ratio_this_over_other']:.4f}, this faster in "
              f"{row['this_faster_rounds']}/{args.rounds} rounds",
              flush=True)
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
