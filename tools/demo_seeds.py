"""How often the face demo's path recovers the two viewer groups, over
data seeds: ``demo_fixations.demo_path`` on the 2 x 20 synthetic viewers
each seed draws, under either or both of its settings:

  * ``synthetic``: the path the demo CLI runs on synthetic data (and
    ``chip_smoke.py``'s phase "demo" gates): ``VBConfig(numtrials=10,
    learn_hyps=True)`` with mode 'd' hyps, then
    ``synthetic_vbhem_config`` (alpha0=1e6, Nv=50, tau=10, 'auto');
  * ``reference``: the reference demo's settings (`vbdemo_face.m`):
    ``reference_vb_config`` with mode 'c' hyps on the 512 x 384 face,
    then ``reference_vbhem_config`` (wtkmeans, Nv=10, tau=5, 50
    restarts, hyps on).

Both VBEM stages learn hyps on ``--hyp-cut`` survivors a subject with
that many L-BFGS steps (by default 5 and 25, the cut the seeds were
first counted at; phase "demo" now takes 10 steps; ``none`` for every
survivor and 50 steps).

    python3 tools/demo_seeds.py [--seeds 0,1,2,3,4,5] [--procs 3]
        [--settings synthetic,reference] [--save DIR]

Runs on one card; ``--procs`` worker processes share it, each taking
every procs-th seed.  Prints, per seed and settings, the VBEM stage's S
per viewer, the grid's selected K, K_hat (the clusters that survive
``vbh3m_remove_empty``), the Rand index against the groups and each K's
best score, then the count of seeds each settings recovered (K_hat=2,
Rand index 1.0).  Seed 0 is the data of ``chip_smoke.py``'s phase
"demo".  ``--save DIR`` writes each seed's base bank (the VBEM
stage's HMMs, float64) with the groups and the result as
``DIR/<settings>_seed<seed>.npz``; ``tools/demo_witness_jax.py`` runs the
JAX package's VBHEM on those banks.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PER_GROUP = 20
HYP_CUT = "5,25"    # the VBEM stages' hyps: survivors, L-BFGS steps


def save_bank(path: str, results, labels, cfg, run: dict, ri: float):
    """One seed's base bank and the port's result on it, as numpy."""
    import numpy as np
    from vbhem_tpu_torch.models import vbhem
    base = vbhem.h3m_from_results(results, device="cpu")

    def f64(t):
        return t.double().numpy()
    info = run["info"]
    np.savez(path, omega=f64(base.omega), prior=f64(base.hmm.prior),
             trans=f64(base.hmm.trans), mean=f64(base.hmm.mean),
             cov=f64(base.hmm.cov), state_mask=base.state_mask.numpy(),
             labels=labels, mu0=np.asarray(cfg.mu0, np.float64),
             w0=np.float64(cfg.w0), s_sel=np.asarray(run["s_sel"]),
             port_best_k=info["model_best_k"],
             port_k_hat=len(run["group_hmms"]), port_rand_index=ri,
             port_model_ll=np.asarray(info["model_ll"]),
             port_labels=run["res"].label.cpu().numpy())


def one_seed(seed: int, settings: list, hyp_cut: tuple, save) -> list:
    import numpy as np
    import torch
    from vbhem_tpu_torch.containers import SeqBatch
    from vbhem_tpu_torch.experiments import demo_fixations as demo
    from vbhem_tpu_torch.utils.metrics import rand_index
    dev = torch.device("cuda", 0)
    out = []
    for name in settings:
        gen = torch.Generator(device="cpu").manual_seed(seed)
        # drawn in float64 and moved to the card in float32, as phase
        # "demo" reads them back from its fixation CSV
        batches, labels = demo.synth_subjects(gen, PER_GROUP, device="cpu")
        batches = [SeqBatch(x=b.x.float().to(dev), lengths=b.lengths.to(dev))
                   for b in batches]
        cut = (dict(max_hyp_solutions=hyp_cut[0], hyp_max_steps=hyp_cut[1])
               if hyp_cut else {})
        run = demo.demo_path(gen, batches, table=name == "reference",
                             image_size=demo.FACE, **cut)
        info = run["info"]
        ri = rand_index(run["res"].label.cpu().numpy(), labels)[1]
        ok = len(run["group_hmms"]) == 2 and ri == 1.0
        print(f"seed {seed} {name}: VBEM S per viewer {run['s_sel']} "
              f"({run['wall_s']['vbem']:.1f}s); VBHEM grid "
              f"K={info['model_best_k']} S={info['model_best_s']} "
              f"K_hat={len(run['group_hmms'])} Rand index {ri:.6f} "
              f"recovered {ok}; per-K best "
              f"{np.max(info['model_ll'], axis=1).tolist()} "
              f"({run['wall_s']['vbhem']:.1f}s)", flush=True)
        if save:
            save_bank(os.path.join(save, f"{name}_seed{seed}.npz"),
                      run["results"], labels, run["vb_config"], run, ri)
        out.append((name, ok))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3,4,5")
    ap.add_argument("--procs", type=int, default=3)
    ap.add_argument("--settings", default="synthetic,reference")
    ap.add_argument("--hyp-cut", default=HYP_CUT,
                    help="the VBEM stages' hyps: survivors,steps or none")
    ap.add_argument("--save", default=None,
                    help="directory for each seed's bank (.npz)")
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    settings = args.settings.split(",")
    hyp_cut = (None if args.hyp_cut == "none"
               else tuple(int(v) for v in args.hyp_cut.split(",")))
    if args.worker:
        for seed in seeds:
            for name, ok in one_seed(seed, settings, hyp_cut, args.save):
                print(f"RESULT {seed} {name} {int(ok)}", flush=True)
        return 0
    from vbhem_tpu_torch.ops import _build
    _build.build()
    if args.save:
        os.makedirs(args.save, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"settings {settings}; VBEM hyps cut to survivors, L-BFGS "
          f"steps: {args.hyp_cut}", flush=True)
    passthrough = ["--settings", args.settings, "--hyp-cut", args.hyp_cut]
    if args.save:
        passthrough += ["--save", args.save]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", "--seeds",
         ",".join(str(s) for s in seeds[i::args.procs])] + passthrough,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(min(args.procs, len(seeds)))]
    counts, rc = {}, 0
    for p in procs:
        out, _ = p.communicate()
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, _, name, ok = line.split()
                counts.setdefault(name, []).append(int(ok))
            elif "[hyp]" not in line:
                print(line, flush=True)
        if p.returncode != 0:
            print(f"worker exit code {p.returncode}", flush=True)
            rc = 1
    for name, oks in counts.items():
        print(f"{name} settings: recovered on {sum(oks)} of {len(oks)} "
              f"seeds", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
