"""CLI for the synthetic ground-truth benchmark
(`Synthetic_experiment/exprmt1_demo.m` + `syn_evluate.m`): the
counterpart of the JAX package's ``examples/synthetic_experiment.py``.

Runs VBEM -> VBHEM (K,S grid) -> VHEM (AIC/BIC) -> CCFD -> PPK (AIC/BIC)
over seeded repeats with per-stage checkpoint/resume, then prints the
recovery summary (Rand index, purity, P(K=2), P(S=2) per method).

Example (a small run on the CPU):
  python -m vbhem_tpu_torch.experiments.synthetic_experiment --repeats 2 \\
      --subjects 6 --seqs 10 --kmax 3 --smax 3 --out /tmp/syn --device cpu

Several processes may share one ``--out`` with disjoint ``--repeat-ids``;
``python -m vbhem_tpu_torch.experiments.aggregate_run`` then summarizes
the directory.
"""
import argparse
import dataclasses
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="syn_out")
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--subjects", type=int, default=20,
                    help="HMMs per ground-truth cluster")
    ap.add_argument("--seqs", type=int, default=25)
    ap.add_argument("--t", type=int, default=50)
    ap.add_argument("--kmax", type=int, default=6)
    ap.add_argument("--smax", type=int, default=5)
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--hem-trials", type=int, default=20,
                    help="VHEM restarts per initmode (x3 under 'auto')")
    ap.add_argument("--repeat-ids", default=None,
                    help="comma list of repeat indices (subset of a "
                         "shared outdir for multi-process runs)")
    ap.add_argument("--methods", default="vbhem,vhem,ccfd,ppk")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    ap.add_argument("--dtype", default=None, choices=["f32", "f64"],
                    help="compute precision: by default f32 on the card "
                         "and f64 on the CPU")
    ap.add_argument("--hyp-steps", type=int, default=25,
                    help="L-BFGS step cap for the batched hyp optimizers")
    ap.add_argument("--max-hyp-solutions", default="5",
                    help="cap on uniqueLL survivors that get hyp-"
                         "optimized per grid cell ('none' = optimize "
                         "every survivor, the reference behavior — "
                         "`vbhem_h3m_c.m:96-160`)")
    args = ap.parse_args(argv)
    max_hyp = (None if str(args.max_hyp_solutions).lower() == "none"
               else int(args.max_hyp_solutions))

    from vbhem_tpu_torch.config import HEMConfig
    from vbhem_tpu_torch.experiments import runner, synthetic

    repeat_ids = ([int(v) for v in args.repeat_ids.split(",")]
                  if args.repeat_ids else None)
    summary = runner.run_experiment(
        args.out, n_repeats=args.repeats, repeat_ids=repeat_ids,
        n_per_cluster=args.subjects, n_seqs=args.seqs, t=args.t,
        k_grid=range(1, args.kmax + 1), s_grid=range(1, args.smax + 1),
        vb_config=dataclasses.replace(
            synthetic.default_vb_config(), hyp_max_steps=args.hyp_steps,
            max_hyp_solutions=max_hyp, verbose=2),
        vbhem_config=dataclasses.replace(
            synthetic.default_vbhem_config(trials=args.trials),
            hyp_max_steps=args.hyp_steps, max_hyp_solutions=max_hyp,
            verbose=2),
        # exprmt1_demo.m:115-118: hemopt.tau = T, Nv = 100, initmode auto
        hem_config=HEMConfig(trials=args.hem_trials, nv=100, tau=args.t),
        methods=tuple(args.methods.split(",")),
        dtype=args.dtype, device=args.device)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
