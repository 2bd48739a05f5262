"""The port's VBHEM on the face demo's saved banks
(``tools/demo_seeds.py --save``), on any device, beside
``tools/demo_witness_jax.py``'s runs of the JAX package on the same
banks: by default the restarts of the reference demo's settings without
hyps (100 restarts of wtkmeans and of baseem in cells (2, 2), (2, 3) and
(3, 3), ``vbhem.fit_single_ks``: how many recover the two groups, and
the best bound); with ``--grid`` the whole ``cluster_batched`` at the
reference settings (hyps on) and ``vbh3m_remove_empty``: the selected K,
K_hat, the Rand index and each K's best score.

    python3 tools/demo_restarts.py DIR/reference_seed3.npz [...]
        [--dtype float64] [--device cpu] [--seed 7] [--grid]
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vbhem_tpu_torch.config import VBHEMConfig  # noqa: E402
from vbhem_tpu_torch.experiments import demo_fixations as demo  # noqa: E402
from vbhem_tpu_torch.containers import H3M, HMM  # noqa: E402
from vbhem_tpu_torch.models import vbhem  # noqa: E402
from vbhem_tpu_torch.utils.metrics import rand_index  # noqa: E402

CELLS = ((2, 2), (2, 3), (3, 3))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("banks", nargs="+")
    ap.add_argument("--dtype", default="float64",
                    choices=("float32", "float64"))
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--grid", action="store_true")
    args = ap.parse_args()
    dt = getattr(torch, args.dtype)
    for path in args.banks:
        z = np.load(path)

        def t(a):
            return torch.as_tensor(a, dtype=dt, device=args.device)
        base = H3M(omega=t(z["omega"]),
                   hmm=HMM(*(t(z[k]) for k in ("prior", "trans", "mean",
                                               "cov"))),
                   state_mask=torch.as_tensor(z["state_mask"],
                                              device=args.device))
        if args.grid:
            t0 = time.perf_counter()
            res, info = vbhem.cluster_batched(
                torch.Generator().manual_seed(args.seed), base,
                *demo.REFERENCE_GRID, demo.reference_vbhem_config(
                    m0=tuple(float(v) for v in z["mu0"])))
            res, hmms = vbhem.vbh3m_remove_empty(res)
            ri = rand_index(res.label.cpu().numpy(), z["labels"])[1]
            print(f"{os.path.basename(path)} {args.dtype} port grid "
                  f"K={info['model_best_k']} S={info['model_best_s']} "
                  f"K_hat={len(hmms)} Rand index {ri:.6f}; per-K best "
                  f"{np.max(info['model_ll'], axis=1).round(3).tolist()} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
            continue
        for mode in ("wtkmeans", "baseem"):
            cfg = VBHEMConfig(alpha0=1.0, eta0=1.0, epsilon0=1.0,
                              lambda0=1.0, v0=10.0, w0=0.001,
                              m0=tuple(float(v) for v in z["mu0"]),
                              trials=100, nv=10, tau=5, initmode=mode,
                              learn_hyps=False)
            for k, s in CELLS:
                st = vbhem.fit_single_ks(
                    torch.Generator().manual_seed(args.seed), base, k, s,
                    cfg)
                lab = torch.argmax(st.hat_z, -1).cpu().numpy()
                ok = sum(rand_index(lb, z["labels"])[1] == 1.0
                         for lb in lab)
                print(f"{os.path.basename(path)} {args.dtype} port {mode} "
                      f"({k}, {s}): {ok} of 100 restarts recover the "
                      f"groups; best bound {float(st.ll.max()):.2f}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
