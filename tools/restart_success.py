"""Count how many VBHEM baseem restarts recover the planted groups on the
bank that chip_smoke.py's VBEM path learns, on one NVIDIA card.

    python3 tools/restart_success.py

Learns one 2-state HMM per subject for 8192 synthetic subjects
(``batch.learn_bank``, 20 restarts, as chip_smoke.py phase 4), converts
the bank with ``h3m_from_results`` and runs the (K=2, S=2) cell of
``cluster`` (``fit_single_ks``) at the settings of the JAX package's
tests/test_vbhem.py:49-56 with chip_smoke.PIPELINE_TRIALS restarts, for
each of SEEDS seeds.  For each seed it prints how many restarts reach
Rand index 1.0 against the planted groups, and whether the restart of
best ELBO is one of them.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import PIPELINE_TRIALS  # noqa: E402
from vbhem_tpu_torch import VBConfig, VBHEMConfig  # noqa: E402
from vbhem_tpu_torch.models import batch, vbhem  # noqa: E402
from vbhem_tpu_torch.utils.planted import (rand_index,  # noqa: E402
                                           synthetic_subjects)

SEEDS = 4


def main() -> int:
    if not torch.cuda.is_available():
        print("restart_success: no CUDA device is available",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    device = torch.device("cuda", 0)
    batches, labels = synthetic_subjects(4096, seed=1, device=device)
    results, _ = batch.learn_bank(
        torch.Generator(device=device).manual_seed(0), batches, 2,
        VBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=20, learn_hyps=False))
    base = vbhem.h3m_from_results(results)
    cfg = VBHEMConfig(alpha0=1e6, m0=(1.5, 1.5), w0=1.0,
                      trials=PIPELINE_TRIALS, nv=100, tau=50,
                      initmode="baseem", learn_hyps=False)
    out = []
    for seed in range(SEEDS):
        st = vbhem.fit_single_ks(torch.Generator().manual_seed(seed), base,
                                 2, 2, cfg)
        lab = torch.argmax(st.hat_z, dim=-1).cpu().numpy()
        ri = np.array([rand_index(lab[t], labels)
                       for t in range(cfg.trials)])
        best = int(torch.argmax(st.ll))
        row = {"seed": seed, "trials": cfg.trials,
               "recovered": int(np.sum(ri == 1.0)),
               "best_elbo_restart_recovers": bool(ri[best] == 1.0),
               "collapsed_to_one_cluster": int(np.sum(
                   torch.min(st.stats.nj, dim=-1).values.cpu().numpy()
                   < 1.0))}
        out.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": smi, "seeds": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
