"""Time kernel B1 (the fused pair E-step) at the launches of chip_smoke.py's
pipeline phase on one NVIDIA card.

    python3 tools/time_b1_pipeline.py [--n 50] [--label NAME] [--out FILE]

The pipeline clusters a learned bank of 8192 2-state HMMs (D=2) with 64
restart lanes of Kr in {1, 2, 3} reduced HMMs of Sr=2 states at tau=50,
in float32.  For each Kr this draws a random bank of those shapes and
random baseem starts, and reports B1's device time (torch.profiler), the
wrapper's time and the plain PyTorch version's time (CUDA events), and
B1's bound as chip_smoke.py computes it.

It takes its helpers from the chip_smoke.py of the checkout it sits in
(``random_posts``, ``kernel_args``, ``_plain_pair``, ``_time``,
``device_ms``, ``b1_bound``), so a copy placed in an earlier checkout
whose chip_smoke.py has them times that checkout's kernel: run the two
checkouts in one call, in the order earlier, later, later, earlier.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
object; ``--out`` also writes the object to a file.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from vbhem_tpu_torch import VBHEMConfig  # noqa: E402
from vbhem_tpu_torch.models import vbhem  # noqa: E402
from vbhem_tpu_torch.ops import pair_estep_cuda  # noqa: E402
from vbhem_tpu_torch.utils.planted import random_bank  # noqa: E402

KB, LANES, SB, SR, D, TAU = 8192, 64, 2, 2, 2, 50


def time_kr(kr: int, n: int, device) -> dict:
    rng = np.random.default_rng(0)
    base = random_bank(rng, KB, SB, D, device, torch.float32)
    cfg = VBHEMConfig(m0=(0.0,) * D, w0=1.0, nv=100, tau=TAU)
    hyps = vbhem.VBHEMHyps.from_config(cfg, D, torch.float32, device)
    gen = torch.Generator(device="cpu").manual_seed(1)
    post = chip_smoke.random_posts(gen, base, hyps, LANES, kr, SR, cfg.nv)
    args = chip_smoke.kernel_args(base, post)
    def kernel():
        pair_estep_cuda.pair_bwd_fwd_fused_cuda(*args, TAU)

    def plain():
        chip_smoke._plain_pair(args, TAU)

    # kernel, plain, kernel; the plain version takes ~100x longer, so it
    # runs a tenth of the calls
    wrapper, plain_runs = [], []
    for fn, calls, into in ((kernel, n, wrapper),
                            (plain, max(n // 10, 2), plain_runs),
                            (kernel, n, wrapper)):
        fn()
        into.append(chip_smoke._time(fn, calls, device) * 1e3)
    dev_ms = chip_smoke.device_ms(kernel, "pair_estep_fused_kernel", 20)
    b = chip_smoke.b1_bound(KB, LANES * kr, SB, SR, D, TAU, 4)
    return {"kernel_device_ms": dev_ms, "wrapper_ms_runs": wrapper,
            "plain_ms_runs": plain_runs, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=50,
                    help="calls per timed run (default 50)")
    ap.add_argument("--label", default=str(REPO.name),
                    help="name of this checkout in the output")
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_b1_pipeline: no CUDA device is available",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = {"label": args.label, "nvidia_smi": chip_smoke.nvidia_smi_line(),
           "shape": f"Kb={KB} L={LANES} Sb={SB} Sr={SR} D={D} tau={TAU} f32",
           "kr": {}}
    for kr in (1, 2, 3):
        row = time_kr(kr, args.n, device)
        out["kr"][kr] = row
        print(f"B1 [{args.label}] Kr={kr}: device "
              f"{row['kernel_device_ms']:.4f} ms, wrapper "
              f"{np.mean(row['wrapper_ms_runs']):.4f} ms (runs "
              f"{row['wrapper_ms_runs']}), plain "
              f"{np.mean(row['plain_ms_runs']):.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    print(out["nvidia_smi"], flush=True)
    text = json.dumps(out)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
