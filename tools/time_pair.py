"""Time kernels B1 (the fused pair E-step) and B3 (the pair recursion on a
precomputed emission matrix) at the launches of the port's paths on one
NVIDIA card.

    python3 tools/time_pair.py [--n 50] [--only REGEX] [--label NAME]
                               [--out FILE]

Shapes, float32 unless named (Kb=8192, D=2, random banks and starts):
  B1 bench: L=1, Kr=8, Sb=Sr=3, tau=10 (bench.py's shape);
  B1 main-path cell: L=8, Kr=3, Sb=Sr=3, tau=10 (chip_smoke's phase 3);
  B1 pipeline: L=64, Kr=1, 2, 3, Sb=Sr=2, tau=50 (phase 5);
  B3 VHEM full width: L=20, Kr=3, Sb=2, Sr=3, tau=10 (phase 6);
  B3 DIC cells: L=1, Kr=1, 2, 3, Sb=Sr=2, tau=50, float32 and float64
  (phase 7);
  B1 long tau: L=8, Kr=2, Sb=Sr=2, tau=200, past what the resident design
  holds (no path of the port launches it);
  B1 padded grid: 344 lanes at (Kmax, Smax) = (6, 5), Sb=2, tau=50, each
  lane masked to its cell (chip_smoke's ``grid_chunk``; phase 8's launch
  under the scratch design), and the hyp objective's launch, Kb=40, 80
  such lanes;
  B3 f64 rescoring: cell (6, 5) unpadded, Kb=8192, Sb=2, tau=50 (phase
  8's float64 rescoring).
For each: the kernel's device time (torch.profiler), the wrapper's time
and the plain PyTorch version's time (CUDA events; not run at the padded
grid's launches, whose per-step Theta takes tens of GB), the bound as the
chip_smoke.py beside this file computes it, and, where the checkout's
wrapper picks a design (``ops/pair_estep_cuda.design``), the one it took.
At the padded grid's launches the bound counts each lane at its own
cell's S (``live_bound``, where chip_smoke.py has ``b1_bound_live``) and
``padded_bound_ms`` at the padded Smax.  ``--only`` times the shapes whose
name the regular expression matches.

It takes its helpers from the chip_smoke.py of the checkout it sits in
(``random_posts``, ``kernel_args``, ``_plain_pair``, ``b3_inputs``,
``_errors``, ``_time``, ``device_ms``, ``b1_bound``, ``b3_bound``), so a
copy placed in an earlier checkout whose chip_smoke.py has them times that
checkout's kernels: run the two checkouts in one call, in the order
earlier, later, later, earlier.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
object; ``--out`` also writes the object to a file.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from vbhem_tpu_torch import VBHEMConfig  # noqa: E402
from vbhem_tpu_torch.models import vbhem  # noqa: E402
from vbhem_tpu_torch.ops import pair_estep as plain  # noqa: E402
from vbhem_tpu_torch.ops import pair_estep_cuda  # noqa: E402
from vbhem_tpu_torch.utils.planted import random_bank  # noqa: E402

KB, D = 8192, 2
# name, kernel, lanes, kr, sb, sr, tau, dtype
SHAPES = [
    ("B1 bench", "B1", 1, 8, 3, 3, 10, torch.float32),
    ("B1 main-path cell", "B1", 8, 3, 3, 3, 10, torch.float32),
    ("B1 pipeline Kr=1", "B1", 64, 1, 2, 2, 50, torch.float32),
    ("B1 pipeline Kr=2", "B1", 64, 2, 2, 2, 50, torch.float32),
    ("B1 pipeline Kr=3", "B1", 64, 3, 2, 2, 50, torch.float32),
    ("B3 VHEM full width", "B3", 20, 3, 2, 3, 10, torch.float32),
    ("B3 DIC Kr=1 f32", "B3", 1, 1, 2, 2, 50, torch.float32),
    ("B3 DIC Kr=2 f32", "B3", 1, 2, 2, 2, 50, torch.float32),
    ("B3 DIC Kr=3 f32", "B3", 1, 3, 2, 2, 50, torch.float32),
    ("B3 DIC Kr=1 f64", "B3", 1, 1, 2, 2, 50, torch.float64),
    ("B3 DIC Kr=2 f64", "B3", 1, 2, 2, 2, 50, torch.float64),
    ("B3 DIC Kr=3 f64", "B3", 1, 3, 2, 2, 50, torch.float64),
    ("B1 long tau", "B1", 8, 2, 2, 2, 200, torch.float32),
    ("B1 padded grid, 344 lanes", "B1grid", 344, 6, 2, 5, 50, torch.float32),
    ("B1 hyp objective, Kb=40", "B1grid", 80, 6, 2, 5, 50, torch.float32),
    ("B3 f64 rescoring (6, 5)", "B3", 1, 6, 2, 5, 50, torch.float64),
]
DEVICE_NAMES = {"B1": "pair_estep_fused_kernel", "B3": "pair_bwd_fwd_kernel"}


def inputs(kernel, lanes, kr, sb, sr, tau, dtype, device):
    """(launch, plain version or None at the padded grid's launches, the
    lanes' cells at those launches)."""
    if kernel == "B1grid":
        kb = 40 if lanes == 80 else KB
        base = random_bank(np.random.default_rng(0), kb, sb, D, device,
                           dtype)
        post, cells, _, _ = chip_smoke.grid_chunk(base, lanes, device)
        args = chip_smoke.grid_kernel_args(base, post, cells)
        return (lambda: pair_estep_cuda.pair_bwd_fwd_fused_cuda(*args, tau),
                None, cells)
    if kernel == "B1":
        base = random_bank(np.random.default_rng(0), KB, sb, D, device,
                           dtype)
        cfg = VBHEMConfig(m0=(0.0,) * D, w0=1.0, nv=100, tau=tau)
        hyps = vbhem.VBHEMHyps.from_config(cfg, D, dtype, device)
        gen = torch.Generator(device="cpu").manual_seed(1)
        post = chip_smoke.random_posts(gen, base, hyps, lanes, kr, sr,
                                       cfg.nv)
        args = chip_smoke.kernel_args(base, post)
        fn = pair_estep_cuda.pair_bwd_fwd_fused_cuda
        plain_fn = chip_smoke._plain_pair
    else:
        args = chip_smoke.b3_inputs(5, lanes, KB, kr, sb, sr, device, dtype)
        fn = pair_estep_cuda.pair_bwd_fwd_cuda
        plain_fn = plain.pair_bwd_fwd

    return (lambda: fn(*args, tau),
            lambda: plain_fn(args, tau) if kernel == "B1"
            else plain_fn(*args, tau), None)


def time_shape(shape, n, device) -> dict:
    name, kernel, lanes, kr, sb, sr, tau, dtype = shape
    launch, plain_fn, cells = inputs(kernel, lanes, kr, sb, sr, tau, dtype,
                                     device)
    grid = kernel == "B1grid"
    kb = 40 if grid and lanes == 80 else KB
    if grid:   # a few calls: the scratch design took 0.75 s a launch
        n = 3
    wrapper, plain_runs = [], []
    for fn, calls, into in ((launch, n, wrapper),
                            (plain_fn, max(n // 10, 2), plain_runs),
                            (launch, n, wrapper)):
        if fn is None:
            continue
        fn()
        into.append(chip_smoke._time(fn, calls, device) * 1e3)
    dev_ms = chip_smoke.device_ms(launch, DEVICE_NAMES["B1" if grid
                                                    else kernel],
                                  n if grid else 20)
    itemsize = torch.empty((), dtype=dtype).element_size()
    if grid and hasattr(chip_smoke, "b1_bound_live"):
        b = {**chip_smoke.b1_bound_live(kb, cells, kr, sb, sr, D, tau,
                                        itemsize),
             "padded_bound_ms": chip_smoke.b1_bound(
                 kb, lanes * kr, sb, sr, D, tau, itemsize)["bound_ms"]}
    elif kernel in ("B1", "B1grid"):
        b = chip_smoke.b1_bound(kb, lanes * kr, sb, sr, D, tau, itemsize)
    else:
        b = chip_smoke.b3_bound(KB, lanes * kr, sb, sr, tau, itemsize)
    row = {"kernel_device_ms": dev_ms, "wrapper_ms_runs": wrapper,
           "plain_ms_runs": plain_runs,
           **{k: v for k, v in b.items() if not isinstance(v, dict)}}
    design = getattr(pair_estep_cuda, "design", None)
    if design is not None:
        row["design"] = tuple(design(sb, sr, tau, itemsize, kb * lanes * kr,
                                     chip_smoke.sm_count()))
    print(f"{name}: device {dev_ms:.4f} ms, wrapper "
          f"{np.mean(wrapper):.4f} ms (runs {wrapper}), plain "
          f"{np.mean(plain_runs) if plain_runs else float('nan'):.4f} ms, "
          f"bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}), design {row.get('design')}", flush=True)
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=50,
                    help="calls per timed run (default 50)")
    ap.add_argument("--only", default=None,
                    help="time only the shapes whose name this matches")
    ap.add_argument("--label", default=str(REPO.name),
                    help="name of this checkout in the output")
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_pair: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = {"label": args.label, "nvidia_smi": chip_smoke.nvidia_smi_line(),
           "shapes": {}}
    for shape in SHAPES:
        if args.only is None or re.search(args.only, shape[0]):
            out["shapes"][shape[0]] = time_shape(shape, args.n, device)
    print(out["nvidia_smi"], flush=True)
    text = json.dumps(out)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
