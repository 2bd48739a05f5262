"""Time kernel B2 (the VBEM forward-backward) at the VBEM path's full-width
launch on one NVIDIA card.

    python3 tools/time_b2.py [--label NAME] [--out FILE]

Learns nothing: it draws the synthetic protocol's 8192 subjects (25
sequences of T=50, D=2), random-start posteriors for 20 restarts each, and
runs ``chip_smoke.timing_b2`` of the checkout it sits in, which times B2
at that launch (device time by the profiler, the E-step and one VBEM
iteration by CUDA events, kernel against plain).  It takes its helpers
from that checkout's ``chip_smoke.py``, so a copy placed in an unpacked
earlier commit times that commit's kernel; run the two in one call, old,
new, new, old.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
object; ``--out`` also writes the object to a file.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from vbhem_tpu_torch import SeqBatch  # noqa: E402
from vbhem_tpu_torch.models import vbhmm  # noqa: E402
from vbhem_tpu_torch.utils.planted import synthetic_subjects  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default=str(REPO.name))
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_b2: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    device = torch.device("cuda", 0)
    batches, _ = synthetic_subjects(4096, seed=1, device=device)
    bank = SeqBatch(x=torch.stack([b.x for b in batches]),
                    lengths=torch.stack([b.lengths for b in batches]))
    del batches
    hyps = vbhmm.VBHyps.from_config(chip_smoke.VB_CONFIG, 2, torch.float32,
                                    device)
    result = {"label": args.label, "card": smi,
              "timing_b2": chip_smoke.timing_b2(device, {"bank": bank,
                                                         "hyps": hyps})}
    text = json.dumps(result, default=float)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
