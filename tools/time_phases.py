"""Time the end-to-end phases of chip_smoke.py that run the port's older
paths, several times in one process, on one NVIDIA card.

    python3 tools/time_phases.py [--repeat 4] [--label NAME] [--out FILE]

It builds the kernels, learns the 8192-subject bank once (phase "VBEM
path"), then runs, ``--repeat`` times in turn: "VBHEM path", "pipeline",
"VHEM path" and "DIC" (each on that bank, as chip_smoke.py runs them).
For each run it records the phase's time from its start to its end on
the host's clock and, where the phase measures one, its own wall time
(``wall_s``: the path's call alone, synchronized).

It takes the phases from the chip_smoke.py of the checkout it sits in, so
a copy placed in an earlier checkout times that checkout's paths: run the
two checkouts in one call as separate processes, in turns (earlier,
later, earlier, later, ...), since two versions of the package cannot
share a process.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
object; ``--out`` also writes the object to a file.  Exits 1 if a check
of a phase failed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from vbhem_tpu_torch.ops import _build  # noqa: E402

REPEATED = ("VBHEM path", "pipeline", "VHEM path", "DIC")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeat", type=int, default=4)
    ap.add_argument("--label", default=str(REPO))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_phases: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    fails = chip_smoke.Failures()
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    vbem, vbem_s = timed(lambda: chip_smoke.phase_vbem_path(fails, device))
    runs = {name: [] for name in REPEATED}
    for _ in range(args.repeat):
        pipe = None
        for name in REPEATED:
            fn = {
                "VBHEM path": lambda: chip_smoke.phase_vbhem_path(fails,
                                                                  device),
                "pipeline": lambda: chip_smoke.phase_pipeline(fails, device,
                                                              vbem),
                "VHEM path": lambda: chip_smoke.phase_vhem_path(fails, device,
                                                                vbem),
                "DIC": lambda: chip_smoke.phase_dic(fails, device, pipe,
                                                    vbem["labels"]),
            }[name]
            out, sec = timed(fn)
            if name == "pipeline":
                pipe = out
            runs[name].append({"phase_s": sec,
                               "wall_s": (out or {}).get("wall_s")})
            torch.cuda.empty_cache()
    result = {"label": args.label, "build_s": build_s,
              "vbem_path_s": vbem_s, "vbem_wall_s": vbem.get("wall_s"),
              "runs": runs, "failed": fails.items}
    print(chip_smoke.nvidia_smi_line(), flush=True)
    print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result))
    return 1 if fails.items else 0


if __name__ == "__main__":
    sys.exit(main())
