"""Reproduce, on one NVIDIA card, the fault that ``kKeepZ`` in
``vbhem_tpu_torch/csrc/pair_recursion.cuh`` works around: kernel B1's
generic float32 body (the instantiation with runtime Sb, Sr, D) returned
wrong results on masked states when the recursion's underflow guard
formed z = ell + carry again instead of reading it back.

    python3 tools/guard_repro.py [--out DIR] [--sanitizer]

For each variant of the sources:
  kept      the checkout's sources (the guard reads z back);
  reformed  ``kKeepZ`` false, so the guard forms z again, as the
            specialized bodies do;
it copies the package and chip_smoke.py into build/guard_repro/<variant>/
(a directory the repository ignores), patches the header, writes the PTX
of ``csrc/pair_estep_fused.cu`` at the build's flags and the PTX of each
generic float32 entry on its own, and runs chip_smoke's B1 parity cases
that take masked states: the generic body at Sb=Sr=3, D=3, tau=2 and 50,
the (3,3,2) specialization on the same kind of inputs, and the padded
grid's (2,5,2) body (a masked state it must run, which fires its guard,
and the grid's launch case), each variant in its own process, float32
and float64.  With ``--sanitizer`` it also runs the reformed variant's tau=2
case under compute-sanitizer's memcheck and initcheck where the toolkit
has it.

Prints nvcc's version, each case's result per variant, and one JSON
object; the PTX goes to ``--out`` (default chiprun_out/guard_repro).
Exits 0 when the kept variant passes every case.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from vbhem_tpu_torch.ops import _build  # noqa: E402

KEEP_Z = "constexpr bool kKeepZ = SB_ == 0 || SR_ == 0;"
VARIANTS = {"kept": None, "reformed": "constexpr bool kKeepZ = false;"}
CASES = ("d3_masked_state_tau2", "d3_masked_state_tau50",
         "d3_masked_state_tau50_checkpointed", "masked_state_ragged",
         "masked_state_tau50_scratch", "grid_body_masked_state0_tau2",
         "grid_body_masked_state0_tau50",
         "grid_body_masked_state0_tau50_checkpointed", "grid_launch")

RUN_CASES = """
import json, sys
import torch
sys.path.insert(0, '.')
import chip_smoke as cs
names = set(sys.argv[1].split(','))
cs.B1_CASES = [c for c in cs.B1_CASES if c[0] in names]
fails = cs.Failures()
cs.phase_parity_b1(fails, torch.device('cuda', 0))
print('FAILED ' + json.dumps(fails.items), flush=True)
"""


def make_variant(name: str, patch) -> Path:
    root = REPO / "build" / "guard_repro" / name
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    shutil.copy(REPO / "chip_smoke.py", root / "chip_smoke.py")
    shutil.copytree(REPO / "vbhem_tpu_torch", root / "vbhem_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if patch is not None:
        hdr = root / "vbhem_tpu_torch" / "csrc" / "pair_recursion.cuh"
        text = hdr.read_text()
        if text.count(KEEP_Z) != 1:
            raise RuntimeError(f"{hdr}: the kKeepZ line is not there once")
        hdr.write_text(text.replace(KEEP_Z, patch))
    return root


def write_ptx(root: Path, out: Path, name: str) -> dict:
    """PTX of pair_estep_fused.cu; each generic float32 entry (template
    arguments <float, 0, 0, 0, design, false>) also in a file of its
    own."""
    nvcc = _build.find_nvcc()
    src = root / "vbhem_tpu_torch" / "csrc" / "pair_estep_fused.cu"
    ptx = out / f"{name}_pair_estep_fused.ptx"
    subprocess.run([nvcc, "-arch=sm_90a", "-std=c++17", "-O3", "-ptx", "-o",
                    str(ptx), str(src)], check=True)
    text = ptx.read_text()
    entries = {}
    for m in re.finditer(r"\.entry (\S+?)\(", text):
        sym = m.group(1)
        generic = re.search(r"IfLi0ELi0ELi0ELi(\d)E", sym)
        if not generic:
            continue
        end = text.find(".entry", m.end())
        body = text[m.start():end if end > 0 else len(text)]
        design = ("resident", "scratch", "checkpointed")[int(generic[1])]
        path = out / f"{name}_generic_f32_{design}.ptx"
        path.write_text(body)
        entries[design] = {"symbol": sym, "lines": body.count("\n"),
                           "file": str(path)}
    return entries


def run_cases(root: Path, names, prefix=(), timeout=900) -> dict:
    proc = subprocess.run([*prefix, sys.executable, "-c", RUN_CASES,
                           ",".join(names)], cwd=root, capture_output=True,
                          text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith(("PASS parity", "FAIL parity", "FAILED"))]
    for ln in lines:
        print(f"  {ln}", flush=True)
    return {"rc": proc.returncode, "lines": lines,
            "stdout_tail": proc.stdout[-3000:],
            "stderr_tail": proc.stderr[-2000:]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "chiprun_out" /
                                         "guard_repro"))
    ap.add_argument("--sanitizer", action="store_true")
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    if nvcc is None:
        print("guard_repro: nvcc not found", file=sys.stderr)
        return 2
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()[-1]
    print(f"nvcc: {version}", flush=True)
    result = {"nvcc": version, "variants": {}}
    for name, patch in VARIANTS.items():
        root = make_variant(name, patch)
        print(f"variant {name}:", flush=True)
        entries = write_ptx(root, out, name)
        cases = run_cases(root, CASES)
        result["variants"][name] = {"ptx": entries, **cases}
    if args.sanitizer:
        san = Path(nvcc).parent / "compute-sanitizer"
        root = REPO / "build" / "guard_repro" / "reformed"
        result["sanitizer"] = {}
        for tool in ("memcheck", "initcheck"):
            print(f"compute-sanitizer --tool {tool} (reformed, tau=2):",
                  flush=True)
            if not san.is_file():
                result["sanitizer"][tool] = "not in the toolkit"
                continue
            try:
                res = run_cases(root, CASES[:1],
                                prefix=(str(san), "--tool", tool),
                                timeout=150)
                result["sanitizer"][tool] = res
                print(res["stdout_tail"][-1500:], res["stderr_tail"][-800:],
                      flush=True)
            except subprocess.TimeoutExpired:
                result["sanitizer"][tool] = "timed out after 150 s"
                print("  timed out after 150 s", flush=True)
                break
    print(json.dumps(result), flush=True)
    (out / "result.json").write_text(json.dumps(result, indent=1))
    kept = result["variants"]["kept"]
    return 0 if kept["rc"] == 0 and "FAILED []" in kept["lines"] else 1


if __name__ == "__main__":
    sys.exit(main())
