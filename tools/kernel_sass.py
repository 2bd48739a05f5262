"""ptxas's register and spill report and the SASS instruction counts of
the package's CUDA kernels, for comparing two builds of them.

    python3 tools/kernel_sass.py [--lib PATH] [--match REGEX] [--out FILE]

Without ``--lib`` it builds this checkout's kernels (``ops/_build.build``)
and reads that library; ``--lib`` names another build's library (an
earlier checkout's ``build/vbhem_tpu_torch/libvbhem_kernels_<hash>.so``,
whose ``.log`` beside it holds its ``-Xptxas -v`` output).  For every
kernel whose demangled name matches ``--match``: ptxas's registers, stack
frame and spills (``_build.ptxas_report``), and from ``cuobjdump -sass``
the count of SASS instructions and of each opcode.  Needs the CUDA
toolkit (nvcc, cuobjdump) but no card.  Prints one line per kernel and
one JSON object; ``--out`` also writes the object.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from vbhem_tpu_torch.ops import _build  # noqa: E402

FUNCTION = re.compile(r"^\s*Function : (\S+)")
# /*0040*/  @!P0 FFMA R2, R3, R4, R5 ;
INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_]*)")


def tool(name: str) -> str:
    """A CUDA toolkit program: on PATH or beside nvcc."""
    found = shutil.which(name)
    if found:
        return found
    nvcc = _build.find_nvcc()
    if nvcc and (Path(nvcc).parent / name).is_file():
        return str(Path(nvcc).parent / name)
    raise FileNotFoundError(f"{name} not found")


def sass_counts(lib: Path) -> dict:
    """{mangled kernel name: Counter of SASS opcodes} of a library."""
    text = subprocess.run([tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = FUNCTION.match(line)
        if m:
            cur = counts.setdefault(m.group(1), collections.Counter())
            continue
        m = INSTRUCTION.match(line)
        if m and cur is not None:
            cur[m.group(1)] += 1
    return counts


def demangle(names) -> dict:
    """{mangled: demangled} through c++filt, where there is one."""
    names = list(names)
    filt = shutil.which("c++filt")
    if not filt or not names:
        return {n: n for n in names}
    out = subprocess.run([filt, *names], capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {
        n: n for n in names}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lib", type=Path, default=None,
                    help="a built library (default: build this checkout's)")
    ap.add_argument("--match", default=".",
                    help="regular expression on the demangled kernel name")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    lib = args.lib or _build.build()
    report = _build.ptxas_report(lib)
    sass = sass_counts(lib)
    names = demangle(sorted(set(report) | set(sass)))
    out = {"library": lib.name, "kernels": {}}
    for mangled, name in sorted(names.items(), key=lambda kv: kv[1]):
        if not re.search(args.match, name) or mangled not in sass:
            continue
        ops = sass[mangled]
        row = {**report.get(mangled, {}), "instructions": sum(ops.values()),
               "ops": dict(ops.most_common())}
        out["kernels"][name] = row
        top = ", ".join(f"{k} {v}" for k, v in ops.most_common(12))
        print(f"{name}: {row.get('registers')} registers, stack "
              f"{row.get('stack')} B, spills {row.get('spill_stores')}/"
              f"{row.get('spill_loads')} B; {row['instructions']} SASS "
              f"instructions ({top})", flush=True)
    text = json.dumps(out)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
