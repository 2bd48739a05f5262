"""Per-repeat table of a synthetic experiment's checkpoint directory:
each method's selection (K, S per cluster or S) and Rand index, each
stage's wall time, the VBHEM stage's kernel work and each grid's float32
scores against their float64 rescoring.  Reads the checkpoints only and
runs on the CPU.

    python3 tools/acceptance_table.py OUTDIR [--repeats 10] [--json FILE]
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vbhem_tpu_torch.experiments import runner  # noqa: E402

METHODS = (("vbhem", "vbhem", "score"), ("vbhem_dic", "vbhem", "dic_score"),
           ("vhem_aic", "vhem", "aic_score"), ("vhem_bic", "vhem", "bic_score"),
           ("ccfd", "ccfd", "score"), ("ppk_aic", "ppk", "aic_score"),
           ("ppk_bic", "ppk", "bic_score"))


def repeat_row(outdir: str, r: int):
    stages = {s: runner.load_checkpoint(outdir, r, s)
              for s in ("vbem", "vbhem", "vhem", "ccfd", "ppk")}
    if stages["vbhem"] is None:
        return None
    row = {"repeat": r, "select": {}, "wall_s": {}}
    for name, stage, field in METHODS:
        st = stages[stage]
        if st is None:
            continue
        sc = st[field]
        row["select"][name] = {
            "k": int(sc.best_k),
            "s": list(sc.s_list) if sc.s_list else int(sc.best_s),
            "rand_index": float(sc.rand_index)}
    vb = stages["vbem"]
    if vb is not None:
        row["wall_s"]["vbem"] = float(vb["elapsed"])
        row["wall_s"]["vbem_by_s"] = {str(s): float(t) for s, t in
                                      vb["elapsed_by_s"].items()}
    vh = stages["vbhem"]
    row["wall_s"]["vbhem"] = float(vh["elapsed"])
    row["wall_s"]["dic"] = float(vh["elapsed_with_dic"] - vh["elapsed"])
    for s in ("vhem", "ccfd", "ppk"):
        if stages[s] is not None:
            row["wall_s"][s] = float(stages[s]["elapsed"])
    row["vbhem_work"] = vh.get("work")
    f64, f32 = np.asarray(vh["model_ll"]), np.asarray(vh["model_ll_device"])
    gap = np.abs(f32 - f64) / np.abs(f64)
    row["f32_f64_gap"] = {"max": float(np.max(gap)),
                          "cells_over_1e-3": int(np.sum(gap > 1e-3)),
                          "median": float(np.median(gap))}
    ks, ss = np.unravel_index(np.argmax(f32), f32.shape)
    kd, sd = np.unravel_index(np.argmax(f64), f64.shape)
    row["best_cell_f32"] = [int(ks) + 1, int(ss) + 1]
    row["best_cell_f64"] = [int(kd) + 1, int(sd) + 1]
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--json", default=None,
                    help="write the rows here as JSON")
    args = ap.parse_args(argv)
    rows = [row for r in range(args.repeats)
            if (row := repeat_row(args.outdir, r)) is not None]
    names = [m for m, _, _ in METHODS]
    print("| repeat | " + " | ".join(names) + " | VBEM s | VBHEM s | "
          "VHEM s | CCFD s | PPK s |")
    print("|" + " --- |" * (len(names) + 6))
    for row in rows:
        cells = []
        for m in names:
            sel = row["select"].get(m)
            cells.append("—" if sel is None else
                         f"{sel['k']}, {sel['s']}, {sel['rand_index']:.3f}")
        w = row["wall_s"]
        print(f"| {row['repeat']} | " + " | ".join(cells) + " | " + " | ".join(
            f"{w[s]:.1f}" if s in w else "—"
            for s in ("vbem", "vbhem", "vhem", "ccfd", "ppk")) + " |")
    for row in rows:
        print(json.dumps({k: row[k] for k in ("repeat", "wall_s",
                                              "vbhem_work", "f32_f64_gap",
                                              "best_cell_f32",
                                              "best_cell_f64")}))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
