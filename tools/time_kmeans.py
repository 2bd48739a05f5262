"""Time the 'wtkmeans' start's k-means kernels (``csrc/kmeans.cu``) at the
face cell's shapes on one NVIDIA card, against the plain version.

    python3 tools/time_kmeans.py [--repeat 5] [--out FILE]

Draws the face cell's bank (``gpubench/configs/face_demo_kb8192.json``,
float32, 8192 viewer HMMs padded to 3 states: M = 24,576 pooled states)
and the start's draws for its 750 lanes at the padded (Kr, Sr) = (5, 3),
then times by CUDA events, after a warm-up:

* each of the start's four k-means launches (the first stage's Lloyd,
  the energy k-means, the global Lloyd, the per-cluster Lloyd), the
  median of ``--repeat`` runs, beside its bound: the operations these
  inputs need at the iterations each lane ran (points of weight 0 carry
  none) at the card's published float32 rate, or the bytes read and
  written at its memory rate (the per-cluster weights, too large for L2,
  once an iteration; the rest once), the larger;
* the same four k-means through the plain version (``ops/kmeans.py``);
* the whole start (``vbhem.wtkmeans_from_uniforms``: seeding, the four
  k-means, the random dynamics) with the kernels, and with the four
  k-means rebound to the plain version;

and reads a profiler window over one start with the kernels (its ten
largest device operations).  Prints the card's ``nvidia-smi`` name and
power limit, then one JSON object; ``--out`` also writes it to a file.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from gpubench.lib import data  # noqa: E402
from vbhem_tpu_torch.config import VBHEMConfig  # noqa: E402
from vbhem_tpu_torch.containers import H3M, HMM  # noqa: E402
from vbhem_tpu_torch.models import vbhem  # noqa: E402
from vbhem_tpu_torch.ops import kmeans as tkm  # noqa: E402
from vbhem_tpu_torch.ops import kmeans_cuda as kc  # noqa: E402
from vbhem_tpu_torch.utils import profiling  # noqa: E402

F32_FLOP_PER_S = 67e12     # H100 SXM, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
LANES, KR, SR = 750, 5, 3


def face_inputs(device, seed=2 ** 33 + 16):
    cfg = json.loads((REPO / "gpubench" / "configs"
                      / "face_demo_kb8192.json").read_text())
    omega, prior, trans, mean, cov, mask = data.draw_bank(
        data.generator(seed, device), cfg["groups"], cfg["subjects"],
        cfg["grid_bank"], device, torch.float32)
    base = H3M(omega=omega, hmm=HMM(prior=prior, trans=trans, mean=mean,
                                    cov=cov), state_mask=mask)
    gen = torch.Generator(device=device).manual_seed(seed)
    return base, vbhem.draw_wtkmeans(gen, base, KR, SR, (LANES,))


def event_ms(fn, repeat: int) -> list:
    """Each of ``repeat`` runs of ``fn`` in ms, by CUDA events."""
    out = []
    for _ in range(repeat):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def bound(flops: float, n_bytes: float) -> dict:
    t_ops, t_bytes = flops / F32_FLOP_PER_S, n_bytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": n_bytes}


def lloyd_flops(its, weighted, m, k, d):
    """Each iteration: every weighted point's K distances (3D flops each)
    and its cluster's mass and sums (1 + 2D); then every point's final
    assignment."""
    per = 3 * d * k + 1 + 2 * d
    return float(torch.sum(its.double() * weighted.double()) * per
                 + its.numel() * m * 3 * d * k)


def launch_counts(fn):
    """Run ``fn`` while profiling records; the per-lane iterations or
    moves of its one launch."""
    with profiling.recording():
        fn()
        (_, counts), = kc.PENDING
        kc.PENDING.clear()
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_kmeans: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    base, draws = face_inputs(dev)
    means, _, valid = vbhem._pool(base)
    lw = vbhem.long_run_weights(base)
    m, d = means.shape
    seeds_kr = tkm.kmeans_pp_from_uniforms(means, KR, valid,
                                           draws["u_assign"])
    seeds_sr = tkm.kmeans_pp_from_uniforms(means, SR, valid,
                                           draws["u_global"])

    # the kernels, stage by stage
    _, c1 = kc.kmeans_auto(means, seeds_kr, weights=valid)
    a2, _ = kc.weighted_kmeans_energy_auto(means, lw, c1)
    wts = vbhem.wtkmeans_cluster_weights(base, a2, KR)
    seeds_c = tkm.kmeans_pp_from_uniforms(means, SR, wts,
                                          draws["u_cluster"])
    stage_fns = {
        "lloyd_kr": lambda: kc.kmeans_auto(means, seeds_kr, weights=valid),
        "energy": lambda: kc.weighted_kmeans_energy_auto(means, lw, c1),
        "lloyd_sr": lambda: kc.kmeans_auto(means, seeds_sr, weights=valid),
        "cluster": lambda: kc.kmeans_auto(means, seeds_c, weights=wts),
    }
    its1, moves, its3, its4 = (launch_counts(fn) for fn in stage_fns.values())
    torch.cuda.synchronize()
    n_valid = torch.sum(valid > 0)
    n_w = torch.sum(lw > 0)
    weighted4 = torch.sum(wts > 0, -1)                   # [L, Kr]
    stages = {
        "lloyd_kr": (lloyd_flops(its1, n_valid, m, KR, d),
                     LANES * (m * 8 + 2 * KR * d * 4 + 4)),
        "energy": (float((moves.double() + 1).sum() * m
                         * (KR * (3 * d + 3) + 2)
                         + LANES * m * (3 * d * KR)
                         + (moves.double() + 2).sum() * n_w
                         * (1 + 2 * d)),
                   LANES * (m * 8 + 2 * KR * d * 4 + 4)),
        "lloyd_sr": (lloyd_flops(its3, n_valid, m, SR, d),
                     LANES * (m * 8 + 2 * SR * d * 4 + 4)),
        # each (lane, cluster) block reads its weights every iteration
        "cluster": (lloyd_flops(its4, weighted4, m, SR, d),
                    float(its4.double().sum()) * m * 4
                    + LANES * KR * (m * 8 + 2 * SR * d * 4 + 4)),
    }
    common_bytes = m * (d + 2) * 4
    result = {"card": smi, "lanes": LANES, "m": m, "kr": KR, "sr": SR,
              "iterations": {
                  "lloyd_kr_mean": float(its1.double().mean()),
                  "energy_moves_mean": float(moves.double().mean()),
                  "energy_moves_max": int(moves.max()),
                  "lloyd_sr_mean": float(its3.double().mean()),
                  "cluster_mean": float(its4.double().mean()),
                  "cluster_max": int(its4.max())},
              "kernel": {}, "plain": {}}
    lloyd_its = torch.cat([its1, its3, its4.reshape(-1)])
    result["iterations"]["share_of_fixed"] = float(
        lloyd_its.double().sum() / (lloyd_its.numel() * 100))
    for name, (flops, n_bytes) in stages.items():
        fn = stage_fns[name]
        fn()
        ms = statistics.median(event_ms(fn, args.repeat))
        b = bound(flops, n_bytes + common_bytes)
        result["kernel"][name] = {"ms": ms, **b,
                                  "share": b["bound_ms"] / ms}
    result["kernel"]["total_ms"] = sum(v["ms"] for v in
                                       result["kernel"].values())

    plain = {
        "lloyd_kr": lambda: tkm.kmeans(None, means, KR, weights=valid,
                                       init_centers=seeds_kr),
        "energy": lambda: tkm.weighted_kmeans_energy(means, lw, c1),
        "lloyd_sr": lambda: tkm.kmeans(None, means, SR, weights=valid,
                                       init_centers=seeds_sr),
        "cluster": lambda: tkm.kmeans(None, means, SR, weights=wts,
                                      init_centers=seeds_c),
    }
    for name, fn in plain.items():
        fn()
        result["plain"][name] = {"ms": statistics.median(event_ms(fn, 2))}
    result["plain"]["total_ms"] = sum(v["ms"] for v in
                                      result["plain"].values())

    hyps = vbhem.VBHEMHyps.from_config(VBHEMConfig(), d, torch.float32,
                                       dev)

    def start():
        return vbhem.wtkmeans_from_uniforms(base, KR, SR, hyps, 10, **draws)

    start()
    result["start_ms_kernel"] = statistics.median(event_ms(start, 3))
    del wts
    saved = (kc.kmeans_auto, kc.weighted_kmeans_energy_auto)
    kc.kmeans_auto = lambda x, c, weights=None, max_iter=100: \
        tkm.kmeans(None, x, c.shape[-2], weights=weights, init_centers=c,
                   max_iter=max_iter)
    kc.weighted_kmeans_energy_auto = tkm.weighted_kmeans_energy
    try:
        start()
        result["start_ms_plain"] = statistics.median(event_ms(start, 2))
    finally:
        kc.kmeans_auto, kc.weighted_kmeans_energy_auto = saved

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        start()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    result["start_profile_top"] = [
        {"name": e.key[:90], "device_ms": e.device_time_total / 1e3,
         "calls": e.count} for e in rows[:10]]
    text = json.dumps(result, default=float)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
