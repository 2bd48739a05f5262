"""The least time an H100 could take for a kernel's work: the operations
and bytes each kernel needs, counted from its shapes, over the card's
published peaks.  The arithmetic of the program's on-card check script
(``bound``, ``pair_sfu``, ``b1_flop``, ``b1_bound``, ``b1_bound_live``,
``b2_fused_bound``), restated on shapes alone so that it needs neither the
program nor a card.

Peaks of one H100 SXM, from NVIDIA's published specifications: device
memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s, float64
34 TFLOP/s.  float32 special functions (exp, log) run on the SFUs: 16
results per clock per SM (the arithmetic throughput table for compute
capability 9.0) at the 1.98 GHz boost clock over the card's 132 SMs.
float64 ones have no SFU instruction and are counted as 16 flops each (a
range reduction and a short polynomial, fewer than any correctly
rounded exp or log takes), so the bound stays a floor.
"""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12
F64_FLOP_PER_SPECIAL = 16
SFU_PER_SM_PER_CLOCK = 16
BOOST_HZ = 1.98e9
SMS = 132


def bound(n_bytes: float, n_sfu: float, n_flop: float, itemsize: int = 4,
          sms: int = SMS) -> dict:
    """The larger of the bytes time and the operations time: in float32
    the special functions on the SFUs, the rest at the float32 rate; in
    float64 both at the float64 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    if itemsize == 8:
        t_ops = (n_sfu * F64_FLOP_PER_SPECIAL + n_flop) / F64_FLOP_PER_S
    else:
        t_ops = max(n_sfu / (sms * SFU_PER_SM_PER_CLOCK * BOOST_HZ),
                    n_flop / F32_FLOP_PER_S)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "sfu_ops": n_sfu, "flops": n_flop}


def pair_sfu(pairs: int, sb: int, sr: int, tau: int) -> int:
    """Special functions of the pair recursion: per backward step Sb*Sr
    exp and Sr*Sb log; the termination Sb*Sr exp and Sb log; none in the
    forward pass."""
    return pairs * ((tau - 1) * 2 * sb * sr + sb * (sr + 1))


def b1_flop(pairs: int, sb: int, sr: int, d: int, tau: int) -> int:
    """B1's flops: the recursion's per step and E3logN's."""
    return pairs * ((tau - 1) * (5 * sr * sr * sb + 4 * sr * sb * sb)
                    + sb * sr * (4 * d * d + 4))


def b1_bytes(kb: int, lkr: int, sb: int, sr: int, d: int,
             itemsize: int) -> int:
    """B1's bytes: the base bank and the reduced models read once, the
    four outputs written once."""
    pairs = kb * lkr
    return itemsize * (kb * (sb + sb * sb + sb * d + sb * d * d)
                       + lkr * sr * (sr + d + d * d + 4)
                       + pairs * (1 + sr + sr * sr + sr * sb))


def b1_bound(kb: int, lkr: int, sb: int, sr: int, d: int, tau: int,
             itemsize: int) -> dict:
    """B1 at a launch of ``lkr`` reduced models against a bank of ``kb``."""
    pairs = kb * lkr
    return bound(b1_bytes(kb, lkr, sb, sr, d, itemsize),
                 pair_sfu(pairs, sb, sr, tau), b1_flop(pairs, sb, sr, d, tau),
                 itemsize)


def b1_bound_live(kb: int, lane_cells, kmax: int, sb: int, smax: int,
                  d: int, tau: int, itemsize: int) -> dict:
    """B1 at a padded grid launch, each lane's Kb * Kmax pairs counted at
    its own cell's S (the states not masked); bytes at the padded layout."""
    pairs = kb * kmax
    sfu = sum(pair_sfu(pairs, sb, s, tau) for _, s in lane_cells)
    flop = sum(b1_flop(pairs, sb, s, d, tau) for _, s in lane_cells)
    return bound(b1_bytes(kb, len(lane_cells) * kmax, sb, smax, d, itemsize),
                 sfu, flop, itemsize)


def b2_fused_bound(lanes: tuple, n: int, t: int, k: int, d: int,
                   itemsize: int, valid_steps: int) -> dict:
    """B2's fused E-step over lanes (subjects, restarts) of ``n``
    sequences of ``t`` steps: x read once per subject (shared by its
    restarts), the emission constants, scores and the mask rows (T bits a
    sequence, one row per subject) read once; the masked log_rho, gamma,
    xi_sum and phi_norm written once.  ``valid_steps`` counts the steps
    of every lane.  Operations: K exp and one log per valid step, the exp
    of the scores, 10 K^2 flops a valid step and the emission's
    K (D + 2 D^2 + 1)."""
    n_lanes = math.prod(lanes)
    n_seq = n_lanes * n
    subjects = lanes[0]
    log_pz1, log_trans = n_lanes * k, n_lanes * k * k
    emis = n_lanes * k * (1 + d + d * d)
    n_bytes = (itemsize * (subjects * n * t * d + emis + log_pz1 + log_trans
                           + 2 * n_seq * t * k + n_seq * (k * k + 1))
               + subjects * n * -(-t // 8))
    sfu = valid_steps * (k + 1) + log_pz1 + log_trans
    flop = valid_steps * (10 * k * k + k * (d + 2 * d * d + 1))
    return bound(n_bytes, sfu, flop, itemsize)
