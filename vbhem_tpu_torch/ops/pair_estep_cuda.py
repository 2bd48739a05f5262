"""The pair E-step on the card: the wrappers of the hand-written CUDA
kernels ``csrc/pair_estep_fused.cu`` (B1) and ``csrc/pair_bwd_fwd.cu``
(B3), and the dispatches that the VBHEM, VHEM and DIC E-steps call.

:func:`pair_estep_fused_auto` is the counterpart of
``vbhem_tpu.ops.pair_estep_pallas.pair_estep_fused_auto`` (E3logN and the
recursion in one kernel); :func:`pair_bwd_fwd_auto` the counterpart of
``pair_bwd_fwd_auto`` there (the recursion on a precomputed emission
matrix ``ell``).  Each validates its arguments, then takes the plain
PyTorch version (:mod:`.pair_estep`) only for CPU tensors; for CUDA
tensors it launches its kernel or raises.  There is no fallback.

Restart trials ride as leading lane axes of the reduced-model arguments
([..., Kr, Sr] ...); the kernels fold L*Kr into their launch grid, so all
trials of a (K, S) cell go in one launch.

Both kernels keep the recursion's per-step state (Sb*Sr values a step and
pair) where :func:`design` puts it for the shape: in shared memory for all
tau-1 steps ('resident') where a block holds it at enough pairs per SM;
else, in float32, in shared memory as segments of about sqrt(tau) steps
and the carry at each segment's start, each segment's steps recomputed in
the forward pass ('checkpointed'); else in a device-memory scratch
('scratch').

Sizes: Sb and Sr up to :data:`MAX_STATES` run bodies that keep a pair's
vectors in registers; above it, each kernel's wide body keeps them in a
workspace after the scratch (the scratch design only) and its reduced
model in shared memory, so it takes what fits there
(:func:`wide_smem_bytes`) and in the card's memory.  B1 forms E3logN in
registers for D up to :data:`MAX_DIM`; for wider data
:func:`pair_estep_fused_auto` forms it in PyTorch and launches B3.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from . import _build
from .pair_estep import PairStats, expected_pair_ll_variational, pair_bwd_fwd

# Kernel launches made in this process: B1 by pair_bwd_fwd_fused_cuda and
# pair_estep_fused_auto, B3 by pair_bwd_fwd_cuda and pair_bwd_fwd_auto;
# and each kernel's launches by design.
LAUNCHES = 0
BWD_FWD_LAUNCHES = 0
DESIGNS = ("resident", "scratch", "checkpointed")   # the kernels' codes
DESIGN_LAUNCHES = {"B1": dict.fromkeys(DESIGNS, 0),
                   "B3": dict.fromkeys(DESIGNS, 0)}

MAX_STATES = 8   # the register bodies' states; above, the wide bodies
MAX_DIM = 4      # B1's emission dims; above, E3logN in PyTorch and B3
MAX_GRID_Y = 65535

# Shared memory of one sm_90 SM (228 KB), of which each resident block
# takes 1 KB besides its own; a block's static shared memory (its staged
# reduced model), as ptxas reports it for the specialized bodies (at most
# 192 B); the dynamic shared memory a block may take, leaving 3 KB of the
# 227 KB for the static (2.6 KB in the float64 generic B1); the most blocks
# and threads an SM holds.
SMEM_PER_SM = 233472
SMEM_RESERVED_PER_BLOCK = 1024
STATIC_SMEM = 256
SMEM_DYNAMIC_MAX = 232448 - 3072
BLOCKS_PER_SM_MAX = 32
THREADS_PER_SM_MAX = 2048
THREAD_CHOICES = (128, 64, 32)
SMS = 132   # the H100 SXM's SMs, where the wrapper cannot ask the card
# Pairs per SM the resident design must hold (or all of the launch's):
# on an H100, at the pipeline's launch (Sb = Sr = 2, tau = 50), it ran
# faster holding 256 than the scratch and than designs that held up to
# about 700 by recomputing steps (PERF.md §6).
RESIDENT_PAIRS_PER_SM = 256
# Pairs per SM the checkpointed design must hold (or all of the launch's)
# to be taken over the scratch: a warp per scheduler of the SM's four.  Its
# shared memory holds 416 at the padded grid's launch (Sb=2, Sr=5, tau=50,
# float32, 520 B a pair).  float32 only (design_of).
CHECKPOINTED_PAIRS_PER_SM = 128

_C_FN = {torch.float32: "vbhem_pair_estep_fused_f32",
         torch.float64: "vbhem_pair_estep_fused_f64"}
_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_BF_C_FN = {torch.float32: "vbhem_pair_bwd_fwd_f32",
            torch.float64: "vbhem_pair_bwd_fwd_f64"}
_BF_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


class PairDesign(NamedTuple):
    """Where B1 and B3 keep the recursion's per-step state: ``kind`` one of
    :data:`DESIGNS`; ``threads`` pairs per block; ``smem_bytes`` of dynamic
    shared memory per block (0 for the scratch); ``seg`` steps a segment
    (the checkpointed design; 0 for the others)."""
    kind: str
    threads: int
    smem_bytes: int
    seg: int = 0


def checkpointed_slots(tau: int, seg: int) -> int:
    """Steps' room a pair of the checkpointed design takes
    (``checkpointed_slots`` in ``csrc/pair_recursion.cuh``): a segment of
    ``seg`` steps, the carries at the start of segments 1 .. nseg-2, and,
    where a segment is recomputed, the emission matrix it reads."""
    ns = tau - 1
    if ns < 1 or seg < 1:
        return 0
    length = min(seg, ns)
    nseg = -(-ns // length)
    return length + max(nseg - 2, 0) + (nseg > 1)


def checkpoint_segment(tau: int) -> int:
    """The segment length of the checkpointed design at ``tau``: the one
    that needs the fewest slots (:func:`checkpointed_slots`), among equals
    the longest; about sqrt(tau - 1)."""
    if tau < 2:
        return 1
    return min(range(tau - 1, 0, -1),
               key=lambda seg: checkpointed_slots(tau, seg))


def pairs_per_sm(threads: int, smem_bytes: int) -> int:
    """Pairs an SM holds at once with blocks of ``threads`` pairs and
    ``smem_bytes`` of dynamic shared memory each (registers aside)."""
    blocks = SMEM_PER_SM // (smem_bytes + STATIC_SMEM
                             + SMEM_RESERVED_PER_BLOCK)
    return min(blocks, BLOCKS_PER_SM_MAX,
               THREADS_PER_SM_MAX // threads) * threads


def design_of(kind: str, sb: int, sr: int, tau: int,
              itemsize: int) -> Optional[PairDesign]:
    """Design ``kind`` at a shape.  The resident and the checkpointed
    designs take the block size that holds the most pairs per SM, among
    equals the smallest (at the pipeline's launch blocks of 32 ran 5%
    faster than blocks of 128 holding as many pairs, PERF.md §6; at a
    small Kb, as the hyp objective's 40, fewer threads idle); None where
    no block of 32 pairs holds the design's state (every step's, or the
    checkpointed design's segment and carries), and for the checkpointed
    design in float64, which the kernels do not build (its recomputed
    segments spill the float64 registers: csrc/pair_recursion.cuh)."""
    if kind == "scratch":
        return PairDesign("scratch", THREAD_CHOICES[0], 0)
    if kind not in DESIGNS:
        raise ValueError(f"unknown design {kind!r}")
    if is_wide(sb, sr) or (kind == "checkpointed" and itemsize != 4):
        return None
    seg = checkpoint_segment(tau) if kind == "checkpointed" else 0
    slots = checkpointed_slots(tau, seg) if seg else tau - 1
    best = None
    for threads in sorted(THREAD_CHOICES):
        smem = threads * slots * sb * sr * itemsize
        if smem > SMEM_DYNAMIC_MAX:
            continue
        held = pairs_per_sm(threads, smem)
        if best is None or held > pairs_per_sm(best.threads,
                                               best.smem_bytes):
            best = PairDesign(kind, threads, smem, seg)
    return best


def is_wide(sb: int, sr: int) -> bool:
    """Whether Sb, Sr take the kernels' wide body."""
    return sb > MAX_STATES or sr > MAX_STATES


def wide_work_values(sb: int, sr: int, fused: bool) -> int:
    """Values per pair of the wide body's workspace after the scratch's
    states (``wide_work_values`` in ``csrc/pair_recursion.cuh``; B1 adds
    E3logN, Sb*Sr)."""
    return 7 * sb * sr + 2 * sr * sr + 2 * sb + sr + (sb * sr if fused
                                                        else 0)


def wide_smem_bytes(sr: int, d: int, itemsize: int) -> int:
    """Dynamic shared memory of a wide block: the reduced model (log_pi,
    log_a, exp(log_a) and the row maxima) and, for B1 (``d`` > 0), its
    emission constants."""
    n = 2 * sr * sr + 2 * sr
    if d:
        n += sr * d + sr * d * d + 2 * sr
    return n * itemsize


def design(sb: int, sr: int, tau: int, itemsize: int, pairs: int,
           sms: int = SMS) -> PairDesign:
    """The design B1 and B3 take for Sb, Sr, tau, ``itemsize`` and
    ``pairs`` = Kb * L*Kr on a card of ``sms`` SMs.

    Each thread runs one pair's serial recursion, whose latency the pairs
    in flight per SM hide.  The resident design keeps every step's state
    in shared memory, which caps the pairs an SM holds: it is taken where
    it holds RESIDENT_PAIRS_PER_SM pairs per SM, or all of the launch's.
    Else, in float32, the checkpointed design, which keeps about
    2 sqrt(tau) steps' room a pair for one more backward pass of exps,
    where it holds CHECKPOINTED_PAIRS_PER_SM pairs per SM (or all of the
    launch's).  Else
    the scratch, whose pairs in flight only registers limit, at the cost
    of writing and reading every step's state in device memory.  The wide
    body (:func:`is_wide`) has only the scratch design."""
    per_sm = -(-pairs // sms)
    for kind, need in (("resident", RESIDENT_PAIRS_PER_SM),
                       ("checkpointed", CHECKPOINTED_PAIRS_PER_SM)):
        des = design_of(kind, sb, sr, tau, itemsize)
        if des is not None and pairs_per_sm(
                des.threads, des.smem_bytes) >= min(need, per_sm):
            return des
    return design_of("scratch", sb, sr, tau, itemsize)


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check_tensors(named: dict, dtype, device, contiguous=()):
    """Every tensor of ``named`` has ``dtype`` and ``device``; those named
    in ``contiguous`` are contiguous."""
    for name, t in named.items():
        if not torch.is_tensor(t):
            raise ValueError(f"{name} must be a tensor, got {type(t)}")
    if dtype not in _C_FN:
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    for name, t in named.items():
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if name in contiguous and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_shapes(named: dict, want: dict):
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(named[name].shape)}, "
                             f"expected {shape}")


def _check_ranges(kb, sb, kr, sr, lanes, tau):
    if sb < 1 or sr < 1:
        raise ValueError(f"Sb={sb}, Sr={sr}: no states")
    if int(tau) != tau or tau < 1:
        raise ValueError(f"tau={tau}: must be an integer >= 1")
    if kb < 1 or kr < 1:
        raise ValueError(f"empty bank: Kb={kb}, Kr={kr}")
    lkr = math.prod(lanes) * kr
    if lkr > MAX_GRID_Y:
        raise ValueError(f"L*Kr={lkr} exceeds the launch grid's {MAX_GRID_Y}")


def validate(prior_b, trans_b, mean_b, cov_b, log_pi_r, log_a_r, m_r, w_r,
             v_r, lam_r, log_lam_r, tau: int):
    """Check what kernel B1 accepts; raise ValueError otherwise.

    Returns (kb, sb, d, lanes, kr, sr): ``lanes`` is the tuple of leading
    lane axes of the reduced-model arguments."""
    named = dict(prior_b=prior_b, trans_b=trans_b, mean_b=mean_b,
                 cov_b=cov_b, log_pi_r=log_pi_r, log_a_r=log_a_r, m_r=m_r,
                 w_r=w_r, v_r=v_r, lam_r=lam_r, log_lam_r=log_lam_r)
    _check_tensors(named, getattr(mean_b, "dtype", None),
                   getattr(mean_b, "device", None), contiguous=named)
    if mean_b.dim() != 3:
        raise ValueError(f"mean_b must be [Kb, Sb, D], got {tuple(mean_b.shape)}")
    kb, sb, d = mean_b.shape
    if log_pi_r.dim() < 2:
        raise ValueError(f"log_pi_r must be [..., Kr, Sr], got "
                         f"{tuple(log_pi_r.shape)}")
    kr, sr = log_pi_r.shape[-2:]
    lanes = tuple(log_pi_r.shape[:-2])
    _check_shapes(named, dict(
        prior_b=(kb, sb), trans_b=(kb, sb, sb), cov_b=(kb, sb, d, d),
        log_a_r=lanes + (kr, sr, sr), m_r=lanes + (kr, sr, d),
        w_r=lanes + (kr, sr, d, d), v_r=lanes + (kr, sr),
        lam_r=lanes + (kr, sr), log_lam_r=lanes + (kr, sr)))
    _check_ranges(kb, sb, kr, sr, lanes, tau)
    if d < 1:
        raise ValueError(f"D={d}: no dimensions")
    return kb, sb, d, lanes, kr, sr


def _outputs(dev, dt, lkr, kb, sb, sr):
    """The kernels' Kb-last outputs (ll, nu1, sxi, stn)."""
    return (torch.empty((lkr, kb), dtype=dt, device=dev),
            torch.empty((lkr, sr, kb), dtype=dt, device=dev),
            torch.empty((lkr, sr, sr, kb), dtype=dt, device=dev),
            torch.empty((lkr, sr, sb, kb), dtype=dt, device=dev))


def _state_args(des: PairDesign, dev, dt, lkr, kb, sb, sr, tau, work=0):
    """The design's arguments of the C interface after the outputs: the
    scratch [tau-1, Sb*Sr, L*Kr, Kb] followed by ``work`` values a pair
    (the wide body's workspace), allocated for the scratch design only,
    else None; and, after the shape, the design's code, block size, shared
    memory and segment length.  Returns (scratch tensor or None, pointer,
    tail)."""
    if des.kind not in DESIGNS:
        raise ValueError(f"unknown design {des.kind!r}")
    scratch = None
    if des.kind == "scratch":
        scratch = torch.empty((((tau - 1) * sb * sr + work) * lkr * kb,),
                              dtype=dt, device=dev)
    ptr = None if scratch is None else scratch.data_ptr()
    tail = (DESIGNS.index(des.kind), des.threads, des.smem_bytes, des.seg)
    return scratch, ptr, tail


def _unfold(ll, nu1, sxi, stn, lanes, kr, kb, sb, sr) -> PairStats:
    """[L*Kr, F..., Kb] -> [..., Kb, Kr, F...] views."""
    return PairStats(
        ll_elbo=ll.view(lanes + (kr, kb)).movedim(-1, -2),
        nu_1=nu1.view(lanes + (kr, sr, kb)).movedim(-1, -3),
        sum_xi=sxi.view(lanes + (kr, sr, sr, kb)).movedim(-1, -4),
        sum_t_nu=stn.view(lanes + (kr, sr, sb, kb)).movedim(-1, -4))


def _wide_checks(des, sb, sr, d, itemsize):
    """The wide body takes the scratch design and a reduced model that
    fits a block's shared memory."""
    if des.kind != "scratch":
        raise ValueError(f"Sb={sb}, Sr={sr}: the wide body has only the "
                         f"scratch design, not {des.kind!r}")
    need = wide_smem_bytes(sr, d, itemsize)
    if need > SMEM_DYNAMIC_MAX:
        raise ValueError(f"Sr={sr}: the reduced model takes {need} bytes of "
                         f"shared memory, more than a block's "
                         f"{SMEM_DYNAMIC_MAX}")


def _launch(prior_b, trans_b, mean_b, cov_b, reduced, tau, kb, sb, lanes,
            kr, sr, des: Optional[PairDesign] = None) -> PairStats:
    """One launch on arguments :func:`validate` has accepted, in ``des``
    or the design :func:`design` picks.  For D above MAX_DIM, E3logN is
    formed in PyTorch and B3 launched on it (counted as B3's launch)."""
    global LAUNCHES
    dev, dt = mean_b.device, mean_b.dtype
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    d = mean_b.shape[-1]
    if d > MAX_DIM:
        log_pi_r, log_a_r, m_r, w_r, v_r, lam_r, log_lam_r = reduced
        ell = expected_pair_ll_variational(mean_b, cov_b, m_r, w_r, v_r,
                                           lam_r, log_lam_r)
        return _launch_bwd_fwd(prior_b, trans_b, log_pi_r, log_a_r, ell,
                               tau, kb, sb, lanes, kr, sr, des)
    fn = _build.c_function(_C_FN[dt], _ARGTYPES)
    lkr = math.prod(lanes) * kr
    des = des or design(sb, sr, tau, mean_b.element_size(), kb * lkr,
                        _sms(dev))
    wide = is_wide(sb, sr)
    if wide:
        _wide_checks(des, sb, sr, d, mean_b.element_size())

    with torch.cuda.device(dev):
        # base bank with Kb last, so the kernel's loads coalesce
        base_t = (prior_b.t().contiguous(),
                  trans_b.permute(1, 2, 0).contiguous(),
                  mean_b.permute(1, 2, 0).contiguous(),
                  cov_b.permute(1, 2, 3, 0).contiguous())
        outs = _outputs(dev, dt, lkr, kb, sb, sr)
        scratch, ptr, tail = _state_args(
            des, dev, dt, lkr, kb, sb, sr, tau,
            wide_work_values(sb, sr, True) if wide else 0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[t.data_ptr() for t in base_t + tuple(reduced) + outs],
                 ptr, kb, lkr, sb, sr, d, int(tau), *tail, stream)
        if err != 0:
            raise RuntimeError(f"pair_estep_fused kernel launch failed "
                               f"({des}): cudaError {err}")
        LAUNCHES += 1
        DESIGN_LAUNCHES["B1"][des.kind] += 1
        del scratch   # freed on the stream, after the kernel
    return _unfold(*outs, lanes, kr, kb, sb, sr)


def pair_bwd_fwd_fused_cuda(prior_b, trans_b, mean_b, cov_b, log_pi_r,
                            log_a_r, m_r, w_r, v_r, lam_r, log_lam_r,
                            tau: int,
                            des: Optional[PairDesign] = None) -> PairStats:
    """Fused pair E-step (E3logN + backward/forward recursions) in one
    launch of the CUDA kernel.  Arguments and results as
    :func:`pair_estep_fused_auto`; every tensor must be on one CUDA
    device.  ``des`` launches that design instead of :func:`design`'s
    choice (to check and time each design).  The results are views of the
    kernel's Kb-last buffers."""
    kb, sb, _, lanes, kr, sr = validate(
        prior_b, trans_b, mean_b, cov_b, log_pi_r, log_a_r, m_r, w_r, v_r,
        lam_r, log_lam_r, tau)
    return _launch(prior_b, trans_b, mean_b, cov_b,
                   (log_pi_r, log_a_r, m_r, w_r, v_r, lam_r, log_lam_r),
                   tau, kb, sb, lanes, kr, sr, des)


def pair_estep_fused_auto(prior_b, trans_b, mean_b, cov_b, log_pi_r,
                          log_a_r, m_r, w_r, v_r, lam_r, log_lam_r,
                          tau: int) -> PairStats:
    """The fused pair E-step: E3logN (variational flavor) + backward /
    forward recursions over tau virtual steps, for every (base i,
    reduced j) pair.

    prior_b [Kb,Sb], trans_b [Kb,Sb,Sb], mean_b [Kb,Sb,D],
    cov_b [Kb,Sb,D,D]; log_pi_r [..., Kr,Sr], log_a_r [..., Kr,Sr,Sr],
    m_r [..., Kr,Sr,D], w_r [..., Kr,Sr,D,D], v_r / lam_r / log_lam_r
    [..., Kr,Sr]; all float32 or all float64, contiguous, on one device.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise)."""
    kb, sb, _, lanes, kr, sr = validate(
        prior_b, trans_b, mean_b, cov_b, log_pi_r, log_a_r, m_r, w_r, v_r,
        lam_r, log_lam_r, tau)
    if mean_b.device.type == "cpu":
        ell = expected_pair_ll_variational(mean_b, cov_b, m_r, w_r, v_r,
                                           lam_r, log_lam_r)
        return pair_bwd_fwd(prior_b, trans_b, log_pi_r, log_a_r, ell, tau)
    return _launch(prior_b, trans_b, mean_b, cov_b,
                   (log_pi_r, log_a_r, m_r, w_r, v_r, lam_r, log_lam_r),
                   tau, kb, sb, lanes, kr, sr)


# ---------------------------------------------------------------------------
# B3: the recursion on a precomputed emission matrix (VHEM, DIC)
# ---------------------------------------------------------------------------

def validate_bwd_fwd(prior_b, trans_b, log_pi_r, log_a_r, ell, tau: int):
    """Check what kernel B3 accepts; raise ValueError otherwise.  The
    tensors may have any strides: the wrapper lays them out for the
    kernel.

    Returns (kb, sb, lanes, kr, sr)."""
    named = dict(prior_b=prior_b, trans_b=trans_b, log_pi_r=log_pi_r,
                 log_a_r=log_a_r, ell=ell)
    _check_tensors(named, getattr(ell, "dtype", None),
                   getattr(ell, "device", None))
    if prior_b.dim() != 2:
        raise ValueError(f"prior_b must be [Kb, Sb], got "
                         f"{tuple(prior_b.shape)}")
    kb, sb = prior_b.shape
    if log_pi_r.dim() < 2:
        raise ValueError(f"log_pi_r must be [..., Kr, Sr], got "
                         f"{tuple(log_pi_r.shape)}")
    kr, sr = log_pi_r.shape[-2:]
    lanes = tuple(log_pi_r.shape[:-2])
    _check_shapes(named, dict(trans_b=(kb, sb, sb),
                              log_a_r=lanes + (kr, sr, sr),
                              ell=lanes + (kb, kr, sb, sr)))
    _check_ranges(kb, sb, kr, sr, lanes, tau)
    return kb, sb, lanes, kr, sr


def _launch_bwd_fwd(prior_b, trans_b, log_pi_r, log_a_r, ell, tau, kb, sb,
                    lanes, kr, sr,
                    des: Optional[PairDesign] = None) -> PairStats:
    """One launch of B3 on arguments :func:`validate_bwd_fwd` has
    accepted, in ``des`` or the design :func:`design` picks."""
    global BWD_FWD_LAUNCHES
    dev, dt = ell.device, ell.dtype
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    fn = _build.c_function(_BF_C_FN[dt], _BF_ARGTYPES)
    lkr = math.prod(lanes) * kr
    des = des or design(sb, sr, tau, ell.element_size(), kb * lkr,
                        _sms(dev))
    wide = is_wide(sb, sr)
    if wide:
        _wide_checks(des, sb, sr, 0, ell.element_size())

    with torch.cuda.device(dev):
        # [..., Kb, Kr, Sb, Sr] -> [L*Kr, Sb, Sr, Kb]: no copy when ell is
        # a view of a Kb-last buffer, as expected_pair_ll_point returns
        ell_t = ell.movedim(-4, -1).contiguous()
        ins = (ell_t, prior_b.t().contiguous(),
               trans_b.permute(1, 2, 0).contiguous(), log_pi_r.contiguous(),
               log_a_r.contiguous())
        outs = _outputs(dev, dt, lkr, kb, sb, sr)
        scratch, ptr, tail = _state_args(
            des, dev, dt, lkr, kb, sb, sr, tau,
            wide_work_values(sb, sr, False) if wide else 0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[t.data_ptr() for t in ins + outs], ptr, kb, lkr, sb, sr,
                 int(tau), *tail, stream)
        if err != 0:
            raise RuntimeError(f"pair_bwd_fwd kernel launch failed "
                               f"({des}): cudaError {err}")
        BWD_FWD_LAUNCHES += 1
        DESIGN_LAUNCHES["B3"][des.kind] += 1
        del scratch   # freed on the stream, after the kernel
    return _unfold(*outs, lanes, kr, kb, sb, sr)


def pair_bwd_fwd_cuda(prior_b, trans_b, log_pi_r, log_a_r, ell, tau: int,
                      des: Optional[PairDesign] = None) -> PairStats:
    """The recursion on a precomputed emission matrix in one launch of
    kernel B3.  Arguments and results as :func:`pair_bwd_fwd_auto`; every
    tensor must be on one CUDA device.  ``des`` launches that design
    instead of :func:`design`'s choice.  The results are views of the
    kernel's Kb-last buffers."""
    kb, sb, lanes, kr, sr = validate_bwd_fwd(prior_b, trans_b, log_pi_r,
                                             log_a_r, ell, tau)
    return _launch_bwd_fwd(prior_b, trans_b, log_pi_r, log_a_r, ell, tau,
                           kb, sb, lanes, kr, sr, des)


def pair_bwd_fwd_auto(prior_b, trans_b, log_pi_r, log_a_r, ell,
                      tau: int) -> PairStats:
    """Backward + forward recursions over tau virtual steps for every
    (base i, reduced j) pair, on a precomputed emission matrix.

    prior_b [Kb,Sb], trans_b [Kb,Sb,Sb] (zero-padded rows for ragged Sb);
    log_pi_r [..., Kr,Sr], log_a_r [..., Kr,Sr,Sr] (entries may be -inf);
    ell [..., Kb,Kr,Sb,Sr]; all float32 or all float64, on one device.

    CPU tensors take the plain version; CUDA tensors launch kernel B3 (or
    raise)."""
    kb, sb, lanes, kr, sr = validate_bwd_fwd(prior_b, trans_b, log_pi_r,
                                             log_a_r, ell, tau)
    if ell.device.type == "cpu":
        return pair_bwd_fwd(prior_b, trans_b, log_pi_r, log_a_r, ell, tau)
    return _launch_bwd_fwd(prior_b, trans_b, log_pi_r, log_a_r, ell, tau,
                           kb, sb, lanes, kr, sr)
