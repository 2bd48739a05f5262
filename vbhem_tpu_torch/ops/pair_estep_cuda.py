"""The fused pair E-step on the card: the wrapper of the hand-written CUDA
kernel ``csrc/pair_estep_fused.cu`` and the dispatch that the VBHEM
E-step calls.

:func:`pair_estep_fused_auto` is the counterpart of
``vbhem_tpu.ops.pair_estep_pallas.pair_estep_fused_auto``.  It validates
its arguments, then takes the plain PyTorch version
(:mod:`.pair_estep`) only for CPU tensors; for CUDA tensors it launches
the kernel or raises.  There is no fallback.

Restart trials ride as leading lane axes of the reduced-model arguments
([..., Kr, Sr] ...); the kernel folds L*Kr into its launch grid, so all
trials of a (K, S) cell go in one launch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .pair_estep import PairStats, expected_pair_ll_variational, pair_bwd_fwd

# Kernel launches made by :func:`pair_bwd_fwd_fused_cuda` and
# :func:`pair_estep_fused_auto` in this process.
LAUNCHES = 0

MAX_STATES = 8
MAX_DIM = 4
MAX_GRID_Y = 65535

_C_FN = {torch.float32: "vbhem_pair_estep_fused_f32",
         torch.float64: "vbhem_pair_estep_fused_f64"}
_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def validate(prior_b, trans_b, mean_b, cov_b, log_pi_r, log_a_r, m_r, w_r,
             v_r, lam_r, log_lam_r, tau: int):
    """Check what the kernel accepts; raise ValueError otherwise.

    Returns (kb, sb, d, lanes, kr, sr): ``lanes`` is the tuple of leading
    lane axes of the reduced-model arguments."""
    named = dict(prior_b=prior_b, trans_b=trans_b, mean_b=mean_b,
                 cov_b=cov_b, log_pi_r=log_pi_r, log_a_r=log_a_r, m_r=m_r,
                 w_r=w_r, v_r=v_r, lam_r=lam_r, log_lam_r=log_lam_r)
    for name, t in named.items():
        if not torch.is_tensor(t):
            raise ValueError(f"{name} must be a tensor, got {type(t)}")
    dtype, device = mean_b.dtype, mean_b.device
    if dtype not in _C_FN:
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    for name, t in named.items():
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mean_b.dim() != 3:
        raise ValueError(f"mean_b must be [Kb, Sb, D], got {tuple(mean_b.shape)}")
    kb, sb, d = mean_b.shape
    if log_pi_r.dim() < 2:
        raise ValueError(f"log_pi_r must be [..., Kr, Sr], got "
                         f"{tuple(log_pi_r.shape)}")
    kr, sr = log_pi_r.shape[-2:]
    lanes = tuple(log_pi_r.shape[:-2])
    want = dict(prior_b=(kb, sb), trans_b=(kb, sb, sb), cov_b=(kb, sb, d, d),
                log_a_r=lanes + (kr, sr, sr), m_r=lanes + (kr, sr, d),
                w_r=lanes + (kr, sr, d, d), v_r=lanes + (kr, sr),
                lam_r=lanes + (kr, sr), log_lam_r=lanes + (kr, sr))
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(named[name].shape)}, "
                             f"expected {shape}")
    if not (1 <= sb <= MAX_STATES and 1 <= sr <= MAX_STATES):
        raise ValueError(f"Sb={sb}, Sr={sr}: the kernel takes 1..{MAX_STATES}")
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"D={d}: the kernel takes 1..{MAX_DIM}")
    if int(tau) != tau or tau < 1:
        raise ValueError(f"tau={tau}: must be an integer >= 1")
    if kb < 1 or kr < 1:
        raise ValueError(f"empty bank: Kb={kb}, Kr={kr}")
    lkr = math.prod(lanes) * kr
    if lkr > MAX_GRID_Y:
        raise ValueError(f"L*Kr={lkr} exceeds the launch grid's {MAX_GRID_Y}")
    return kb, sb, d, lanes, kr, sr


def _launch(prior_b, trans_b, mean_b, cov_b, reduced, tau, kb, sb, lanes,
            kr, sr) -> PairStats:
    """One launch on arguments :func:`validate` has accepted."""
    global LAUNCHES
    dev, dt = mean_b.device, mean_b.dtype
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    fn = _build.c_function(_C_FN[dt], _ARGTYPES)
    lkr = math.prod(lanes) * kr
    d = mean_b.shape[-1]

    with torch.cuda.device(dev):
        # base bank with Kb last, so the kernel's loads coalesce
        base_t = (prior_b.t().contiguous(),
                  trans_b.permute(1, 2, 0).contiguous(),
                  mean_b.permute(1, 2, 0).contiguous(),
                  cov_b.permute(1, 2, 3, 0).contiguous())
        ll = torch.empty((lkr, kb), dtype=dt, device=dev)
        nu1 = torch.empty((lkr, sr, kb), dtype=dt, device=dev)
        sxi = torch.empty((lkr, sr, sr, kb), dtype=dt, device=dev)
        stn = torch.empty((lkr, sr, sb, kb), dtype=dt, device=dev)
        carry = torch.empty(((tau - 1) * sb * sr * lkr * kb,), dtype=dt,
                            device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[t.data_ptr() for t in base_t + tuple(reduced)],
                 ll.data_ptr(), nu1.data_ptr(), sxi.data_ptr(),
                 stn.data_ptr(), carry.data_ptr(),
                 kb, lkr, sb, sr, d, int(tau), stream)
        if err != 0:
            raise RuntimeError(f"pair_estep_fused kernel launch failed: "
                               f"cudaError {err}")
        LAUNCHES += 1

    # [L*Kr, F..., Kb] -> [..., Kb, Kr, F...]
    return PairStats(
        ll_elbo=ll.view(lanes + (kr, kb)).movedim(-1, -2),
        nu_1=nu1.view(lanes + (kr, sr, kb)).movedim(-1, -3),
        sum_xi=sxi.view(lanes + (kr, sr, sr, kb)).movedim(-1, -4),
        sum_t_nu=stn.view(lanes + (kr, sr, sb, kb)).movedim(-1, -4))


def pair_bwd_fwd_fused_cuda(prior_b, trans_b, mean_b, cov_b, log_pi_r,
                            log_a_r, m_r, w_r, v_r, lam_r, log_lam_r,
                            tau: int) -> PairStats:
    """Fused pair E-step (E3logN + backward/forward recursions) in one
    launch of the CUDA kernel.  Arguments and results as
    :func:`pair_estep_fused_auto`; every tensor must be on one CUDA
    device.  The results are views of the kernel's Kb-last buffers."""
    kb, sb, _, lanes, kr, sr = validate(
        prior_b, trans_b, mean_b, cov_b, log_pi_r, log_a_r, m_r, w_r, v_r,
        lam_r, log_lam_r, tau)
    return _launch(prior_b, trans_b, mean_b, cov_b,
                   (log_pi_r, log_a_r, m_r, w_r, v_r, lam_r, log_lam_r),
                   tau, kb, sb, lanes, kr, sr)


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
