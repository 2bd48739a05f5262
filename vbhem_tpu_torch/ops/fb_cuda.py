"""The VBEM forward-backward on the card: the wrapper of the hand-written
CUDA kernel ``csrc/fb.cu`` (kernel B2) and the dispatch that the VBEM
E-step calls.

:func:`forward_backward_auto` is the counterpart of
``vbhem_tpu.ops.fb_pallas.forward_backward_auto``.  It validates its
arguments, then takes the plain PyTorch version (:mod:`.fb`) only for CPU
tensors; for CUDA tensors it launches the kernel or raises.  There is no
fallback.

Restart lanes ride as leading axes of ``log_rho [..., N, T, K]``; the
kernel reads shared scores per lane and a mask shared by the restarts of
a subject without expanding either, so all lanes go in one launch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .fb import FBStats, forward_backward

# Kernel launches made by :func:`forward_backward_cuda` and
# :func:`forward_backward_auto` in this process.
LAUNCHES = 0

MAX_STATES = 8

_C_FN = {torch.float32: "vbhem_fb_f32", torch.float64: "vbhem_fb_f64"}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong]
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _broadcasts(shape, target) -> bool:
    """Whether ``shape`` broadcasts to ``target`` without changing it."""
    if len(shape) > len(target):
        return False
    return all(a in (1, b) for a, b in zip(shape[::-1], target[::-1]))


def validate(log_pz1, log_trans, log_rho, mask):
    """Check what the kernel accepts; raise ValueError otherwise.

    Returns (lanes, n, t, k, pz1_per_seq, trans_per_seq): ``lanes`` is the
    tuple of leading lane axes of ``log_rho``."""
    named = dict(log_pz1=log_pz1, log_trans=log_trans, log_rho=log_rho,
                 mask=mask)
    for name, t in named.items():
        if not torch.is_tensor(t):
            raise ValueError(f"{name} must be a tensor, got {type(t)}")
    dtype, device = log_rho.dtype, log_rho.device
    if dtype not in _C_FN:
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    for name, t in named.items():
        if name != "mask" and t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
    if mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool, got {mask.dtype}")
    if not log_rho.is_contiguous():
        raise ValueError("log_rho must be contiguous")
    if log_rho.dim() < 3:
        raise ValueError(f"log_rho must be [..., N, T, K], got "
                         f"{tuple(log_rho.shape)}")
    *lanes, n, t_max, k = log_rho.shape
    lanes = tuple(lanes)
    if not 1 <= k <= MAX_STATES:
        raise ValueError(f"K={k}: the kernel takes 1..{MAX_STATES}")
    if t_max < 1 or n < 1 or math.prod(lanes) < 1:
        raise ValueError(f"empty batch: lanes={lanes}, N={n}, T={t_max}")
    pz1_per_seq = log_pz1.dim() == log_rho.dim() - 1
    trans_per_seq = log_trans.dim() == log_rho.dim()
    want = dict(log_pz1=lanes + ((n, k) if pz1_per_seq else (k,)),
                log_trans=lanes + ((n, k, k) if trans_per_seq else (k, k)),
                mask=lanes + (n, t_max))
    for name, shape in want.items():
        if not _broadcasts(named[name].shape, shape):
            raise ValueError(f"{name} has shape {tuple(named[name].shape)}, "
                             f"expected {shape} or a shape that broadcasts "
                             f"to it")
    # the recursion starts from step 0 (fb_pallas.py:73 assumes it)
    if not bool(torch.all(mask[..., 0])):
        raise ValueError("every sequence must have step 0 unmasked "
                         "(mask[..., 0] all true): an empty sequence has no "
                         "forward recursion")
    return lanes, n, t_max, k, pz1_per_seq, trans_per_seq


def _mask_lanes(mask, lanes):
    """The mask as a contiguous uint8 [Bm, N, T] and the number of
    consecutive lanes that share each of its rows: a mask whose lane axes
    are a prefix of ``lanes`` followed by ones (one row per subject, shared
    by its restarts) is not expanded."""
    ml = mask.shape[:-2]
    ml = (1,) * (len(lanes) - len(ml)) + tuple(ml)
    j = len(lanes)
    while j > 0 and ml[j - 1] == 1:
        j -= 1
    if ml[:j] == lanes[:j]:
        rep = math.prod(lanes[j:])
        rows = math.prod(lanes[:j])
        m = mask.reshape((rows,) + tuple(mask.shape[-2:]))
    else:
        rep = 1
        m = torch.broadcast_to(mask, lanes + tuple(mask.shape[-2:]))
        m = m.reshape((-1,) + tuple(mask.shape[-2:]))
    return m.contiguous().view(torch.uint8), rep


def _launch(log_pz1, log_trans, log_rho, mask, lanes, n, t_max, k,
            pz1_per_seq, trans_per_seq) -> FBStats:
    """One launch on arguments :func:`validate` has accepted."""
    global LAUNCHES
    dev, dt = log_rho.device, log_rho.dtype
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    fn = _build.c_function(_C_FN[dt], _ARGTYPES)
    n_seq = math.prod(lanes) * n
    pz1 = torch.broadcast_to(
        log_pz1, lanes + ((n, k) if pz1_per_seq else (k,))).contiguous()
    trans = torch.broadcast_to(
        log_trans, lanes + ((n, k, k) if trans_per_seq else (k, k))
    ).contiguous()
    m8, rep = _mask_lanes(mask, lanes)

    with torch.cuda.device(dev):
        gamma = torch.empty_like(log_rho)
        xi = torch.empty(lanes + (n, k, k), dtype=dt, device=dev)
        phi = torch.empty(lanes + (n,), dtype=dt, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(log_rho.data_ptr(), m8.data_ptr(), pz1.data_ptr(),
                 trans.data_ptr(), gamma.data_ptr(), xi.data_ptr(),
                 phi.data_ptr(), n_seq, n, t_max, k, rep, int(pz1_per_seq),
                 int(trans_per_seq), stream)
        if err != 0:
            raise RuntimeError(f"fb kernel launch failed: cudaError {err}")
        LAUNCHES += 1
    maskf = mask.to(dt)
    return FBStats(log_rho=log_rho * maskf[..., None], gamma=gamma,
                   xi_sum=xi, phi_norm=phi)


def forward_backward_cuda(log_pz1, log_trans, log_rho, mask) -> FBStats:
    """Scaled forward-backward in one launch of the CUDA kernel.
    Arguments and results as :func:`forward_backward_auto`; every tensor
    must be on one CUDA device."""
    shape = validate(log_pz1, log_trans, log_rho, mask)
    return _launch(log_pz1, log_trans, log_rho, mask, *shape)


def forward_backward_auto(log_pz1, log_trans, log_rho, mask) -> FBStats:
    """The scaled forward-backward of the VBEM E-step.

    log_pz1 [..., K] or [..., N, K], log_trans [..., K, K] or
    [..., N, K, K], log_rho [..., N, T, K] (contiguous), all float32 or all
    float64; mask [..., N, T] bool, broadcasting against log_rho's lanes,
    with every sequence's step 0 unmasked; K in 1..8; all on one device.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise)."""
    shape = validate(log_pz1, log_trans, log_rho, mask)
    if log_rho.device.type == "cpu":
        return forward_backward(log_pz1, log_trans, log_rho, mask)
    return _launch(log_pz1, log_trans, log_rho, mask, *shape)
