"""The VBEM forward-backward on the card: the wrappers of the hand-written
CUDA kernel ``csrc/fb.cuh`` (kernel B2) and the dispatch that the VBEM
E-step calls.

B2 has two entries:

* :func:`forward_backward_auto` (entry 1), the counterpart of
  ``vbhem_tpu.ops.fb_pallas.forward_backward_auto``: the forward-backward
  of given emission scores ``log_rho``, at any K (above 8 in the wide
  body ``csrc/fb_wide.cu``, whose vectors live in device memory);
* :func:`e_step_fused`, which forms the emission scores from the data
  ``x`` and the per-state constants of :func:`.fb.emission_constants`
  inside the kernel, so ``log_rho`` is never read from device memory.

:func:`e_step_auto` is the VBEM E-step's dispatch: the plain PyTorch
version (:mod:`.fb`) for CPU tensors; on the card the fused entry where it
takes the shape (D <= 3 and a shape the resident design holds), else
``log_rho`` in PyTorch and entry 1.  There is no fallback: a CUDA tensor
launches B2 or raises.

:func:`design` picks, from the shape alone, the kernel's resident design
(whole sequences held in shared memory), its streamed one (long T) or,
for K above 8, the wide body.
Restart lanes ride as leading axes; the kernel reads shared scores per
lane, and a mask and an ``x`` shared by the restarts of a subject without
expanding either, so all lanes go in one launch.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import _build
from .fb import (FBStats, emission_constants, expected_log_gauss,
                 forward_backward)

# Kernel launches in this process: entry 1 (:func:`forward_backward_cuda`,
# :func:`forward_backward_auto`) and the fused E-step (:func:`e_step_fused`).
LAUNCHES = 0
FUSED_LAUNCHES = 0

# the states the register bodies of csrc/fb.cuh take; above, the wide
# body of csrc/fb_wide.cu, limited only by the memory its workspace takes
MAX_STATES = 8
MAX_FUSED_DIM = 3

# Shared memory of one sm_90 SM (228 KB), of which each resident block
# takes 1 KB besides its own; the most one block may use (227 KB); the
# most blocks and threads an SM holds.
SMEM_PER_SM = 233472
SMEM_RESERVED_PER_BLOCK = 1024
SMEM_PER_BLOCK = 232448
BLOCKS_PER_SM_MAX = 32
THREADS_PER_SM_MAX = 2048
ROW_CHOICES = (32, 64, 96, 128)
# a resident block's own bytes beside its sequences' rows: its mbarrier
BLOCK_BYTES = 16

_C_FN = {torch.float32: "vbhem_fb_f32", torch.float64: "vbhem_fb_f64"}
_C_FUSED = {torch.float32: "vbhem_fb_fused_f32",
            torch.float64: "vbhem_fb_fused_f64"}
_C_WIDE = {torch.float32: "vbhem_fb_wide_f32",
           torch.float64: "vbhem_fb_wide_f64"}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong]
             + [ctypes.c_int] * 7 + [ctypes.c_void_p])
_FUSED_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
_WIDE_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong]
                  + [ctypes.c_int] * 6 + [ctypes.c_void_p])


class Design(NamedTuple):
    """How B2 runs a shape: ``kind`` 'resident' (``rows`` sequences per
    block, ``smem_bytes`` of dynamic shared memory), 'streamed' or 'wide'
    (K above 8; ``rows`` = 0 for both)."""
    kind: str
    rows: int
    smem_bytes: int


def stage_ld(length: int, itemsize: int) -> int:
    """Where a bulk copy lands an input row of ``length`` elements: a
    whole, odd number of 16-byte units, in elements (`stage_ld` in
    ``csrc/fb.cuh``)."""
    per = 16 // itemsize
    return (-(-length // per) | 1) * per


def mask_row_words(t: int) -> int:
    """The resident design's mask row: T bits in 32-bit words, padded to
    whole 16-byte units (`mask_words` in ``csrc/fb.cuh``)."""
    return 4 * -(-(-(-t // 32)) // 4)


def resident_row_bytes(t: int, k: int, itemsize: int, d: int = 0) -> int:
    """Shared memory one sequence takes in the resident design: its
    log_rho / px row ((T*K) | 1 elements), its alpha / gamma row, which
    first holds the staged input row (log_rho, or x in the fused entry;
    :func:`stage_ld`), so max((T*K) | 1, staged) | 1, and its mask row
    (:func:`mask_row_words`).  A block adds 16 bytes for its mbarrier
    (:data:`BLOCK_BYTES`).  ``csrc/fb.cuh`` (`layout`) lays the tiles out
    by the same formulas."""
    rho = (t * k) | 1
    alpha = max(rho, stage_ld(t * (d or k), itemsize)) | 1
    return (rho + alpha) * itemsize + 4 * mask_row_words(t)


def resident_per_sm(rows: int, smem_bytes: int) -> int:
    """Sequences an SM holds at once with blocks of ``rows`` sequences
    and ``smem_bytes`` of shared memory each."""
    blocks = SMEM_PER_SM // (smem_bytes + SMEM_RESERVED_PER_BLOCK)
    return min(blocks, BLOCKS_PER_SM_MAX, THREADS_PER_SM_MAX // rows) * rows


def design(t: int, k: int, itemsize: int, d: int = 0) -> Design:
    """The design B2 takes for T steps of K states of ``itemsize`` bytes
    (and, in the fused entry, D dims).  The recursion is serial in T, so
    the card's throughput grows with the sequences each SM holds: the
    resident design with the rows of ROW_CHOICES that hold the most (the
    fewest rows among equals: smaller blocks interleave their load, compute
    and store phases more finely), if a block of 32 fits; else the
    streamed design.  K above MAX_STATES takes the wide body."""
    if k > MAX_STATES:
        return Design("wide", 0, 0)
    per = resident_row_bytes(t, k, itemsize, d)
    best = Design("streamed", 0, 0)
    most = 0
    for rows in ROW_CHOICES:
        smem = rows * per + BLOCK_BYTES
        if smem > SMEM_PER_BLOCK:
            break
        held = resident_per_sm(rows, smem)
        if held > most:
            best, most = Design("resident", rows, smem), held
    return best


def _broadcasts(shape, target) -> bool:
    """Whether ``shape`` broadcasts to ``target`` without changing it."""
    if len(shape) > len(target):
        return False
    return all(a in (1, b) for a, b in zip(shape[::-1], target[::-1]))


def _check_tensors(named: dict, dtype, device):
    """Every tensor of ``named`` is one; the floating ones (all but
    'mask') have ``dtype``, the mask is bool, all lie on ``device``."""
    for name, t in named.items():
        if not torch.is_tensor(t):
            raise ValueError(f"{name} must be a tensor, got {type(t)}")
    if dtype not in _C_FN:
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    for name, t in named.items():
        if name != "mask" and t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
    if named["mask"].dtype != torch.bool:
        raise ValueError(f"mask must be bool, got {named['mask'].dtype}")


def _check_shapes(named: dict, lanes, n, t_max, k, log_rho_dim):
    """The scores (shared or per sequence) and the mask against the lanes;
    returns (pz1_per_seq, trans_per_seq)."""
    if t_max < 1 or n < 1 or k < 1 or math.prod(lanes) < 1:
        raise ValueError(f"empty batch: lanes={lanes}, N={n}, T={t_max}, "
                         f"K={k}")
    if math.prod(lanes) * n >= 2 ** 31:
        raise ValueError(f"{math.prod(lanes) * n} sequences: the kernel "
                         f"takes fewer than 2**31")
    pz1_per_seq = named["log_pz1"].dim() == log_rho_dim - 1
    trans_per_seq = named["log_trans"].dim() == log_rho_dim
    want = dict(log_pz1=lanes + ((n, k) if pz1_per_seq else (k,)),
                log_trans=lanes + ((n, k, k) if trans_per_seq else (k, k)),
                mask=lanes + (n, t_max))
    for name, shape in want.items():
        if not _broadcasts(named[name].shape, shape):
            raise ValueError(f"{name} has shape {tuple(named[name].shape)}, "
                             f"expected {shape} or a shape that broadcasts "
                             f"to it")
    return pz1_per_seq, trans_per_seq


def check_step0(mask):
    """Raise unless every sequence's step 0 is unmasked (the recursion
    starts there, as fb_pallas.py:73 assumes).  Reads the mask on the
    host: one synchronization."""
    if not bool(torch.all(mask[..., 0])):
        raise ValueError("every sequence must have step 0 unmasked "
                         "(mask[..., 0] all true): an empty sequence has no "
                         "forward recursion")


def validate(log_pz1, log_trans, log_rho, mask, step0=True):
    """Check what entry 1 accepts; raise ValueError otherwise.  With
    ``step0`` also check every sequence's step 0 (a host sync; the VBEM
    loop checks its lengths once instead).

    Returns (lanes, n, t, k, pz1_per_seq, trans_per_seq): ``lanes`` is the
    tuple of leading lane axes of ``log_rho``."""
    named = dict(log_pz1=log_pz1, log_trans=log_trans, log_rho=log_rho,
                 mask=mask)
    _check_tensors(named, getattr(log_rho, "dtype", None),
                   getattr(log_rho, "device", None))
    if not log_rho.is_contiguous():
        raise ValueError("log_rho must be contiguous")
    if log_rho.dim() < 3:
        raise ValueError(f"log_rho must be [..., N, T, K], got "
                         f"{tuple(log_rho.shape)}")
    *lanes, n, t_max, k = log_rho.shape
    lanes = tuple(lanes)
    per_seq = _check_shapes(named, lanes, n, t_max, k, log_rho.dim())
    if step0:
        check_step0(mask)
    return (lanes, n, t_max, k) + per_seq


def validate_fused(x, mask, log_pz1, log_trans, emis):
    """Check what the fused entry accepts; raise ValueError otherwise.
    Step 0 is not checked here (the caller guarantees it).

    Returns (lanes, n, t, k, d, pz1_per_seq, trans_per_seq, design)."""
    named = dict(x=x, mask=mask, log_pz1=log_pz1, log_trans=log_trans,
                 emis=emis)
    _check_tensors(named, getattr(emis, "dtype", None),
                   getattr(emis, "device", None))
    if x.dim() < 3 or emis.dim() < 2:
        raise ValueError(f"x must be [..., N, T, D] and emis [..., K, E], "
                         f"got {tuple(x.shape)} and {tuple(emis.shape)}")
    *_, n, t_max, d = x.shape
    *lanes, k, e = emis.shape
    lanes = tuple(lanes)
    if not 1 <= d <= MAX_FUSED_DIM:
        raise ValueError(f"D={d}: the fused E-step takes 1..{MAX_FUSED_DIM} "
                         f"(wider data: log_rho in PyTorch and "
                         f"forward_backward_auto)")
    if e != 1 + d + d * d:
        raise ValueError(f"emis has {e} constants per state, expected "
                         f"1 + D + D*D = {1 + d + d * d}")
    if not _broadcasts(x.shape, lanes + (n, t_max, d)):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                         f"{lanes + (n, t_max, d)} or a shape that "
                         f"broadcasts to it")
    per_seq = _check_shapes(named, lanes, n, t_max, k, len(lanes) + 3)
    des = design(t_max, k, emis.element_size(), d)
    if des.kind != "resident":
        raise ValueError(f"T={t_max}, K={k}, D={d}: the fused E-step takes "
                         f"only the resident design (K <= {MAX_STATES} and "
                         f"tiles that fit in shared memory); use "
                         f"e_step_auto or forward_backward_auto")
    return (lanes, n, t_max, k, d) + per_seq + (des,)


def _lane_rows(a, lanes, inner):
    """``a`` [*A, *inner] as a contiguous [R, *inner] and the number of
    consecutive lanes that share each row: when A is a prefix of ``lanes``
    followed by ones (one row per subject, shared by its restarts) it is
    not expanded."""
    tail = tuple(a.shape[a.dim() - inner:])
    al = a.shape[:a.dim() - inner]
    al = (1,) * (len(lanes) - len(al)) + tuple(al)
    j = len(lanes)
    while j > 0 and al[j - 1] == 1:
        j -= 1
    if al[:j] == lanes[:j]:
        rep = math.prod(lanes[j:])
        r = a.reshape((math.prod(lanes[:j]),) + tail)
    else:
        rep = 1
        r = torch.broadcast_to(a, lanes + tail).reshape((-1,) + tail)
    return r.contiguous(), rep


def _mask_lanes(mask, lanes):
    """The mask as a contiguous uint8 [Bm, N, T] and the number of
    consecutive lanes that share each of its rows."""
    m, rep = _lane_rows(mask, lanes, 2)
    return m.view(torch.uint8), rep


def _mask_bits(mask, lanes):
    """The mask as the resident design reads it: int32 [Bm, N,
    :func:`mask_row_words`] of bits, bit j of word w for step 32 w + j,
    and the number of consecutive lanes that share each row."""
    m, rep = _lane_rows(mask, lanes, 2)
    t = m.shape[-1]
    used = -(-t // 32)
    bits = m.new_zeros(m.shape[:-1] + (used * 32,), dtype=torch.int32)
    bits[..., :t] = m
    shifts = torch.arange(32, dtype=torch.int32, device=m.device)
    words = torch.sum(bits.unflatten(-1, (used, 32)) << shifts, dim=-1,
                      dtype=torch.int32)
    out = words.new_zeros(m.shape[:-1] + (mask_row_words(t),))
    out[..., :used] = words
    return out, rep


def _outputs(lanes, n, t_max, k, dt, dev):
    """Allocate log_rho (masked), gamma, xi_sum and phi_norm."""
    return (torch.empty(lanes + (n, t_max, k), dtype=dt, device=dev),
            torch.empty(lanes + (n, t_max, k), dtype=dt, device=dev),
            torch.empty(lanes + (n, k, k), dtype=dt, device=dev),
            torch.empty(lanes + (n,), dtype=dt, device=dev))


def _scores(log_pz1, log_trans, lanes, n, k, pz1_per_seq, trans_per_seq):
    pz1 = torch.broadcast_to(
        log_pz1, lanes + ((n, k) if pz1_per_seq else (k,))).contiguous()
    trans = torch.broadcast_to(
        log_trans, lanes + ((n, k, k) if trans_per_seq else (k, k))
    ).contiguous()
    return pz1, trans


def _needs_cuda(dev):
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")


def _launch(log_pz1, log_trans, log_rho, mask, lanes, n, t_max, k,
            pz1_per_seq, trans_per_seq) -> FBStats:
    """One launch of entry 1 on arguments :func:`validate` has accepted."""
    global LAUNCHES
    dev, dt = log_rho.device, log_rho.dtype
    _needs_cuda(dev)
    des = design(t_max, k, log_rho.element_size())
    if des.kind == "wide":
        return _launch_wide(log_pz1, log_trans, log_rho, mask, lanes, n,
                            t_max, k, pz1_per_seq, trans_per_seq)
    fn = _build.c_function(_C_FN[dt], _ARGTYPES)
    pz1, trans = _scores(log_pz1, log_trans, lanes, n, k, pz1_per_seq,
                         trans_per_seq)
    m8, rep = (_mask_bits(mask, lanes) if des.rows > 0
               else _mask_lanes(mask, lanes))
    with torch.cuda.device(dev):
        out = _outputs(lanes, n, t_max, k, dt, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(log_rho.data_ptr(), m8.data_ptr(), pz1.data_ptr(),
                 trans.data_ptr(), *[o.data_ptr() for o in out],
                 math.prod(lanes) * n, n, t_max, k, rep, int(pz1_per_seq),
                 int(trans_per_seq), des.rows, stream)
        if err != 0:
            raise RuntimeError(f"fb kernel launch failed: cudaError {err}")
        LAUNCHES += 1
    return FBStats(*out)


def wide_work_values(k: int) -> int:
    """Values of the wide body's workspace per sequence: exp(log_trans),
    px, beta and a scratch vector (``csrc/fb_wide.cu``)."""
    return k * k + 3 * k


def _launch_wide(log_pz1, log_trans, log_rho, mask, lanes, n, t_max, k,
                 pz1_per_seq, trans_per_seq) -> FBStats:
    """One launch of entry 1's wide body (K above MAX_STATES), counted
    as an entry-1 launch."""
    global LAUNCHES
    dev, dt = log_rho.device, log_rho.dtype
    fn = _build.c_function(_C_WIDE[dt], _WIDE_ARGTYPES)
    pz1, trans = _scores(log_pz1, log_trans, lanes, n, k, pz1_per_seq,
                         trans_per_seq)
    m8, rep = _mask_lanes(mask, lanes)
    n_seq = math.prod(lanes) * n
    with torch.cuda.device(dev):
        out = _outputs(lanes, n, t_max, k, dt, dev)
        work = torch.empty((wide_work_values(k) * n_seq,), dtype=dt,
                           device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(log_rho.data_ptr(), m8.data_ptr(), pz1.data_ptr(),
                 trans.data_ptr(), *[o.data_ptr() for o in out],
                 work.data_ptr(), n_seq, n, t_max, k, rep,
                 int(pz1_per_seq), int(trans_per_seq), stream)
        if err != 0:
            raise RuntimeError(f"fb wide kernel launch failed: cudaError "
                               f"{err}")
        LAUNCHES += 1
        del work   # freed on the stream, after the kernel
    return FBStats(*out)


def forward_backward_cuda(log_pz1, log_trans, log_rho, mask) -> FBStats:
    """Scaled forward-backward in one launch of entry 1.  Arguments and
    results as :func:`forward_backward_auto`; every tensor must be on one
    CUDA device."""
    shape = validate(log_pz1, log_trans, log_rho, mask)
    return _launch(log_pz1, log_trans, log_rho, mask, *shape)


def forward_backward_auto(log_pz1, log_trans, log_rho, mask) -> FBStats:
    """The scaled forward-backward of the VBEM E-step.

    log_pz1 [..., K] or [..., N, K], log_trans [..., K, K] or
    [..., N, K, K], log_rho [..., N, T, K] (contiguous), all float32 or all
    float64; mask [..., N, T] bool, broadcasting against log_rho's lanes,
    with every sequence's step 0 unmasked; K >= 1; all on one device.

    CPU tensors take the plain version; CUDA tensors launch entry 1 of the
    kernel (or raise)."""
    shape = validate(log_pz1, log_trans, log_rho, mask)
    if log_rho.device.type == "cpu":
        return forward_backward(log_pz1, log_trans, log_rho, mask)
    return _launch(log_pz1, log_trans, log_rho, mask, *shape)


def e_step_fused(x, mask, log_pz1, log_trans, emis) -> FBStats:
    """The VBEM E-step with the emission scores formed in the kernel.

    x [..., N, T, D] (D in 1..3; its leading axes broadcast against the
    lanes, one row per subject shared by its restarts), mask [..., N, T]
    bool likewise, log_pz1 / log_trans as for :func:`forward_backward_auto`,
    emis [..., K, 1 + D + D*D] from :func:`.fb.emission_constants` (its
    leading axes are the lanes).  Every sequence's step 0 must be unmasked;
    that is not checked here.  The shape must take the resident design
    (:func:`design`).  Every tensor must be on one CUDA device: the plain
    version of this entry is :func:`.fb.expected_log_gauss` followed by
    :func:`.fb.forward_backward`, which :func:`e_step_auto` runs for CPU
    tensors.  Returns FBStats with log_rho [..., N, T, K] masked."""
    global FUSED_LAUNCHES
    (lanes, n, t_max, k, d, pz1_per_seq, trans_per_seq,
     des) = validate_fused(x, mask, log_pz1, log_trans, emis)
    dev, dt = emis.device, emis.dtype
    _needs_cuda(dev)
    fn = _build.c_function(_C_FUSED[dt], _FUSED_ARGTYPES)
    pz1, trans = _scores(log_pz1, log_trans, lanes, n, k, pz1_per_seq,
                         trans_per_seq)
    xr, x_rep = _lane_rows(x, lanes, 3)
    m8, rep = _mask_bits(mask, lanes)
    em = emis.contiguous()
    with torch.cuda.device(dev):
        out = _outputs(lanes, n, t_max, k, dt, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xr.data_ptr(), em.data_ptr(), m8.data_ptr(), pz1.data_ptr(),
                 trans.data_ptr(), *[o.data_ptr() for o in out],
                 math.prod(lanes) * n, n, t_max, k, d, rep, x_rep,
                 int(pz1_per_seq), int(trans_per_seq), des.rows, stream)
        if err != 0:
            raise RuntimeError(f"fused fb kernel launch failed: cudaError "
                               f"{err}")
        FUSED_LAUNCHES += 1
    return FBStats(*out)


def e_step_auto(x, mask, log_pz1, log_trans, niw) -> FBStats:
    """The VBEM E-step of every lane: expected log emissions of x under
    the NIW posterior ``niw`` (fields [..., K, ...], the lanes leading),
    then the scaled forward-backward.  x [..., N, T, D] and mask
    [..., N, T] broadcast against the lanes; every sequence's step 0 must
    be unmasked (the VBEM loop checks its lengths once).

    CPU tensors take the plain version (:func:`.fb.expected_log_gauss`,
    then :func:`.fb.forward_backward`).  CUDA tensors launch B2: the fused
    entry where D <= 3 and the resident design holds the shape, else
    entry 1 on log_rho formed in PyTorch (its wide body for K above 8)."""
    if x.device.type == "cpu":
        return forward_backward(log_pz1, log_trans,
                                expected_log_gauss(x, niw), mask)
    t_max, d = x.shape[-2:]
    k = niw.m.shape[-2]
    if d <= MAX_FUSED_DIM and \
            design(t_max, k, x.element_size(), d).kind == "resident":
        return e_step_fused(x, mask, log_pz1, log_trans,
                            emission_constants(niw))
    log_rho = expected_log_gauss(x, niw).contiguous()
    shape = validate(log_pz1, log_trans, log_rho, mask, step0=False)
    return _launch(log_pz1, log_trans, log_rho, mask, *shape)
