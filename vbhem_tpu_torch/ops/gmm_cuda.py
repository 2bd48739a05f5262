"""The EM of the GMM starts on the card: the wrapper of the hand-written
CUDA kernel of ``csrc/gmm.cu``.

* :func:`em_to_tol_auto`: the dispatch of :func:`.gmm._em_to_tol`, which
  :func:`.gmm.fit_gmm_from_means` (and so :func:`.gmm.fit_gmm`) and
  :func:`.gmm.fit_gmm_split` call: the plain version for CPU tensors, for
  CUDA tensors one launch of the kernel (or a raise).  There is no
  fallback.
* :func:`em_rows`: the launch on a data row layout, which validates its
  arguments.

The kernel runs each restart lane's whole EM in one warp, its iterations
looped on chip, to the plain version's stop rule; the host waits for
nothing until the results are read.  While profiling records, each
launch's per-lane iteration counts are read back once, at the end of the
launch, as the profiling counters ``gmm.lanes``, ``gmm.iters_run`` (the
iterations the lanes ran) and ``gmm.iters_fixed`` (lanes x max_iter);
when it does not, the counters cost no sync.

The kernel takes K in 1..MAX_K and D in DIMS; :func:`check_fit` refuses a
fit outside that range on the card: :func:`.gmm.fit_gmm` and
:func:`.gmm.fit_gmm_split` call it before their draws, and the VBHEM
front ends before they draw any lane under 'random'.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ..utils import profiling

# Kernel launches made in this process.
LAUNCHES = 0

MAX_K = 8              # components a lane: the kernel's register bodies
DIMS = (1, 2, 3, 4)    # the dimensions of a point
MAX_WARPS = 8          # restart lanes (one a warp) a block
# A row's points are staged in shared memory where their M (D + 1) values
# take at most this many bytes (two blocks an SM at the largest); larger
# rows are read from device memory.
SHARED_BYTES = 100 * 1024

_DTYPES = (torch.float32, torch.float64)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] * 3
             + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_double] * 2 + [ctypes.c_void_p])


def check_fit(device, k_max: int, d: int):
    """Refuse, on a CUDA ``device``, a GMM fit the kernel cannot run: K =
    ``k_max`` above MAX_K or D outside DIMS.  The CPU's plain version takes
    any."""
    if torch.device(device).type == "cpu":
        return
    if not 1 <= k_max <= MAX_K or d not in DIMS:
        raise ValueError(
            f"the GMM starts on the card (VBEM 'random' and 'split', the "
            f"VBHEM 'random' initializer) take K in 1..{MAX_K} and D in "
            f"{DIMS} (their EM kernel, csrc/gmm.cu), got K={k_max}, D={d}")


def block_warps(per_row: int) -> int:
    """Warps (restart lanes) a block: the count in 1..MAX_WARPS that leaves
    the fewest warps idle over a row's blocks, the larger on a tie."""
    return min(range(MAX_WARPS, 0, -1),
               key=lambda w: -(-per_row // w) * w - per_row)


def _shape(name, t, want):
    if tuple(t.shape) != tuple(want):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(want)}")


def em_rows(x, w, ridge, weight0, mean0, cov0, max_iter: int = 100,
            tol: float = 1e-5, log_floor: float = 0.0):
    """One launch of the kernel: the EM of :func:`.gmm._em_to_tol` for
    ``rows`` data rows of ``per_row`` restart lanes each.

    x [rows, M, D] or [M, D] (every row's data), w [rows, M] or [M] (the
    points' weights), ridge [rows, D, D] or [D, D]; the start weight0
    [rows, per_row, K], mean0 [.., K, D], cov0 [.., K, D, D].  All float32
    or all float64, contiguous, on one CUDA device; K in 1..MAX_K, D in
    DIMS.  Returns the fit (weight, mean, cov, in new tensors of the start's
    shapes) and each lane's iterations (int32 [rows, per_row])."""
    global LAUNCHES
    named = dict(x=x, w=w, ridge=ridge, weight0=weight0, mean0=mean0,
                 cov0=cov0)
    for name, t in named.items():
        if not torch.is_tensor(t):
            raise ValueError(f"{name} must be a tensor, got {type(t)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or float64, got {x.dtype}")
    for name, t in named.items():
        if t.dtype != x.dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected "
                             f"{x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if weight0.dim() != 3 or x.dim() not in (2, 3):
        raise ValueError(f"weight0 must be [rows, per_row, K] and x [M, D] "
                         f"or [rows, M, D], got {tuple(weight0.shape)} and "
                         f"{tuple(x.shape)}")
    rows, per_row, k = weight0.shape
    m, d = x.shape[-2:]
    if d not in DIMS:
        raise ValueError(f"D={d}: the kernel takes D in {DIMS}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K={k}: the kernel takes 1..{MAX_K} components")
    if not 1 <= m < 2 ** 31 or not 1 <= rows * per_row < 2 ** 31:
        raise ValueError(f"M={m}, {rows} x {per_row} lanes: the kernel "
                         f"takes 1..2**31-1 of each")
    shared = x.dim() == 2
    if not shared:
        _shape("x", x, (rows, m, d))
    _shape("w", w, (m,) if w.dim() == 1 else (rows, m))
    _shape("ridge", ridge, (d, d) if ridge.dim() == 2 else (rows, d, d))
    _shape("mean0", mean0, (rows, per_row, k, d))
    _shape("cov0", cov0, (rows, per_row, k, d, d))
    warps = block_warps(per_row)
    if rows * -(-per_row // warps) >= 2 ** 31:
        raise ValueError(f"{rows} rows of {per_row} lanes: more than "
                         f"2**31-1 blocks")
    if x.device.type != "cuda":
        raise ValueError(f"em_rows launches the kernel: its tensors must be "
                         f"on a CUDA device, got {x.device}")
    weight, mean, cov = (t.clone() for t in (weight0, mean0, cov0))
    iters = torch.empty((rows, per_row), dtype=torch.int32, device=x.device)
    staged = int(m * (d + 1) * x.element_size() <= SHARED_BYTES)
    fn = _build.c_function(f"vbhem_gmm_em_{_SUFFIX[x.dtype]}", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), 0 if shared else m * d, w.data_ptr(),
                 0 if w.dim() == 1 else m, ridge.data_ptr(),
                 0 if ridge.dim() == 2 else d * d, weight.data_ptr(),
                 mean.data_ptr(), cov.data_ptr(), iters.data_ptr(), rows,
                 per_row, m, k, d, warps, staged, int(max_iter), float(tol),
                 float(log_floor), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gmm EM kernel launch failed ({rows} x "
                           f"{per_row} lanes, K={k}, D={d}): cudaError "
                           f"{err}")
    LAUNCHES += 1
    count_iterations(iters, max_iter)
    return weight, mean, cov, iters


def count_iterations(iters: torch.Tensor, max_iter: int):
    """While profiling records, one launch's per-lane ``iters`` read back
    (one sync) as ``gmm.lanes``, ``gmm.iters_run`` (their sum) and
    ``gmm.iters_fixed`` (lanes x ``max_iter``); otherwise nothing, and no
    sync."""
    if not profiling.active():
        return
    n = iters.numel()
    profiling.count("gmm.lanes", n)
    profiling.count("gmm.iters_run", int(torch.sum(iters)))
    profiling.count("gmm.iters_fixed", n * int(max_iter))


def _rows(t: torch.Tensor, nx: int, tail: int) -> torch.Tensor:
    """``t`` [*X, 1.., *own] (``tail`` own axes) as [rows, *own], or as
    [*own] where every row holds the same data (stride 0 over X, as the
    VBHEM pools' broadcast base means), contiguous."""
    own = t.shape[t.dim() - tail:]
    t = t.reshape(t.shape[:nx] + own)
    if all(s == 0 or n == 1 for s, n in zip(t.stride()[:nx], t.shape[:nx])):
        return t[(0,) * nx].contiguous()
    return t.reshape((-1,) + own).contiguous()


def em_to_tol_auto(x, w_pt, g, ridge, max_iter: int, tol: float,
                   log_floor: float, nx: int):
    """:func:`.gmm._em_to_tol` (same arguments: x [*X, 1.., M, D], w_pt
    [*X, 1.., M], the start ``g`` with lanes [*X, *E], ridge [*X, 1.., D,
    D], ``nx`` data axes X): the plain version for CPU tensors; for CUDA
    tensors each of the prod(X) data rows and its prod(E) restart lanes go
    to one launch of the kernel (:func:`em_rows`).  Returns a GMM.

    At D = 4 the plain version's Cholesky raises on a covariance that is
    not positive definite, where the kernel turns the lane NaN; so a NaN
    lane at D = 4 raises here too (one sync a launch, at D = 4 alone)."""
    from . import gmm            # gmm imports this module
    if x.device.type == "cpu":
        return gmm._em_to_tol(x, w_pt, g, ridge, max_iter, tol, log_floor,
                              nx)
    lanes = tuple(g.weight.shape[:-1])
    k, (m, d) = g.weight.shape[-1], x.shape[-2:]
    if lanes[:nx] != tuple(x.shape[:nx]):
        raise ValueError(f"the start's lanes {lanes} must lead with the "
                         f"data axes {tuple(x.shape[:nx])}")
    rows = math.prod(lanes[:nx])
    per_row = math.prod(lanes[nx:])
    start = [a.reshape((rows, per_row) + a.shape[len(lanes):])
             .contiguous() for a in g]
    fit = em_rows(_rows(x, nx, 2), _rows(w_pt, nx, 1), _rows(ridge, nx, 2),
                  *start, max_iter=max_iter, tol=tol, log_floor=log_floor)
    if d == 4 and bool(torch.isnan(fit[2]).any()):
        raise torch.linalg.LinAlgError(
            f"gmm EM kernel: a D = 4 covariance is not positive definite "
            f"(the plain version's Cholesky raises there); "
            f"{int(torch.isnan(fit[2]).flatten(2).any(-1).sum())} lanes NaN")
    return gmm.GMM(*(a.reshape(lanes + a.shape[2:]) for a in fit[:3]))
