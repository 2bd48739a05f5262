"""The k-means of the VBHEM 'wtkmeans' start on the card: the wrappers of
the hand-written CUDA kernels of ``csrc/kmeans.cu``.

* :func:`kmeans_auto`: weighted Lloyd k-means from given centers, as
  :func:`.kmeans.kmeans`;
* :func:`weighted_kmeans_energy_auto`: the energy-adjusted weighted
  k-means of `my_weighted_kmeans.m`, as :func:`.kmeans.weighted_kmeans_energy`.

Each validates its arguments, then takes the plain PyTorch version
(:mod:`.kmeans`) only for CPU tensors; for CUDA tensors it launches its
kernel or raises.  There is no fallback.  The kernels run each lane's
whole k-means in one block, its iterations looped on chip: a Lloyd lane
leaves its loop at the first iteration that returns its centers unchanged
bit for bit, after which the plain version's remaining iterations return
the same centers; the energy k-means stops each lane on the plain
version's rule, and the host waits for nothing until the results are read.

While profiling records, each launch appends its lanes' iterations run
(Lloyd) or moves made (energy) to :data:`PENDING` as an int32 tensor on
the card, not read back; :func:`count_iterations` reads the Lloyd ones
back once, records them as the profiling counters ``kmeans.lanes``,
``kmeans.iters_run`` and ``kmeans.iters_fixed`` (lanes x max_iter, the
plain version's count) and empties the list.

The kernels take K in 1..MAX_K and D in DIMS; :func:`check_grid` refuses
a grid outside that range before a front end draws anything.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .kmeans import kmeans, weighted_kmeans_energy
from ..utils import profiling

# Kernel launches made in this process (both entries).
LAUNCHES = 0
# (entry, its lanes' iterations or moves) of each launch made while
# profiling records; emptied by count_iterations
PENDING: list = []

MAX_K = 8              # centers a lane: the kernels' register bodies
DIMS = (1, 2, 3, 4)    # the dimensions of a point
# Points whose energy k-means state (a byte a point) a block keeps in
# shared memory (at most 227 KB on sm_90); more take a device workspace.
SHARED_POINTS = 200_000

_DTYPES = (torch.float32, torch.float64)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_LLOYD_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
_ENERGY_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                    + [ctypes.c_double, ctypes.c_void_p])


def check_grid(device, k_max: int, s_max: int, d: int):
    """Refuse, on a CUDA ``device``, a 'wtkmeans' start the kernels cannot
    run: Kr = ``k_max`` or Sr = ``s_max`` above MAX_K, or D outside DIMS.
    The CPU's plain version takes any."""
    if torch.device(device).type == "cpu":
        return
    if k_max > MAX_K or s_max > MAX_K or d not in DIMS:
        raise ValueError(
            f"initmode 'wtkmeans' (also run by 'auto') on the card takes "
            f"K and S up to {MAX_K} and D in {DIMS} (its k-means kernels, "
            f"csrc/kmeans.cu), got K={k_max}, S={s_max}, D={d}; pick "
            f"initmode 'baseem' or 'gmmNew' for this grid")


def _check(x, init_centers, **others):
    """The checks every entry makes: x [M, D] and init_centers [..., K, D]
    float32 or float64, every tensor on x's device, the floats in x's
    dtype, all contiguous; K in 1..MAX_K, D in DIMS, 1 <= M < 2**31, 1 to
    2**31-1 lanes (the leading axes of init_centers).
    Returns (M, K, D, lanes)."""
    named = dict(x=x, init_centers=init_centers, **others)
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
    if x.dim() != 2 or init_centers.dim() < 2:
        raise ValueError(f"x must be [M, D] and init_centers [..., K, D], "
                         f"got {tuple(x.shape)} and "
                         f"{tuple(init_centers.shape)}")
    m, d = x.shape
    k = init_centers.shape[-2]
    if d not in DIMS or init_centers.shape[-1] != d:
        raise ValueError(f"D={d} (centers {init_centers.shape[-1]}): the "
                         f"kernels take D in {DIMS}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K={k}: the kernels take 1..{MAX_K} centers")
    if not 1 <= m < 2 ** 31:
        raise ValueError(f"M={m}: the kernels take 1..2**31-1 points")
    lanes = tuple(init_centers.shape[:-2])
    if not 1 <= math.prod(lanes) < 2 ** 31:
        raise ValueError(f"lanes {lanes}: the kernels take 1..2**31-1")
    return m, k, d, lanes


def _shape(name, t, want):
    if tuple(t.shape) != tuple(want):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(want)}")


def _launch(kind: str, dt, args, argtypes, counts: torch.Tensor):
    global LAUNCHES
    fn = _build.c_function(f"vbhem_kmeans_{kind}_{_SUFFIX[dt]}", argtypes)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"kmeans {kind} kernel launch failed "
                           f"({counts.numel()} lanes): cudaError {err}")
    LAUNCHES += 1
    if profiling.active():
        PENDING.append((kind, counts))


def kmeans_auto(x: torch.Tensor, init_centers: torch.Tensor,
                weights: Optional[torch.Tensor] = None, max_iter: int = 100):
    """Weighted Lloyd k-means of x [M, D] from ``init_centers`` [*L, K, D]
    under ``weights`` [M] or [*L, M] (ones where None): (assignment
    [*L, M], centers [*L, K, D]), as :func:`.kmeans.kmeans` with these
    centers and ``max_iter``.  All float32 or all float64, contiguous, on
    one device.  CPU tensors take the plain version; CUDA tensors launch
    the kernel (or raise)."""
    m, k, d, lanes = _check(x, init_centers, **(
        {} if weights is None else {"weights": weights}))
    w = torch.ones((m,), dtype=x.dtype, device=x.device) \
        if weights is None else weights
    if w.shape != (m,):
        _shape("weights", w, lanes + (m,))
    if x.device.type == "cpu":
        return kmeans(None, x, k, weights=w, init_centers=init_centers,
                      max_iter=max_iter)
    n = math.prod(lanes)
    assign = torch.empty(lanes + (m,), dtype=torch.int64, device=x.device)
    centers = torch.empty_like(init_centers)
    its = torch.empty(lanes, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        _launch("lloyd", x.dtype, (
            x.data_ptr(), w.data_ptr(), 0 if w.dim() == 1 else m,
            init_centers.data_ptr(), assign.data_ptr(), centers.data_ptr(),
            its.data_ptr(), n, m, k, d, int(max_iter)), _LLOYD_ARGTYPES, its)
    return assign, centers


def weighted_kmeans_energy_auto(x: torch.Tensor, weights: torch.Tensor,
                                init_centers: torch.Tensor,
                                max_iter: int = 100, tol: float = 1e-6):
    """The energy-adjusted weighted k-means of x [M, D] under ``weights``
    [M] from ``init_centers`` [*L, K, D]: (assignment [*L, M], centers
    [*L, K, D]), as :func:`.kmeans.weighted_kmeans_energy`.  Tensors as
    :func:`kmeans_auto`'s.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    m, k, d, lanes = _check(x, init_centers, weights=weights)
    _shape("weights", weights, (m,))
    if x.device.type == "cpu":
        return weighted_kmeans_energy(x, weights, init_centers,
                                      max_iter=max_iter, tol=tol)
    n = math.prod(lanes)
    assign = torch.empty(lanes + (m,), dtype=torch.int64, device=x.device)
    centers = torch.empty_like(init_centers)
    its = torch.empty(lanes, dtype=torch.int32, device=x.device)
    ws = torch.empty((n, m), dtype=torch.uint8, device=x.device) \
        if m > SHARED_POINTS else None
    with torch.cuda.device(x.device):
        _launch("energy", x.dtype, (
            x.data_ptr(), weights.data_ptr(), init_centers.data_ptr(),
            assign.data_ptr(), centers.data_ptr(), its.data_ptr(),
            None if ws is None else ws.data_ptr(), n, m, k, d,
            int(max_iter), float(tol)), _ENERGY_ARGTYPES, its)
    return assign, centers


def count_iterations(max_iter: int = 100):
    """Record the iterations of the Lloyd launches in :data:`PENDING`,
    read back once: ``kmeans.lanes``, ``kmeans.iters_run`` (summed over
    the lanes) and ``kmeans.iters_fixed`` (lanes x ``max_iter``, what the
    plain version runs); then empty :data:`PENDING`."""
    iters = [t.reshape(-1) for kind, t in PENDING if kind == "lloyd"]
    PENDING.clear()
    if not iters:
        return
    its = torch.cat(iters)
    profiling.count("kmeans.lanes", its.numel())
    profiling.count("kmeans.iters_run", int(torch.sum(its)))
    profiling.count("kmeans.iters_fixed", its.numel() * max_iter)
