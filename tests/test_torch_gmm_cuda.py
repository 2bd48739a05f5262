"""The EM kernel of the GMM starts (``csrc/gmm.cu``, wrapped by
``vbhem_tpu_torch/ops/gmm_cuda.py``).

On the CPU: the dispatch ``em_to_tol_auto`` returns exactly what the plain
``gmm._em_to_tol`` returns and launches nothing; the launch ``em_rows``
refuses what the kernel does not take; the ``gmm.*`` counters are recorded
only while profiling records; the front ends refuse a K or D beyond the
kernel on the card before they draw, and the kernel's range covers every
VBEM K and D that the port's configurations, experiments and runner pass;
and a NumPy transliteration of one warp's loop (the row's mean point
summed by one warp, the staged points of nonzero weight, each thread's
every 32nd point, the butterfly, the closed-form inverse or Cholesky, the
stop rule) gives the plain version's fits and per-lane iteration counts in
float64.

On the card (marked ``card``, skipped here; run there with ``python -m
pytest --noconftest -o addopts="" -m card -s tests/test_torch_gmm_cuda.py``,
as this file imports no JAX): the kernel against the plain version at both
bank cells' full shapes and on edge cases, and the launch counters in the
benchmark's jobs.
"""
import inspect
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from vbhem_tpu_torch.ops import gmm as tgmm
from vbhem_tpu_torch.ops import gmm_cuda as gc
from vbhem_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
F64 = torch.float64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")


def _rows_data(seed, rows=2, m=61, d=2, k=3, pad=9, spread=(40.0, 300.0),
               dtype=F64, device="cpu"):
    """``rows`` data rows of m real points around k centers far from the
    origin, then ``pad`` padded points (weight 0, at the origin):
    x [rows, m + pad, D], w [rows, m + pad]."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(spread[1] / 2, spread[1], (rows, k, d))
    lab = rng.integers(0, k, (rows, m))
    x = np.take_along_axis(mu, lab[..., None], 1) \
        + rng.normal(0, spread[0], (rows, m, d))
    x = np.concatenate([x, np.zeros((rows, pad, d))], 1)
    w = np.concatenate([np.ones((rows, m)), np.zeros((rows, pad))], 1)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return t(x), t(w)


def _start(gen, x, w, k, lanes, reg=1e-6):
    """fit_gmm's start and the plain EM's arguments for x [R, M, D] and w
    [R, M] with ``lanes`` restarts a row: (x4, w4, GMM start [R, L, ..],
    ridge [R, 1, D, D])."""
    r, m, d = x.shape
    u = torch.rand((r, lanes, m), generator=gen, dtype=F64).to(x.device)
    u = torch.where(w[:, None] > 0, u, -1.0)
    idx = torch.topk(u, k, dim=-1).indices
    mean0 = torch.gather(x[:, None].expand(r, lanes, m, d), -2,
                         idx[..., None].expand(idx.shape + (d,)))
    x4, w4 = x[:, None], w[:, None]
    _, data_cov, ridge = tgmm._pooled(x4, w4, reg)
    cov0 = torch.broadcast_to((data_cov + ridge)[..., None, :, :],
                              (r, lanes, k, d, d))
    weight0 = torch.full((r, lanes, k), 1.0 / k, dtype=x.dtype,
                         device=x.device)
    return x4, w4, tgmm.GMM(weight0, mean0, cov0), ridge


# ---------------------------------------------------------------------------
# the CPU path is the plain version; it launches nothing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fit", ["from_means", "lanes", "split", "pools"])
def test_auto_on_cpu_is_the_plain_version(fit, monkeypatch):
    """Through each caller's shapes, the dispatch returns what the plain
    ``_em_to_tol`` returns, bit for bit, and launches nothing."""
    x, w = _rows_data(1)
    seen = []

    em_to_tol = tgmm._em_to_tol

    def plain(*args):
        out = em_to_tol(*args)
        seen.append(out)
        return out

    monkeypatch.setattr(tgmm, "_em_to_tol", plain)
    if fit == "from_means":
        got = tgmm.fit_gmm_from_means(x, x[:, :3], w)
    elif fit == "lanes":
        got = tgmm.fit_gmm(torch.Generator().manual_seed(2), x, 3,
                           weights=w, lanes=(4, 2))
        assert got.mean.shape == (2, 4, 2, 3, 2)
    elif fit == "split":
        got = tgmm.fit_gmm_split(x, 3, weights=w)
    else:
        # the VBHEM 'random' pools: one data set shared by every (lane,
        # cluster) row, each row's own weights, one fit a row
        pool = x[0].expand(4, 2, *x.shape[1:])
        wts = (torch.arange(x.shape[1]) % 2 == torch.arange(2)[:, None]) \
            * w[0]
        wts = wts.expand(4, 2, -1)
        got = tgmm.fit_gmm_from_means(pool, pool[..., 5:8, :], wts)
    assert len(seen) == 1
    for g, h in zip(got, seen[0]):
        assert g.shape == h.shape and torch.equal(g, h)
    assert gc.LAUNCHES == 0


def test_em_iterations_is_the_plain_em():
    """``_em_to_tol`` is ``em_iterations`` without the counts."""
    x, w = _rows_data(2)
    args = _start(torch.Generator().manual_seed(3), x, w, 3, 4)
    fit, its = tgmm.em_iterations(*args, 100, 1e-5, 0.0, 1)
    assert its.shape == (2, 4) and bool(torch.all(its >= 2))
    assert all(torch.equal(a, b) for a, b in zip(
        fit, tgmm._em_to_tol(*args, 100, 1e-5, 0.0, 1)))


def _d4_indefinite(device, dtype=F64):
    """A D = 4 start whose lane (1, 3) has an indefinite covariance."""
    x, w = _rows_data(33, rows=2, m=200, d=4, k=2, dtype=dtype,
                      device=device)
    x4, w4, g, ridge = _start(torch.Generator().manual_seed(4), x, w, 2, 5)
    cov = g.cov.clone()
    cov[1, 3, 0] = torch.diag(torch.tensor([1.0, -1.0, 1.0, 1.0],
                                           dtype=dtype, device=device))
    return x4, w4, g._replace(cov=cov), ridge


def test_d4_indefinite_start_raises_on_cpu():
    """At D = 4 the plain version's Cholesky raises on a covariance that
    is not positive definite; the dispatch on the CPU is that version."""
    with pytest.raises(torch.linalg.LinAlgError):
        gc.em_to_tol_auto(*_d4_indefinite("cpu"), 100, 1e-5, 0.0, 1)


# ---------------------------------------------------------------------------
# what the launch refuses; the block layout; the counters
# ---------------------------------------------------------------------------

def _sound(k=3, d=2, rows=2, per_row=4):
    x, w = _rows_data(5, rows=rows, d=d, k=k)
    x4, w4, g, ridge = _start(torch.Generator().manual_seed(1), x, w, k,
                              per_row)
    return dict(x=x, w=w, ridge=ridge[:, 0].contiguous(),
                weight0=g.weight.contiguous(), mean0=g.mean.contiguous(),
                cov0=g.cov.contiguous())


def _faulty(fault):
    a = _sound(**({"k": 9} if fault == "k9" else {"d": 5} if fault == "d5"
                  else {}))
    if fault == "dtype":
        a["x"] = a["x"].float()
    elif fault == "int":
        a = {n: t.long() for n, t in a.items()}
    elif fault == "mixed":
        a["cov0"] = a["cov0"].float()
    elif fault == "device":
        a["mean0"] = a["mean0"].to("meta")
    elif fault == "x_strided":
        a["x"] = torch.cat([a["x"], a["x"]], -1)[..., ::2]
    elif fault == "start_strided":
        a["mean0"] = a["mean0"].transpose(-1, -2).contiguous() \
            .transpose(-1, -2)
    elif fault == "w_shape":
        a["w"] = a["w"][:, :-1].contiguous()
    elif fault == "x_rows":
        a["x"] = a["x"][:1].contiguous()
    elif fault == "ridge_shape":
        a["ridge"] = a["ridge"][:1].contiguous()
    elif fault == "mean_shape":
        a["mean0"] = a["mean0"][..., :1].contiguous()
    elif fault == "cov_shape":
        a["cov0"] = a["cov0"][:, :1].contiguous()
    elif fault == "weight_rank":
        a["weight0"] = a["weight0"][0].contiguous()
    elif fault == "k0":
        a = {n: t[:, :, :0].contiguous() if n in ("weight0", "mean0",
                                                  "cov0") else t
             for n, t in a.items()}
    elif fault == "cpu":
        pass
    return a


FAULTS = {"k9": "K=9", "d5": "D=5", "k0": "K=0", "dtype": "dtype",
          "int": "float32 or float64", "mixed": "dtype",
          "device": "meta", "x_strided": "contiguous",
          "start_strided": "contiguous", "w_shape": "w has shape",
          "x_rows": "x has shape", "ridge_shape": "ridge has shape",
          "mean_shape": "mean0 has shape", "cov_shape": "cov0 has shape",
          "weight_rank": "weight0 must be", "cpu": "CUDA device"}


@pytest.mark.parametrize("fault", FAULTS)
def test_em_rows_refuses(fault):
    """Each fault is named before anything launches; sound CPU tensors are
    refused for their device, last."""
    with pytest.raises(ValueError, match=FAULTS[fault]):
        gc.em_rows(**_faulty(fault))
    assert gc.LAUNCHES == 0


@pytest.mark.parametrize("per_row,warps", [(1, 1), (20, 5), (50, 5),
                                           (8, 8), (9, 3), (64, 8), (7, 7)])
def test_block_warps_leaves_the_fewest_idle(per_row, warps):
    assert gc.block_warps(per_row) == warps


def test_rows_layout_shares_broadcast_data():
    """The pools' base means, broadcast over (lane, cluster), go to the
    kernel once ([M, D], every row reading it); per-row data as [R, ..]."""
    x, w = _rows_data(6, rows=1)
    pool = x[0].expand(3, 2, *x.shape[1:])
    got = gc._rows(pool, 2, 2)
    assert got.shape == x.shape[1:] and torch.equal(got, x[0])
    got = gc._rows(w[0].expand(3, 2, -1).clone(), 2, 1)
    assert got.shape == (6, w.shape[1]) and got.is_contiguous()
    x4 = x.expand(2, *x.shape[1:]).clone()[:, None]        # [R, 1, M, D]
    assert gc._rows(x4, 1, 2).shape == (2,) + x.shape[1:]


def test_counters_only_while_recording():
    its = torch.tensor([[3, 100], [7, 2]], dtype=torch.int32)
    with profiling.recording() as rec:
        gc.count_iterations(its, 100)
        gc.count_iterations(its[:1], 50)
    assert rec.counters == {"gmm.lanes": 6, "gmm.iters_run": 215,
                            "gmm.iters_fixed": 500}
    gc.count_iterations(its, 100)        # not recording: nothing kept
    assert rec.counters["gmm.lanes"] == 6


# ---------------------------------------------------------------------------
# the range: refused on the card before drawing; it covers the port's K
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,d", [(9, 2), (2, 5), (2, 0), (0, 2)])
def test_check_fit_refuses_beyond_the_kernel_on_the_card(k, d):
    with pytest.raises(ValueError, match="csrc/gmm.cu"):
        gc.check_fit("cuda", k, d)
    gc.check_fit("cpu", k, d)                 # the plain version takes any
    gc.check_fit("cuda", gc.MAX_K, 4)


class _Refused(Exception):
    pass


def _refuse(seen):
    def check(device, k_max, d):
        seen.append((torch.device(device).type, k_max, d))
        raise _Refused
    return check


def _no_draw(*args, **kwargs):
    raise AssertionError("drew before checking the fit")


@pytest.mark.parametrize("front", ["fit_gmm", "fit_gmm_split", "cluster",
                                   "cluster_batched"])
def test_front_ends_check_the_fit_before_drawing(front, monkeypatch):
    """The GMM fits hand their K, and the VBHEM front ends under 'random'
    their largest S, and D to ``check_fit`` before they draw or fit
    anything."""
    from vbhem_tpu_torch.config import VBHEMConfig
    from vbhem_tpu_torch.models import vbhem
    from vbhem_tpu_torch.utils import planted
    seen = []
    monkeypatch.setattr(gc, "check_fit", _refuse(seen))
    monkeypatch.setattr(torch, "rand", _no_draw)
    monkeypatch.setattr(vbhem, "draw_lanes", _no_draw)
    x, w = _rows_data(7, rows=1, m=40, pad=0)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(_Refused):
        if front == "fit_gmm":
            tgmm.fit_gmm(gen, x, 3, weights=w, lanes=(2,))
        elif front == "fit_gmm_split":
            tgmm.fit_gmm_split(x, 3, weights=w)
        else:
            base, _ = planted.planted_bank(6, "cpu", F64)
            getattr(vbhem, front)(gen, base, [1, 2], [2, 3], VBHEMConfig(
                trials=2, initmode="random", learn_hyps=False))
    assert seen == [("cpu", 3, 2)]


def _port_vbem_ks():
    """Every (K list, D) that the port's configurations, experiments and
    runner hand to a GMM start: VBEM 'random' / 'split' over the subjects'
    K (the synthetic protocol's S, the demo's S grids), and the VBHEM
    'random' initializer over the grids' S."""
    import ast
    from vbhem_tpu_torch.experiments import (demo_fixations, runner,
                                             synthetic, synthetic_experiment)
    found = [([int(inspect.signature(synthetic.learn_subject_hmms)
                   .parameters["s"].default)], 2)]
    found.append((list(inspect.signature(runner.run_repeat)
                       .parameters["s_grid"].default), 2))
    src = inspect.getsource(synthetic_experiment)
    smax = int(src.split('"--smax", type=int, default=')[1].split(")")[0])
    found.append((list(range(1, smax + 1)), 2))
    # the demo's VBEM S grids: the int lists its settings return
    for node in ast.walk(ast.parse(inspect.getsource(
            demo_fixations.demo_configs))):
        if isinstance(node, ast.List) and node.elts and all(
                isinstance(e, ast.Constant) for e in node.elts):
            found.append(([e.value for e in node.elts], 2))
    found.append((list(demo_fixations.REFERENCE_GRID[1]), 2))
    for f in sorted((ROOT / "gpubench" / "configs").glob("*.json")):
        cfg = json.loads(f.read_text())
        d = len(cfg["groups"][0]["mean"][0])
        k = cfg.get("vbem", {}).get("k", [])
        found.append((k if isinstance(k, list) else [k], d))
        if "grid" in cfg:
            found.append((cfg["grid"]["s"], d))
    return found


def test_kernel_range_covers_the_ports_fits():
    found = _port_vbem_ks()
    assert len(found) >= 8
    found = [(ks, d) for ks, d in found if ks]
    for ks, d in found:
        assert 1 <= min(ks) and max(ks) <= gc.MAX_K, ks
        assert d in gc.DIMS
        gc.check_fit("cuda", max(ks), d)
    # the face VBEM cell's K = 1..3 and the bank cell's K = 2
    assert {3, 2} <= {max(ks) for ks, _ in found}


# ---------------------------------------------------------------------------
# a NumPy transliteration of one warp's loop
# ---------------------------------------------------------------------------

def _butterfly(v):
    """The warp's xor butterfly over its 32 threads' values v [32, ...]:
    every thread ends with the same sum."""
    idx = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[idx ^ off]
    assert np.all((v == v[:1]) | np.isnan(v))
    return v[0]


def _stripes(vals, n):
    """Per-thread sums of vals [n, ...] over points t, t + 32, ... in order
    (thread t's running sum), then the butterfly."""
    q = -(-n // 32)
    acc = np.zeros((32,) + vals.shape[1:])
    for j in range(q):
        sl = vals[32 * j: 32 * j + 32]
        acc[:sl.shape[0]] = acc[:sl.shape[0]] + sl
    return _butterfly(acc)


def _inverse(a):
    """The kernel's inverse and log-determinant of a symmetric [D, D]."""
    d = a.shape[0]
    if d == 1:
        return 1.0 / a, np.log(a[0, 0])
    if d == 2:
        det = a[0, 0] * a[1, 1] - a[0, 1] * a[0, 1]
        return np.array([[a[1, 1], -a[0, 1]], [-a[0, 1], a[0, 0]]]) / det, \
            np.log(det)
    if d == 3:
        (a00, a01, a02), (_, a11, a12), (_, _, a22) = a
        c = np.array([[a11 * a22 - a12 * a12, a02 * a12 - a01 * a22,
                       a01 * a12 - a02 * a11],
                      [0, a00 * a22 - a02 * a02, a01 * a02 - a00 * a12],
                      [0, 0, a00 * a11 - a01 * a01]])
        c = np.triu(c) + np.triu(c, 1).T
        det = a00 * c[0, 0] + a01 * c[0, 1] + a02 * c[0, 2]
        return c / det, np.log(det)
    low = np.zeros((d, d))
    for j in range(d):
        low[j, j] = np.sqrt(a[j, j] - np.sum(low[j, :j] ** 2))
        for i in range(j + 1, d):
            low[i, j] = (a[i, j] - np.sum(low[i, :j] * low[j, :j])) \
                / low[j, j]
    li = np.linalg.inv(low)
    return li.T @ li, 2.0 * np.sum(np.log(np.diag(low)))


def em_warp_np(x, w, ridge, weight0, mean0, cov0, max_iter=100, tol=1e-5,
               log_floor=0.0, staged=True):
    """One lane of the kernel in NumPy: (weight, mean, cov, iterations)."""
    m, d = x.shape
    k = weight0.shape[0]
    c = _stripes(np.concatenate([w[:, None] * x, w[:, None]], 1), m)
    c = c[:d] / c[d]
    keep = w != 0 if staged else np.ones(m, bool)
    xs, ws = x[keep] - c, w[keep]
    mu = mean0 - c
    lo = np.tril(cov0)
    cv = lo + np.swapaxes(np.tril(cov0, -1), -1, -2) if d == 4 else \
        0.5 * (cov0 + np.swapaxes(cov0, -1, -2))
    wk = weight0.copy()
    ll = last = -np.finfo(np.float64).max
    it = 0
    while True:
        denom = 1.0 if last == 0 else last
        with np.errstate(invalid="ignore", divide="ignore",
                         over="ignore"):
            not_conv = np.abs((ll - last) / denom) > tol
        if not (it < max_iter and (it < 2 or not_conv)):
            break
        with np.errstate(invalid="ignore", divide="ignore",
                         over="ignore"):
            inv = [_inverse(cv[j]) for j in range(k)]
            lw = np.log(wk + log_floor)
            lp = np.stack([-0.5 * (np.einsum("nd,de,ne->n", xs - mu[j],
                                             inv[j][0], xs - mu[j])
                                   + inv[j][1] + d * math.log(2 * math.pi))
                           + lw[j] for j in range(k)], 1)
            mx = lp[:, 0].copy()
            for j in range(1, k):
                mx = np.where(np.isnan(lp[:, j]) | (lp[:, j] > mx),
                              lp[:, j], mx)
            mx = np.where(np.isfinite(mx), mx, 0.0)
            ex = np.exp(lp - mx[:, None])
            s = ex.sum(1)
            r = ex * (ws / s)[:, None]                           # [n, K]
            rx = r[:, :, None] * xs[:, None, :]                  # [n, K, D]
            rxx = rx[:, :, :, None] * xs[:, None, None, :]       # [.., D, D]
            n = xs.shape[0]
            new_ll = _stripes(((np.log(s) + mx) * ws)[:, None], n)[0]
            nk = _stripes(r, n) + 1e-30
            mu = _stripes(rx, n) / nk[:, None]
            m2 = _stripes(rxx, n) / nk[:, None, None]
            cv = (m2 - mu[:, :, None] * mu[:, None, :]) + ridge
            wk = nk / np.sum(nk)
        last, ll = ll, new_ll
        it += 1
    if it == 0:
        return weight0, mu + c, cov0, 0
    return wk, mu + c, cv, it


def _np_fit(x, w, g, ridge, **kw):
    """em_warp_np over every (row, lane) of x [R, M, D] (or [M, D]
    shared), w [R, M], the start g [R, L, ..], ridge [R, D, D]."""
    r, lanes, k = g.weight.shape
    out = [np.zeros(a.shape) for a in g]
    its = np.zeros((r, lanes), int)
    for i in range(r):
        xi = (x if x.dim() == 2 else x[i]).numpy()
        for p in range(lanes):
            *fit, its[i, p] = em_warp_np(xi, w[i].numpy(), ridge[i].numpy(),
                                         *(a[i, p].numpy() for a in g), **kw)
            for o, f in zip(out, fit):
                o[i, p] = f
    return out, its


def _close(got, want, rel=1e-11):
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.array_equal(np.isnan(a), np.isnan(b))
        ok = ~np.isnan(b)
        scale = max(np.max(np.abs(b[ok])), 1e-300) if ok.any() else 1.0
        assert np.max(np.abs(a[ok] - b[ok]), initial=0.0) <= rel * scale


@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_transliteration_matches_plain(k, d):
    """Every (K, D): two padded rows of three restart lanes each, their
    weighted means far from the origin; fits within 1e-11 of the largest
    entry, and the same iteration counts."""
    x, w = _rows_data(10 + 4 * k + d, d=d, k=max(k, 2))
    args = _start(torch.Generator().manual_seed(k * d), x, w, k, 3)
    want, its = tgmm.em_iterations(*args, 100, 1e-5, 0.0, 1)
    got, np_its = _np_fit(x, w, args[2], args[3][:, 0])
    assert np.array_equal(np_its, its.numpy())
    _close(got, [a.numpy() for a in want])


@pytest.mark.parametrize("case", ["unstaged", "log_floor", "max_iter",
                                  "k_points", "nan", "no_iteration",
                                  "pools"])
def test_transliteration_edge_cases(case):
    """The read from device memory (points of weight 0 skipped as they
    come), the split's log floor, lanes stopped at max_iter, a row with
    exactly K real points, a start the plain version turns NaN (an
    indefinite covariance: NaN from the first iteration, stopped after
    two), max_iter 0, and the VBHEM pools' per-lane weights on shared
    points."""
    k, d = 3, 2
    kw, floor, max_iter = {}, 0.0, 100
    x, w = _rows_data(21, m=80 if case != "k_points" else 3, k=k)
    args = list(_start(torch.Generator().manual_seed(4), x, w, k, 3))
    if case == "unstaged":
        kw["staged"] = False
    elif case == "log_floor":
        floor = 1e-300
    elif case == "max_iter":
        max_iter = 3
    elif case == "no_iteration":
        max_iter = 0
    elif case == "nan":
        cov = args[2].cov.clone()
        cov[0, 1, 2] = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
        args[2] = args[2]._replace(cov=cov)
    elif case == "pools":
        x = x[0]
        w = torch.stack([w[0] * (torch.arange(x.shape[0]) % 2 == j)
                         for j in range(2)])
        x4 = x.expand(2, 1, *x.shape)
        _, data_cov, ridge = tgmm._pooled(x4, w[:, None], 1e-6)
        g = args[2]
        args = [x4, w[:, None], g._replace(cov=torch.broadcast_to(
            (data_cov + ridge)[..., None, :, :], g.cov.shape)), ridge]
    want, its = tgmm.em_iterations(*args, max_iter, 1e-5, floor, 1)
    got, np_its = _np_fit(x, w, args[2], args[3][:, 0], max_iter=max_iter,
                          log_floor=floor, **kw)
    assert np.array_equal(np_its, its.numpy())
    _close(got, [a.numpy() for a in want])
    if case == "max_iter":
        assert bool(torch.all(its == 3))
    if case == "nan":
        assert np.all(np.isnan(got[1][0, 1])) and np_its[0, 1] == 2
        assert not np.any(np.isnan(got[1][1]))
    if case == "k_points":
        assert bool(torch.all(torch.isfinite(want.mean)))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _bank_cell(dtype, seed=2 ** 33 + 18):
    """The bank cell's data as its configuration draws it: x [S, M, D] and
    the weights [S, M] (all real)."""
    from gpubench.lib import data
    cfg = json.loads((ROOT / "gpubench" / "configs"
                      / "exprmt1_kb8192.json").read_text())
    d = cfg["data"]
    x, lengths = data.draw_sequences(
        data.generator(seed, "cuda"), cfg["groups"], cfg["subjects"],
        d["seqs_per_subject"], d["seq_len"], d["noise"], "cuda", dtype)
    mask = torch.arange(x.shape[2], device="cuda") < lengths[..., None]
    return x.flatten(1, 2), mask.flatten(1).to(dtype)


def _face_cell(dtype, seed=2 ** 33 + 18):
    """The face VBEM cell's ragged viewers as its job lays them out (the
    padded bank's slots): x [S, N T, D], the weights [S, N T]."""
    from gpubench.jobs import bank_select
    from gpubench.lib import data
    cfg = json.loads((ROOT / "gpubench" / "configs"
                      / "face_vbem_kb8192.json").read_text())
    x, lengths, _, _ = bank_select.draw_viewers(
        data.generator(seed, "cuda"), cfg, "cuda", dtype)
    mask = torch.arange(x.shape[2], device="cuda") < lengths[..., None]
    return x.flatten(1, 2), mask.flatten(1).to(dtype)


CELLS = {"bank": (_bank_cell, 2, 20), "face_k1": (_face_cell, 1, 1),
         "face_k2": (_face_cell, 2, 50), "face_k3": (_face_cell, 3, 50)}
# Float32 at the cells' shapes, against the plain float64 fit: the lanes
# the kernel may leave off (_lanes_off) beyond the plain float32 version,
# twice the largest excess read on the H100 (157, face K = 2; bank 64,
# face K = 3 none); the NaN lanes it may add, between the largest excess
# of the final kernel (7, face K = 3) and that of a kernel whose m2 - mean
# mean^T was fused (11 there, 4 at face K = 2).
F32_SLACK_LANES = 314
F32_NAN_SLACK = 9


def _plain_rows(args, max_iter=100, tol=1e-5, floor=0.0, chunk=1024):
    """The plain version on the card, ``chunk`` rows at a time (each lane
    is independent): (GMM [R, L, ..], iterations [R, L])."""
    x4, w4, g, ridge = args
    outs, its = [], []
    for a in range(0, x4.shape[0], chunk):
        sl = slice(a, a + chunk)
        fit, it = tgmm.em_iterations(x4[sl], w4[sl], tgmm.GMM(
            *(t[sl] for t in g)), ridge[sl], max_iter, tol, floor, 1)
        outs.append(fit)
        its.append(it)
    return tgmm.GMM(*(torch.cat(p) for p in zip(*outs))), torch.cat(its)


def _kernel_rows(args, max_iter=100, tol=1e-5, floor=0.0):
    x4, w4, g, ridge = args
    *fit, its = gc.em_rows(x4[:, 0].contiguous(), w4[:, 0].contiguous(),
                           ridge[:, 0].contiguous(),
                           *(t.contiguous() for t in g), max_iter=max_iter,
                           tol=tol, log_floor=floor)
    return tgmm.GMM(*fit), its


def _rel(a, b):
    ok = torch.isfinite(b)
    return float(torch.max(torch.abs(a[ok] - b[ok]))
                 / torch.clamp_min(torch.max(torch.abs(b[ok])), 1e-300))


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_card_cells_float64(card, cell):
    """At the cell's full shape in float64: the kernel's fits within 1e-10
    of the plain version's, NaN where it is NaN, and the same iterations
    on every lane."""
    draw, k, lanes = CELLS[cell]
    x, w = draw(F64)
    args = _start(torch.Generator().manual_seed(18), x, w, k, lanes)
    got, its = _kernel_rows(args)
    want, want_its = _plain_rows(args)
    for a, b in zip(got, want):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert _rel(a, b) < 1e-10
    same = its.long() == want_its
    print(f"\n{cell} f64: {its.numel()} lanes, iterations mean "
          f"{its.double().mean():.2f} max {int(its.max())}; "
          f"{int((~same).sum())} lanes stopped at another iteration")
    assert bool(torch.all(same))


def _lanes_off(fit, ref, x, w, tol=1e-3) -> torch.Tensor:
    """Lanes [R, L] whose fit leaves the float64 fit ``ref`` by more than
    ``tol``: weights absolutely, means relative to the data's spread and
    covariances to its square, or NaN where ``ref`` is not."""
    real = w > 0
    scale = float(torch.std(x.double()[real]))
    gaps = ((fit.weight.double() - ref.weight).abs().amax(-1),
            (fit.mean.double() - ref.mean).abs().flatten(2).amax(-1) / scale,
            (fit.cov.double() - ref.cov).abs().flatten(2).amax(-1)
            / scale ** 2)
    off = torch.zeros_like(gaps[0], dtype=torch.bool)
    for g in gaps:
        off |= g > tol
    nan = lambda g: torch.isnan(g.mean).flatten(2).any(-1)
    return off | (nan(fit) & ~nan(ref))


def _f32_against_f64(x, w, k, lanes, max_iter=100):
    """The kernel and the plain version in float32 from one start, and the
    plain float64 fit from the same start on the same points: ((kernel
    fit, its), (plain fit, its), float64 fit)."""
    gen = lambda: torch.Generator().manual_seed(18)
    args = _start(gen(), x, w, k, lanes)
    ref, _ = _plain_rows(_start(gen(), x.double(), w.double(), k, lanes),
                         max_iter=max_iter)
    return (_kernel_rows(args, max_iter=max_iter),
            _plain_rows(args, max_iter=max_iter), ref)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_card_cells_float32(card, cell):
    """At the cell's full shape in float32: the kernel leaves no more
    lanes off the plain float64 fit from the same start (1e-3, see
    ``_lanes_off``) than the plain float32 version does, up to
    F32_SLACK_LANES, and no more NaN lanes, up to F32_NAN_SLACK; the lanes
    that stopped at another iteration than the plain float32 run
    reported."""
    draw, k, lanes = CELLS[cell]
    x, w = draw(torch.float32)
    (got, its), (want, want_its), ref = _f32_against_f64(x, w, k, lanes)
    off_k = int(_lanes_off(got, ref, x, w).sum())
    off_p = int(_lanes_off(want, ref, x, w).sum())
    nan = lambda g: int(torch.isnan(g.mean).flatten(2).any(-1).sum())
    other = 100 * float((its.long() != want_its).double().mean())
    print(f"\n{cell} f32: {its.numel()} lanes; off the float64 fit: kernel "
          f"{off_k}, plain {off_p}; stopped at another iteration than the "
          f"plain run {other:.3f}%; NaN lanes kernel {nan(got)} plain "
          f"{nan(want)} float64 {nan(ref)}")
    assert off_k <= off_p + F32_SLACK_LANES
    assert nan(got) <= nan(want) + F32_NAN_SLACK


def _edge(case, dtype):
    k, max_iter, reg = 3, 100, 1e-6
    m = 3 if case == "k_points" else 400
    x, w = _rows_data(31, rows=3, m=m, k=k, dtype=dtype, device="cuda")
    if case == "collapse":
        # four copies of one point, far from the rest, start a component
        x[:, :4] = x[:, :1] + 5000.0
        reg = 0.0
    args = list(_start(torch.Generator().manual_seed(5), x, w, k, 7,
                       reg=reg))
    if case == "collapse":
        mean = args[2].mean.clone()
        mean[:, :, 0] = x[:, None, 0]
        args[2] = args[2]._replace(mean=mean)
    elif case == "max_iter":
        max_iter = 3
    elif case == "nan":
        cov = args[2].cov.clone()
        cov[1, 2, 0] = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
        args[2] = args[2]._replace(cov=cov)
    return args, max_iter


EDGE_CASES = [(case, dtype) for case in ("max_iter", "k_points", "nan",
                                         "unstaged")
              for dtype in (F64, torch.float32)] + [("collapse",
                                                     torch.float32)]


@pytest.mark.card
@pytest.mark.parametrize("case,dtype", EDGE_CASES)
def test_card_edge_cases(card, case, dtype, monkeypatch):
    """A lane at max_iter, a row of exactly K real points, an indefinite
    start (NaN from the first iteration, stopped after two), rows read
    from device memory, and in float32 a component collapsing onto four
    copies of one point with no ridge (NaN once its determinant
    underflows, as in the plain version): NaN on the same lanes as the
    plain version; float64 the same iterations and within 1e-10.  (In
    float64 the collapse's determinant does not underflow, and whether its
    scatter rounds below zero is a matter of summation order: on the H100
    the plain version turned 1 of 21 lanes NaN there and the kernel
    none.)"""
    args, max_iter = _edge(case, dtype)
    if case == "unstaged":
        monkeypatch.setattr(gc, "SHARED_BYTES", 0)
    got, its = _kernel_rows(args, max_iter=max_iter)
    want, want_its = _plain_rows(args, max_iter=max_iter)
    nan_k = torch.isnan(got.mean).flatten(2).any(-1)
    nan_p = torch.isnan(want.mean).flatten(2).any(-1)
    print(f"\n{case} {dtype}: NaN lanes kernel {int(nan_k.sum())} plain "
          f"{int(nan_p.sum())} of {nan_k.numel()}")
    assert torch.equal(nan_k, nan_p)
    if case == "nan":
        assert bool(nan_k[1, 2]) and int(its[1, 2]) == 2
    if case == "collapse" and dtype == torch.float32:
        assert bool(nan_k.any())
    if case == "max_iter":
        assert bool(torch.all(its == 3))
    if dtype == F64:
        assert torch.equal(its.long(), want_its)
        for a, b in zip(got, want):
            assert _rel(a, b) < 1e-10


@pytest.mark.card
@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_card_d4_indefinite_start_raises(card, dtype):
    """At D = 4 the dispatch raises on an indefinite start, as the plain
    version does on the card; the kernel itself turns that lane NaN and
    no other."""
    args = _d4_indefinite("cuda", dtype)
    for fit in (tgmm._em_to_tol, gc.em_to_tol_auto):
        with pytest.raises(torch.linalg.LinAlgError):
            fit(*args, 100, 1e-5, 0.0, 1)
    got, _ = _kernel_rows(args)
    nan = torch.isnan(got.cov).flatten(2).any(-1)
    assert bool(nan[1, 3]) and int(nan.sum()) == 1


@pytest.mark.card
@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("d", [1, 3, 4])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_card_shapes(card, k, d, dtype):
    """K = 1, 4, 8 and D = 1, 3, 4 against the plain version, 4 rows of
    32 lanes: float64 the same iterations and within 1e-10; float32 no
    more lanes off the float64 fit than the plain float32 version leaves,
    up to 6 of the 128 (at K = 8 on 300 points in one dimension float32
    and float64 part on a few lanes either way: 2 against 0 of 18 on the
    H100)."""
    x, w = _rows_data(41 + k + d, rows=4, m=300, d=d, k=k, dtype=dtype,
                      device="cuda")
    if dtype == F64:
        args = _start(torch.Generator().manual_seed(6), x, w, k, 32)
        got, its = _kernel_rows(args)
        want, want_its = _plain_rows(args)
        assert torch.equal(its.long(), want_its)
        for a, b in zip(got, want):
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            assert _rel(a, b) < 1e-10
        return
    (got, _), (want, _), ref = _f32_against_f64(x, w, k, 32)
    off_k = int(_lanes_off(got, ref, x, w).sum())
    off_p = int(_lanes_off(want, ref, x, w).sum())
    print(f"\nK={k} D={d} f32: lanes off the float64 fit kernel {off_k} "
          f"plain {off_p} of 128")
    assert off_k <= off_p + 6


@pytest.mark.card
def test_card_fits_go_through_the_kernel(card):
    """fit_gmm, fit_gmm_split and the pools' fit_gmm_from_means launch the
    kernel once each and agree with the plain version in float64."""
    x, w = _rows_data(51, rows=4, m=200, dtype=F64, device="cuda")
    before = gc.LAUNCHES
    gen = torch.Generator(device="cuda")
    got = tgmm.fit_gmm(gen.manual_seed(3), x, 3, weights=w, lanes=(5,))
    split = tgmm.fit_gmm_split(x, 3, weights=w)
    pool = x[0].expand(2, 3, *x.shape[1:])
    wts = w[:3].expand(2, 3, -1)
    pools = tgmm.fit_gmm_from_means(pool, pool[..., 2:4, :], wts)
    assert gc.LAUNCHES == before + 3
    plain = tgmm._em_to_tol
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gc, "em_to_tol_auto", lambda *a: plain(*a))
        want = tgmm.fit_gmm(gen.manual_seed(3), x, 3, weights=w,
                            lanes=(5,))
        want_split = tgmm.fit_gmm_split(x, 3, weights=w)
        want_pools = tgmm.fit_gmm_from_means(pool, pool[..., 2:4, :], wts)
    for fit, ref in ((got, want), (split, want_split), (pools, want_pools)):
        for a, b in zip(fit, ref):
            assert a.shape == b.shape and _rel(a, b) < 1e-10


@pytest.mark.card
def test_card_counters_in_the_benchmarks_jobs(card):
    """One launch a K loop in the bank jobs (the benchmark's jobs, cut to
    their tiny size), the ``gmm.*`` counters in their recorder; no launch
    in a grid job."""
    from gpubench.lib import registry
    bench = registry.load_benchmark()
    seen = {}
    for name in ("bank.exprmt1_kb8192", "bank_select.face_vbem_kb8192",
                 "grid.exprmt1_kb8192", "grid.face_demo_kb8192"):
        cell = registry.cell(bench, name)
        traffic = registry.load_json(registry.traffic_file(cell["traffic"]))
        kind = registry.job_module(traffic["job"])
        config = kind.tiny(registry.load_json(
            registry.config_file(bench, cell["config"])))
        job = kind.Job(config, traffic, 2 ** 33 + 18, torch.device("cuda"))
        before = gc.LAUNCHES
        with profiling.recording() as rec:
            job.run(0)
        seen[name] = (gc.LAUNCHES - before, dict(rec.counters))
    for name, loops in (("bank.exprmt1_kb8192", 1),
                        ("bank_select.face_vbem_kb8192", 3)):
        launches, counters = seen[name]
        assert launches == loops
        assert counters["gmm.iters_fixed"] == 100 * counters["gmm.lanes"]
        assert 0 < counters["gmm.iters_run"] <= counters["gmm.iters_fixed"]
    for name in ("grid.exprmt1_kb8192", "grid.face_demo_kb8192"):
        assert seen[name][0] == 0
        assert not any(k.startswith("gmm.") for k in seen[name][1])
