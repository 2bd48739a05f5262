"""The k-means kernels of 'wtkmeans' (``csrc/kmeans.cu``, wrapped by
``vbhem_tpu_torch/ops/kmeans_cuda.py``).

On the CPU: the ``*_auto`` entries return exactly what the plain version
returns (``ops/kmeans.py``: ``kmeans``, ``weighted_kmeans_energy``, and
``kmeans`` under ``vbhem.wtkmeans_cluster_weights``, a (lane, cluster) a
lane), with and without lane axes; they raise on what the kernels do not
take, and the front ends refuse such a grid before drawing; they launch
nothing; the kernels' (K, D) range covers every grid that the port's
configurations, experiments and runner hand to 'wtkmeans'; and NumPy
transliterations of the kernels' loops (direct distances, torch.argmin's
tie rule, the Lloyd lane's exit at unchanged centers, the energy move's
one pass) give the plain version's results and move counts in float64.

On the card (marked ``card``, skipped here; run there with ``python -m
pytest --noconftest -o addopts="" -m card -s tests/test_torch_kmeans_cuda.py``,
as this file imports no JAX): the kernels against the plain version at
the face cell's full shapes and on edge cases, and the launch counters in
the benchmark's jobs.
"""
import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vbhem_tpu_torch.ops import kmeans as tkm
from vbhem_tpu_torch.ops import kmeans_cuda as kc
from vbhem_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
F64 = torch.float64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")


def _blobs(seed, m=203, d=2, k=4, lanes=(), pad=17, dtype=F64,
           device="cpu"):
    """Points around k centers plus ``pad`` padded points at the origin
    (weight 0), valid weights, positive long-run-like weights (0 at the
    padding) and seeds drawn from the points for every lane."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(0, 300, (k, d))
    x = np.concatenate([mu[rng.integers(0, k, m)]
                        + rng.normal(0, 20, (m, d)), np.zeros((pad, d))])
    valid = np.concatenate([np.ones(m), np.zeros(pad)])
    w = valid * rng.uniform(0.1, 1.0, m + pad)
    w = w / w.sum()
    n = int(np.prod(lanes))
    seeds = x[rng.choice(m, (n, k))].reshape(lanes + (k, d))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                  device=device)
    return t(x), t(valid), t(w), t(seeds)


LANES = [(), (3,), (2, 2)]


def _cluster_w(valid, assign, kr):
    """The recipe of ``vbhem.wtkmeans_cluster_weights``: each cluster's
    valid members under ``assign`` [*L, M], or every valid state where it
    has none.  [*L, Kr, M]."""
    member = (assign[..., None, :] == torch.arange(
        kr, device=assign.device)[:, None]).to(valid.dtype) * valid
    return torch.where(member.sum(-1, keepdim=True) > 0, member, valid)


# ---------------------------------------------------------------------------
# the CPU path is the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("entry", ["lloyd", "energy", "cluster"])
def test_auto_on_cpu_is_the_plain_version(entry, lanes):
    x, valid, w, seeds = _blobs(1, lanes=lanes)
    launches = kc.LAUNCHES
    if entry == "lloyd":
        got = kc.kmeans_auto(x, seeds, weights=valid)
        want = tkm.kmeans(None, x, seeds.shape[-2], weights=valid,
                          init_centers=seeds)
    elif entry == "energy":
        got = kc.weighted_kmeans_energy_auto(x, w, seeds)
        want = tkm.weighted_kmeans_energy(x, w, seeds)
    else:
        kr, sr = 3, 2
        assign, _ = tkm.weighted_kmeans_energy(x, w, _blobs(
            2, k=kr, lanes=lanes)[3])
        cseeds = _blobs(3, k=sr, lanes=lanes + (kr,))[3]
        wts = _cluster_w(valid, assign, kr)
        got = kc.kmeans_auto(x, cseeds, weights=wts)
        want = tkm.kmeans(None, x, sr, weights=wts, init_centers=cseeds)
    for g, h in zip(got, want):
        assert g.shape == h.shape and g.dtype == h.dtype
        assert torch.equal(g, h)
    assert kc.LAUNCHES == launches == 0


def test_lloyd_auto_without_weights_and_with_lane_weights():
    x, valid, w, seeds = _blobs(4, lanes=(3,))
    got = kc.kmeans_auto(x, seeds)
    want = tkm.kmeans(None, x, seeds.shape[-2], init_centers=seeds)
    assert all(torch.equal(g, h) for g, h in zip(got, want))
    lane_w = torch.stack([w, valid, w * 2])
    got = kc.kmeans_auto(x, seeds, weights=lane_w)
    want = tkm.kmeans(None, x, seeds.shape[-2], weights=lane_w,
                      init_centers=seeds)
    assert all(torch.equal(g, h) for g, h in zip(got, want))


def test_cluster_weights_is_the_initializer_recipe():
    """``vbhem.wtkmeans_cluster_weights`` of a bank is the tests' recipe
    over its valid states: a cluster's valid members, or every valid state
    where it has none (cluster 2 here)."""
    from vbhem_tpu_torch.containers import H3M, HMM
    from vbhem_tpu_torch.models import vbhem
    valid = torch.tensor([1., 1., 0., 1., 0.], dtype=F64)
    base = H3M(omega=torch.ones(1, dtype=F64), hmm=HMM(
        prior=torch.full((1, 5), 0.2, dtype=F64),
        trans=torch.full((1, 5, 5), 0.2, dtype=F64),
        mean=torch.zeros((1, 5, 2), dtype=F64),
        cov=torch.eye(2, dtype=F64).expand(1, 5, 2, 2)),
        state_mask=valid[None] > 0)
    assign = torch.tensor([[0, 1, 2, 0, 2]])
    got = vbhem.wtkmeans_cluster_weights(base, assign, 3)
    want = torch.tensor([[[1., 0., 0., 1., 0.], [0., 1., 0., 0., 0.],
                          [1., 1., 0., 1., 0.]]], dtype=F64)
    assert torch.equal(got, want)
    assert torch.equal(_cluster_w(valid, assign, 3), want)


# ---------------------------------------------------------------------------
# what the wrappers refuse
# ---------------------------------------------------------------------------

def _call(entry, x, valid, w, seeds):
    if entry == "lloyd":
        return kc.kmeans_auto(x, seeds, weights=valid)
    if entry == "energy":
        return kc.weighted_kmeans_energy_auto(x, w, seeds)
    # each (lane, cluster)'s weights [2, 2, M], as 'wtkmeans' passes them
    return kc.kmeans_auto(x, seeds, weights=valid)


def _faulty(fault, entry):
    """Arguments of ``entry`` with ``fault``; the others sound."""
    k, d = 3, 2
    if fault == "d0":
        d = 0
    elif fault == "d5":
        d = 5
    elif fault == "k9":
        k = 9
    x, valid, w, seeds = _blobs(5, d=d, k=k)
    lanes = (2,)
    seeds = seeds.expand(lanes + seeds.shape).contiguous()
    if entry == "cluster":   # a (lane, cluster) a lane, weights of its own
        seeds = seeds[..., None, :, :].expand(
            lanes + (2,) + seeds.shape[-2:]).contiguous()
        valid = valid.expand(lanes + (2,) + valid.shape).contiguous()
    if fault == "k0":
        seeds = seeds[..., :0, :]
    elif fault == "dtype":
        x = x.float()
    elif fault == "weights_dtype":
        valid, w = valid.float(), w.float()
    elif fault == "device":
        seeds = seeds.to("meta")
    elif fault == "x_strided":
        x = torch.cat([x, x], dim=1)[:, ::2]
    elif fault == "centers_strided":
        seeds = seeds.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif fault == "weights_strided":
        valid = torch.stack([valid, valid], -1)[..., 0]
        w = torch.stack([w, w], -1)[..., 0]
    elif fault == "weights_shape":
        valid, w = valid[..., :-1], w[..., :-1]
    elif fault == "centers_d":
        seeds = seeds[..., :1].contiguous()
    return x, valid, w, seeds


FAULTS = ["d0", "d5", "k0", "k9", "dtype", "weights_dtype", "device",
          "x_strided", "centers_strided", "weights_strided",
          "weights_shape", "centers_d"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("entry", ["lloyd", "energy", "cluster"])
def test_wrappers_refuse(entry, fault):
    with pytest.raises(ValueError):
        _call(entry, *_faulty(fault, entry))
    assert kc.LAUNCHES == 0


def test_lloyd_refuses_lane_weights_off_the_lanes():
    """Per-lane weights must have the centers' lane axes: [2, 2, M] seeds
    take [2, 2, M] or [M] weights, not [2, M] or [4, M]."""
    x, valid, w, seeds = _faulty("none", "cluster")
    for lanes in ((2,), (4,), (2, 1)):
        with pytest.raises(ValueError, match="weights"):
            kc.kmeans_auto(x, seeds, weights=valid[0, 0].expand(
                lanes + valid.shape[-1:]).contiguous())
    assert kc.LAUNCHES == 0


@pytest.mark.parametrize("d", [1, 4])
@pytest.mark.parametrize("entry", ["lloyd", "energy"])
def test_auto_takes_one_to_four_dimensions(entry, d):
    """D = 1 and D = 4 are inside the kernels' range (what kernel B1 takes
    for a fixation's dimensions without falling back): the CPU path is the
    plain version there too."""
    x, valid, w, seeds = _blobs(9, d=d, lanes=(2,))
    if entry == "lloyd":
        got = kc.kmeans_auto(x, seeds, weights=valid)
        want = tkm.kmeans(None, x, 4, weights=valid, init_centers=seeds)
    else:
        got = kc.weighted_kmeans_energy_auto(x, w, seeds)
        want = tkm.weighted_kmeans_energy(x, w, seeds)
    assert all(torch.equal(g, h) for g, h in zip(got, want))


@pytest.mark.parametrize("grid", [((1, 2, 9), (1, 2), 2), ((3,), (9,), 2),
                                  ((2,), (2,), 5), ((2,), (2,), 0)])
def test_check_grid_refuses_beyond_the_kernels_on_the_card(grid):
    ks, ss, d = grid
    with pytest.raises(ValueError, match="wtkmeans"):
        kc.check_grid("cuda", max(ks), max(ss), d)
    kc.check_grid("cpu", max(ks), max(ss), d)       # the plain version
    kc.check_grid("cuda", kc.MAX_K, kc.MAX_K, 4)


@pytest.mark.parametrize("front", ["cluster", "cluster_batched"])
@pytest.mark.parametrize("mode", ["auto", "wtkmeans", "baseem"])
def test_front_ends_check_the_grid_before_drawing(front, mode, monkeypatch):
    """``cluster`` and ``cluster_batched`` hand the whole grid to
    ``check_grid`` before any draw when they run 'wtkmeans'."""
    from vbhem_tpu_torch.config import VBHEMConfig
    from vbhem_tpu_torch.models import vbhem
    from vbhem_tpu_torch.utils import planted
    base, _ = planted.planted_bank(6, "cpu", F64)
    seen = []

    class Refused(Exception):
        pass

    def check(device, k_max, s_max, d):
        seen.append((torch.device(device).type, k_max, s_max, d))
        raise Refused

    def no_draw(*args, **kwargs):
        raise AssertionError("drew before checking the grid")

    monkeypatch.setattr(kc, "check_grid", check)
    monkeypatch.setattr(vbhem, "draw_lanes", no_draw)
    cfg = VBHEMConfig(trials=2, initmode=mode, learn_hyps=False)
    fn = getattr(vbhem, front)
    if mode == "baseem":
        with pytest.raises(AssertionError, match="drew"):
            fn(torch.Generator().manual_seed(0), base, [1, 3], [2], cfg)
        assert seen == []
    else:
        with pytest.raises(Refused):
            fn(torch.Generator().manual_seed(0), base, [1, 3], [2], cfg)
        assert seen == [("cpu", 3, 2, 2)]


# ---------------------------------------------------------------------------
# nothing launches on the CPU; the range covers the port's grids
# ---------------------------------------------------------------------------

def test_wtkmeans_start_on_cpu_launches_nothing():
    from vbhem_tpu_torch.config import VBHEMConfig
    from vbhem_tpu_torch.models import vbhem
    from vbhem_tpu_torch.utils import planted
    base, _ = planted.planted_bank(12, "cpu", F64)
    hyps = vbhem.VBHEMHyps.from_config(VBHEMConfig(), 2, F64, "cpu")
    with profiling.recording() as rec:
        post = vbhem.init_wtkmeans(torch.Generator().manual_seed(1), base, 3,
                                   2, hyps, 10, lanes=(4,))
    assert post.niw.m.shape[:3] == (4, 3, 2)
    assert kc.LAUNCHES == 0
    assert not any(k.startswith("kmeans.") for k in rec.counters)


def test_count_iterations_records_the_three_counters():
    """The Lloyd launches' iterations in PENDING become the three
    counters (the energy moves do not), and PENDING is emptied."""
    its = [("lloyd", torch.tensor([3, 100], dtype=torch.int32)),
           ("energy", torch.tensor([40, 50], dtype=torch.int32)),
           ("lloyd", torch.tensor([[1, 2], [5, 7]], dtype=torch.int32))]
    with profiling.recording() as rec:
        kc.PENDING[:] = its
        kc.count_iterations()
        assert kc.PENDING == []
        kc.count_iterations()
    assert rec.counters == {"kmeans.lanes": 6, "kmeans.iters_run": 118,
                            "kmeans.iters_fixed": 600}
    kc.PENDING[:] = its
    kc.count_iterations()     # not recording: nothing kept
    assert rec.counters["kmeans.lanes"] == 6 and kc.PENDING == []


def _port_grids():
    """Every (K grid, S grid, D) that the port's configurations,
    experiments and runner hand to 'wtkmeans' (directly, or through
    'auto'), and the benchmark's configurations."""
    from vbhem_tpu_torch.experiments import (demo_fixations, runner,
                                             synthetic, synthetic_experiment)
    grids = [(demo_fixations.REFERENCE_GRID[0],
              demo_fixations.REFERENCE_GRID[1], 2)]
    for fn in (runner.run_repeat, synthetic.run_vbhem):
        sig = inspect.signature(fn).parameters
        grids.append((list(sig["k_grid"].default),
                      list(sig["s_grid"].default), 2))
    src = inspect.getsource(synthetic_experiment)
    kmax = int(src.split('"--kmax", type=int, default=')[1].split(")")[0])
    smax = int(src.split('"--smax", type=int, default=')[1].split(")")[0])
    grids.append((list(range(1, kmax + 1)), list(range(1, smax + 1)), 2))
    for f in sorted((ROOT / "gpubench" / "configs").glob("*.json")):
        cfg = json.loads(f.read_text())
        if "grid" not in cfg:           # a VBEM-only configuration
            continue
        d = len(cfg["groups"][0]["mean"][0])
        grids.append((cfg["grid"]["k"], cfg["grid"]["s"], d))
    return grids


def test_kernel_range_covers_the_ports_grids():
    grids = _port_grids()
    assert len(grids) >= 6
    for ks, ss, d in grids:
        assert max(ks) <= kc.MAX_K and max(ss) <= kc.MAX_K, (ks, ss)
        assert min(ks) >= 1 and min(ss) >= 1
        assert d in kc.DIMS
        kc.check_grid("cuda", max(ks), max(ss), d)
    # the padded grid runs every lane at (max K, max S): the face cell's
    assert (5, 3) in {(max(ks), max(ss)) for ks, ss, _ in grids}


# ---------------------------------------------------------------------------
# NumPy transliterations of the kernels' loops
# ---------------------------------------------------------------------------

def _first_min(f):
    """torch.argmin's order over the last axis: the first NaN, else the
    first minimum."""
    nan = np.isnan(f)
    return np.where(nan.any(-1), np.argmax(nan, -1),
                    np.argmin(np.where(nan, np.inf, f), -1))


def _nearest(x, c):
    return _first_min(((x[:, None, :] - c[None]) ** 2).sum(-1))


def _sums(x, w, a, k):
    oh = (a[:, None] == np.arange(k)) * w[:, None]
    return oh.sum(0), oh.T @ x


def lloyd_np(x, w, c0, max_iter=100):
    """The Lloyd kernel, lane by lane: (assignment, centers, iterations
    run).  A lane leaves its loop after an iteration that returns every
    center unchanged."""
    k = c0.shape[-2]
    out = []
    for wl, c in zip(w, c0):
        c, it = c.copy(), 0
        while it < max_iter:
            mass, s = _sums(x, wl, _nearest(x, c), k)
            new = np.where(mass[:, None] > 0,
                           s / np.maximum(mass, 1e-30)[:, None], c)
            it += 1
            same = np.array_equal(new, c)
            c = new
            if same:
                break
        out.append((_nearest(x, c), c, it))
    return [np.stack(v) for v in zip(*out)]


def energy_np(x, w, c0, max_iter=100, tol=1e-6):
    """The energy kernel, lane by lane: pass k reads state k, sums its
    energy and forms move k; the stop test reads state k's energy.
    (assignment, centers, moves)."""
    k = c0.shape[-2]
    out = []
    for c in c0:
        a = _nearest(x, c)
        mass, s = _sums(x, w, a, k)
        moves, e_old = 0, None
        while True:
            wc, c = mass, s / np.maximum(mass, 1e-30)[:, None]
            num = ((x[:, None, :] - c[None]) ** 2).sum(-1) * wc
            den = wc - w[:, None]
            with np.errstate(divide="ignore", invalid="ignore"):
                f = np.where(a[:, None] == np.arange(k),
                             np.where(den > 0, num / den, np.inf),
                             num / (wc + w[:, None]))
            own = f[np.arange(len(a)), a]
            e = np.sum(w * np.where(np.isfinite(own), own, 0.0))
            nxt = _first_min(f)
            if moves == 0:
                e_old = e + 2 * tol + 1.0
            if not (moves < max_iter and abs(e - e_old) >= tol):
                break
            mass, s = _sums(x, w, nxt, k)
            a, e_old, moves = nxt, e, moves + 1
        out.append((a, c, moves))
    return [np.stack(v) for v in zip(*out)]


def cluster_np(x, wts, c0, max_iter=100):
    """The per-cluster k-means: the Lloyd kernel with block (l, j) under
    its cluster's weights ``wts`` [L, Kr, M].  (centers, iterations
    run)."""
    _, c, it = lloyd_np(x, wts.reshape((-1,) + wts.shape[-1:]),
                        c0.reshape((-1,) + c0.shape[-2:]), max_iter)
    return c.reshape(c0.shape), it.reshape(c0.shape[:-2])


def energy_moves_plain(x, w, init_centers, max_iter=100, tol=1e-6):
    """The moves each lane of :func:`ops.kmeans.weighted_kmeans_energy`
    makes: its loop, counting (the plain version does not return them)."""
    k = init_centers.shape[-2]

    def state(assign):
        oh = torch.nn.functional.one_hot(assign, k).to(x.dtype) * w[:, None]
        w_c = oh.sum(-2)
        cen = (oh.transpose(-1, -2) @ x) / torch.clamp_min(w_c, 1e-30)[
            ..., None]
        d2 = tkm._sq_dist(x, cen)
        wc = w_c[..., None, :]
        den = wc - w[:, None]
        f = torch.where(torch.nn.functional.one_hot(assign, k).bool(),
                        torch.where(den > 0, d2 * wc / den, torch.inf),
                        d2 * wc / (wc + w[:, None]))
        own = torch.gather(f, -1, assign[..., None])[..., 0]
        e = torch.sum(torch.where(torch.isfinite(own), w * own,
                                  torch.zeros_like(own)), -1)
        return f, e

    assign = torch.argmin(tkm._sq_dist(x, init_centers), -1)
    f, new_e = state(assign)
    old_e = new_e + 2 * tol + 1.0
    it = torch.zeros(new_e.shape, dtype=torch.int64, device=x.device)
    while True:
        active = (it < max_iter) & (torch.abs(new_e - old_e) >= tol)
        if not bool(torch.any(active)):
            return it
        nxt = torch.argmin(f, -1)
        nf, e = state(nxt)
        assign = torch.where(active[..., None], nxt, assign)
        f = torch.where(active[..., None, None], nf, f)
        old_e = torch.where(active, new_e, old_e)
        new_e = torch.where(active, e, new_e)
        it = it + active.long()


def _edge_case(case, dtype=F64, device="cpu"):
    """(x, valid, w, seeds [L, K, D]) of an edge case: 'empty' (a seed far
    from every point: its cluster stays empty), 'owner' (three points
    hold all the weight, so a cluster whose only weighted member is one of
    them gives that member the energy +inf),
    'sparse' (nine points in ten of weight 0), 'ragged' (M = 1031, not a
    multiple of the block)."""
    m = {"ragged": 1031}.get(case, 300)
    x, valid, w, seeds = _blobs(7, m=m, k=3, lanes=(4,), pad=13,
                                dtype=dtype, device=device)
    if case == "empty":
        seeds[:, 2] = 1e4
    elif case == "owner":
        w = torch.zeros_like(w)
        w[[5, 100, 200]] = torch.tensor([0.5, 0.3, 0.2], dtype=dtype,
                                        device=device)
    elif case == "sparse":
        keep = torch.arange(x.shape[0], device=device) % 10 == 0
        valid, w = valid * keep, w * keep
    return x, valid, w, seeds


EDGE_CASES = ["plain", "empty", "owner", "sparse", "ragged"]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_lloyd_transliteration_matches_plain(case):
    x, valid, _, seeds = _edge_case(case)
    want_a, want_c = tkm.kmeans(None, x, 3, weights=valid,
                                init_centers=seeds)
    lw = np.broadcast_to(valid.numpy(), (seeds.shape[0],) + valid.shape)
    a, c, it = lloyd_np(x.numpy(), lw, seeds.numpy())
    np.testing.assert_array_equal(a, want_a.numpy())
    np.testing.assert_allclose(c, want_c.numpy(), rtol=1e-12, atol=1e-9)
    assert np.all(it < 100)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_energy_transliteration_matches_plain(case):
    x, _, w, seeds = _edge_case(case)
    want_a, want_c = tkm.weighted_kmeans_energy(x, w, seeds)
    a, c, moves = energy_np(x.numpy(), w.numpy(), seeds.numpy())
    np.testing.assert_array_equal(a, want_a.numpy())
    np.testing.assert_allclose(c, want_c.numpy(), rtol=1e-12, atol=1e-9)
    np.testing.assert_array_equal(moves,
                                  energy_moves_plain(x, w, seeds).numpy())


@pytest.mark.parametrize("case", EDGE_CASES)
def test_cluster_transliteration_matches_plain(case):
    x, valid, w, seeds = _edge_case(case)
    kr, sr = 3, 2
    assign, _ = tkm.weighted_kmeans_energy(x, w, seeds)
    if case == "empty":
        assign = torch.where(assign == 2, 0, assign)   # cluster 2: no member
    cseeds = _blobs(8, m=x.shape[0] - 13, k=sr, lanes=(4, kr), pad=13)[3]
    wts = _cluster_w(valid, assign, kr)
    want = tkm.kmeans(None, x, sr, weights=wts, init_centers=cseeds)[1]
    got, it = cluster_np(x.numpy(), wts.numpy(), cseeds.numpy())
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-9)
    assert np.all(it < 100)


def test_energy_nan_energies_follow_argmin():
    """A point of weight 0 facing a cluster of mass 0 has energy 0/0 =
    NaN there (the padding against the empty cluster's zero center):
    torch.argmin takes the first NaN, and so does the transliteration."""
    x, _, w, seeds = _edge_case("empty")
    a, _, moves = energy_np(x.numpy(), w.numpy(), seeds.numpy())
    want_a, _ = tkm.weighted_kmeans_energy(x, w, seeds)
    np.testing.assert_array_equal(a, want_a.numpy())
    np.testing.assert_array_equal(moves,
                                  energy_moves_plain(x, w, seeds).numpy())
    a0 = _nearest(x.numpy(), seeds[0].numpy())
    assert not np.any(a0 == 2) and np.any(w.numpy() == 0)
    f = np.array([[1.0, np.nan, 0.5, np.nan], [2.0, 1.0, 1.0, 3.0],
                  [np.inf, np.inf, 1.0, np.nan]])
    np.testing.assert_array_equal(
        _first_min(f), torch.argmin(torch.as_tensor(f), -1).numpy())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _face_bank(dtype, device="cuda", seed=2 ** 33 + 16):
    """The face cell's bank, drawn as its configuration file draws it, and
    its pool: (base, means [M, D], valid [M], long-run weights [M])."""
    from gpubench.lib import data
    from vbhem_tpu_torch.containers import H3M, HMM
    from vbhem_tpu_torch.models import vbhem
    cfg = json.loads((ROOT / "gpubench" / "configs"
                      / "face_demo_kb8192.json").read_text())
    omega, prior, trans, mean, cov, mask = data.draw_bank(
        data.generator(seed, device), cfg["groups"], cfg["subjects"],
        cfg["grid_bank"], device, dtype)
    base = H3M(omega=omega, hmm=HMM(prior=prior, trans=trans, mean=mean,
                                    cov=cov), state_mask=mask)
    means, _, valid = vbhem._pool(base)
    return base, means, valid, vbhem.long_run_weights(base)


def _face_seeds(base, means, valid, lanes=750, kr=5, sr=3):
    """The kmeans++ seeds of the first stage [L, Kr, D] and of the global
    k-means [L, Sr, D], from 'wtkmeans''s own draws."""
    from vbhem_tpu_torch.models import vbhem
    gen = torch.Generator(device=means.device).manual_seed(16)
    dr = vbhem.draw_wtkmeans(gen, base, kr, sr, (lanes,))
    return (tkm.kmeans_pp_from_uniforms(means, kr, valid, dr["u_assign"]),
            tkm.kmeans_pp_from_uniforms(means, sr, valid, dr["u_global"]),
            dr["u_cluster"])


def _energy_kernel(x, w, seeds):
    """The energy kernel's (assignment, centers) and each lane's moves,
    read from the launch's entry in PENDING."""
    with profiling.recording():
        out = kc.weighted_kmeans_energy_auto(x, w, seeds)
        kind, moves = kc.PENDING.pop()
    assert kind == "energy"
    return out + (moves.long(),)


def _stages(means, valid, lw, seeds_kr, seeds_sr, u_cluster, kernel):
    """The first three k-means of 'wtkmeans' on one path: (first stage's
    centers, energy assignment and centers, global centers), and the
    moves of the energy loop (the kernel's, or counted)."""
    kr, sr = seeds_kr.shape[-2], seeds_sr.shape[-2]
    if kernel:
        _, c1 = kc.kmeans_auto(means, seeds_kr, weights=valid)
        a2, c2, moves = _energy_kernel(means, lw, c1)
        _, c3 = kc.kmeans_auto(means, seeds_sr, weights=valid)
    else:
        _, c1 = tkm.kmeans(None, means, kr, weights=valid,
                           init_centers=seeds_kr)
        a2, c2 = tkm.weighted_kmeans_energy(means, lw, c1)
        moves = energy_moves_plain(means, lw, c1)
        _, c3 = tkm.kmeans(None, means, sr, weights=valid,
                           init_centers=seeds_sr)
    return c1, a2, c2, c3, moves


def _cluster_stage(means, valid, a2, u_cluster, kernel, sr=3):
    """The per-cluster k-means, seeded as 'wtkmeans' seeds it: its
    centers [L, Kr, Sr, D]."""
    kr = u_cluster.shape[-2]
    wts = _cluster_w(valid, a2, kr)
    seeds = tkm.kmeans_pp_from_uniforms(means, sr, wts, u_cluster)
    fn = kc.kmeans_auto if kernel else (
        lambda x, c, weights: tkm.kmeans(None, x, sr, weights=weights,
                                         init_centers=c))
    return fn(means, seeds, weights=wts)[1]


def _rel(a, b):
    return float(torch.max(torch.abs(a - b))
                 / torch.clamp_min(torch.max(torch.abs(b)), 1e-300))


@pytest.mark.card
def test_card_face_shapes_float64(card):
    """At the face cell's shapes in float64: identical assignments and
    move counts, centers within 1e-12 relative, the kernel's launches
    counted, and the Lloyd lanes leaving their loops early."""
    base, means, valid, lw = _face_bank(F64)
    seeds_kr, seeds_sr, u_cluster = _face_seeds(base, means, valid)
    before = kc.LAUNCHES
    got = _stages(means, valid, lw, seeds_kr, seeds_sr, u_cluster, True)
    want = _stages(means, valid, lw, seeds_kr, seeds_sr, u_cluster, False)
    assert kc.LAUNCHES == before + 3
    c1, a2, c2, c3, moves = got
    assert _rel(c1, want[0]) < 1e-12
    assert torch.equal(a2, want[1])
    assert _rel(c2, want[2]) < 1e-12
    assert _rel(c3, want[3]) < 1e-12
    assert torch.equal(moves, want[4])
    with profiling.recording():
        c4 = _cluster_stage(means, valid, a2, u_cluster, True)
        kind, its = kc.PENDING.pop()
    assert kind == "lloyd" and its.shape == (750, 5)
    assert _rel(c4, _cluster_stage(means, valid, a2, u_cluster, False)) \
        < 1e-12
    print(f"\nface f64: energy moves mean {moves.double().mean():.2f} max "
          f"{int(moves.max())}; per-cluster Lloyd iterations mean "
          f"{its.double().mean():.2f} max {int(its.max())} of 100")
    assert int(its.max()) <= 100


@pytest.mark.card
def test_card_face_shapes_float32_lanes_off_float64(card):
    """In float32, how many lanes' starts differ from the plain float64
    run, for the kernel and for the plain float32 path: the kernel's
    direct distances may not leave more lanes off than the plain path's
    GEMM expansion does (on the H100: 120 and 205 lanes of 750)."""
    out = {}
    base64, means64, valid64, lw64 = _face_bank(F64)
    seeds = _face_seeds(base64, means64, valid64)
    ref = _stages(means64, valid64, lw64, *seeds, False)
    ref4 = _cluster_stage(means64, valid64, ref[1], seeds[2], False)
    # the same points, seeds and weights, rounded to float32
    means, valid, lw = means64.float(), valid64.float(), lw64.float()
    s32 = (seeds[0].float(), seeds[1].float(), seeds[2])
    for name, kernel in (("kernel", True), ("plain", False)):
        c1, a2, c2, c3, moves = _stages(means, valid, lw, *s32, kernel)
        c4 = _cluster_stage(means, valid, a2, s32[2], kernel)
        out[name] = {
            "lanes_assign_differ": int(torch.sum(torch.any(a2 != ref[1],
                                                           -1))),
            "lanes_moves_differ": int(torch.sum(moves != ref[4])),
            "lanes_centers_off_1e-4": int(torch.sum(torch.amax(
                torch.abs(c4.double() - ref4) / 400.0, (-1, -2, -3))
                > 1e-4))}
    print("\nface f32 lanes off the plain float64 run (of 750):",
          json.dumps(out))
    for what in ("lanes_assign_differ", "lanes_moves_differ",
                 "lanes_centers_off_1e-4"):
        assert out["kernel"][what] <= out["plain"][what], what


@pytest.mark.card
@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_card_edge_cases(card, case, dtype):
    """The kernels against the plain version on the edge cases; float64
    exact assignments and move counts, float32 within rounding."""
    x, valid, w, seeds = _edge_case(case, dtype, "cuda")
    tol = 1e-12 if dtype == F64 else 1e-4
    a1, c1 = kc.kmeans_auto(x, seeds, weights=valid)
    b1, d1 = tkm.kmeans(None, x, 3, weights=valid, init_centers=seeds)
    a2, c2, moves = _energy_kernel(x, w, seeds)
    b2, d2 = tkm.weighted_kmeans_energy(x, w, seeds)
    if dtype == F64:
        assert torch.equal(a1, b1) and torch.equal(a2, b2)
        assert torch.equal(moves, energy_moves_plain(x, w, seeds))
    assert _rel(c1, d1) < tol and _rel(c2, d2) < tol
    assign = b2 if case != "empty" else torch.where(b2 == 2, 0, b2)
    cseeds = _blobs(8, m=x.shape[0] - 13, k=2, lanes=(4, 3), pad=13,
                    dtype=dtype, device="cuda")[3]
    wts = _cluster_w(valid, assign, 3)
    got = kc.kmeans_auto(x, cseeds, weights=wts)
    want = tkm.kmeans(None, x, 2, weights=wts, init_centers=cseeds)
    if dtype == F64:
        assert torch.equal(got[0], want[0])
    assert _rel(got[1], want[1]) < tol


@pytest.mark.card
@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("d", [1, 3, 4])
def test_card_dimensions(card, d, dtype):
    """D = 1, 3, 4 against the plain version: float64 exact assignments
    and move counts, float32 centers within rounding."""
    x, valid, w, seeds = _blobs(11, m=500, d=d, lanes=(6,), dtype=dtype,
                                device="cuda")
    tol = 1e-12 if dtype == F64 else 1e-4
    a1, c1 = kc.kmeans_auto(x, seeds, weights=valid)
    b1, d1 = tkm.kmeans(None, x, 4, weights=valid, init_centers=seeds)
    a2, c2, moves = _energy_kernel(x, w, seeds)
    b2, d2 = tkm.weighted_kmeans_energy(x, w, seeds)
    if dtype == F64:
        assert torch.equal(a1, b1) and torch.equal(a2, b2)
        assert torch.equal(moves, energy_moves_plain(x, w, seeds))
    assert _rel(c1, d1) < tol and _rel(c2, d2) < tol


@pytest.mark.card
@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_card_energy_state_in_device_memory(card, dtype, monkeypatch):
    """Past SHARED_POINTS points the energy kernel keeps its state in a
    device workspace: the same results as the plain version (forced here
    at M = 1031 by lowering SHARED_POINTS)."""
    x, _, w, seeds = _edge_case("ragged", dtype, "cuda")
    monkeypatch.setattr(kc, "SHARED_POINTS", 64)
    a2, c2, moves = _energy_kernel(x, w, seeds)
    b2, d2 = tkm.weighted_kmeans_energy(x, w, seeds)
    if dtype == F64:
        assert torch.equal(a2, b2)
        assert torch.equal(moves, energy_moves_plain(x, w, seeds))
    assert _rel(c2, d2) < (1e-12 if dtype == F64 else 1e-4)


@pytest.mark.card
def test_card_counters_in_the_benchmarks_jobs(card):
    """``kmeans.*`` counters in a face job (the benchmark's job, cut to
    its tiny size); no k-means launch in an exprmt1 grid job (baseem) or
    in a bank job (GMM starts)."""
    from gpubench.lib import registry
    bench = registry.load_benchmark()
    seen = {}
    for name in ("grid.face_demo_kb8192", "grid.exprmt1_kb8192",
                 "bank.exprmt1_kb8192"):
        cell = registry.cell(bench, name)
        traffic = registry.load_json(registry.traffic_file(cell["traffic"]))
        kind = registry.job_module(traffic["job"])
        config = kind.tiny(registry.load_json(
            registry.config_file(bench, cell["config"])))
        job = kind.Job(config, traffic, 2 ** 33 + 16, torch.device("cuda"))
        before = kc.LAUNCHES
        with profiling.recording() as rec:
            job.run(0)
        seen[name] = (kc.LAUNCHES - before, dict(rec.counters))
    launches, counters = seen["grid.face_demo_kb8192"]
    assert launches > 0 and counters["kmeans.lanes"] > 0
    assert counters["kmeans.iters_fixed"] == 100 * counters["kmeans.lanes"]
    assert 0 < counters["kmeans.iters_run"] <= counters["kmeans.iters_fixed"]
    for name in ("grid.exprmt1_kb8192", "bank.exprmt1_kb8192"):
        assert seen[name][0] == 0
        assert not any(k.startswith("kmeans.") for k in seen[name][1])
