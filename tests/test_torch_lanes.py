"""The lane schedule (``models/lanes.py``) as each of the four EM engines
runs it: VBHEM (``vbhem.vbhem_em``), VBEM (``vbhmm.vbem_em``), grouped
VBEM (``vbhmm_groups.vbem_em``) and VHEM (``vhem.vhem_em``), each on a
few restart lanes of a tiny float64 problem on the CPU.

A lane whose bound is NaN ends at -inf with its start model; a lane that
is done keeps every field until the loop ends; ``max_iter`` stops a lane
that never converges; each loop iteration is one ``<engine>.iter`` span;
and the lanes run in chunks through ``lanes.in_chunks`` give the same
bits as all lanes at once.
"""
import math

import pytest
import torch

from vbhem_tpu_torch import HEMConfig, VBConfig, VBHEMConfig
from vbhem_tpu_torch.containers import SeqBatch, tree_map
from vbhem_tpu_torch.models import lanes, vbhem, vbhmm, vhem
from vbhem_tpu_torch.models import vbhmm_groups as tg
from vbhem_tpu_torch.utils import profiling
from vbhem_tpu_torch.utils.planted import planted_bank

DT = torch.float64
L = 5                 # restart lanes
# lanes a chunk: chunks of 3 and 2.  A chunk of one lane would take other
# CPU matmul paths in the VBHEM and VHEM statistics, whose rounding
# differs at 1e-13.
CHUNK = 3
MAX_ITER = 60


def _subjects(n=6, t=12, seed=4):
    """Sequences around two emission regions, as the tracing tests'."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, t, 2, generator=gen, dtype=DT)
    x[n // 2:] += 3.0
    return SeqBatch(x=x, lengths=torch.full((n,), t))


def _vbhem():
    base, _ = planted_bank(16, torch.device("cpu"), DT)
    cfg = VBHEMConfig(nv=10, tau=5, m0=(13.0, 10.0), w0=1.0)
    hyps = vbhem.VBHEMHyps.from_config(cfg, 2, DT, torch.device("cpu"))
    init = vbhem.draw_lanes("baseem", torch.Generator().manual_seed(3),
                            base, 2, 2, hyps, cfg.nv, L)

    def run(post, max_iter=MAX_ITER, min_diff=1e-5):
        return vbhem.vbhem_em(base, post, hyps, nv=cfg.nv, tau=cfg.tau,
                              max_iter=max_iter, min_diff=min_diff)
    return run, init, (vbhem, "_em_iteration", 1)


def _vbem():
    data = _subjects()
    hyps = vbhmm.VBHyps.from_config(VBConfig(), 2, DT, torch.device("cpu"))
    init = vbhmm.random_init(torch.Generator().manual_seed(1), data, 2,
                             hyps, lanes=(L,))

    def run(post, max_iter=MAX_ITER, min_diff=1e-5):
        return vbhmm.vbem_em(data, post, hyps, max_iter=max_iter,
                             min_diff=min_diff)
    return run, init, (vbhmm, "_iteration", 1)


def _grouped():
    data = _subjects()
    group_map = torch.tensor([0, 1, 0, 1, 0, 1])
    hyps = vbhmm.VBHyps.from_config(VBConfig(), 2, DT, torch.device("cpu"))
    init = tg.from_ungrouped(vbhmm.random_init(
        torch.Generator().manual_seed(2), data, 2, hyps, lanes=(L,)), 2)

    def run(post, max_iter=MAX_ITER, min_diff=1e-5):
        return tg.vbem_em(data, post, hyps, group_map, max_iter=max_iter,
                          min_diff=min_diff)
    return run, init, (tg, "elbo", None)


def _vhem():
    base, _ = planted_bank(16, torch.device("cpu"), DT)
    # no covariance regularization, so the start model enters the loop as
    # it is
    cfg = HEMConfig(trials=L, nv=10, tau=5, reg_cov=0.0)
    init = vhem.init_baseem(torch.Generator().manual_seed(5), base, 2, 2,
                            cfg, lanes=(L,))

    def run(h3m, max_iter=MAX_ITER, min_diff=1e-5):
        return vhem.vhem_em(base, h3m, HEMConfig(
            trials=L, nv=10, tau=5, reg_cov=0.0, max_iter=max_iter,
            min_diff=min_diff), gen=torch.Generator().manual_seed(0))
    return run, init, (vhem, "_iteration", 2)


# engine: (its problem, its span name, its model's field)
ENGINES = {"vbhem": (_vbhem, "vbhem_em", "post"),
           "vbem": (_vbem, "vbem_em", "post"),
           "grouped": (_grouped, "grouped_em", "post"),
           "vhem": (_vhem, "vhem_em", "h3m")}


@pytest.fixture(scope="module", params=list(ENGINES))
def engine(request):
    make, name, model = ENGINES[request.param]
    run, init, ll_site = make()
    return dict(run=run, init=init, ll_site=ll_site, name=name, model=model)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for part in tree for x in _leaves(part)]
    return [] if tree is None else [tree]


def _lane(tree, i):
    return tree_map(lambda a: a[i], tree)


def _assert_same_bits(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_nan_lane_ends_at_minus_inf_with_its_start_model(engine,
                                                          monkeypatch):
    """A lane whose first bound is NaN becomes -inf, is done after one
    iteration and keeps its start model; the other lanes run on."""
    module, attr, at = engine["ll_site"]
    inner = getattr(module, attr)
    calls = []

    def poisoned(*a, **k):
        out = inner(*a, **k)
        calls.append(1)
        if len(calls) > 1:
            return out
        ll = (out if at is None else out[at]).clone()
        ll[1] = math.nan
        return ll if at is None else out[:at] + (ll,) + out[at + 1:]
    monkeypatch.setattr(module, attr, poisoned)
    st = engine["run"](engine["init"])
    assert float(st.ll[1]) == -math.inf
    assert bool(st.done[1]) and int(st.it[1]) == 1
    _assert_same_bits(_lane(getattr(st, engine["model"]), 1),
                      _lane(engine["init"], 1))
    others = [0, 2, 3, 4]
    assert torch.all(torch.isfinite(st.ll[others]))
    assert torch.all(st.it[others] > 1)


def test_done_lane_keeps_every_field(engine):
    """A lane that converged before the loop's last iteration holds every
    field of its state from then on: stopped at its own iteration count,
    it has the same bits."""
    full = engine["run"](engine["init"])
    lane = int(torch.argmin(full.it))
    stop = int(full.it[lane])
    assert stop < int(torch.max(full.it)) and stop < MAX_ITER
    early = engine["run"](engine["init"], max_iter=stop)
    assert int(torch.max(early.it)) == stop
    _assert_same_bits(_lane(full, lane), _lane(early, lane))


def test_max_iter_stops_a_lane_that_never_converges(engine):
    st = engine["run"](engine["init"], max_iter=4, min_diff=-math.inf)
    assert torch.equal(st.it, torch.full((L,), 4))
    assert bool(torch.all(st.done))
    assert torch.all(torch.isfinite(st.ll))


def test_one_iter_span_per_loop_iteration(engine):
    """While recording, each iteration is one ``<engine>.iter`` span and
    the lane counters add up the lanes' iterations; the results are the
    bits of an unrecorded run."""
    name = engine["name"]
    with profiling.recording() as rec, profiling.span("fit"):
        st = engine["run"](engine["init"])
    fit = rec.spans[-1]
    assert fit.name == "fit"
    spans = [s for s in rec.spans if s.name == f"{name}.iter"]
    assert len(spans) == int(torch.max(st.it)) == len(rec.spans) - 1
    assert all(s.parent == fit.id for s in spans)
    assert rec.counters == {
        f"{name}.lane_iters_active": int(torch.sum(st.it)),
        f"{name}.lane_iters_launched": int(torch.max(st.it)) * L}
    _assert_same_bits(st, engine["run"](engine["init"]))


def test_chunked_equals_unchunked(engine, monkeypatch):
    """Lanes run in chunks through ``lanes.in_chunks`` give the bits of all
    lanes run at once.  VHEM's degenerate repairs draw their noise for the
    lanes that run together, so its draws are held fixed here."""
    monkeypatch.setattr(vhem, "_rand", lambda gen, shape, dtype, device:
                        torch.full(shape, 0.37, dtype=dtype, device=device))
    whole = engine["run"](engine["init"])
    chunked = lanes.in_chunks(
        lambda sl: engine["run"](tree_map(lambda a: a[sl], engine["init"])),
        L, CHUNK)
    _assert_same_bits(chunked, whole)


def test_chunk_slices_cover_the_lanes_in_order():
    assert lanes.chunk_slices(5, 2) == [slice(0, 2), slice(2, 4),
                                        slice(4, 5)]
    assert lanes.chunk_slices(5, None) == [slice(0, 5)]
    x = torch.arange(7)
    assert torch.equal(lanes.in_chunks(lambda sl: 2 * x[sl], 7, 3), 2 * x)


@pytest.mark.parametrize("engine_rule", ["relative", "vhem"])
def test_settle_rules(engine_rule):
    """The guard's convergence test is the engine's: VBHEM/VBEM's
    ``|(ll - last)/last| <= min_diff`` counts a fall as converged, VHEM's
    signed strict ``(ll - last)/|last| < min_diff`` as well, and neither
    converges on a lane's first iteration."""
    last = torch.tensor([-10.0, -10.0, -10.0, -10.0], dtype=DT)
    ll = torch.tensor([-10.0, -5.0, -20.0, math.nan], dtype=DT)
    it = torch.tensor([1, 1, 1, 0])
    rule = (lanes.within(1e-5) if engine_rule == "relative" else
            (lambda a, b: (a - b) / torch.abs(b) < 1e-5))
    got, unstable, done = lanes.settle(ll, last, it, 100, rule)
    assert got[3] == -math.inf and unstable.tolist() == [False] * 3 + [True]
    falls = engine_rule == "vhem"
    assert done.tolist() == [True, False, falls, True]
    _, _, done0 = lanes.settle(ll, last, torch.zeros(4, dtype=torch.int64),
                               100, rule)
    assert done0.tolist() == [False, False, False, True]
    _, _, capped = lanes.settle(ll, last, torch.full((4,), 99), 100, rule)
    assert bool(torch.all(capped))
