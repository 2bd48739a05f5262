"""The port's recorder (``utils/profiling``): the spans and lane counters
of ``cluster_batched`` and ``learn_bank`` and their EM loops, at the tiny
sizes of the benchmark's job kinds, on the CPU.

With recording on each stage leaves one span tree under its root, every
span carrying the root's id; the iteration spans number the loop's
iterations and the counters the lanes' own and launched lane-iterations.
Under a ``torch.profiler`` window the same spans are nested
``user_annotation`` events.  With recording off nothing is stored and the
results are bit-identical.
"""
import json
import math

import pytest
import torch

from vbhem_tpu_torch import VBConfig, VBHEMConfig
from vbhem_tpu_torch.containers import SeqBatch
from vbhem_tpu_torch.models import batch, vbhem, vbhmm
from vbhem_tpu_torch.utils import profiling
from vbhem_tpu_torch.utils.planted import planted_bank

STAGES = ("cluster_batched", "learn_bank")
PHASES = {"cluster_batched": {"starts", "em", "rescore", "select"},
          "learn_bank": {"pad", "starts", "em", "pick", "finalize", "split"}}
ENGINE = {"cluster_batched": "vbhem_em", "learn_bank": "vbem_em"}
CHUNK = 12            # lanes a chunk of the 32-lane grid: three chunks


@pytest.fixture(scope="module")
def bank_base():
    base, _ = planted_bank(16, torch.device("cpu"), torch.float32)
    return base


@pytest.fixture(scope="module")
def subjects():
    gen = torch.Generator().manual_seed(4)
    return [SeqBatch(x=torch.randn(5, 12, 2, generator=gen) + 3.0 * (i % 2),
                     lengths=torch.full((5,), 12)) for i in range(6)]


def _run(stage, bank_base, subjects, monkeypatch):
    """One call of ``stage`` at a tiny size; returns (result, info, the
    EM loops' final states in call order)."""
    finals = []
    if stage == "cluster_batched":
        em = vbhem.vbhem_em_masked

        def keep(*a, **k):
            finals.append(em(*a, **k))
            return finals[-1]
        monkeypatch.setattr(vbhem, "vbhem_em_masked", keep)
        monkeypatch.setattr(vbhem, "lane_chunk", lambda *a, **k: CHUNK)
        cfg = VBHEMConfig(trials=8, nv=10, tau=5, max_iter=30,
                          initmode="baseem", learn_hyps=False,
                          m0=(13.0, 10.0), w0=1.0)
        res, info = vbhem.cluster_batched(torch.Generator().manual_seed(3),
                                          bank_base, [1, 2], [1, 2], cfg)
    else:
        em = vbhmm.vbem_em

        def keep(*a, **k):
            finals.append(em(*a, **k))
            return finals[-1]
        monkeypatch.setattr(vbhmm, "vbem_em", keep)
        res, info = batch.learn_bank(torch.Generator().manual_seed(1),
                                     subjects, 2,
                                     VBConfig(numtrials=3, max_iter=20))
    return res, info, finals


def _iterations(stage, info) -> int:
    return sum(info["grid_chunk_iters"]) if stage == "cluster_batched" \
        else info["model_em_iters"]


@pytest.mark.parametrize("stage", STAGES)
def test_span_tree_under_one_root(stage, bank_base, subjects, monkeypatch):
    with profiling.recording() as rec:
        _, info, finals = _run(stage, bank_base, subjects, monkeypatch)
    roots = [s for s in rec.spans if s.parent is None]
    assert [r.name for r in roots] == [stage]
    root = roots[0]
    by_id = {s.id: s for s in rec.spans}
    # every span under the root, sharing its id as the request id
    assert all(s.root == root.id for s in rec.spans)
    assert {s.name for s in rec.spans} == (
        {stage, f"{ENGINE[stage]}.iter"}
        | {f"{stage}.{p}" for p in PHASES[stage]})
    for s in rec.spans:
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        if s.name.startswith(stage + "."):
            assert s.parent == root.id
        elif s.name.endswith(".iter"):
            assert by_id[s.parent].name == f"{stage}.em"
    counts = profiling.PhaseTimer(rec).counts
    assert counts[f"{stage}.em"] == len(finals) == (
        3 if stage == "cluster_batched" else 1)
    assert counts[f"{ENGINE[stage]}.iter"] == _iterations(stage, info)


@pytest.mark.parametrize("stage", STAGES)
def test_lane_counters(stage, bank_base, subjects, monkeypatch):
    with profiling.recording() as rec:
        _, info, finals = _run(stage, bank_base, subjects, monkeypatch)
    eng = ENGINE[stage]
    assert rec.counters[f"{eng}.lane_iters_active"] == sum(
        int(torch.sum(st.it)) for st in finals)
    # each loop runs its slowest lane's iterations on every lane
    assert rec.counters[f"{eng}.lane_iters_launched"] == sum(
        int(torch.max(st.it)) * math.prod(st.it.shape) for st in finals)
    if stage == "cluster_batched":
        lanes = [CHUNK, CHUNK, 32 - 2 * CHUNK]
        assert rec.counters[f"{eng}.lane_iters_launched"] == sum(
            n * i for n, i in zip(lanes, info["grid_chunk_iters"]))
    assert rec.counters[f"{eng}.lane_iters_active"] < \
        rec.counters[f"{eng}.lane_iters_launched"]


@pytest.mark.parametrize("stage", STAGES)
def test_spans_are_nested_profiler_annotations(stage, bank_base, subjects,
                                               monkeypatch, tmp_path):
    with profiling.device_trace(str(tmp_path)):
        assert profiling.active()
        _run(stage, bank_base, subjects, monkeypatch)
    assert not profiling.active()
    rec = profiling.RECORDER
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ann = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("cat") == "user_annotation"
           and e.get("ph") == "X"]
    names = sorted(s.name for s in rec.spans)
    assert sorted(a[0] for a in ann) == names

    def inside(name, outer):
        return all(any(o[1] <= a[1] and a[2] <= o[2] for o in ann
                       if o[0] == outer) for a in ann if a[0] == name)
    for phase in PHASES[stage]:
        assert inside(f"{stage}.{phase}", stage)
    assert inside(f"{ENGINE[stage]}.iter", f"{stage}.em")


def _leaves(tree) -> list:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree, key=str)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return []


@pytest.mark.parametrize("stage", STAGES)
def test_off_stores_nothing_and_is_bit_identical(stage, bank_base, subjects,
                                                  monkeypatch):
    profiling.RECORDER.clear()
    assert not profiling.active()
    assert profiling.span("x") is profiling.span("y")   # one shared no-op
    profiling.count("x", 1)
    off, info_off, _ = _run(stage, bank_base, subjects, monkeypatch)
    assert profiling.RECORDER.spans == [] and profiling.RECORDER.counters == {}
    monkeypatch.undo()
    with profiling.recording() as rec:
        on, info_on, _ = _run(stage, bank_base, subjects, monkeypatch)
    assert rec.spans and rec.counters
    a, b = _leaves(off), _leaves(on)
    assert len(a) == len(b) > 0
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    if stage == "cluster_batched":
        assert (info_off["model_ll"] == info_on["model_ll"]).all()
        assert info_off["grid_chunk_iters"] == info_on["grid_chunk_iters"]
    else:
        assert info_off == info_on


def test_phase_timer_over_the_recorder(bank_base, subjects, monkeypatch):
    with profiling.recording() as rec:
        _, info, _ = _run("learn_bank", bank_base, subjects, monkeypatch)
    pt = profiling.PhaseTimer(rec)
    assert pt.counts["vbem_em.iter"] == info["model_em_iters"]
    assert pt.counts["learn_bank"] == 1
    assert pt.totals["learn_bank"] >= pt.totals["learn_bank.em"] > 0
    assert "learn_bank.split" in pt.summary()
    # a root span opened afterwards replaces what the recorder held
    with profiling.recording() as rec:
        with profiling.span("other"):
            pass
    assert [s.name for s in rec.spans] == ["other"]
