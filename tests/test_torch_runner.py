"""The port's synthetic benchmark runner (``experiments/runner.py``) and
its two command-line modules.

``aggregate`` and ``aggregate_from_checkpoints`` against the JAX
package's: the same ``RecoveryScore``s (and distance matrices, meta
sidecars, excluded repeats, segregated scales) give identical dicts.
One small repeat of all four methods on the CPU (6 subjects per group,
enough for CCFD to find its centers): its stages and checkpoint files,
no ``*_error``, every score present; a failing stage isolated; resume
without recomputing; the refusal to mix scales; checkpoints pickled on the CPU loading back on a
given device; a clear refusal of the JAX package's checkpoints; and the
runner and both CLIs run with ``jax``, ``optax`` and ``vbhem_tpu``
blocked from import, as on the machine with the card."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vbhem_tpu.experiments import runner as jrunner
from vbhem_tpu.experiments import synthetic as jsyn
from vbhem_tpu_torch import HEMConfig
from vbhem_tpu_torch.containers import SeqBatch
from vbhem_tpu_torch.experiments import runner
from vbhem_tpu_torch.experiments import synthetic as tsyn

REPO = Path(__file__).resolve().parent.parent


def _scores(rng, cls):
    """Random scores of every method, as the runner records them."""
    out = {}
    for m in ("vbhem", "vbhem_dic", "vhem_aic", "vhem_bic", "ccfd",
              "ppk_aic", "ppk_bic"):
        k = int(rng.integers(1, 5))
        lab = rng.integers(0, k, size=8)
        s_list = ([int(v) for v in rng.integers(1, 4, size=k)]
                  if m in ("vbhem", "vbhem_dic", "vhem_aic") else None)
        out[m] = cls(rand_index=float(rng.uniform()),
                     purity=float(rng.uniform(0.5, 1.0)), best_k=k,
                     best_s=int(rng.integers(1, 4)), labels=lab,
                     s_list=s_list)
    return out


def _dist(rng):
    a = rng.uniform(size=(8, 8))
    d = a + a.T
    np.fill_diagonal(d, 0.0)
    return d


def test_aggregate_matches_jax():
    rng = np.random.default_rng(0)
    per = []
    for r in range(4):
        seed = int(rng.integers(1 << 30))
        per.append((_scores(np.random.default_rng(seed), jsyn.RecoveryScore),
                    _scores(np.random.default_rng(seed), tsyn.RecoveryScore),
                    {"vbhem": float(rng.uniform())} if r % 2 else {}))
    want = jrunner.aggregate([{"scores": j, "dunn": d} for j, _, d in per])
    got = runner.aggregate([{"scores": t, "dunn": d} for _, t, d in per])
    assert got == want
    assert got["vbhem"]["n_repeats"] == 4 and "dunn_mean" in got["vbhem"]


def _write_outdir(pkg, synmod, outdir, scales):
    """Stage checkpoints and meta sidecars of one run in ``outdir``,
    written by ``pkg``'s own ``_save``: repeat r at scale scales[r]."""
    os.makedirs(outdir, exist_ok=True)
    for r, scale in enumerate(scales):
        rng = np.random.default_rng(10 + r)
        sc = _scores(rng, synmod.RecoveryScore)
        pkg._write_meta(outdir, r, pkg._scale_meta(
            scale, 25, 50, range(1, 7), range(1, 6), "f32"))
        if r == 3:
            continue                   # a repeat with no method stage
        pkg._save(outdir, r, "vbhem", {"score": sc["vbhem"],
                                       "dic_score": sc["vbhem_dic"]})
        pkg._save(outdir, r, "vhem", {"aic_score": sc["vhem_aic"],
                                      "bic_score": sc["vhem_bic"]})
        if r != 1:
            pkg._save(outdir, r, "ccfd", {"score": sc["ccfd"]})
            pkg._save(outdir, r, "ppk", {"aic_score": sc["ppk_aic"],
                                         "bic_score": sc["ppk_bic"]})
            pkg._save(outdir, r, "dist", _dist(rng))


@pytest.mark.parametrize("scales,exclude", [
    ((20, 20, 20, 20, 20), ()),
    ((20, 20, 20, 20, 20), (2,)),
    ((20, 10, 20, 20, 10), (4,)),
], ids=["one_scale", "excluded", "mixed_scales"])
def test_aggregate_from_checkpoints_matches_jax(tmp_path, scales, exclude):
    _write_outdir(jrunner, jsyn, str(tmp_path / "jax"), scales)
    _write_outdir(runner, tsyn, str(tmp_path / "port"), scales)
    want = jrunner.aggregate_from_checkpoints(str(tmp_path / "jax"), 6,
                                              exclude_repeats=exclude)
    got = runner.aggregate_from_checkpoints(str(tmp_path / "port"), 6,
                                            exclude_repeats=exclude)
    assert got == want
    assert ("groups" in got) == (len(set(scales)) > 1)


# ---------------------------------------------------------------------------
# one small repeat of all four methods
# ---------------------------------------------------------------------------

METHODS = ("vbhem", "vhem", "ccfd", "ppk")


def small_kwargs(**over):
    kw = dict(
        n_per_cluster=6, n_seqs=10, t=30, k_grid=range(1, 4),
        s_grid=range(1, 3),
        vb_config=dataclasses.replace(tsyn.default_vb_config(), numtrials=4,
                                      learn_hyps=False),
        vbhem_config=dataclasses.replace(tsyn.default_vbhem_config(trials=4),
                                         learn_hyps=False),
        hem_config=HEMConfig(trials=3, nv=100, tau=10),
        methods=METHODS, verbose=False, device="cpu")
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("syn"))
    return outdir, runner.run_repeat(0, outdir, **small_kwargs())


def test_small_repeat_scores_every_method(small_run):
    outdir, out = small_run
    assert not [k for k in out["timings"] if k.endswith("_error")], \
        out["timings"]
    assert set(out["scores"]) == {"vbhem", "vbhem_dic", "vhem_aic",
                                  "vhem_bic", "ccfd", "ppk_aic", "ppk_bic"}
    for sc in out["scores"].values():
        assert isinstance(sc, tsyn.RecoveryScore)
        assert np.isfinite(sc.rand_index) and len(sc.labels) == 12
    assert set(out["timings"]) == {"vbem", "vbhem", "vhem", "ccfd", "ppk",
                                   "dist"}
    # CCFD found its centers at this size, and the planted groups are
    # recovered by VBHEM
    assert out["scores"]["ccfd"].best_k >= 2
    assert out["scores"]["vbhem"].rand_index == 1.0
    assert set(out["work"]) == {"vbem", "vbhem", "vhem"}
    assert out["work"]["vbhem"]["rescored"] == 0     # float64: no rescoring
    assert out["work"]["vbhem"]["dic_cells"] == 6
    assert all(v > 0 for v in (out["work"]["vbem"]["em_iters"],
                               out["work"]["vbhem"]["em_iters"],
                               out["work"]["vhem"]["em_iters"]))
    files = sorted(os.listdir(outdir))
    assert files == sorted([f"r000_{s}.pkl" for s in runner.STAGES]
                           + ["r000_meta.json"]), files
    meta = json.load(open(os.path.join(outdir, "r000_meta.json")))
    assert meta["dtype"] == "f64" and meta["n_per_cluster"] == 6
    assert meta["provenance"]["bank_version"] == "0.1.0"
    banks = runner.load_checkpoint(outdir, 0, "vbem")
    assert sorted(banks["banks"]) == [1, 2]
    assert banks["elapsed"] == pytest.approx(
        sum(banks["elapsed_by_s"].values()))


def test_resume_recomputes_nothing(small_run, monkeypatch):
    outdir, out = small_run

    def refuse(*a, **k):
        raise AssertionError("a stage was recomputed")
    for name in ("sample_dataset", "learn_subject_hmms", "run_vbhem",
                 "run_vbhem_dic", "run_vhem_grid", "run_ccfd",
                 "run_ppk_grid"):
        monkeypatch.setattr(tsyn, name, refuse)
    again = runner.run_repeat(0, outdir, **small_kwargs())
    assert again["work"] == {}
    assert again["dunn"] == out["dunn"]
    assert again["timings"] == {k: v for k, v in out["timings"].items()
                                if k != "dist"}
    for m, sc in out["scores"].items():
        g = again["scores"][m]
        assert g._replace(labels=None) == sc._replace(labels=None)
        np.testing.assert_array_equal(g.labels, sc.labels)
    # and the aggregate of the checkpoints is that of the run
    assert runner.aggregate_from_checkpoints(outdir, 1) == dict(
        runner.aggregate([out]), provenance={"0": json.load(open(
            os.path.join(outdir, "r000_meta.json")))["provenance"]})


def test_a_failing_stage_is_isolated(small_run, tmp_path, monkeypatch):
    """A stage that raises is reported as ``<stage>_error``; the other
    stages still score."""
    import shutil
    outdir = str(tmp_path / "copy")
    shutil.copytree(small_run[0], outdir)
    os.remove(runner._ckpt_path(outdir, 0, "ccfd"))

    def broken(*a, **k):
        raise RuntimeError("broken stage")
    monkeypatch.setattr(tsyn, "run_ccfd", broken)
    out = runner.run_repeat(0, outdir, **small_kwargs())
    assert out["timings"]["ccfd_error"] == "RuntimeError('broken stage')"
    assert "ccfd" not in out["scores"] and len(out["scores"]) == 6
    assert not os.path.exists(runner._ckpt_path(outdir, 0, "ccfd"))


def test_refuses_to_mix_scales(small_run):
    outdir, _ = small_run
    with pytest.raises(ValueError, match="different scale"):
        runner.run_repeat(0, outdir, **small_kwargs(n_seqs=11))
    with pytest.raises(ValueError, match="different scale"):
        runner.run_repeat(0, outdir, **small_kwargs(s_grid=range(1, 4)))


def test_checkpoints_load_back_on_a_device(small_run):
    """Tensors are pickled on the CPU and come back on the device asked
    for (here the CPU; the card the same way)."""
    outdir, _ = small_run
    ds = runner.load_checkpoint(outdir, 0, "data")
    assert isinstance(ds, tsyn.SyntheticDataset)
    assert all(isinstance(b, SeqBatch) and b.x.device.type == "cpu"
               and b.x.dtype == torch.float64 for b in ds.batches)
    st = runner.load_checkpoint(outdir, 0, "vbhem", device="cpu")
    assert st["result"].label.device.type == "cpu"
    with open(runner._ckpt_path(outdir, 0, "vbem"), "rb") as f:
        raw = f.read()
    assert b"cuda" not in raw
    # the data is the seeded draw, on any device
    want = tsyn.sample_dataset(runner.stage_generator(0, 0),
                               n_per_cluster=6, n_seqs=10, t=30,
                               device="cpu")
    for a, b in zip(ds.batches, want.batches):
        assert torch.equal(a.x, b.x)


def test_refuses_jax_checkpoints(tmp_path):
    """An outdir of the JAX package: loading raises a clear error instead
    of failing inside pickle (on the card, for want of JAX)."""
    import jax
    ds = jsyn.sample_dataset(jax.random.key(0), n_per_cluster=1, n_seqs=2,
                             t=3)
    jrunner._save(str(tmp_path), 0, "data", ds)
    with pytest.raises(runner.ForeignCheckpointError, match="JAX package"):
        runner.load_checkpoint(str(tmp_path), 0, "data")
    with pytest.raises(runner.ForeignCheckpointError):
        runner.run_repeat(0, str(tmp_path), **small_kwargs(n_per_cluster=1,
                                                           n_seqs=2, t=3))


def test_stage_seeds():
    seeds = {runner.stage_seed(r, tag) for r in range(10)
             for tag in (0, 1, 2, 3, 4, 5, 101, 102)}
    assert len(seeds) == 80
    assert runner.stage_seed(3, 1) == runner.stage_seed(3, 1)
    assert all(0 <= s < 1 << 63 for s in seeds)


def test_runner_and_clis_run_with_jax_blocked(tmp_path):
    """The CLI runs a small experiment with jax, optax and the JAX
    package blocked from import (as on the machine with the card),
    resumes it, and the aggregate CLI summarizes its directory."""
    out = tmp_path / "syn"
    code = (
        "import sys, json\n"
        "for m in ('jax', 'jaxlib', 'optax', 'vbhem_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from vbhem_tpu_torch.experiments import aggregate_run, "
        "synthetic_experiment\n"
        f"argv = ['--out', {str(out)!r}, '--repeats', '1', '--subjects', "
        "'3', '--seqs', '6', '--t', '15', '--kmax', '2', '--smax', '2', "
        "'--trials', '2', '--hem-trials', '2', '--hyp-steps', '2', "
        "'--device', 'cpu']\n"
        "s1 = synthetic_experiment.main(argv)\n"
        "s2 = synthetic_experiment.main(argv)\n"
        "assert s1 == s2, (s1, s2)\n"
        f"agg = aggregate_run.main([{str(out)!r}, '--repeats', '1'])\n"
        "assert sorted(agg['methods']) == sorted(list(s1) + "
        "['provenance']), agg\n"
        "assert agg['repeats_with_vbhem'] == [0]\n"
        "assert set(agg['stage_wall_clock']) == {'vbem', 'vbhem', 'vhem', "
        "'ccfd', 'ppk'}\n"
        "print('OK', sorted(s1))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "OK" in res.stdout
    assert sorted(os.listdir(out)) == sorted(
        [f"r000_{s}.pkl" for s in runner.STAGES]
        + ["r000_meta.json", "summary.json"])
    meta = json.load(open(out / "r000_meta.json"))
    assert meta["dtype"] == "f64"       # the CPU's default
    with open(out / "r000_vbhem.pkl", "rb") as f:
        assert b"vbhem_tpu_torch" in f.read()
