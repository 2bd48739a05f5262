"""The port's fixation IO, plots and profiling (ROADMAP A10) against the
JAX package: ``read_fixations`` on generated CSVs (with and without FixD,
mixed-case headers, ragged trials) against the JAX (pandas) reader; the
native loader, built by the host compiler from this package's own
source, against the Python reader, and ``read_fixations_auto`` saying
which ran; the BIFF8 parsers against the JAX copies on constructed byte
strings; ``get_median_length`` and ``batches_from_nested``;
``PhaseTimer``; one figure per plot function under Agg, with the JAX
function's axes count; and the demo CLI's ``--quick --xls`` run on the
CPU."""
import struct
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbhem_tpu import containers as jc
from vbhem_tpu.models import vbhem as jv
from vbhem_tpu.utils import io as jio
from vbhem_tpu.utils import plots as jplots
from vbhem_tpu.utils import xls as jxls
from vbhem_tpu_torch import VBConfig, VBHEMConfig, convert
from vbhem_tpu_torch.containers import SeqBatch
from vbhem_tpu_torch.models import vbhem as tv
from vbhem_tpu_torch.models import vbhmm as tvb
from vbhem_tpu_torch.utils import io as tio
from vbhem_tpu_torch.utils import native_io
from vbhem_tpu_torch.utils import plots as tplots
from vbhem_tpu_torch.utils import profiling
from vbhem_tpu_torch.utils import xls as txls


def write_table(path, rng, with_dur, header=("SubjectID", "TrialID",
                                             "FixX", "FixY", "FixD")):
    """A fixation CSV of 3 subjects with ragged trials, rows of one trial
    not all adjacent, and the columns in a shuffled order."""
    cols = list(header if with_dur else header[:4])
    order = rng.permutation(len(cols))
    rows = []
    for s, subj in enumerate(["s1", "s2", "s3"]):
        for trial in range(1, 3 + s):
            for _ in range(int(rng.integers(1, 6))):
                vals = [subj, str(trial), f"{rng.uniform(0, 512):.4f}",
                        f"{rng.uniform(0, 384):.4f}",
                        f"{rng.uniform(100, 400):.2f}"][:len(cols)]
                rows.append(vals)
    # one late row of s1's first trial: grouped with its trial
    rows.append(["s1", "1", "1.5", "2.5", "300"][:len(cols)])
    with open(path, "w") as f:
        f.write(",".join(cols[i] for i in order) + "\n")
        for r in rows:
            f.write(",".join(r[i] for i in order) + "\n")


def assert_same_subjects(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].lengths.cpu().numpy(),
                                      np.asarray(want[k].lengths))
        np.testing.assert_allclose(got[k].x.cpu().numpy(),
                                   np.asarray(want[k].x), rtol=1e-15)


@pytest.mark.parametrize("case", ["xy", "xyd", "mixed_case"])
def test_read_fixations_csv_matches_jax(tmp_path, case):
    path = tmp_path / "fix.csv"
    header = ("subjectID", "TRIALID", "fixX", "FixY", "fixd") \
        if case == "mixed_case" else ("SubjectID", "TrialID", "FixX",
                                      "FixY", "FixD")
    write_table(path, np.random.default_rng(len(case)), case != "xy",
                header)
    got = tio.read_fixations(str(path), device="cpu")
    want = jio.read_fixations(str(path))
    assert_same_subjects(got, want)
    assert got["s1"].x.shape[-1] == (2 if case == "xy" else 3)
    assert got["s1"].x.device.type == "cpu"


def test_read_fixations_numeric_ids_and_errors(tmp_path):
    path = tmp_path / "ids.csv"
    path.write_text("SubjectID,TrialID,FixX,FixY\n"
                    "01,1,10,20\n01,1,11,21\n2,1,30,40\n2,2,50,60\n")
    got = tio.read_fixations(str(path), device="cpu")
    want = jio.read_fixations(str(path))
    assert_same_subjects(got, want)
    assert list(got) == ["1", "2"]
    bad = tmp_path / "bad.csv"
    bad.write_text("Subject,TrialID,FixX,FixY\n1,1,2,3\n")
    with pytest.raises(ValueError, match="SubjectID"):
        tio.read_fixations(str(bad), device="cpu")


def test_xlsx_without_pandas_names_pandas(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="pandas"):
        tio.read_fixations(str(tmp_path / "t.xlsx"), device="cpu")


def test_native_reader_matches_python_reader(tmp_path):
    """The loader builds from ``csrc/fixation_loader.cc`` with the host
    compiler into the ignored build directory and reads what the Python
    reader reads; ``read_fixations_auto`` says which reader ran."""
    assert native_io.native_available(), native_io.unavailable_reason()
    lib = native_io._build.host_library_path(native_io.SOURCE)
    assert lib.is_file() and lib.parent == native_io._build.BUILD_DIR
    for with_dur in (False, True):
        path = tmp_path / f"fix{int(with_dur)}.csv"
        write_table(path, np.random.default_rng(7), with_dur)
        want = tio.read_fixations(str(path), device="cpu")
        got = native_io.read_fixations_native(str(path), device="cpu")
        assert_same_subjects(got, want)
        auto, reader = native_io.read_fixations_auto(str(path),
                                                     device="cpu")
        assert reader == "native"
        assert_same_subjects(auto, want)
    sub, reader = native_io.read_fixations_auto(str(path), t_max=9,
                                                dtype=np.float32,
                                                device="cpu")
    assert reader == "native" and sub["s1"].x.shape[1] == 9
    assert sub["s1"].x.dtype == torch.float32
    broken = tmp_path / "broken.csv"
    broken.write_text("a,b\n1,2\n")
    with pytest.raises(RuntimeError, match="header"):
        native_io.read_fixations_native(str(broken), device="cpu")


def test_read_fixations_auto_python_paths(tmp_path, monkeypatch):
    path = tmp_path / "fix.csv"
    write_table(path, np.random.default_rng(3), False)
    monkeypatch.setattr(native_io, "native_available", lambda: False)
    sub, reader = native_io.read_fixations_auto(str(path), device="cpu")
    assert reader == "python"
    assert_same_subjects(sub, jio.read_fixations(str(path)))


def _biff_record(op, body):
    return struct.pack("<HH", op, len(body)) + body


def test_biff8_parsers_match_jax():
    stream = (_biff_record(0x0809, b"\x00" * 8)
              + _biff_record(0x0203, struct.pack("<HHHd", 1, 2, 0, 3.25))
              + _biff_record(0x00FD, struct.pack("<HHHI", 0, 0, 0, 1))
              + _biff_record(0, b"") + _biff_record(0x0203, b"x" * 14))
    assert list(txls._records(stream)) == list(jxls._records(stream))
    assert len(list(txls._records(stream))) == 3
    rks = [0x00000002 | (1234 << 2), 0x00000003 | (1234 << 2),
           (0xFFFFFFFF << 2 & 0xFFFFFFFF) | 2,
           struct.unpack("<II", struct.pack("<d", 2.5))[1],
           struct.unpack("<II", struct.pack("<d", 2.5))[1] | 1]
    for rk in rks:
        assert txls._decode_rk(rk) == jxls._decode_rk(rk)
    assert txls._decode_rk(rks[0]) == 1234.0
    assert txls._decode_rk(rks[1]) == 12.34

    def s8(text, high=False):
        raw = text.encode("utf-16le" if high else "latin-1")
        return struct.pack("<HB", len(text), int(high)) + raw

    # one table in one record (a high-byte string among them), and one
    # whose third string runs on into a CONTINUE record, after its option
    # byte: the JAX package's reader decodes that byte as text there, so
    # the port is held to the strings (tests/test_torch_xls.py)
    whole = [struct.pack("<ii", 3, 3) + s8("SubjectID") + s8("FixX")
             + s8("Yé!", high=True)]
    assert txls._parse_sst(whole) == jxls._parse_sst(whole) == [
        "SubjectID", "FixX", "Yé!"]
    split = [struct.pack("<ii", 3, 3) + s8("SubjectID") + s8("FixX")
             + struct.pack("<HB", 6, 0) + b"Fi", b"\x00xYZ!" + s8("end")]
    assert txls._parse_sst(split) == ["SubjectID", "FixX", "FixYZ!"]


def test_median_length_and_nested_batches():
    rng = np.random.default_rng(1)
    nested = [[rng.normal(size=(t, 2)) for t in (3, 5, 4)],
              [rng.normal(size=(t, 2)) for t in (7, 2)]]
    got = tio.batches_from_nested(nested, device="cpu")
    want = jio.batches_from_nested(nested)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.lengths.numpy(),
                                      np.asarray(w.lengths))
        np.testing.assert_allclose(g.x.numpy(), np.asarray(w.x))
    assert tio.get_median_length(got) == jio.get_median_length(want) == 4.0
    assert tio.get_median_length(nested) == jio.get_median_length(nested)
    with pytest.raises(TypeError):
        tio.get_median_length(3)


def test_write_fixations_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    subjects = {f"v{i}": SeqBatch(
        x=torch.as_tensor(rng.normal(size=(3, 4, 3))),
        lengths=torch.as_tensor([4, 2, 3], dtype=torch.int32))
        for i in range(2)}
    for b in subjects.values():
        b.x[1, 2:] = 0.0
        b.x[2, 3:] = 0.0
    path = tmp_path / "rt.csv"
    tio.write_fixations(str(path), subjects)
    back = tio.read_fixations(str(path), device="cpu")
    assert list(back) == list(subjects)
    for k, b in subjects.items():
        np.testing.assert_array_equal(back[k].lengths.numpy(),
                                      b.lengths.numpy())
        np.testing.assert_allclose(back[k].x.numpy(), b.x.numpy(),
                                   rtol=1e-15)


def test_phase_timer_and_trace(tmp_path):
    import time as _t
    pt = profiling.PhaseTimer()
    out = []
    with pt.phase("a", block_on=out):
        _t.sleep(0.01)
        out.append(torch.ones(3))
    with pt.phase("a"):
        _t.sleep(0.01)
    with pt.phase("b", block_on={"x": torch.zeros(1)}):
        pass
    assert pt.counts == {"a": 2, "b": 1} and pt.totals["a"] >= 0.02
    assert "a" in pt.summary() and "b" in pt.summary()
    with profiling.device_trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0


# ---------------------------------------------------------------------------
# plots: one figure per function, the JAX function's axes count
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def learned():
    from vbhem_tpu_torch.experiments import demo_fixations as demo
    gen = torch.Generator().manual_seed(0)
    batches, _ = demo.synth_subjects(gen, n_per_group=2, n_trials=6, t=8,
                                     device="cpu")
    cfg = VBConfig(mu0=(256.0, 192.0), w0=1e-3, numtrials=2, max_iter=20)
    results = [tvb.learn(gen, b, 2, cfg)[0] for b in batches]
    base = tv.h3m_from_results(results, device="cpu")
    res, _ = tv.cluster(gen, base, 2, 2, VBHEMConfig(
        trials=2, learn_hyps=False, initmode="baseem", m0=(256.0, 192.0),
        w0=1e-3, nv=10, tau=5, max_iter=20))
    return batches[0], results[0], res


def _jax_batch(b):
    return jc.SeqBatch(x=jnp.asarray(b.x.numpy()),
                       lengths=jnp.asarray(b.lengths.numpy()))


def _jax_hmm(h):
    return jc.HMM(*[jnp.asarray(a) for a in convert.to_numpy(h)])


def _jax_vbhem_result(res):
    n = convert.to_numpy(res)
    h3m = jc.H3M(omega=n.h3m.omega, hmm=jc.HMM(*n.h3m.hmm),
                 state_mask=n.h3m.state_mask)
    return jv.VBHEMResult(post=None, h3m=h3m, ll=n.ll, hat_z=n.hat_z,
                          ll_elbo=n.ll_elbo, nj=n.nj, label=n.label,
                          counts_n1=n.counts_n1, counts=n.counts,
                          trans_counts=n.trans_counts)


def _axes_fn(name, mod, batch, hmm_res, vres, jax_side):
    """A call of the axes-level plot function ``name`` of ``mod`` on one
    axes."""
    h = hmm_res.model
    hmm3 = h._replace(mean=torch.cat([h.mean, torch.full_like(
        h.mean[:, :1], 250.0)], -1), cov=torch.eye(3, dtype=h.cov.dtype
                                                   ).expand(2, 3, 3) * 40.0)
    if jax_side:
        h, hmm3, batch = _jax_hmm(h), _jax_hmm(hmm3), _jax_batch(batch)
    return {
        "plot_emissions": lambda ax: mod.plot_emissions(ax, h),
        "plot_transprob": lambda ax: mod.plot_transprob(ax, h.trans),
        "plot_prior": lambda ax: mod.plot_prior(ax, h.prior),
        "plot_fixations": lambda ax: mod.plot_fixations(ax, batch, h),
        "plot_model_selection": lambda ax: mod.plot_model_selection(
            ax, np.array([[-3.0, -2.0], [-2.5, -1.0]]), [1, 2], [1, 2]),
        "plot_emissions_dur": lambda ax: mod.plot_emissions_dur(ax, hmm3),
        "plot_transcount": lambda ax: mod.plot_transcount(
            ax, hmm_res.trans_counts if not jax_side
            else np.asarray(hmm_res.trans_counts)),
        "plot_emcounts": lambda ax: mod.plot_emcounts(ax, hmm_res.counts),
        "plot_ccfd_decision": lambda ax: mod.plot_ccfd_decision(
            ax, torch.arange(5.0), torch.arange(5.0).flip(0), [0, 1]),
    }[name]


AXES_FUNCTIONS = ["plot_emissions", "plot_transprob", "plot_prior",
                  "plot_fixations", "plot_model_selection",
                  "plot_emissions_dur", "plot_transcount", "plot_emcounts",
                  "plot_ccfd_decision"]


def test_every_plot_function_is_ported():
    public = {n for n in dir(jplots) if n.startswith("plot_")}
    assert public == set(AXES_FUNCTIONS) | {"plot_vbhmm",
                                            "plot_vbhem_clusters"}
    assert all(hasattr(tplots, n) for n in public)


@pytest.mark.parametrize("name", AXES_FUNCTIONS + ["plot_vbhmm",
                                                   "plot_vbhem_clusters"])
def test_plots_smoke(learned, name, tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    batch, hmm_res, vres = learned
    figs = []
    for mod, jax_side in ((tplots, False), (jplots, True)):
        if name == "plot_vbhmm":
            r = hmm_res if not jax_side else hmm_res._replace(
                model=_jax_hmm(hmm_res.model))
            b = batch if not jax_side else _jax_batch(batch)
            fig = mod.plot_vbhmm(r, batch=b, title="t")
        elif name == "plot_vbhem_clusters":
            fig = mod.plot_vbhem_clusters(
                vres if not jax_side else _jax_vbhem_result(vres))
        else:
            fig, ax = plt.subplots()
            _axes_fn(name, mod, batch, hmm_res, vres, jax_side)(ax)
        figs.append(fig)
    got, want = figs
    assert len(got.axes) == len(want.axes)
    assert [len(a.get_children()) for a in got.axes] == \
        [len(a.get_children()) for a in want.axes]
    got.savefig(tmp_path / f"{name}.png")
    assert (tmp_path / f"{name}.png").stat().st_size > 0
    plt.close("all")


def test_demo_cli_quick_xls(tmp_path):
    """The demo CLI on a fixation CSV (``--quick --xls``) on the CPU: the
    native loader reads it, and the run selects, prunes and plots."""
    from vbhem_tpu_torch.experiments import demo_fixations as demo
    gen = torch.Generator().manual_seed(3)
    batches, _ = demo.synth_subjects(gen, n_per_group=3, n_trials=6, t=8,
                                     device="cpu")
    path = tmp_path / "demo.csv"
    tio.write_fixations(str(path), {f"p{i}": b
                                    for i, b in enumerate(batches)})
    out = tmp_path / "out"
    summary = demo.main(["--quick", "--xls", str(path), "--device", "cpu",
                         "--out", str(out)])
    assert summary["reader"] == "native"
    assert summary["subjects"] == 6
    assert summary["best_k"] in (1, 2) and summary["best_s"] == 2
    assert sum(len(g) for g in summary["groups"]) == 6
    assert len(summary["plots"]) == 6 + 2
    assert all((out / p.split("/")[-1]).is_file() for p in summary["plots"])


def test_new_modules_run_with_jax_blocked(tmp_path):
    """With jax and the JAX package blocked (as on the machine with the
    card): the 'auto' front-ends and every initializer, grouped VBEM with
    the heuristic hyps, the native and Python readers, the profiler and
    the demo CLI run on the CPU."""
    import subprocess
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    code = f"""
import sys
sys.modules['jax'] = None
sys.modules['vbhem_tpu'] = None
import numpy as np, torch
from vbhem_tpu_torch import VBConfig, VBHEMConfig
from vbhem_tpu_torch.models import vbhem, vbhmm_groups, hyp_heuristics
from vbhem_tpu_torch.experiments import demo_fixations as demo
from vbhem_tpu_torch.utils import io, native_io, planted, profiling
gen = torch.Generator().manual_seed(0)
base, _ = planted.planted_bank(8, 'cpu', torch.float64)
cfg = VBHEMConfig(trials=2, learn_hyps=False, nv=10, tau=4, max_iter=5,
                  m0=(13.0, 10.0), w0=1.0)
vbhem.cluster(gen, base, [1, 2], 2, cfg)
vbhem.cluster_batched(gen, base, [1, 2], [1, 2], cfg)
h = vbhem.VBHEMHyps.from_config(cfg, 2, device='cpu')
for mode, fn in vbhem._INITIALIZERS.items():
    fn(gen, base, 2, 2, h, 10, lanes=(2,))
batches, labels = demo.synth_subjects(gen, 2, 4, 6, device='cpu')
b = batches[0]._replace(x=torch.cat([x.x for x in batches]),
                        lengths=torch.cat([x.lengths for x in batches]))
vcfg = hyp_heuristics.set_hyperparam(VBConfig(numtrials=2, max_iter=5),
                                     [b], 'c', demo.FACE)
with profiling.device_trace(r'{tmp_path}'):
    vbhmm_groups.learn_grouped(gen, b, [1, 2], np.repeat([0, 1], 8), 2,
                               vcfg)
io.write_fixations(r'{tmp_path}/d.csv', {{'a': batches[0]}})
_, reader = native_io.read_fixations_auto(r'{tmp_path}/d.csv', device='cpu')
assert reader == 'native', native_io.unavailable_reason()
demo.main(['--quick', '--device', 'cpu', '--out', r'{tmp_path}/demo'])
print('ran')
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ran")


@pytest.mark.parametrize("ragged", [False, True], ids=["bank", "ragged"])
def test_demo_learn_subjects(ragged):
    """The demo's per-subject VBEM over S: subjects of one shape are the
    lanes of ``learn_bank``, ragged ones go through ``vbhmm.learn`` one by
    one; either way each subject keeps one of the S values."""
    from vbhem_tpu_torch.experiments import demo_fixations as demo
    gen = torch.Generator().manual_seed(5)
    batches, _ = demo.synth_subjects(gen, n_per_group=2, n_trials=4, t=6,
                                     device="cpu")
    if ragged:
        batches[1] = SeqBatch(x=batches[1].x[:3], lengths=torch.tensor(
            [6, 4, 5], dtype=torch.int32))
    cfg = VBConfig(mu0=(256.0, 192.0), w0=1e-3, numtrials=2, max_iter=10)
    results, s_sel = demo.learn_subjects(gen, batches, [1, 2], cfg)
    assert len(results) == 4 and set(s_sel) <= {1, 2}
    assert [int(r.post.alpha.shape[-1]) for r in results] == s_sel
