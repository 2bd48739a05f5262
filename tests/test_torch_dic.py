"""The port's DIC and AIC/BIC (models/dic.py), its full pruning
``vbhem.vbh3m_remove_empty``, DIC selection over a VBHEM grid
(``experiments/synthetic.run_vbhem_dic``) and its NumPy metrics
(``utils/metrics.py``) against the JAX package on the same float64
inputs.  The VBHEM fits are the JAX package's, handed to the port by
field name through ``vbhem_tpu_torch.convert``.

Tolerances: P_d and DIC at rtol 1e-8 (host sums of the same terms and the
pair recursion, in another order); pruning and metrics exactly or at
rtol 1e-12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_vbhem import _jax_result
from tests.test_torch_vhem import assert_tree_close, bank  # noqa: F401
from vbhem_tpu.config import VBHEMConfig as JConfig
from vbhem_tpu.experiments import synthetic as jsyn
from vbhem_tpu.models import dic as jdic
from vbhem_tpu.models import vbhem as jvb
from vbhem_tpu.utils import metrics as jmet
from vbhem_tpu_torch import convert
from vbhem_tpu_torch.experiments import synthetic as tsyn
from vbhem_tpu_torch.models import dic as tdic
from vbhem_tpu_torch.models import vbhem as tvb
from vbhem_tpu_torch.utils import metrics as tmet

TAU = 10


def to_port(obj):
    return convert.to_torch(obj, device="cpu")


@pytest.fixture(scope="module")
def grid(bank):  # noqa: F811
    """The JAX package's VBHEM fits over K in {1, 2, 3}, S=2 on the bank
    of tests/test_compare_methods.py (the settings of its DIC test)."""
    jb, tb, labels = bank
    cfg = JConfig(alpha0=1e6, m0=(1.5, 1.5), w0=1.0, trials=4, nv=100,
                  tau=TAU, initmode="baseem", learn_hyps=False)
    _, info = jvb.cluster(jax.random.key(4), jb, [1, 2, 3], 2, cfg)
    return jb, tb, labels, info


@pytest.mark.parametrize("synthetic,per_time", [(False, False),
                                                (True, False),
                                                (False, True)])
def test_dic_matches_jax(grid, synthetic, per_time):
    jb, tb, _, info = grid
    for cell, jres in info["model_all"].items():
        want = jdic.dic(jb, jres, TAU, synthetic=synthetic,
                        per_time=per_time)
        got = tdic.dic(tb, to_port(jres), TAU, synthetic=synthetic,
                       per_time=per_time)
        np.testing.assert_allclose(got, want, rtol=1e-8, err_msg=str(cell))
        assert np.all(np.isfinite(got))


def test_dic_f32_inputs_match_f64(grid):
    """The same fit in float32 and in float64: DIC finite in both and
    within float32's reach of each other."""
    import torch
    jb, tb, _, info = grid
    for cell, jres in info["model_all"].items():
        res32 = convert.to_torch(jres, device="cpu", dtype=torch.float32)
        base32 = convert.to_torch(jb, device="cpu", dtype=torch.float32)
        p32, d32 = tdic.dic(base32, res32, TAU)
        p64, d64 = tdic.dic(tb, to_port(jres), TAU)
        assert np.isfinite(p32) and np.isfinite(d32)
        assert d32 == pytest.approx(d64, rel=1e-4), cell


def test_run_vbhem_dic_matches_jax(grid):
    jb, tb, labels, info = grid
    want = jsyn.run_vbhem_dic(info, jb, TAU, labels)
    tinfo = {"model_all": {c: to_port(r)
                           for c, r in info["model_all"].items()}}
    got = tsyn.run_vbhem_dic(tinfo, tb, TAU, labels)
    np.testing.assert_allclose(got["dic"], want["dic"], rtol=1e-8)
    g, w = got["score"], want["score"]
    assert (g.best_k, g.best_s, g.s_list) == (w.best_k, w.best_s, w.s_list)
    assert g.rand_index == pytest.approx(w.rand_index, rel=1e-12)
    assert g.purity == pytest.approx(w.purity, rel=1e-12)
    np.testing.assert_array_equal(g.labels, np.asarray(w.labels))


def test_aic_bic_vhem_matches_jax():
    for args in ((-123.4, 2, 2, 2, 800), (-5.0, 1, 3, 3, 0),
                 (10.0, 4, 1, 2, 12)):
        np.testing.assert_allclose(tdic.aic_bic_vhem(*args),
                                   jdic.aic_bic_vhem(*args), rtol=1e-15)


@pytest.mark.parametrize("sortclusters", ["f", "e"])
def test_vbh3m_remove_empty_matches_jax(sortclusters):
    jres = _jax_result(np.random.default_rng(21), 9, 4, 3, 2)
    # every surviving cluster keeps a live state (the JAX package's
    # standardize takes no empty HMM)
    counts = np.asarray(jres.counts).copy()
    counts[2] = [1.0, 2.0, 0.5]
    jres = jres._replace(counts=jnp.asarray(counts))
    want_res, want_hmms = jvb.vbh3m_remove_empty(jres,
                                                 sortclusters=sortclusters)
    got_res, got_hmms = tvb.vbh3m_remove_empty(to_port(jres),
                                               sortclusters=sortclusters)
    assert got_res.nj.shape == (3,)
    assert_tree_close(got_res, want_res, rtol=1e-12)
    assert [h.model.prior.shape[0] for h in got_hmms] == \
        [h.model.prior.shape[0] for h in want_hmms] == [2, 3, 3]
    for g, w in zip(got_hmms, want_hmms):
        assert_tree_close(g, w, rtol=1e-12)


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    pairs = [([0, 0, 1, 1], [1, 1, 0, 0]), ([0, 1, 0, 1], [0, 0, 1, 1]),
             (rng.integers(0, 3, 50), rng.integers(0, 4, 50)),
             ([2, 2, 2], [0, 0, 0])]
    for a, b in pairs:
        np.testing.assert_array_equal(tmet.contingency(a, b),
                                      jmet.contingency(a, b))
        np.testing.assert_allclose(tmet.rand_index(a, b),
                                   jmet.rand_index(a, b), rtol=1e-12)
        assert tmet.purity(a, b) == jmet.purity(a, b)
    x = rng.normal(size=(12, 2))
    dist = np.linalg.norm(x[:, None] - x[None], axis=-1)
    lab = rng.integers(0, 3, 12)
    assert tmet.dunn_index(dist, lab) == jmet.dunn_index(dist, lab)
    assert tmet.dunn_index(dist, np.arange(12)) == np.inf
    with pytest.raises(ValueError):
        tmet.contingency([0, 1], [0])


def test_jax_arrays_convert_as_numpy(grid):
    """A JAX result crosses by field name, whatever array type its leaves
    have."""
    jb, tb, _, info = grid
    got = to_port(info["model_all"][(1, 2)])
    assert isinstance(got, tvb.VBHEMResult)
    np.testing.assert_array_equal(got.label.numpy(),
                                  np.asarray(info["model_all"][(1, 2)].label))
    assert jnp.asarray(got.nj.numpy()).shape == (1,)
