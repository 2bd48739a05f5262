"""The port's VHEM (models/vhem.py, ops/kmeans.py, ops/gmm.mix_hier_em,
experiments/synthetic.run_vhem_grid) against the JAX package on the same
float64 inputs, made from a numpy seed and handed to both packages
through ``vbhem_tpu_torch.convert``.

Tolerances: each function of the EM iteration at rtol 1e-10 (the same
closed forms, summed in another order); the lane-batched EM loop from
JAX-made inits against ``jax.vmap(vhem_em)`` at rtol 1e-8 for the LL and
the final model (a few tens of iterations compound the rounding).  The
two packages draw different random numbers, so the degenerate repairs
are compared on the parts that do not depend on the draw, the random
initializers and the clustering by outcome, and ``kmeans`` from the same
``init_centers``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_vbhem import gt_hmm
from vbhem_tpu import containers as jc
from vbhem_tpu.config import HEMConfig as JConfig
from vbhem_tpu.experiments import synthetic as jsyn
from vbhem_tpu.models import vbhem as jvb
from vbhem_tpu.models import vhem as jv
from vbhem_tpu.ops import gmm as jgmm
from vbhem_tpu.ops import kmeans as jkm
from vbhem_tpu.utils.metrics import rand_index
from vbhem_tpu_torch import HEMConfig
from vbhem_tpu_torch import convert
from vbhem_tpu_torch.containers import tree_map
from vbhem_tpu_torch.experiments import synthetic as tsyn
from vbhem_tpu_torch.models import vhem as tv
from vbhem_tpu_torch.ops import gmm as tgmm
from vbhem_tpu_torch.ops import kmeans as tkm

RTOL = 1e-10


def to_port(obj):
    return convert.to_torch(obj, device="cpu")


def assert_tree_close(got, want, rtol=RTOL, atol=0.0):
    g = convert.to_numpy(got)
    if isinstance(want, tuple) and hasattr(want, "_fields"):
        for f in want._fields:
            if getattr(want, f) is not None and f != "key":
                assert_tree_close(getattr(got, f), getattr(want, f), rtol,
                                  atol)
    else:
        np.testing.assert_allclose(g, np.asarray(want), rtol=rtol, atol=atol)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def bank():
    """The bank of tests/test_compare_methods.py: 12 noisy copies of two
    2-state HMMs differing in means and dynamics.  Returns (JAX bank,
    port bank, labels)."""
    rng = np.random.default_rng(0)
    hmms, labels = [], []
    for gi, (trans, shift) in enumerate([
            ([[0.6, 0.4], [0.4, 0.6]], 0.0),
            ([[0.3, 0.7], [0.7, 0.3]], 2.0)]):
        for _ in range(6):
            h = gt_hmm(trans)
            mean = np.asarray(h.mean) + shift + rng.normal(0, 0.15, (2, 2))
            trans_n = np.asarray(h.trans) + rng.uniform(0, 0.05, (2, 2))
            trans_n = trans_n / trans_n.sum(-1, keepdims=True)
            hmms.append(jc.HMM(prior=h.prior, trans=jnp.asarray(trans_n),
                               mean=jnp.asarray(mean), cov=h.cov))
            labels.append(gi)
    jb = jvb.h3m_from_hmms(hmms)
    return jb, to_port(jb), np.array(labels)


def jax_init(jb, kr, sr, seed, lanes=None):
    cfg = JConfig()
    if lanes is None:
        return jv.init_baseem(jax.random.key(seed), jb, kr, sr, cfg)
    return jax.vmap(lambda k: jv.init_baseem(k, jb, kr, sr, cfg))(
        jax.random.split(jax.random.key(seed), lanes))


@pytest.mark.parametrize("sr,smooth,lanes", [(2, 1.0, None), (3, 2.0, 2),
                                             (1, 1.0, None)])
def test_e_step_matches_jax(bank, sr, smooth, lanes):
    jb, tb, _ = bank
    init = jax_init(jb, 3, sr, 1, lanes)
    if lanes is None:
        want = jv.e_step(jb, init, 6, smooth)
    else:
        want = jax.vmap(lambda h: jv.e_step(jb, h, 6, smooth))(init)
    got = tv.e_step(tb, to_port(init), 6, smooth)
    assert_tree_close(got, want, atol=1e-13)


def _m_step_case(bank, sr, tau, lanes=None):
    jb, tb, _ = bank
    init = jax_init(jb, 3, sr, 2, lanes)
    rng = np.random.default_rng(sr + tau)
    z = rng.dirichlet(np.ones(3), (lanes or 1, jb.num_hmms))
    z = z if lanes else z[0]
    if lanes is None:
        pair = jv.e_step(jb, init, tau)
    else:
        pair = jax.vmap(lambda h: jv.e_step(jb, h, tau))(init)
    return jb, tb, pair, z


@pytest.mark.parametrize("covar_type,sr,tau,lanes", [
    ("full", 2, 5, None), ("diag", 2, 5, None), ("full", 1, 5, None),
    ("full", 2, 1, None), ("full", 3, 4, 3)])
def test_m_step_matches_jax(bank, covar_type, sr, tau, lanes):
    jb, tb, pair, z = _m_step_case(bank, sr, tau, lanes)
    cfg = dict(tau=tau, covar_type=covar_type)
    if lanes is None:
        want = jv.m_step(jb, pair, jnp.asarray(z), JConfig(**cfg))
    else:
        want = jax.vmap(lambda p, zz: jv.m_step(jb, p, zz, JConfig(**cfg)))(
            pair, jnp.asarray(z))
    got = tv.m_step(tb, to_port(pair), to_port(z), HEMConfig(**cfg))
    assert_tree_close(got[0], want[0], atol=1e-14)
    assert_tree_close(got[1], want[1], atol=1e-14)
    if covar_type == "diag":
        off = got[0].hmm.cov[..., 0, 1].numpy()
        assert np.all(off == 0.0)


def test_vhem_em_lanes_match_jax_vmap(bank):
    """Three restart lanes from JAX-made baseem inits: the port's
    lane-batched loop (done lanes frozen) against jax.vmap(vhem_em).  No
    degenerate repair fires on this bank, so nothing depends on a draw."""
    jb, tb, _ = bank
    kw = dict(trials=1, nv=100, tau=10, max_iter=30)
    inits = jax_init(jb, 2, 2, 3, lanes=3)
    want = jax.vmap(lambda q: jv.vhem_em(jb, q, JConfig(**kw)))(inits)
    got = tv.vhem_em(tb, to_port(inits), HEMConfig(**kw))
    it = np.asarray(want.it)
    assert len(set(it.tolist())) > 1      # lanes finish at different times
    np.testing.assert_array_equal(got.it.numpy(), it)
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    np.testing.assert_allclose(got.ll.numpy(), np.asarray(want.ll), rtol=1e-8)
    np.testing.assert_allclose(got.last_ll.numpy(), np.asarray(want.last_ll),
                               rtol=1e-8)
    assert_tree_close(got.h3m, want.h3m, rtol=1e-8, atol=1e-10)
    for f in ("z", "ll_elbo", "emit_counts"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-8,
                                   atol=1e-10, err_msg=f)
    # one lane alone gives what it gives among others
    one = tv.vhem_em(tb, to_port(jax.tree.map(lambda a: a[1], inits)),
                     HEMConfig(**kw))
    np.testing.assert_allclose(float(one.ll), float(got.ll[1]), rtol=1e-12)


def test_vhem_em_nan_lane_keeps_its_model(bank):
    """A lane whose LL is NaN becomes -inf, is done, and keeps its old
    model (`hem_h3m_c_step.m`, the JAX package's unstable revert), while
    the other lanes run on."""
    jb, tb, _ = bank
    init = to_port(jax_init(jb, 2, 2, 4, lanes=2))
    mean = init.hmm.mean.clone()
    mean[1, 0, 0, 0] = float("nan")
    init = init._replace(hmm=init.hmm._replace(mean=mean))
    cfg = HEMConfig(trials=1, nv=100, tau=10, max_iter=20)
    st = tv.vhem_em(tb, init, cfg)
    assert st.ll[1] == -np.inf and bool(st.done[1]) and int(st.it[1]) == 1
    assert np.isfinite(float(st.ll[0])) and int(st.it[0]) > 1
    torch.testing.assert_close(st.h3m.hmm.trans[1], init.hmm.trans[1])
    torch.testing.assert_close(st.h3m.omega[1], init.omega[1])


def test_fix_degenerate_components(bank):
    jb, tb, _ = bank
    h = jv.init_baseem(jax.random.key(5), jb, 3, 2, JConfig())
    # healthy: identity
    fixed = tv.fix_degenerate_components(to_port(h), gen())
    assert_tree_close(fixed, h, rtol=1e-15)
    # a degenerate cluster in lane 1 only; lane 0 healthy
    omega = np.array([[0.2, 0.5, 0.3], [0.0, 0.7, 0.3]])
    trans = np.asarray(h.hmm.trans).copy()
    trans[1, 0, 1] = 0.0                      # the donor's zero transition
    jh = h._replace(omega=jnp.asarray(omega[1]),
                    hmm=h.hmm._replace(trans=jnp.asarray(trans)))
    want = jv.fix_degenerate_components(jh, jax.random.key(6))
    lanes = jax.tree.map(lambda a: jnp.stack([a, a]), jh)
    lanes = lanes._replace(omega=jnp.asarray(omega))
    got = tv.fix_degenerate_components(to_port(lanes), gen(1))
    np.testing.assert_allclose(got.omega[1].numpy(), np.asarray(want.omega),
                               rtol=1e-12)
    np.testing.assert_allclose(got.omega[1].numpy(), [0.35, 0.35, 0.3])
    for f in ("mean", "cov"):
        np.testing.assert_array_equal(getattr(got.hmm, f)[1].numpy(),
                                      np.asarray(getattr(want.hmm, f)))
    a = got.hmm.trans[1, 0].numpy()
    assert a[0, 1] == 0.0 and np.all(a[[0, 1], [0, 0]] > 0)
    np.testing.assert_allclose(a.sum(-1), 1.0, rtol=1e-12)
    np.testing.assert_allclose(got.hmm.prior[1, 0].numpy().sum(), 1.0,
                               rtol=1e-12)
    # untouched: the healthy lane and the healthy clusters
    assert_tree_close(tree_map(lambda x: x[0], got),
                      jax.tree.map(lambda x: x[0], lanes), rtol=1e-15)
    np.testing.assert_array_equal(got.hmm.trans[1, 1:].numpy(),
                                  trans[1:])


def test_fix_degenerate_states(bank):
    jb, tb, _ = bank
    h = jv.init_baseem(jax.random.key(7), jb, 2, 3, JConfig())
    counts = np.array([[5.0, 0.0, 1.0], [2.0, 3.0, 4.0]])
    want = jv.fix_degenerate_states(h, jnp.asarray(counts),
                                    jax.random.key(8))
    got = tv.fix_degenerate_states(to_port(h), torch.as_tensor(counts), gen())
    # everything but the noised mean of the repaired state is draw-free
    for f in ("prior", "trans", "cov"):
        np.testing.assert_allclose(getattr(got.hmm, f).numpy(),
                                   np.asarray(getattr(want.hmm, f)),
                                   rtol=1e-12, err_msg=f)
    np.testing.assert_allclose(got.hmm.prior.numpy().sum(-1), 1.0)
    np.testing.assert_allclose(got.hmm.trans.numpy().sum(-1), 1.0)
    mean = got.hmm.mean.numpy()
    donor = np.asarray(h.hmm.mean)[0, 0]
    ratio = mean[0, 1] / donor
    assert np.all((ratio >= 1.0) & (ratio < 1.01)), ratio
    np.testing.assert_array_equal(mean[1], np.asarray(h.hmm.mean)[1])
    np.testing.assert_array_equal(mean[0, [0, 2]],
                                  np.asarray(h.hmm.mean)[0, [0, 2]])
    # healthy counts: identity
    same = tv.fix_degenerate_states(to_port(h), torch.ones(2, 3), gen())
    assert_tree_close(same, h, rtol=1e-15)


def test_init_highp_and_trick_match_jax(bank):
    jb, tb, _ = bank
    omega = np.linspace(1, 2, jb.num_hmms)
    jb = jb._replace(omega=jnp.asarray(omega / omega.sum()))
    tb = to_port(jb)
    cfg = JConfig()
    want = jv.init_highp(jax.random.key(0), jb, 3, 2, cfg)
    got = tv.init_highp(gen(), tb, 3, 2, HEMConfig())
    assert_tree_close(got, want, rtol=0)
    lanes = tv.init_highp(gen(), tb, 3, 2, HEMConfig(), lanes=(2,))
    assert_tree_close(tree_map(lambda a: a[1], lanes), want, rtol=0)
    want = jv.init_trick(jax.random.key(0), jb, 3, 2, cfg)
    got = tv.init_trick(gen(), tb, 3, 2, HEMConfig())
    assert_tree_close(got.hmm, want.hmm, rtol=0)
    assert float(got.omega.sum()) == pytest.approx(1.0)


@pytest.mark.parametrize("mode", ["baseem", "base", "gmmNew", "gmmNew2",
                                  "gmm"])
def test_random_initializers_are_valid(bank, mode):
    """Every initializer over two lanes: the shapes, stochastic rows,
    cluster weights that sum to one, emissions drawn from the bank (the
    JAX package's own structural checks, `tests/test_compare_methods.py`)."""
    jb, tb, _ = bank
    h = tv._INITIALIZERS[mode](gen(3), tb, 2, 2, HEMConfig(), lanes=(2,))
    assert h.hmm.mean.shape == (2, 2, 2, 2) and h.omega.shape == (2, 2)
    np.testing.assert_allclose(h.omega.sum(-1).numpy(), 1.0, rtol=1e-12)
    np.testing.assert_allclose(h.hmm.prior.sum(-1).numpy(), 1.0, rtol=1e-12)
    np.testing.assert_allclose(h.hmm.trans.sum(-1).numpy(), 1.0, rtol=1e-12)
    assert torch.all(torch.linalg.eigvalsh(h.hmm.cov) > 0)
    if mode == "gmm":
        # every (cluster, state) starts from the pooled long-run Gaussian
        want = jv.init_gmm(jax.random.key(5), jb, 2, 2, JConfig())
        np.testing.assert_allclose(
            h.hmm.mean.numpy(),
            np.broadcast_to(np.asarray(want.hmm.mean)[0, 0], (2, 2, 2, 2)),
            rtol=1e-8)


def test_cluster_recovers_clusters_and_identity(bank):
    """`test_vhem_recovers_clusters` of tests/test_compare_methods.py on
    the port, in 'baseem' and the default 'auto' (baseem, gmmNew,
    gmmNew2), and the K == Kb identity shortcut."""
    jb, tb, labels = bank
    for mode in ("baseem", "auto"):
        info = {}
        res = tv.cluster(gen(0), tb, 2, 2, HEMConfig(trials=8, nv=100, tau=10),
                         initmode=mode, info=info)
        assert rand_index(res.label.numpy(), labels)[1] == pytest.approx(1.0)
        np.testing.assert_allclose(res.h3m.omega.numpy(), 0.5, atol=0.1)
        assert info["em_iters"] > 0
        assert sum(len(g) for g in res.groups) == jb.num_hmms
    kb = jb.num_hmms
    res = tv.cluster(gen(0), tb, kb, 2, HEMConfig(trials=2, nv=10, tau=5))
    assert float(res.ll) == 0.0
    np.testing.assert_array_equal(res.label.numpy(), np.arange(kb))
    np.testing.assert_array_equal(res.z.numpy(), np.eye(kb))
    assert res.h3m is tb


def test_cluster_split_matches_jax(bank):
    """'split' mode is deterministic when no degenerate repair fires."""
    jb, tb, labels = bank
    want = jv.cluster_split(jax.random.key(0), jb, 2, 2, JConfig(trials=1))
    got = tv.cluster_split(gen(), tb, 2, 2, HEMConfig(trials=1))
    np.testing.assert_array_equal(got.label.numpy(), np.asarray(want.label))
    np.testing.assert_allclose(float(got.ll), float(want.ll), rtol=1e-8)
    assert_tree_close(got.h3m.hmm, want.h3m.hmm, rtol=1e-7, atol=1e-9)


def test_compute_stats_matches_jax(bank):
    jb, tb, _ = bank
    st = jv.vhem_em(jb, jax_init(jb, 2, 2, 9), JConfig(max_iter=15))
    jres = jv.finalize(st)
    want = jv.compute_stats(jres, jb, tau=10)
    got = tv.compute_stats(to_port(jres), tb, tau=10)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


def test_kmeans_matches_jax_from_the_same_centers():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(c, 0.5, (30, 2)) for c in (0, 4, 9)])
    w = rng.uniform(0.2, 1.0, len(x))
    c0 = x[[0, 1, 2]]
    for weights in (None, w):
        ja, jc_ = jkm.kmeans(jax.random.key(0), jnp.asarray(x), 3,
                             weights=None if weights is None
                             else jnp.asarray(weights),
                             init_centers=jnp.asarray(c0), max_iter=20)
        ta, tc_ = tkm.kmeans(gen(), torch.as_tensor(x), 3,
                             weights=None if weights is None
                             else torch.as_tensor(weights),
                             init_centers=torch.as_tensor(c0), max_iter=20)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_allclose(tc_.numpy(), np.asarray(jc_), rtol=1e-12)
    # seeded lanes: kmeans++ spreads the three seeds over the three blobs
    a, c = tkm.kmeans(gen(1), torch.as_tensor(x), 3, lanes=(4,))
    assert a.shape == (4, 90) and c.shape == (4, 3, 2)
    for lane in range(4):
        np.testing.assert_allclose(np.sort(c[lane, :, 0].numpy()),
                                   [0, 4, 9], atol=0.3)


def test_mix_hier_em_reduces_separated_gaussians():
    """Two well separated groups of Gaussians reduce to their two pooled
    moments, in the JAX package and in every lane of the port."""
    rng = np.random.default_rng(6)
    mean = np.concatenate([rng.normal(0, 0.2, (20, 2)),
                           rng.normal(8, 0.2, (20, 2))])
    a = rng.normal(size=(40, 2, 2)) * 0.2
    cov = np.einsum("pde,pfe->pdf", a, a) + 0.5 * np.eye(2)
    prior = np.ones(40)
    prior[3] = 0.0                               # a masked-out component
    jg, jlp = jgmm.mix_hier_em(jax.random.key(0), *map(jnp.asarray,
                                                       (mean, cov, prior)), 2)
    tg, tlp = tgmm.mix_hier_em(gen(), *map(torch.as_tensor,
                                           (mean, cov, prior)), 2, lanes=(3,))
    assert tg.mean.shape == (3, 2, 2) and tlp.shape == (3, 2, 40)
    order = np.argsort(np.asarray(jg.mean)[:, 0])
    for lane in range(3):
        o = np.argsort(tg.mean[lane, :, 0].numpy())
        for f in ("weight", "mean", "cov"):
            np.testing.assert_allclose(getattr(tg, f)[lane].numpy()[o],
                                       np.asarray(getattr(jg, f))[order],
                                       rtol=1e-6, atol=1e-8, err_msg=f)
    np.testing.assert_allclose(np.exp(tlp.numpy()).sum(-2), 1.0, rtol=1e-10)


def _results(jb, tb):
    """VBHMMResult lists (JAX, port) whose point models are the bank's
    HMMs, as h3m_from_results(use_post=False) reads them."""
    def wrap(mod, b, i, like):
        hmm = type(b.hmm)(*[a[i] for a in b.hmm])
        s = hmm.prior.shape[0]
        ones = like(np.ones(s))
        post = mod.HMMPosterior(alpha=ones, epsilon=like(np.ones((s, s))),
                                niw=mod.NIW(beta=ones, v=ones, m=hmm.mean,
                                            w=hmm.cov))
        return mod.VBHMMResult(post=post, model=hmm, ll=like(0.0),
                               gamma=like(np.zeros((1, 1, s))),
                               counts_n1=ones, counts=ones,
                               trans_counts=like(np.ones((s, s))))
    from vbhem_tpu_torch import containers as tc
    kb = jb.num_hmms
    return ([wrap(jc, jb, i, jnp.asarray) for i in range(kb)],
            [wrap(tc, tb, i, torch.as_tensor) for i in range(kb)])


def test_run_vhem_grid_selects_as_jax(bank):
    """AIC and BIC over K in {1, 2, 3} x S in {1, 2} pick the same cell in
    both packages, and the port's selections recover the groups."""
    jb, tb, labels = bank
    jres, tres = _results(jb, tb)
    kw = dict(trials=4, nv=100, tau=10, initmode="baseem")
    want = jsyn.run_vhem_grid(jax.random.key(0), jres, labels, [1, 2, 3],
                              [1, 2], JConfig(**kw))
    got = tsyn.run_vhem_grid(gen(), tres, labels, [1, 2, 3], [1, 2],
                             HEMConfig(**kw))
    for crit in ("aic", "bic"):
        g, w = got[crit + "_score"], want[crit + "_score"]
        assert (g.best_k, g.best_s) == (w.best_k, w.best_s), crit
        assert g.rand_index == pytest.approx(1.0)
        assert np.unravel_index(np.argmin(got[crit]), got[crit].shape) == \
            np.unravel_index(np.argmin(want[crit]), want[crit].shape)
    assert set(got["em_iters"]) == set(got["cells"])
    # the expected-LL and parameter count behind the criteria
    r = got["cells"][(2, 2)]
    assert tsyn._vhem_expected_ll(r, 100) == pytest.approx(
        jsyn._vhem_expected_ll(jv.VHEMResult(*convert.to_numpy(r)), 100),
        rel=1e-12)
    assert all(tsyn._num_params(k, s, 2) == jsyn._num_params(k, s, 2)
               for k in (1, 3) for s in (1, 4))
    res, score = tsyn.run_vhem(gen(), tres, labels)
    assert score.rand_index == pytest.approx(1.0) and score.best_k == 2
