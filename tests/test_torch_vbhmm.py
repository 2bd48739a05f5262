"""The port's VBEM engine against the JAX package on the same inputs, made
with numpy (the synthetic protocol's sequences from
``vbhem_tpu_torch.utils.planted``) and handed to both packages.

In float64: the statistics, M-step (full and diag), bound and GMM ->
posterior conversion at rtol 1e-10; the lane-batched EM loop against
``jax.vmap(vbem_em)`` from the JAX package's own initial posteriors (the
same per-lane iteration count, ll at rtol 1e-9); the GMM EM from the same
start means and the deterministic split GMM at rtol 1e-8 (EM to a 1e-5
tolerance amplifies rounding); the port's float64 lane bound against
``rescore.vbem_elbo_f64`` at 1e-9 relative.  End to end: ``learn`` picks
K=2 on the data of tests/test_vbhmm.py, and ``learn_bank`` followed by the
port's ``h3m_from_results`` and ``cluster`` recovers two planted groups,
as tests/test_vbhem.py:104-111 requires of the JAX pipeline."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbhem_tpu import containers as jc
from vbhem_tpu.config import VBConfig as JConfig
from vbhem_tpu.models import rescore as jrescore
from vbhem_tpu.models import vbhmm as jv
from vbhem_tpu.ops import gmm as jgmm
from vbhem_tpu_torch import VBConfig, VBHEMConfig
from vbhem_tpu_torch import containers as tc
from vbhem_tpu_torch.containers import tree_map
from vbhem_tpu_torch import convert
from vbhem_tpu_torch.models import batch as tbatch
from vbhem_tpu_torch.models import rescore as trescore
from vbhem_tpu_torch.models import vbhem as tvbhem
from vbhem_tpu_torch.models import vbhmm as tv
from vbhem_tpu_torch.ops import gmm as tgmm
from vbhem_tpu_torch.utils import planted

RTOL = 1e-10


def to_port(obj):
    return convert.to_torch(obj, device="cpu")


def close(got, want, rtol=RTOL, atol=0.0):
    g = convert.to_numpy(got)
    if isinstance(want, tuple) and hasattr(want, "_fields"):
        for f in want._fields:
            close(getattr(g, f), getattr(want, f), rtol, atol)
    elif want is not None:
        np.testing.assert_allclose(g, np.asarray(want), rtol=rtol, atol=atol)


def subject(seed=7, n_seqs=25, t=50, ragged=False):
    """One subject of the sticky ground-truth HMM (the data of
    tests/test_vbhmm.py:28-32, without the protocol's noise), as the
    port's and the JAX package's SeqBatch."""
    batches, _ = planted.synthetic_subjects(1, n_seqs=n_seqs, t=t, noise=0.0,
                                            seed=seed, device="cpu",
                                            dtype=torch.float64)
    x = batches[0].x.numpy().copy()
    lengths = np.full(n_seqs, t, np.int32)
    if ragged:
        lengths[1::3] = np.arange(1, len(lengths[1::3]) + 1) * 2
        x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    tb = tc.SeqBatch(x=torch.as_tensor(x), lengths=torch.as_tensor(lengths))
    jb = jc.SeqBatch(x=jnp.asarray(x), lengths=jnp.asarray(lengths))
    return tb, jb


@pytest.fixture(scope="module")
def one_step():
    """A JAX random_init posterior on a ragged subject and the JAX
    package's E-step, statistics and bound at it."""
    tb, jb = subject(ragged=True, n_seqs=12, t=30)
    cfg = JConfig(mu0=(1.5, 1.5), w0=1.0)
    jh = jv.VBHyps.from_config(cfg, 2)
    post = jv.random_init(jax.random.key(3), jb, 3, jh)
    fb = jv.e_step(jb, post)
    stats = jv.suff_stats(jb, fb)
    return dict(tb=tb, jb=jb, jh=jh, post=post, fb=fb, stats=stats,
                ll=jv.elbo(jb, post, fb, stats, jh))


def test_e_step_suff_stats_elbo(one_step):
    p = one_step
    tpost, th = to_port(p["post"]), to_port(p["jh"])
    fb = tv.e_step(p["tb"], tpost)
    close(fb, p["fb"], atol=1e-12)
    stats = tv.suff_stats(p["tb"], fb)
    close(stats, p["stats"], atol=1e-12)
    np.testing.assert_allclose(float(tv.elbo(p["tb"], tpost, fb, stats, th)),
                               float(p["ll"]), rtol=RTOL)


def test_e_step_lanes_match_jax():
    """The port's E-step (its CPU path: expected_log_gauss, then the plain
    forward-backward) over lanes [S, L] of a ragged bank whose x is shared
    by each subject's restarts, against the JAX package's e_step lane by
    lane, in all four FBStats fields."""
    subjects = [subject(seed=s, n_seqs=6, t=15, ragged=True) for s in (21, 22)]
    bank = tc.SeqBatch(x=torch.stack([tb.x for tb, _ in subjects]),
                       lengths=torch.stack([tb.lengths for tb, _ in subjects]))
    jh = jv.VBHyps.from_config(JConfig(mu0=(1.5, 1.5), w0=1.0), 2)
    keys = jax.random.split(jax.random.key(8), 6)
    jposts = [[jv.random_init(keys[3 * s + j], subjects[s][1], 3, jh)
               for j in range(3)] for s in range(2)]
    post = tree_map(lambda *a: torch.stack(a),
                    *[tree_map(lambda *b: torch.stack(b),
                               *[to_port(p) for p in row]) for row in jposts])
    assert post.alpha.shape == (2, 3, 3)
    got = tv.e_step(bank, post)
    assert got.log_rho.shape == (2, 3, 6, 15, 3)
    for s in range(2):
        for j in range(3):
            want = jv.e_step(subjects[s][1], jposts[s][j])
            close(tree_map(lambda a: a[s, j], got), want, rtol=1e-10,
                  atol=1e-12)


def test_em_loops_check_lengths_once():
    """A subject with no step at all: the E-step does not check (no host
    sync per iteration); vbem_em, em_trace and the float64 rescoring each
    check the lengths once and raise.  An empty sequence beside real ones
    is a padded trial: all three run, and it changes nothing."""
    tb, _ = subject(seed=23, n_seqs=4, t=10)
    hyps = tv.VBHyps.from_config(VBConfig(mu0=(1.5, 1.5), w0=1.0), 2,
                                 device="cpu")
    post = tv.random_init(torch.Generator().manual_seed(0), tb, 2, hyps)
    nothing = tc.SeqBatch(x=tb.x, lengths=torch.zeros(4, dtype=torch.int32))
    tv.e_step(nothing, post)
    for run in (lambda: tv.vbem_em(nothing, post, hyps, max_iter=2),
                lambda: tv.em_trace(nothing, post, hyps, n_iter=2),
                lambda: trescore.vbem_rescore_lanes(nothing, post, hyps)):
        with pytest.raises(ValueError, match="at least one step"):
            run()
    lengths = torch.tensor([10, 0, 10, 10], dtype=torch.int32)
    empty = tc.SeqBatch(x=tb.x, lengths=lengths)
    real = tc.SeqBatch(x=tb.x[lengths > 0], lengths=lengths[lengths > 0])
    for b_, r_ in ((tv.vbem_em(empty, post, hyps, max_iter=2).ll,
                    tv.vbem_em(real, post, hyps, max_iter=2).ll),
                   (tv.em_trace(empty, post, hyps, n_iter=2)[1],
                    tv.em_trace(real, post, hyps, n_iter=2)[1]),
                   (trescore.vbem_rescore_lanes(empty, post, hyps),
                    trescore.vbem_rescore_lanes(real, post, hyps))):
        torch.testing.assert_close(b_, r_, rtol=1e-12, atol=0)
    assert tv.vbem_em(tb, post, hyps, max_iter=2).it == 2


@pytest.mark.parametrize("covar_type", ["full", "diag"])
def test_m_step(one_step, covar_type):
    p = one_step
    want = jv.m_step(p["stats"], p["jh"], covar_type)
    got = tv.m_step(to_port(p["stats"]), to_port(p["jh"]), covar_type)
    close(got, want, atol=1e-14)


@pytest.mark.parametrize("covar_type", ["full", "diag"])
def test_init_from_gmm(one_step, covar_type):
    p = one_step
    rng = np.random.default_rng(8)
    k, d = 3, 2
    a = rng.normal(size=(k, d, d))
    g = (rng.dirichlet(np.ones(k)), rng.normal(size=(k, d)),
         np.einsum("kde,kfe->kdf", a, a) + np.eye(d))
    want = jv.init_from_gmm(*map(jnp.asarray, g), jnp.asarray(321.0),
                            p["jh"], covar_type)
    got = tv.init_from_gmm(*map(torch.as_tensor, g), 321.0,
                           to_port(p["jh"]), covar_type)
    close(got, want)


def test_vbem_em_lanes_match_jax_vmap():
    """Five restart lanes from the JAX package's own random_init
    posteriors: the port's lane-batched loop (done lanes frozen) against
    jax.vmap(vbem_em)."""
    tb, jb = subject(seed=9, n_seqs=8, t=25, ragged=True)
    jh = jv.VBHyps.from_config(JConfig(mu0=(1.5, 1.5), w0=1.0), 2)
    posts = jax.vmap(lambda k: jv.random_init(k, jb, 3, jh))(
        jax.random.split(jax.random.key(4), 5))
    want = jax.vmap(lambda q: jv.vbem_em(jb, q, jh, max_iter=40))(posts)
    got = tv.vbem_em(tb, to_port(posts), to_port(jh), max_iter=40)
    it = np.asarray(want.it)
    assert len(set(it.tolist())) > 1      # lanes finish at different times
    np.testing.assert_array_equal(got.it.numpy(), it)
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    np.testing.assert_allclose(got.ll.numpy(), np.asarray(want.ll), rtol=1e-9)
    close(got.post, want.post, rtol=1e-8, atol=1e-10)
    close(got.gamma, want.gamma, rtol=1e-8, atol=1e-10)


def test_em_trace_matches_jax_and_never_decreases():
    tb, jb = subject(seed=10, n_seqs=8, t=25)
    jh = jv.VBHyps.from_config(JConfig(mu0=(1.5, 1.5), w0=1.0), 2)
    post = jv.random_init(jax.random.key(5), jb, 2, jh)
    _, want = jv.em_trace(jb, post, jh, n_iter=20)
    _, got = tv.em_trace(tb, to_port(post), to_port(jh), n_iter=20)
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-9)
    assert np.all(np.diff(got) >= -1e-9 * np.abs(got[:-1]))


def test_gmm_em_core_matches_jax_from_the_same_start():
    tb, jb = subject(seed=11, n_seqs=6, t=20, ragged=True)
    x = jb.x.reshape(-1, 2)
    w = jb.mask.reshape(-1).astype(x.dtype)
    key = jax.random.key(6)
    want = jgmm.fit_gmm(key, x, 3, weights=w)
    start = x[jax.random.permutation(key, x.shape[0])[:3]]
    got = tgmm.fit_gmm_from_means(torch.as_tensor(np.array(x)),
                                  torch.as_tensor(np.array(start)),
                                  torch.as_tensor(np.array(w)))
    close(got, want, rtol=1e-8, atol=1e-10)


def test_fit_gmm_lanes_are_independent_fits():
    """Each (subject, restart) lane of fit_gmm is the EM of its own start:
    the same as fitting that subject alone from the lane's start means."""
    tb, _ = subject(seed=12, n_seqs=5, t=20)
    x = torch.stack([tb.x.reshape(-1, 2), tb.x.reshape(-1, 2) * 0.5 + 1.0])
    gen = torch.Generator().manual_seed(0)
    g = tgmm.fit_gmm(gen, x, 2, lanes=(3,))
    assert g.mean.shape == (2, 3, 2, 2)
    gen = torch.Generator().manual_seed(0)
    u = torch.rand((2, 3, x.shape[1]), generator=gen, dtype=torch.float64)
    idx = torch.topk(u, 2, dim=-1).indices
    for s in range(2):
        for lane in range(3):
            one = tgmm.fit_gmm_from_means(x[s], x[s][idx[s, lane]])
            for f in ("weight", "mean", "cov"):
                torch.testing.assert_close(getattr(g, f)[s, lane],
                                           getattr(one, f), rtol=1e-9,
                                           atol=1e-12)


def test_fit_gmm_split_matches_jax():
    _, jb = subject(seed=13, n_seqs=6, t=20, ragged=True)
    x = jb.x.reshape(-1, 2)
    w = jb.mask.reshape(-1).astype(x.dtype)
    want = jgmm.fit_gmm_split(x, 3, weights=w)
    got = tgmm.fit_gmm_split(torch.as_tensor(np.array(x)), 3,
                             weights=torch.as_tensor(np.array(w)))
    close(got, want, rtol=1e-8, atol=1e-10)


def _jax_result(rng, k=3, d=2):
    a = rng.normal(size=(k, d, d))
    post = jc.HMMPosterior(
        alpha=jnp.asarray(rng.uniform(1, 9, k)),
        epsilon=jnp.asarray(rng.uniform(0.5, 9, (k, k))),
        niw=jc.NIW(beta=jnp.asarray(rng.uniform(1, 9, k)),
                   v=jnp.asarray(rng.uniform(4, 9, k)),
                   m=jnp.asarray(rng.normal(size=(k, d))),
                   w=jnp.asarray(np.einsum("kde,kfe->kdf", a, a)
                                 + np.eye(d))))
    return jc.VBHMMResult(
        post=post, model=post.to_point(), ll=jnp.asarray(-3.0),
        gamma=jnp.asarray(rng.dirichlet(np.ones(k), (4, 5))),
        counts_n1=jnp.asarray(rng.uniform(0, 3, k)),
        counts=jnp.asarray([40.0, 0.3, 12.0][:k]),
        trans_counts=jnp.asarray(rng.uniform(0, 9, (k, k))),
        state_mask=jnp.ones(k, bool))


@pytest.mark.parametrize("mode", ["e", "p", "f", "s", "l", "r"])
def test_standardize_and_permute(mode):
    jres = _jax_result(np.random.default_rng(14))
    close(tv.standardize(to_port(jres), mode), jv.standardize(jres, mode),
          rtol=1e-12)


def test_standardize_lanes_match_one_by_one():
    rs = [_jax_result(np.random.default_rng(s)) for s in (15, 16, 17)]
    batched = tree_map(lambda *a: torch.stack(a),
                           *[to_port(r) for r in rs])
    for mode in ("f", "e", "s"):
        got = tv.standardize(batched, mode)
        for i, r in enumerate(rs):
            close(tree_map(lambda a: a[i], got), jv.standardize(r, mode),
                  rtol=1e-12)


def test_remove_empty_and_steady_state():
    jres = _jax_result(np.random.default_rng(18))
    got, keep, removed = tv.remove_empty(to_port(jres), thresh=1.0)
    want, wkeep, wremoved = jv.remove_empty(jres, thresh=1.0)
    assert list(keep) == list(wkeep) == [0, 2]
    assert list(removed) == list(wremoved) == [1]
    close(got, want, rtol=1e-12)
    assert tv.remove_empty(to_port(jres), thresh=0.1)[0].post.alpha.shape \
        == (3,)
    trans = np.array(jres.model.trans)
    close(tv.steady_state(torch.as_tensor(trans)),
          jv.steady_state(jnp.asarray(trans)), rtol=1e-10)


def test_f64_lane_bound_matches_jax_rescore():
    """The port's float64 rescoring of float32 lanes against the JAX
    package's NumPy float64 bound, lane by lane."""
    tb, jb = subject(seed=19, n_seqs=6, t=20, ragged=True)
    jh = jv.VBHyps.from_config(JConfig(mu0=(1.5, 1.5), w0=1.0), 2)
    posts = jax.vmap(lambda k: jv.random_init(k, jb, 2, jh))(
        jax.random.split(jax.random.key(7), 3))
    t32 = convert.to_torch(posts, device="cpu", dtype=torch.float32)
    b32 = tc.SeqBatch(x=tb.x.float(), lengths=tb.lengths)
    got = trescore.vbem_rescore_lanes(b32, t32, convert.to_torch(
        jh, device="cpu", dtype=torch.float32))
    assert got.dtype == torch.float64
    for li in range(3):
        p = convert.to_numpy(tree_map(lambda a: a[li], t32))
        want = jrescore.vbem_elbo_f64(np.asarray(b32.x), np.asarray(jb.lengths),
                                      p, jh)
        np.testing.assert_allclose(float(got[li]), want, rtol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32_rescored"])
def test_learn_selects_k2(dtype):
    tb, jb = subject()
    tb = tc.SeqBatch(x=tb.x.to(dtype), lengths=tb.lengths)
    cfg = VBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=4)
    res, info = tv.learn(torch.Generator().manual_seed(0), tb, [1, 2, 3],
                         cfg)
    assert info["model_best_k"] == 2, info["model_ll"]
    if dtype == torch.float64:   # the JAX package on the same data
        _, jinfo = jv.learn(jax.random.key(0), jb, [1, 2, 3],
                            JConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=4))
        assert jinfo["model_best_k"] == 2, jinfo["model_ll"]
    assert res.post.alpha.shape == (2,) and res.post.alpha.dtype == dtype
    if dtype == torch.float32:
        assert all("ll_f64" in i for i in info["model_infos"][1:])
    means = res.model.mean.double().numpy()
    order = np.argsort(means[:, 0])
    np.testing.assert_allclose(means[order], [[0, 0], [3, 3]], atol=0.35)
    # 'f' ordering starts at the most probable initial state
    assert float(res.model.prior[0]) >= float(res.model.prior[1]) - 1e-9


def test_learn_initmodes_and_what_is_not_ported():
    tb, _ = subject(seed=20, n_seqs=6, t=20)
    gen = torch.Generator().manual_seed(1)
    cfg = VBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=2, initmode="split",
                   keep_suboptimal=True)
    res, info = tv.learn(gen, tb, 2, cfg)
    assert len(info["suboptimal"]) == 1 and res.model.mean.shape == (2, 2)
    gmm = (np.array([0.5, 0.5]), np.array([[0.0, 0.0], [3.0, 3.0]]),
           np.tile(np.eye(2), (2, 1, 1)))
    res_g, _ = tv.learn(gen, tb, 2, VBConfig(mu0=(1.5, 1.5), w0=1.0,
                                             initmode="initgmm"),
                        initgmm=gmm)
    res_h, _ = tv.learn(gen, tb, 2, VBConfig(mu0=(1.5, 1.5), w0=1.0,
                                             initmode="inithmm"),
                        inithmm=res_g.post)
    # inithmm restarts from the initgmm solution: the same optimum
    np.testing.assert_allclose(res_h.ll.numpy(), res_g.ll.numpy(), rtol=1e-4)
    with pytest.raises(ValueError, match="initgmm"):
        tv.learn(gen, tb, 2, VBConfig(learn_hyps=False, initmode="initgmm"))


def test_learn_bank_then_cluster_recovers_planted_groups():
    """Six subjects per planted group: the bank learned by learn_bank,
    converted by h3m_from_results and clustered by cluster at the
    settings of tests/test_vbhem.py:49-56."""
    batches, labels = planted.synthetic_subjects(6, n_seqs=15, seed=2,
                                                 device="cpu",
                                                 dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    results, info = tbatch.learn_bank(
        gen, batches, 2, VBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=3))
    assert len(results) == 12 and info["model_em_iters"] >= 2
    diag = np.array([float(torch.diagonal(r.model.trans).mean())
                     for r in results])
    assert np.all((diag > 0.5) == (labels == 0)), diag
    base = tvbhem.h3m_from_results(results, device="cpu")
    cfg = VBHEMConfig(alpha0=1e6, m0=(1.5, 1.5), w0=1.0, trials=8, nv=100,
                      tau=50, initmode="baseem", learn_hyps=False)
    res, cinfo = tvbhem.cluster(gen, base, [1, 2, 3], 2, cfg)
    assert planted.rand_index(
        cinfo["model_all"][(2, 2)].label.numpy(), labels) == 1.0
    assert planted.rand_index(res.label.numpy(), labels) == 1.0


def test_learn_bank_lanes_match_per_subject_em():
    """The bank's EM over [S, L] lanes gives each subject what vbem_em on
    that subject alone gives from the same start."""
    batches, _ = planted.synthetic_subjects(2, n_seqs=5, t=20, seed=3,
                                            device="cpu",
                                            dtype=torch.float64)
    bank = tc.SeqBatch(x=torch.stack([b.x for b in batches]),
                       lengths=torch.stack([b.lengths for b in batches]))
    hyps = tv.VBHyps.from_config(VBConfig(mu0=(1.5, 1.5), w0=1.0), 2,
                                 device="cpu")
    post0 = tv.random_init(torch.Generator().manual_seed(5), bank, 2, hyps,
                           lanes=(3,))
    st = tv.vbem_em(bank, post0, hyps, max_iter=30)
    assert st.ll.shape == (4, 3)
    for s in (0, 3):
        one = tv.vbem_em(batches[s], tree_map(lambda a: a[s], post0),
                         hyps, max_iter=30)
        np.testing.assert_array_equal(st.it[s].numpy(), one.it.numpy())
        np.testing.assert_allclose(st.ll[s].numpy(), one.ll.numpy(),
                                   rtol=1e-12)


def test_learn_bank_and_learn_batch_reject_what_is_not_ported():
    batches, _ = planted.synthetic_subjects(1, n_seqs=4, t=10, device="cpu")
    gen = torch.Generator().manual_seed(0)
    res, _ = tbatch.learn_batch(gen, batches, 2, VBConfig(
        mu0=(1.5, 1.5), w0=1.0, numtrials=2, learn_hyps=False))
    assert len(res) == 2 and res[0].model.trans.shape == (2, 2)
