"""The port's VBHEM initializers (ROADMAP A3) against the JAX package on
the same float64 inputs: ``weighted_kmeans_energy`` (also against the
NumPy port of `my_weighted_kmeans.m`), the weighted randSample start of
``fit_gmm``, each initializer's draw-consuming helper fed the JAX
package's own draws (1e-10), 'random''s hyper-space conversion against a
NumPy oracle, the initializers' validity on lane axes, ``vbhem_em`` from
each mode's start (1e-9), the 'auto' front-ends on a planted bank (the
same selection and labels as the JAX package), and the initmode errors.
The two packages draw different random numbers, so a test hands the port
the JAX package's draws, reproduced from its keys."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbhem_tpu import containers as jc
from vbhem_tpu.config import VBHEMConfig as JConfig
from vbhem_tpu.models import vbhem as jv
from vbhem_tpu.ops import gmm as jgmm
from vbhem_tpu.ops import kmeans as jkm
from vbhem_tpu.utils.metrics import rand_index
from vbhem_tpu_torch import VBHEMConfig
from vbhem_tpu_torch import convert
from vbhem_tpu_torch.models import vbhem as tv
from vbhem_tpu_torch.ops import gmm as tgmm
from vbhem_tpu_torch.ops import kmeans as tkm
from vbhem_tpu_torch.utils import planted

RTOL = 1e-10
KB, SB, D, NV = 12, 3, 2, 10
CFG = dict(m0=(0.5, -0.5), w0=0.5, nv=NV, tau=4)


def to_port(obj):
    return convert.to_torch(obj, device="cpu")


def t(a):
    return torch.as_tensor(np.array(a))


def assert_tree_close(got, want, rtol=RTOL, atol=0.0):
    g = convert.to_numpy(got)
    for f in want._fields:
        a, b = getattr(g, f), getattr(want, f)
        if hasattr(b, "_fields"):
            assert_tree_close(getattr(got, f), b, rtol, atol)
        else:
            np.testing.assert_allclose(a, np.asarray(b), rtol=rtol,
                                       atol=atol, err_msg=f)


def jax_bank(seed, kb=KB, sb=SB, d=D, ragged=True):
    rng = np.random.default_rng(seed)
    bank = planted.random_bank(rng, kb, sb, d, "cpu", torch.float64,
                               ragged=ragged)
    n = convert.to_numpy(bank)
    return jc.H3M(omega=jnp.asarray(n.omega),
                  hmm=jc.HMM(*[jnp.asarray(a) for a in n.hmm]),
                  state_mask=jnp.asarray(n.state_mask)), bank


@pytest.fixture(scope="module")
def bank():
    jb, tb = jax_bank(0)
    jh = jv.VBHEMHyps.from_config(JConfig(**CFG), D)
    return jb, tb, jh, to_port(jh)


def _pool(jb):
    kb, sb = jb.state_mask.shape
    return (jb.hmm.mean.reshape(kb * sb, -1),
            jb.state_mask.reshape(-1).astype(jnp.float64))


# ---------------------------------------------------------------------------
# k-means and the GMM start
# ---------------------------------------------------------------------------

def _kmeans_case(seed, m=40, k=3, lanes=()):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(size=(m // 2, D)),
                        rng.normal(size=(m // 2, D)) + 4.0])
    w = rng.uniform(0.2, 2.0, size=m)
    init_c = np.stack([x[rng.choice(m, k, replace=False)]
                       for _ in range(int(np.prod(lanes)))]).reshape(
        lanes + (k, D))
    return x, w, init_c


@pytest.mark.parametrize("lanes", [(1,), (4,), (2, 3)],
                         ids=["one", "lanes", "lane_axes"])
def test_weighted_kmeans_energy_matches_jax(lanes):
    x, w, init_c = _kmeans_case(2, lanes=lanes)
    if lanes == (1,):
        init_c = init_c[0]
    got_a, got_c = tkm.weighted_kmeans_energy(t(x), t(w), t(init_c))
    fn = lambda c: jkm.weighted_kmeans_energy(jnp.asarray(x), jnp.asarray(w),
                                              c)
    for _ in range(init_c.ndim - 2):
        fn = jax.vmap(fn)
    want_a, want_c = fn(jnp.asarray(init_c))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               rtol=RTOL, atol=1e-12)


def test_weighted_kmeans_energy_degenerate_member_is_inf():
    """A cluster owning all its weight through one point gives that
    point +inf member energy and moves it, as in the JAX package."""
    x = np.array([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0], [5.1, 5.0]])
    w = np.array([1.0, 1.0, 1.0, 1.0])
    init_c = np.array([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0]])
    got_a, got_c = tkm.weighted_kmeans_energy(t(x), t(w), t(init_c))
    want_a, want_c = jkm.weighted_kmeans_energy(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(init_c))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=RTOL)


def test_weighted_kmeans_energy_matches_matlab_oracle():
    """The case of the JAX package's oracle test (`my_weighted_kmeans.m`
    ported loop for loop to NumPy), run on the port."""
    rng = np.random.default_rng(4)
    m, d, k = 40, 2, 3
    x = np.concatenate([rng.normal(size=(m // 2, d)),
                        rng.normal(size=(m // 2, d)) + 4.0])
    w = rng.uniform(0.2, 2.0, size=m)
    init_c = x[rng.choice(m, k, replace=False)]

    def centroids(cl):
        cen = np.zeros((k, d))
        wc = np.zeros(k)
        for j in range(k):
            mem = cl == j
            wc[j] = w[mem].sum()
            if wc[j] > 0:
                cen[j] = (w[mem, None] * x[mem]).sum(0) / wc[j]
        return cen, wc

    def energies(cl, cen, wc):
        d2 = ((x[:, None] - cen[None]) ** 2).sum(-1)
        f = np.zeros(m)
        for j in range(k):
            mem = cl == j
            with np.errstate(divide="ignore", invalid="ignore"):
                f[mem] = d2[mem, j] * wc[j] / (wc[j] - w[mem])
        total = np.nansum(np.where(np.isfinite(f), w * f, 0.0))
        return d2, f, total

    cl = np.argmin(((x[:, None] - init_c[None]) ** 2).sum(-1), -1)
    cen, wc = centroids(cl)
    d2, f, old_e = energies(cl, cen, wc)
    for _ in range(100):
        fmat = np.zeros((m, k))
        for j in range(k):
            mem = cl == j
            fmat[mem, j] = f[mem]
            non = ~mem
            fmat[non, j] = d2[non, j] * wc[j] / (wc[j] + w[non])
        cl = np.argmin(fmat, -1)
        cen, wc = centroids(cl)
        d2, f, new_e = energies(cl, cen, wc)
        if abs(new_e - old_e) < 1e-6:
            break
        old_e = new_e

    got_cl, got_cen = tkm.weighted_kmeans_energy(t(x), t(w), t(init_c))
    np.testing.assert_array_equal(got_cl.numpy(), cl)
    np.testing.assert_allclose(got_cen.numpy(), cen, rtol=1e-10)


def test_kmeans_with_per_lane_weights_matches_jax():
    """k-means whose lanes weigh the points their own way (the per-cluster
    k-means of 'wtkmeans'), from the same seeds: each lane as the JAX
    function with that lane's weights."""
    x, _, init_c = _kmeans_case(5, k=2, lanes=(3,))
    rng = np.random.default_rng(6)
    w = (rng.uniform(size=(3, x.shape[0])) > 0.4).astype(np.float64)
    _, got = tkm.kmeans(None, t(x), 2, weights=t(w), init_centers=t(init_c))
    for lane in range(3):
        _, want = jkm.kmeans(None, jnp.asarray(x), 2,
                             weights=jnp.asarray(w[lane]),
                             init_centers=jnp.asarray(init_c[lane]))
        np.testing.assert_allclose(got[lane].numpy(), np.asarray(want),
                                   rtol=RTOL, atol=1e-12)


def test_fit_gmm_start_weighted_matches_jax():
    """``fit_gmm(start_weighted=True)``: from the JAX package's weighted
    randSample start (its indices, reproduced from the key), the port's
    EM gives the JAX fit; the port's own weighted draw picks distinct
    points of positive weight."""
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.normal(size=(15, D)),
                        rng.normal(size=(15, D)) + 5.0])
    w = (rng.uniform(size=30) > 0.3).astype(np.float64)
    key = jax.random.key(3)
    want = jgmm.fit_gmm(key, jnp.asarray(x), 3, weights=jnp.asarray(w),
                        start_weighted=True)
    idx = np.asarray(jax.random.choice(key, 30, (3,), replace=False,
                                       p=jnp.asarray(w / w.sum())))
    got = tgmm.fit_gmm_from_means(t(x), t(x[idx]), t(w))
    assert_tree_close(got, want)

    gen = torch.Generator().manual_seed(0)
    g = tgmm.fit_gmm(gen, t(x), 3, weights=t(w), lanes=(50,),
                     start_weighted=True)
    assert g.mean.shape == (50, 3, D)
    gen = torch.Generator().manual_seed(0)
    u = torch.rand((50, 30), generator=gen, dtype=torch.float64)
    key_ = torch.log(t(w / w.sum())) - torch.log(-torch.log(u))
    picks = torch.topk(key_, 3, dim=-1).indices.numpy()
    assert np.all(w[picks] > 0)
    assert all(len(set(row)) == 3 for row in picks)


# ---------------------------------------------------------------------------
# the initializers, from the JAX package's draws
# ---------------------------------------------------------------------------

def wtkmeans_draws(key, jb, kr, sr):
    """The draws of ``vbhem_tpu.models.vbhem.init_wtkmeans`` for ``key``:
    the kmeans++ seeds of its three k-means stages and the uniforms."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    means, valid = _pool(jb)
    seeds_kr = jkm.kmeans_pp_init(k1, means, kr, valid)
    _, init_c = jkm.kmeans(k1, means, kr, weights=valid)
    p = jax.vmap(lambda p, a: jax.lax.fori_loop(
        0, 50, lambda _, q: q @ a, p))(jb.hmm.prior, jb.hmm.trans)
    weights = (p * jb.state_mask).reshape(-1)
    assign, _ = jkm.weighted_kmeans_energy(
        means, weights / jnp.sum(weights), init_c)
    global_seeds = jkm.kmeans_pp_init(k3, means, sr, valid)

    def cluster_seed(j, kj):
        in_c = ((assign == j) & (valid > 0)).astype(jnp.float64)
        return jkm.kmeans_pp_init(kj, means, sr, jnp.where(
            jnp.sum(in_c) > 0, in_c, valid))

    kp, ka = jax.random.split(k4)
    return dict(seeds_kr=seeds_kr, assign=assign, global_seeds=global_seeds,
                cluster_seeds=jax.vmap(cluster_seed)(
                    jnp.arange(kr), jax.random.split(k2, kr)),
                u_prior=jax.random.uniform(kp, (kr, sr), jnp.float64),
                u_trans=jax.random.uniform(ka, (kr, sr, sr), jnp.float64))


def random_draws(key, jb, kr, sr):
    """The draws of ``init_random``: the partition and each cluster's
    weighted randSample start means."""
    k1, k2 = jax.random.split(key)
    kb, sb = jb.state_mask.shape
    perm = jax.random.permutation(k1, kb)
    rand_lab = jax.random.randint(jax.random.fold_in(k1, 1), (kb,), 0, kr,
                                  dtype=jnp.int32)
    npin = min(kr, kb)
    labels = jnp.zeros((kb,), jnp.int32)
    labels = labels.at[perm[:npin]].set(jnp.arange(npin, dtype=jnp.int32))
    labels = labels.at[perm[npin:]].set(rand_lab[perm[npin:]])
    means, valid = _pool(jb)
    base_of = jnp.repeat(jnp.arange(kb), sb)

    def start(j, kj):
        w_c = ((labels[base_of] == j) & (valid > 0)).astype(jnp.float64)
        idx = jax.random.choice(kj, kb * sb, (sr,), replace=False,
                                p=w_c / jnp.sum(w_c))
        return means[idx]

    return dict(labels=labels, mean0=jax.vmap(start)(
        jnp.arange(kr), jax.random.split(k2, kr)))


def gmmnew_draws(key, jb, kr, sr, two=False):
    """The draws of ``init_gmmNew`` (``two``: ``init_gmmNew2``)."""
    keys = jax.random.split(key, 4 if two else 3)
    means, valid = _pool(jb)
    t_ = kr * sr if two else sr
    out = dict(seeds=jkm.kmeans_pp_init(keys[0], means, t_,
                                        valid / jnp.sum(valid)))
    if two:
        out["use"] = jax.random.permutation(keys[1], kr * sr)
    out["u_omega"] = jax.random.uniform(keys[-2], (kr,), jnp.float64)
    kp, ka = jax.random.split(keys[-1])
    out["u_prior"] = jax.random.uniform(kp, (kr, sr), jnp.float64)
    out["u_trans"] = jax.random.uniform(ka, (kr, sr, sr), jnp.float64)
    return out


def port_from_draws(mode, tb, kr, sr, th, draws):
    """The port's draw-consuming helper of ``mode`` on JAX draws (each
    with the lane axes of the draws)."""
    dr = {k: t(np.asarray(v)) for k, v in draws.items()}
    if mode == "wtkmeans":
        assign = tv.wtkmeans_assign(tb, dr["seeds_kr"])
        np.testing.assert_array_equal(assign.numpy(), dr["assign"].numpy())
        return tv.wtkmeans_from_draws(tb, kr, sr, th, NV, assign,
                                      dr["global_seeds"],
                                      dr["cluster_seeds"], dr["u_prior"],
                                      dr["u_trans"])
    if mode == "random":
        return tv.random_from_draws(tb, kr, sr, th, NV,
                                    dr["labels"].long(), dr["mean0"])
    if mode == "gmmNew":
        return tv.gmmnew_from_draws(tb, kr, sr, th, NV, dr["seeds"],
                                    dr["u_omega"], dr["u_prior"],
                                    dr["u_trans"])
    return tv.gmmnew2_from_draws(tb, kr, sr, th, NV, dr["seeds"],
                                 dr["use"].long(), dr["u_omega"],
                                 dr["u_prior"], dr["u_trans"])


DRAWS = {"wtkmeans": wtkmeans_draws, "random": random_draws,
         "gmmNew": gmmnew_draws,
         "gmmNew2": lambda *a: gmmnew_draws(*a, two=True)}
JAX_INIT = {"wtkmeans": jv.init_wtkmeans, "random": jv.init_random,
            "gmmNew": jv.init_gmmNew, "gmmNew2": jv.init_gmmNew2}


@pytest.mark.parametrize("mode", list(DRAWS))
def test_initializer_from_jax_draws(bank, mode):
    """Each initializer's helper, fed the JAX package's draws, gives the
    JAX initializer's posterior at 1e-10; with a lane axis, each lane
    its own key's."""
    jb, tb, jh, th = bank
    kr, sr = 3, 2
    keys = jax.random.split(jax.random.key(11), 2)
    want, draws = jax.jit(jax.vmap(lambda k: (
        JAX_INIT[mode](k, jb, kr, sr, jh, NV),
        DRAWS[mode](k, jb, kr, sr))))(keys)
    got = port_from_draws(mode, tb, kr, sr, th, draws)
    assert_tree_close(got, want, atol=1e-12)
    one = port_from_draws(mode, tb, kr, sr, th,
                          {k: v[0] for k, v in draws.items()})
    assert_tree_close(one, jax.tree.map(lambda a: a[0], want), atol=1e-12)


def test_random_conversion_oracle(bank):
    """'random''s conversion (`vbhemhmm_init.m:983-1030`) against the
    NumPy oracle of the JAX package's test, from a given partition and
    per-cluster GMM."""
    _, tb, jh, th = bank
    kr, sr = 3, 2
    rng = np.random.default_rng(9)
    labels = np.array([0, 1, 2] + list(rng.integers(0, kr, KB - 3)))
    weight = rng.dirichlet(np.ones(sr), kr)
    ybar = rng.normal(size=(kr, sr, D))
    a = rng.normal(size=(kr, sr, D, D))
    cov = np.einsum("...de,...fe->...df", a, a) + np.eye(D)
    post = tv.random_conversion(tb, kr, sr, th, NV, t(labels),
                                tgmm.GMM(t(weight), t(ybar), t(cov)))
    lam0, v0 = float(jh.lambda0), float(jh.v0)
    m0 = np.asarray(jh.m0)
    w0inv = np.diag(np.asarray(jh.w0inv_diag))
    n_i = NV * np.asarray(tb.omega)
    for j in range(kr):
        n_j = float(n_i[labels == j].sum())
        nj_rho = n_j * weight[j]
        np.testing.assert_allclose(post.niw.beta[j].numpy(), lam0 + nj_rho,
                                   rtol=RTOL)
        np.testing.assert_allclose(post.niw.v[j].numpy(),
                                   v0 + nj_rho + 1.0, rtol=RTOL)
        want_m = (lam0 * m0 + nj_rho[:, None] * ybar[j]) \
            / (lam0 + nj_rho)[:, None]
        np.testing.assert_allclose(post.niw.m[j].numpy(), want_m, rtol=RTOL)
        for s in range(sr):
            mult1 = lam0 * nj_rho[s] / (lam0 + nj_rho[s])
            diff = ybar[j, s] - m0
            want_w = np.linalg.inv(w0inv + nj_rho[s] * cov[j, s]
                                   + mult1 * np.outer(diff, diff))
            np.testing.assert_allclose(post.niw.w[j, s].numpy(), want_w,
                                       rtol=1e-9)
        np.testing.assert_allclose(post.alpha[j].numpy(),
                                   float(jh.alpha0) + n_j, rtol=RTOL)
        np.testing.assert_allclose(post.eta[j].numpy(),
                                   float(jh.eta0) + n_j / sr, rtol=RTOL)
        np.testing.assert_allclose(post.epsilon[j].numpy(),
                                   float(jh.epsilon0) + n_j / sr, rtol=RTOL)


def test_long_run_weights_match_jax_recipe(bank):
    jb, tb, _, _ = bank
    p = jax.vmap(lambda p, a: jax.lax.fori_loop(0, 50, lambda _, q: q @ a,
                                                p))(jb.hmm.prior,
                                                    jb.hmm.trans)
    w = (p * jb.state_mask).reshape(-1)
    np.testing.assert_allclose(tv.long_run_weights(tb).numpy(),
                               np.asarray(w / jnp.sum(w)), rtol=RTOL)


@pytest.mark.parametrize("mode", sorted(tv._INITIALIZERS))
def test_initializer_validity_on_lane_axes(bank, mode):
    """Drawn by the port's own generator on a lane axis: finite, alpha,
    eta, epsilon, beta > 0, v > D - 1, W symmetric positive definite,
    every leaf contiguous (as kernel B1 reads it); 'random' leaves no
    cluster empty."""
    _, tb, _, th = bank
    kr, sr, n = 4, 3, 6
    gen = torch.Generator().manual_seed(1)
    post = tv._INITIALIZERS[mode](gen, tb, kr, sr, th, NV, lanes=(n,))
    for leaf in (post.alpha, post.eta, post.epsilon, *post.niw):
        assert leaf.is_contiguous() and bool(torch.all(torch.isfinite(leaf)))
    assert post.alpha.shape == (n, kr)
    assert post.niw.w.shape == (n, kr, sr, D, D)
    for leaf in (post.alpha, post.eta, post.epsilon, post.niw.beta):
        assert bool(torch.all(leaf > 0))
    assert bool(torch.all(post.niw.v > D - 1))
    w = post.niw.w
    assert torch.allclose(w, w.transpose(-1, -2))
    assert bool(torch.all(torch.linalg.eigvalsh(w) > 0))
    if mode == "random":
        labels = tv.random_labels(torch.Generator().manual_seed(2), KB, kr,
                                  (50,))
        for lane in labels:
            assert set(lane.tolist()) == set(range(kr))
        few = tv.random_labels(torch.Generator().manual_seed(2), 2, 5, (3,))
        assert bool(torch.all(few.max(dim=-1).values <= 4))


@pytest.mark.parametrize("mode", sorted(tv._INITIALIZERS))
def test_draw_lanes_does_not_depend_on_the_chunk(bank, mode):
    """Every lane's draws are made up front, so the chunks the posteriors
    are made in change no lane's start: chunks of 1, 3 and 7 lanes give
    the same posteriors as one chunk, and one chunk the same as the
    initializer with ``lanes=(n,)`` from the same generator state."""
    _, tb, _, th = bank
    kr, sr, n = 4, 3, 7
    whole = tv.draw_lanes(mode, torch.Generator().manual_seed(3), tb, kr, sr,
                          th, NV, n)
    direct = tv._INITIALIZERS[mode](torch.Generator().manual_seed(3), tb, kr,
                                    sr, th, NV, lanes=(n,))
    assert_tree_close(direct, convert.to_numpy(whole), rtol=0.0)
    for chunk in (1, 3, n):
        got = tv.draw_lanes(mode, torch.Generator().manual_seed(3), tb, kr,
                            sr, th, NV, n, chunk)
        assert_tree_close(got, convert.to_numpy(whole), rtol=0.0)


def test_inverse_cdf_samplers():
    """``inverse_cdf`` never draws an index of weight 0 while the row has
    positive weight (u = 0 included); ``kmeans_pp_from_uniforms`` seeds
    only on points of positive weight; ``sample_without_replacement``
    draws distinct indices, those of positive weight first, and its
    first draw follows the weights."""
    p = torch.tensor([[0.0, 2.0, 0.0, 1.0], [0.0, 0.0, 0.0, 0.0]])
    u = torch.tensor([[0.0, 0.5, 0.7, 0.999999]]).T.expand(4, 2)
    idx = tkm.inverse_cdf(p.expand(4, 2, 4), u)
    assert idx[:, 0].tolist() == [1, 1, 3, 3]
    assert bool(torch.all(idx[:, 1] == 3))
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(30, D)))
    w = torch.as_tensor((rng.uniform(size=30) > 0.5).astype(np.float64))
    seeds = tkm.kmeans_pp_from_uniforms(
        x, 5, w, torch.as_tensor(rng.uniform(size=(20, 5))))
    on = x[w > 0]
    assert bool(torch.all((seeds.reshape(-1, 1, D) == on).all(-1).any(-1)))
    wts = torch.tensor([[0.0, 3.0, 1.0, 0.0, 0.0]]).expand(2000, 5)
    got = tgmm.sample_without_replacement(
        wts, torch.as_tensor(rng.uniform(size=(2000, 4))))
    assert all(len(set(r)) == 4 for r in got.tolist())
    assert set(got[:, :2].reshape(-1).tolist()) == {1, 2}
    assert abs(float(torch.mean((got[:, 0] == 1).double())) - 0.75) < 0.05


EM_KW = dict(nv=NV, tau=4, max_iter=30)


@pytest.fixture(scope="module")
def jax_em(bank):
    """``jax.vmap(vbhem_em)`` on the bank, compiled once for every mode."""
    jb, _, jh, _ = bank
    return jax.jit(jax.vmap(lambda p: jv.vbhem_em(jb, p, jh, **EM_KW)))


@pytest.mark.parametrize("mode", sorted(tv._INITIALIZERS))
def test_vbhem_em_from_each_mode_matches_jax(bank, jax_em, mode):
    """``vbhem_em`` from the JAX initializer's start for each mode, lanes
    against ``jax.vmap``: the same iteration counts, ll at 1e-9."""
    jb, tb, jh, th = bank
    kr, sr = 2, 2
    keys = jax.random.split(jax.random.key(5), 2)
    init = jax.jit(jax.vmap(lambda k: jv._INITIALIZERS[mode](
        k, jb, kr, sr, jh, NV)))(keys)
    want = jax_em(init)
    got = tv.vbhem_em(tb, to_port(init), th, **EM_KW)
    np.testing.assert_array_equal(got.it.numpy(), np.asarray(want.it))
    np.testing.assert_allclose(got.ll.numpy(), np.asarray(want.ll),
                               rtol=1e-9)
    np.testing.assert_allclose(got.post.niw.m.numpy(),
                               np.asarray(want.post.niw.m), rtol=1e-8,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# 'auto' in the front-ends, and the errors
# ---------------------------------------------------------------------------

def _jax_h3m(base):
    n = convert.to_numpy(base)
    return jc.H3M(omega=jnp.asarray(n.omega),
                  hmm=jc.HMM(*[jnp.asarray(a) for a in n.hmm]),
                  state_mask=jnp.asarray(n.state_mask))


AUTO_KW = dict(trials=4, learn_hyps=False, nv=100, tau=5, m0=(13.0, 10.0),
               w0=1.0, max_iter=60)


@pytest.fixture(scope="module")
def planted_pair():
    """A planted bank and the JAX package's selection on it under 'auto':
    ``cluster_batched`` over K in {1, 2} x S in {1, 2} (the JAX ``cluster``
    runs the same rule but compiles every cell and mode anew, about a
    minute here)."""
    base, labels = planted.planted_bank(16, torch.device("cpu"),
                                        torch.float64, seed=4)
    jres, jinfo = jv.cluster_batched(jax.random.key(0), _jax_h3m(base),
                                     [1, 2], [1, 2], JConfig(**AUTO_KW))
    assert (jinfo["model_best_k"], jinfo["model_best_s"]) == (2, 2)
    return base, labels, np.asarray(jres.label)


def test_cluster_auto_matches_jax_selection(planted_pair):
    """``cluster`` under the default initmode 'auto': every mode run in
    every cell, and the JAX package's (K, S) and labels."""
    base, labels, jlabel = planted_pair
    cfg = VBHEMConfig(**AUTO_KW)
    assert cfg.initmode == "auto"
    res, info = tv.cluster(torch.Generator().manual_seed(0), base, [1, 2],
                           [1, 2], cfg)
    assert (info["model_best_k"], info["model_best_s"]) == (2, 2)
    assert rand_index(res.label.numpy(), jlabel)[1] == pytest.approx(1.0)
    assert rand_index(res.label.numpy(), labels)[1] == pytest.approx(1.0)
    assert set(info["model_initmode"].values()) <= set(tv.AUTO_MODES)
    assert all(n >= 3 for n in info["model_em_iters"].values())
    assert np.all(np.isfinite(info["model_ll"]))


def test_cluster_batched_auto_matches_jax_selection(planted_pair):
    """``cluster_batched`` under 'auto': the three modes' restarts
    concatenated along the trials axis, the JAX package's (K, S) and
    labels."""
    base, labels, jlabel = planted_pair
    res, info = tv.cluster_batched(torch.Generator().manual_seed(0), base,
                                   [1, 2], [1, 2], VBHEMConfig(**AUTO_KW))
    assert (info["model_best_k"], info["model_best_s"]) == (2, 2)
    assert rand_index(res.label.numpy(), jlabel)[1] == pytest.approx(1.0)
    assert rand_index(res.label.numpy(), labels)[1] == pytest.approx(1.0)
    # three modes' worth of chunks, one each on the CPU
    assert len(info["grid_chunk_iters"]) == 3
    assert all(n >= 3 for n in info["model_em_iters"].values())


def test_resolve_initmode_errors():
    for mode in tv._INITIALIZERS:
        assert tv.resolve_initmode(mode) == mode
    with pytest.raises(ValueError, match="front-end"):
        tv.resolve_initmode("auto")
    with pytest.raises(ValueError, match="unknown initmode"):
        tv.resolve_initmode("kmeans")
    assert tv.front_end_modes("auto") == ["baseem", "gmmNew", "wtkmeans"]
    assert tv.front_end_modes("random") == ["random"]
    assert not hasattr(tv, "_NOT_PORTED")
