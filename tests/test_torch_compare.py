"""The port's comparison methods, PPK-SC (``models/ppk.py``) and CCFD
(``models/ccfd.py``), with ``synthetic.run_ccfd`` and
``synthetic.run_ppk_grid``, against the JAX package's on the same
float64 inputs, made with numpy from a seed (or by the JAX package) and
handed over through ``vbhem_tpu_torch.convert``.

``bhatt_affinity``, ``ppk``, ``gram_matrix`` (ragged state counts) and
``skl_distance_matrix`` (given data, and the pair loop for data of
differing shapes) within 1e-10; ``_ccfd_core`` and ``ccfd`` on the same
distance matrix: identical labels, centers and halo.  The two packages
draw k-means seeds differently, so ``spectral_cluster``, ``ppk_sc`` and
``run_ppk_grid`` are given the JAX package's draws: a wrapper around the
JAX package's ``kmeans`` records the rows its kmeans++ seeding picks,
and the port's ``kmeans`` starts from the same rows.  Their labels and
log-likelihood grids must then match (where a two-member cluster's
center is a tie that rounding decides, the cell's log-likelihood is
left out); the embeddings match up to the sign of each column."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbhem_tpu.containers import HMM as JHMM
from vbhem_tpu.containers import SeqBatch as JSeqBatch
from vbhem_tpu.experiments import synthetic as jsyn
from vbhem_tpu.models import ccfd as jccfd
from vbhem_tpu.models import hmm_tools as jht
from vbhem_tpu.models import ppk as jppk
from vbhem_tpu.ops import kmeans as jkm
from vbhem_tpu_torch import convert
from vbhem_tpu_torch.experiments import synthetic as tsyn
from vbhem_tpu_torch.models import ccfd as tccfd
from vbhem_tpu_torch.models import ppk as tppk
from vbhem_tpu_torch.ops import kmeans as tkm

RTOL = 1e-10


def to_port(obj):
    return convert.to_torch(obj, device="cpu")


def rand_hmm(rng, k, d=2):
    a = rng.normal(size=(k, d, d)) * 0.4
    return JHMM(prior=jnp.asarray(rng.dirichlet(np.ones(k))),
                trans=jnp.asarray(rng.dirichlet(np.ones(k) * 2, k)),
                mean=jnp.asarray(rng.normal(size=(k, d)) * 2.0),
                cov=jnp.asarray(np.einsum("kde,kfe->kdf", a, a)
                                + 0.5 * np.eye(d)))


def planted_hmms(rng, per_group):
    """Subjects near the two ground-truth HMMs: their transitions and
    means jittered."""
    out = []
    for h in jsyn.gt_hmms():
        for _ in range(per_group):
            tr = np.asarray(h.trans) + rng.normal(size=(2, 2)) * 0.03
            tr = np.clip(tr, 0.05, None)
            out.append(h._replace(
                trans=jnp.asarray(tr / tr.sum(1, keepdims=True)),
                mean=h.mean + jnp.asarray(rng.normal(size=(2, 2)) * 0.05)))
    return out


def two_group_bank(rng, s, per_group):
    """Subjects near two random S-state templates, so that the PPK Gram
    matrix has two blocks and its top eigenvalues are apart (an affinity
    near the identity has every eigenvalue near 1, and its eigenvectors
    are then any basis)."""
    out = []
    for _ in range(2):
        tmpl = rand_hmm(rng, s)
        for _ in range(per_group):
            tr = np.asarray(tmpl.trans) + rng.uniform(size=(s, s)) * 0.05
            out.append(tmpl._replace(
                trans=jnp.asarray(tr / tr.sum(1, keepdims=True)),
                mean=tmpl.mean + jnp.asarray(rng.normal(size=(s, 2)) * 0.1)))
    return out


def own_data(hmms, n_seqs, t, seed=0):
    return [JSeqBatch(x=jht.sample(jax.random.key(seed + i), h, t,
                                   n_seqs)[1],
                      lengths=jnp.full((n_seqs,), t, jnp.int32))
            for i, h in enumerate(hmms)]


# ---------------------------------------------------------------------------
# PPK
# ---------------------------------------------------------------------------

def test_bhatt_affinity_matches_jax():
    rng = np.random.default_rng(0)
    h1, h2 = rand_hmm(rng, 3), rand_hmm(rng, 2)
    want = jppk.bhatt_affinity(h1.mean, h1.cov, h2.mean, h2.cov)
    got = tppk.bhatt_affinity(*(to_port(v) for v in (h1.mean, h1.cov,
                                                     h2.mean, h2.cov)))
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("t", [1, 2, 10])
def test_ppk_matches_jax(t):
    rng = np.random.default_rng(t)
    h1, h2 = rand_hmm(rng, 3), rand_hmm(rng, 2)
    np.testing.assert_allclose(float(tppk.ppk(to_port(h1), to_port(h2), t)),
                               float(jppk.ppk(h1, h2, t)), rtol=RTOL)


def test_gram_matrix_ragged_matches_jax():
    """Ragged state counts go through the state-padded bank: padded states
    contribute exactly 0."""
    rng = np.random.default_rng(3)
    hmms = [rand_hmm(rng, k) for k in (1, 2, 3, 2, 3)]
    want = jppk.gram_matrix(hmms)
    got = tppk.gram_matrix([to_port(h) for h in hmms])
    assert got.shape == (5, 5)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got, got.T, rtol=0)
    # the padded pair equals the unpadded one
    np.testing.assert_allclose(
        got[0, 2], float(tppk.ppk(to_port(hmms[0]), to_port(hmms[2]))),
        rtol=1e-12)


class KmeansDraws:
    """Record the rows the JAX package's kmeans++ seeding picks, call by
    call, and start the port's k-means from the same rows."""

    def __init__(self, monkeypatch):
        self.rows = []
        self.real_jax, self.real_port = jkm.kmeans, tkm.kmeans
        monkeypatch.setattr(jppk, "kmeans", self.jax_kmeans)
        monkeypatch.setattr(tppk, "kmeans", self.port_kmeans)

    def jax_kmeans(self, key, x, k, **kw):
        c0 = jkm.kmeans_pp_init(key, x, k)
        xn = np.asarray(x)
        self.rows.append([int(np.argmin(((xn - np.asarray(c)) ** 2).sum(1)))
                          for c in c0])
        return self.real_jax(key, x, k, init_centers=c0)

    def port_kmeans(self, gen, x, k, **kw):
        rows = self.rows.pop(0)
        return self.real_port(gen, x, k, init_centers=x[rows])


def assert_embedding_close(got, want):
    """Equal up to the sign of each column."""
    for j in range(want.shape[1]):
        sign = np.sign(np.dot(got[:, j], want[:, j])) or 1.0
        np.testing.assert_allclose(sign * got[:, j], want[:, j], rtol=1e-8,
                                   atol=1e-10)


def test_spectral_cluster_matches_jax(monkeypatch):
    draws = KmeansDraws(monkeypatch)
    rng = np.random.default_rng(4)
    hmms = planted_hmms(rng, 5) + [rand_hmm(rng, 2) for _ in range(2)]
    gram = jppk.gram_matrix(hmms)
    for k in (1, 2, 3):
        wa, wc, wu = jppk.spectral_cluster(jax.random.key(k), gram, k)
        ga, gc, gu = tppk.spectral_cluster(torch.Generator(), gram, k)
        np.testing.assert_array_equal(ga, np.asarray(wa))
        np.testing.assert_array_equal(gu, wu)     # the same NumPy input
        np.testing.assert_allclose(gc, np.asarray(wc), rtol=1e-10,
                                   atol=1e-12)
    assert not draws.rows


def test_ppk_sc_matches_jax(monkeypatch):
    draws = KmeansDraws(monkeypatch)
    rng = np.random.default_rng(5)
    hmms = planted_hmms(rng, 4)
    want = jppk.ppk_sc(jax.random.key(0), hmms, 2)
    got = tppk.ppk_sc(torch.Generator(), [to_port(h) for h in hmms], 2)
    assert isinstance(got, tppk.PPKSCResult)
    np.testing.assert_allclose(got.gram, want.gram, rtol=RTOL)
    assert_embedding_close(got.embedding, want.embedding)
    np.testing.assert_array_equal(got.label, np.asarray(want.label))
    np.testing.assert_array_equal(got.center_idx, want.center_idx)
    assert len(np.unique(got.label)) == 2
    assert not draws.rows


# ---------------------------------------------------------------------------
# CCFD
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def planted():
    """Eight subjects per ground-truth HMM with 10 sequences of T=20 each
    drawn from its own HMM, and the JAX package's distance matrix."""
    rng = np.random.default_rng(7)
    hmms = planted_hmms(rng, 8)
    data = own_data(hmms, 10, 20)
    dist = jccfd.skl_distance_matrix(jax.random.key(0), hmms, data=data)
    return hmms, data, dist


def test_skl_distance_matrix_given_data_matches_jax(planted):
    hmms, data, dist = planted
    got = tccfd.skl_distance_matrix(None, [to_port(h) for h in hmms],
                                    data=[to_port(b) for b in data])
    assert got.shape == (16, 16)
    np.testing.assert_allclose(got, dist, rtol=RTOL, atol=1e-12)
    assert np.all(np.diag(got) == 0.0)


def test_skl_distance_matrix_shape_mismatch_matches_jax():
    """Subjects whose data shapes differ take the ordered-pair loop, in
    both packages; states differ too."""
    rng = np.random.default_rng(8)
    hmms = [rand_hmm(rng, k) for k in (2, 3, 2)]
    data = [own_data([h], n, t, seed=10 + i)[0]
            for i, (h, n, t) in enumerate(zip(hmms, (4, 6, 4), (9, 9, 7)))]
    want = jccfd.skl_distance_matrix(jax.random.key(0), hmms, data=data)
    got = tccfd.skl_distance_matrix(None, [to_port(h) for h in hmms],
                                    data=[to_port(b) for b in data])
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_skl_distance_matrix_sampled():
    """Without data each HMM draws its own sample: the matrix is symmetric,
    zero on the diagonal, deterministic for a seed, and separates the two
    ground-truth groups."""
    rng = np.random.default_rng(9)
    hmms = [to_port(h) for h in planted_hmms(rng, 3)]
    d1 = tccfd.skl_distance_matrix(torch.Generator().manual_seed(2), hmms,
                                   n_samples=30, t=30)
    d2 = tccfd.skl_distance_matrix(torch.Generator().manual_seed(2), hmms,
                                   n_samples=30, t=30)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_allclose(d1, d1.T, rtol=1e-12)
    assert np.all(np.diag(d1) == 0.0)
    assert d1[:3, 3:].min() > max(d1[:3, :3].max(), d1[3:, 3:].max())


def _same_core(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_ccfd_core_matches_jax(planted):
    dist = planted[2]
    pur = dist[np.triu_indices(16, 1)]
    found = 0
    for pct in (2.0, 7.0, 10.0, 13.0, 30.0, 60.0):
        dc = pur.min() + (pur.max() - pur.min()) * pct / 100.0
        try:
            want = jccfd._ccfd_core(dist, dc, 3.0)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                tccfd._ccfd_core(dist, dc, 3.0)
            continue
        _same_core(tccfd._ccfd_core(dist, dc, 3.0), want)
        found += 1
    assert found >= 2


def test_ccfd_matches_jax_on_the_same_distances(planted, monkeypatch):
    hmms, data, dist = planted
    want = jccfd.ccfd(jax.random.key(0), hmms, data=data)
    monkeypatch.setattr(tccfd, "skl_distance_matrix",
                        lambda *a, **k: dist.copy())
    got = tccfd.ccfd(None, [to_port(h) for h in hmms],
                     data=[to_port(b) for b in data])
    assert isinstance(got, tccfd.CCFDResult)
    for f in ("label", "center_idx", "halo", "rho", "delta"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.dc == want.dc and got.fitness == want.fitness
    # the planted groups are found
    assert len(got.center_idx) == 2
    assert len(np.unique(got.label[:8])) == 1 \
        and len(np.unique(got.label[8:])) == 1


def test_run_ccfd_matches_jax(planted):
    """``run_ccfd`` on a bank and its data: the port computes its own
    distances (within 1e-10 of the JAX package's), and scores as the JAX
    package does."""
    hmms, data, _ = planted

    class R:
        def __init__(self, model):
            self.model = model

    labels = np.repeat([0, 1], 8)
    jds = jsyn.SyntheticDataset(batches=data, labels=labels)
    want = jsyn.run_ccfd(jax.random.key(0), [R(h) for h in hmms], labels,
                         ds=jds)
    got = tsyn.run_ccfd(None, [R(to_port(h)) for h in hmms], labels,
                        ds=to_port(jds))
    np.testing.assert_array_equal(got["result"].label,
                                  want["result"].label)
    assert got["score"]._replace(labels=None) == \
        tsyn.RecoveryScore(*want["score"])._replace(labels=None)


# ---------------------------------------------------------------------------
# the PPK grid of the synthetic benchmark
# ---------------------------------------------------------------------------

def test_run_ppk_grid_matches_jax(monkeypatch):
    draws = KmeansDraws(monkeypatch)
    rng = np.random.default_rng(10)

    class R:
        def __init__(self, model):
            self.model = model

    jds = jsyn.sample_dataset(jax.random.key(2), n_per_cluster=3, n_seqs=6,
                              t=15)
    banks = {s: two_group_bank(rng, s, 3) for s in (1, 2, 3)}
    want = jsyn.run_ppk_grid(jax.random.key(0),
                             {s: [R(h) for h in b] for s, b in banks.items()},
                             jds, jds.labels, k_grid=range(1, 4))
    got = tsyn.run_ppk_grid(
        torch.Generator(),
        {s: [R(to_port(h)) for h in b] for s, b in banks.items()},
        to_port(jds), jds.labels, k_grid=range(1, 4))
    assert not draws.rows
    # a cluster of two members has both at the same distance from its
    # centroid: either may be its center, and the two packages' roundings
    # decide; such a cell's log-likelihood then differs
    assert set(got["cells"]) == set(want["cells"])
    same = np.zeros(want["ll"].shape, bool)
    for (k, s_), w in want["cells"].items():
        g = got["cells"][(k, s_)]
        lab = np.asarray(w["label"])
        np.testing.assert_array_equal(g["label"], lab)
        for j in np.where(g["center_idx"] != w["center_idx"])[0]:
            members = np.where(lab == j)[0]
            assert len(members) == 2 and g["center_idx"][j] in members
        same[k - 1, s_ - 1] = np.array_equal(g["center_idx"],
                                             w["center_idx"])
    assert same.sum() >= 6
    for key in ("ll", "aic", "bic"):
        np.testing.assert_allclose(got[key][same], want[key][same],
                                   rtol=RTOL)
    for crit in ("aic", "bic"):
        g = got[crit + "_score"]
        ki, si = np.unravel_index(np.argmin(got[crit]), got[crit].shape)
        assert (g.best_k, g.best_s) == (ki + 1, si + 1)
        np.testing.assert_array_equal(
            g.labels, got["cells"][(ki + 1, si + 1)]["label"])
        if same.all():
            w = want[crit + "_score"]
            assert (g.best_k, g.best_s, g.rand_index) == \
                (w.best_k, w.best_s, w.rand_index)
