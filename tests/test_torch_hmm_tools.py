"""The port's HMM tools (``vbhem_tpu_torch.models.hmm_tools``) against
the JAX package's on the same float64 inputs, made with numpy from a seed
and handed over through ``vbhem_tpu_torch.convert``: ``loglik`` (plain,
``normalize``, ragged lengths, a leading models axis over a state-padded
bank against ``jax.vmap``), ``kld`` on given data, ``entropy`` and
``state_seq_logprob`` within 1e-10; ``viterbi``'s paths identical, with
-1 on padding, ties going to the first state.  ``sample`` cannot match
``jax.random`` bit for bit, so its statistics are tested on a large
draw: the initial-state frequencies within 0.03 of the prior, the
transition frequencies within 0.01 of the transition matrix, each
state's emission mean within 0.03 and covariance within 0.05; and
``synthetic.sample_dataset`` is deterministic for a seed, with the
reference's shapes and labels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbhem_tpu.containers import HMM as JHMM
from vbhem_tpu.containers import SeqBatch as JSeqBatch
from vbhem_tpu.experiments import synthetic as jsyn
from vbhem_tpu.models import hmm_tools as jht
from vbhem_tpu.models import vbhem as jv
from vbhem_tpu_torch import convert
from vbhem_tpu_torch.containers import HMM, SeqBatch
from vbhem_tpu_torch.experiments import synthetic as tsyn
from vbhem_tpu_torch.models import hmm_tools as tht

RTOL = 1e-10


def to_port(obj):
    return convert.to_torch(obj, device="cpu")


def rand_hmm(rng, k, d=2, sep=2.0):
    a = rng.normal(size=(k, d, d)) * 0.4
    return JHMM(prior=jnp.asarray(rng.dirichlet(np.ones(k))),
                trans=jnp.asarray(rng.dirichlet(np.ones(k) * 2, k)),
                mean=jnp.asarray(rng.normal(size=(k, d)) * sep),
                cov=jnp.asarray(np.einsum("kde,kfe->kdf", a, a)
                                + 0.5 * np.eye(d)))


def rand_batch(rng, n=7, t=12, d=2, ragged=True):
    x = rng.normal(size=(n, t, d)) * 2.0
    lengths = rng.integers(1, t + 1, size=n) if ragged else np.full(n, t)
    lengths[0] = t
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    return JSeqBatch(x=jnp.asarray(x), lengths=jnp.asarray(lengths,
                                                           jnp.int32))


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_loglik_matches_jax(normalize, ragged):
    rng = np.random.default_rng(1 + 2 * ragged + normalize)
    hmm, batch = rand_hmm(rng, 3), rand_batch(rng, ragged=ragged)
    want = jht.loglik(batch, hmm, normalize=normalize)
    got = tht.loglik(to_port(batch), to_port(hmm), normalize=normalize)
    assert got.shape == (7,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def padded_bank(rng, states=(1, 3, 2, 3)):
    """The JAX package's state-padded bank of HMMs with ``states`` states."""
    hmms = [rand_hmm(rng, k) for k in states]
    return hmms, jv.h3m_from_hmms(hmms).hmm


def test_loglik_models_axis_matches_jax_vmap():
    """One call over a leading models axis of a state-padded bank equals
    the JAX package's vmap over the models, and each model alone."""
    rng = np.random.default_rng(5)
    hmms, hb = padded_bank(rng)
    batch = rand_batch(rng)
    want = jax.vmap(lambda p, a, m, c: jht.loglik(
        batch, JHMM(prior=p, trans=a, mean=m, cov=c)))(*hb)
    got = tht.loglik(to_port(batch), to_port(hb))
    assert got.shape == (4, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    for i, h in enumerate(hmms):   # padded states contribute nothing
        np.testing.assert_allclose(got[i].numpy(),
                                   np.asarray(jht.loglik(batch, h)),
                                   rtol=1e-9)
    # two model axes: a [2, 4] grid of models
    grid = HMM(*[torch.stack([f, f.flip(0)]) for f in to_port(hb)])
    got2 = tht.loglik(to_port(batch), grid, normalize=True)
    want2 = np.asarray(want) / np.asarray(batch.lengths)[None]
    np.testing.assert_allclose(got2[0].numpy(), want2, rtol=RTOL)
    np.testing.assert_allclose(got2[1].numpy(), want2[::-1], rtol=RTOL)


def test_loglik_floor_on_far_data():
    """Data far from every state underflows every density: the floor keeps
    the result finite and equal to the JAX package's."""
    rng = np.random.default_rng(2)
    hmm = rand_hmm(rng, 2)
    x = np.full((2, 6, 2), 80.0)
    x[1, :, 1] = -80.0
    batch = JSeqBatch(x=jnp.asarray(x), lengths=jnp.asarray([6, 4],
                                                            jnp.int32))
    want = np.asarray(jht.loglik(batch, hmm))
    got = tht.loglik(to_port(batch), to_port(hmm)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("ragged", [False, True])
def test_viterbi_matches_jax(ragged):
    rng = np.random.default_rng(11 + ragged)
    hmm, batch = rand_hmm(rng, 3, sep=1.0), rand_batch(rng, n=9,
                                                      ragged=ragged)
    wp, wl = jht.viterbi(batch, hmm)
    gp, gl = tht.viterbi(to_port(batch), to_port(hmm))
    assert gp.dtype == torch.int32
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=RTOL)
    pad = np.arange(12)[None, :] >= np.asarray(batch.lengths)[:, None]
    assert np.all(gp.numpy()[pad] == -1) and np.all(gp.numpy()[~pad] >= 0)


def test_viterbi_ties_go_to_the_first_state():
    """Two identical states: every candidate ties, and both packages take
    the first maximum (state 0) at every step."""
    hmm = JHMM(prior=jnp.asarray([0.5, 0.5]),
               trans=jnp.full((2, 2), 0.5),
               mean=jnp.zeros((2, 2)), cov=jnp.broadcast_to(jnp.eye(2),
                                                            (2, 2, 2)))
    batch = rand_batch(np.random.default_rng(3), n=4, t=6)
    wp, wl = jht.viterbi(batch, hmm)
    gp, gl = tht.viterbi(to_port(batch), to_port(hmm))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    assert set(np.unique(gp.numpy())) <= {-1, 0}
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=RTOL)


def test_viterbi_models_axis_matches_jax_vmap():
    rng = np.random.default_rng(6)
    _, hb = padded_bank(rng)
    batch = rand_batch(rng)
    wp, wl = jax.vmap(lambda p, a, m, c: jht.viterbi(
        batch, JHMM(prior=p, trans=a, mean=m, cov=c)))(*hb)
    gp, gl = tht.viterbi(to_port(batch), to_port(hb))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=RTOL)


def test_kld_entropy_state_seq_logprob_match_jax():
    rng = np.random.default_rng(8)
    h1, h2 = rand_hmm(rng, 3), rand_hmm(rng, 2)
    batch = rand_batch(rng)
    key = jax.random.key(0)
    np.testing.assert_allclose(
        float(tht.kld(None, to_port(h1), to_port(h2), batch=to_port(batch))),
        float(jht.kld(key, h1, h2, batch=batch)), rtol=RTOL)
    np.testing.assert_allclose(
        float(tht.entropy(to_port(batch), to_port(h1))),
        float(jht.entropy(batch, h1)), rtol=RTOL)
    states = rng.integers(0, 3, size=(6, 10))
    np.testing.assert_allclose(
        tht.state_seq_logprob(torch.as_tensor(states), to_port(h1)).numpy(),
        np.asarray(jht.state_seq_logprob(jnp.asarray(states), h1)),
        rtol=RTOL)
    # KL of an HMM with itself on its own Monte-Carlo sample is 0
    gen = torch.Generator().manual_seed(4)
    assert float(tht.kld(gen, to_port(h1), to_port(h1), n_samples=20,
                         t=15)) == 0.0


def test_sample_statistics():
    """A large draw's initial states, transitions and emissions match the
    HMM it was drawn from."""
    rng = np.random.default_rng(9)
    hmm = to_port(rand_hmm(rng, 3))
    n, t = 4000, 50
    z, x = tht.sample(torch.Generator().manual_seed(1), hmm, t=t, n=n)
    assert z.shape == (n, t) and x.shape == (n, t, 2)
    assert x.dtype == torch.float64
    z, x = z.numpy(), x.numpy()
    p0 = np.bincount(z[:, 0], minlength=3) / n
    np.testing.assert_allclose(p0, hmm.prior.numpy(), atol=0.03)
    counts = np.zeros((3, 3))
    np.add.at(counts, (z[:, :-1].ravel(), z[:, 1:].ravel()), 1)
    np.testing.assert_allclose(counts / counts.sum(1, keepdims=True),
                               hmm.trans.numpy(), atol=0.01)
    for k in range(3):
        xk = x[z == k]
        np.testing.assert_allclose(xk.mean(0), hmm.mean[k].numpy(),
                                   atol=0.03)
        np.testing.assert_allclose(np.cov(xk.T), hmm.cov[k].numpy(),
                                   atol=0.05)
    # the same seed draws the same sample
    z2, x2 = tht.sample(torch.Generator().manual_seed(1), hmm, t=t, n=n)
    np.testing.assert_array_equal(z2.numpy(), z)
    np.testing.assert_array_equal(x2.numpy(), x)


def test_sample_dataset_shapes_labels_and_determinism():
    ds = tsyn.sample_dataset(torch.Generator().manual_seed(3),
                             n_per_cluster=3, n_seqs=5, t=7, device="cpu")
    assert isinstance(ds, tsyn.SyntheticDataset)
    assert len(ds.batches) == 6
    np.testing.assert_array_equal(ds.labels, [0, 0, 0, 1, 1, 1])
    for b in ds.batches:
        assert b.x.shape == (5, 7, 2) and b.x.dtype == torch.float64
        assert b.lengths.dtype == torch.int32
        assert torch.all(b.lengths == 7)
    again = tsyn.sample_dataset(torch.Generator().manual_seed(3),
                                n_per_cluster=3, n_seqs=5, t=7, device="cpu")
    for a, b in zip(ds.batches, again.batches):
        assert torch.equal(a.x, b.x)
    other = tsyn.sample_dataset(torch.Generator().manual_seed(4),
                                n_per_cluster=3, n_seqs=5, t=7, device="cpu")
    assert not torch.equal(ds.batches[0].x, other.batches[0].x)
    # the ground truth is the JAX package's
    for mine, theirs in zip(tsyn.gt_hmms(device="cpu"), jsyn.gt_hmms()):
        for f in theirs._fields:
            np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                          np.asarray(getattr(theirs, f)))


def test_sample_dataset_carries_into_the_port():
    """A JAX-made dataset goes through ``convert.to_torch`` whole."""
    jds = jsyn.sample_dataset(jax.random.key(0), n_per_cluster=2, n_seqs=3,
                              t=5)
    ds = to_port(jds)
    assert type(ds) is tsyn.SyntheticDataset
    assert all(type(b) is SeqBatch for b in ds.batches)
    np.testing.assert_array_equal(ds.labels, jds.labels)
    np.testing.assert_array_equal(ds.batches[3].x.numpy(),
                                  np.asarray(jds.batches[3].x))
