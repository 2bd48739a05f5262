"""The port's VBEM forward-backward (the plain version of kernel B2)
against the JAX package: against ``vbhem_tpu.ops.fb.forward_backward`` in
float64 (rtol 1e-10, atol 1e-12: the same recursion, differing only in
the order of a few roundings), against the brute-force path enumeration
of tests/test_fb.py, and in float32 against the JAX package's real Pallas
kernel in interpret mode, at the tolerances tests/test_fb.py:123-147
holds that kernel to (gamma atol 2e-6, xi_sum atol 2e-5, phi_norm rtol
2e-6).  Also a line-by-line NumPy transliteration of ``csrc/fb.cu``
(which cannot run here) against the plain version, the wrapper's
validation and the dispatch's behaviour on a machine with no card.  The
CUDA kernel itself is held against the plain version on the card by
chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_fb import brute_force_fb
from vbhem_tpu.containers import NIW as JNIW
from vbhem_tpu.ops import fb as jfb
from vbhem_tpu.ops.fb_pallas import forward_backward_pallas
from vbhem_tpu_torch import containers as tc
from vbhem_tpu_torch.ops import _build
from vbhem_tpu_torch.ops import fb as tfb
from vbhem_tpu_torch.ops import fb_cuda

FIELDS = ("log_rho", "gamma", "xi_sum", "phi_norm")


def make_case(seed, n=6, t=7, k=3, lanes=(), per_seq=False, ragged=True):
    """Sub-normalized scores (like exp of digamma expectations), emission
    scores and a ragged mask with a length-1 sequence, as numpy."""
    rng = np.random.default_rng(seed)
    ps = lanes + ((n,) if per_seq else ())
    log_pz1 = np.log(rng.dirichlet(np.ones(k), ps) * 0.8)
    log_trans = np.log(rng.dirichlet(np.ones(k), ps + (k,)) * 0.9)
    log_rho = rng.normal(size=lanes + (n, t, k)) * 2.0 - 1.0
    lengths = rng.integers(1, t + 1, size=n) if ragged else np.full(n, t)
    lengths[0] = 1
    lengths[-1] = t
    mask = np.arange(t)[None, :] < lengths[:, None]
    return log_pz1, log_trans, log_rho, mask


CASES = {
    "shared_ragged": dict(),
    "per_seq": dict(per_seq=True),
    "t1": dict(t=1),
    "k1": dict(k=1),
    "k8": dict(k=8, t=4),
    "full_length": dict(ragged=False),
    "lanes": dict(lanes=(2, 3)),
    "lanes_per_seq": dict(lanes=(3,), per_seq=True),
}


def jax_fb(case):
    """The JAX package's XLA forward-backward, vmapped over lane axes."""
    log_pz1, log_trans, log_rho, mask = map(jnp.asarray, case)
    fn = lambda p, a, r: jfb.forward_backward(p, a, r, mask)  # noqa: E731
    for _ in range(log_rho.ndim - 3):
        fn = jax.vmap(fn)
    return fn(log_pz1, log_trans, log_rho)


def port(case, dtype=torch.float64):
    p, a, r, m = case
    return (torch.as_tensor(p, dtype=dtype), torch.as_tensor(a, dtype=dtype),
            torch.as_tensor(r, dtype=dtype), torch.as_tensor(m))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_f64(name):
    case = make_case(1, **CASES[name])
    want = jax_fb(case)
    got = fb_cuda.forward_backward_auto(*port(case))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-10,
                                   atol=1e-12, err_msg=f)
    assert np.all(got.gamma.numpy()[..., ~case[3], :] == 0.0)


def test_plain_matches_bruteforce():
    log_pz1, log_trans, log_rho, mask = make_case(2, n=5, t=5, k=3)
    got = tfb.forward_backward(*port((log_pz1, log_trans, log_rho, mask)))
    for i in range(mask.shape[0]):
        ln = int(mask[i].sum())
        g, xi, pn = brute_force_fb(log_pz1, log_trans, log_rho[i, :ln])
        np.testing.assert_allclose(got.gamma[i, :ln].numpy(), g, atol=1e-10)
        np.testing.assert_allclose(got.xi_sum[i].numpy(), xi, atol=1e-10)
        np.testing.assert_allclose(float(got.phi_norm[i]), pn, atol=1e-10)


@pytest.mark.parametrize("per_seq", [False, True], ids=["shared", "per_seq"])
def test_plain_f32_matches_jax_pallas_kernel(per_seq):
    case = make_case(3, n=9, t=8, k=3, per_seq=per_seq)
    case = tuple(c.astype(np.float32) if c.dtype == np.float64 else c
                 for c in case)
    want = forward_backward_pallas(*map(jnp.asarray, case), interpret=True)
    got = fb_cuda.forward_backward_auto(*port(case, torch.float32))
    np.testing.assert_allclose(got.gamma.numpy(), np.asarray(want.gamma),
                               atol=2e-6)
    np.testing.assert_allclose(got.xi_sum.numpy(), np.asarray(want.xi_sum),
                               atol=2e-5)
    np.testing.assert_allclose(got.phi_norm.numpy(),
                               np.asarray(want.phi_norm), rtol=2e-6)


def test_expected_log_gauss_matches_jax():
    rng = np.random.default_rng(4)
    lanes, n, t, k, d = (2,), 3, 4, 3, 2
    x = rng.normal(size=(n, t, d)) * 2
    a = rng.normal(size=lanes + (k, d, d))
    niw = dict(beta=rng.uniform(1, 5, lanes + (k,)),
               v=rng.uniform(d + 1.5, 9, lanes + (k,)),
               m=rng.normal(size=lanes + (k, d)),
               w=np.einsum("...de,...fe->...df", a, a) + np.eye(d))
    got = tfb.expected_log_gauss(torch.as_tensor(x), tc.NIW(
        **{f: torch.as_tensor(v) for f, v in niw.items()}))
    assert got.shape == lanes + (n, t, k)
    for li in range(lanes[0]):
        want = jfb.expected_log_gauss(jnp.asarray(x), JNIW(
            **{f: jnp.asarray(v[li]) for f, v in niw.items()}))
        np.testing.assert_allclose(got[li].numpy(), np.asarray(want),
                                   rtol=1e-12)


def kernel_transliteration(log_pz1, log_trans, log_rho, mask, tc_max):
    """``csrc/fb.cu`` line by line for one lane of shared scores, in
    numpy: the block's sequences walk T in chunks of ``tc_max`` steps
    through tiles (the backward tile with alpha_{c0-1} in column 0),
    alpha is written into the gamma buffer and turned into gamma in
    place, and c_p is recomputed from alpha_{p-1} in the backward pass."""
    n, t_max, k = log_rho.shape
    pz1, a_mat = np.exp(log_pz1), np.exp(log_trans)
    gamma = np.full_like(log_rho, np.nan)
    xi_out = np.empty((n, k, k))
    phi = np.empty(n)

    def load_px(r):
        mx = r.max()
        return np.exp(r - mx), mx

    def predict(alpha, px):
        delta = (alpha @ a_mat) * px
        c = delta.sum()
        return delta, (c if c > 0 else 1.0)

    starts = list(range(0, t_max, tc_max))
    for s in range(n):
        msk = mask[s]
        for c0 in starts:                               # forward
            tc = min(tc_max, t_max - c0)
            rho = log_rho[s, c0:c0 + tc].copy()         # tile_in
            g = np.full((tc + 1, k), np.nan)
            for j in range(tc):
                t = c0 + j
                if t == 0:
                    px, sum_max = load_px(rho[0])
                    delta = pz1 * px
                    c = delta.sum()
                    sum_logc = np.log(c)
                    alpha = delta / c
                elif msk[t]:
                    px, mx = load_px(rho[j])
                    delta, c = predict(alpha, px)
                    alpha = delta / c
                    sum_logc += np.log(c)
                    sum_max += mx
                g[j + 1] = alpha
            gamma[s, c0:c0 + tc] = g[1:]                # tile_out
        phi[s] = sum_logc + sum_max
        beta, xi = np.ones(k), np.zeros((k, k))
        for c0 in reversed(starts):                     # backward
            tc = min(tc_max, t_max - c0)
            rho = log_rho[s, c0:c0 + tc].copy()
            g = np.full((tc + 1, k), np.nan)
            if c0 > 0:
                g[:] = gamma[s, c0 - 1:c0 + tc]
            else:
                g[1:] = gamma[s, :tc]
            for j in range(tc, 0, -1):
                pos = c0 + j - 1
                g[j] = g[j] * beta if msk[pos] else 0.0
                if pos == 0:
                    continue
                if msk[pos]:
                    alpha = g[j - 1].copy()
                    px, _ = load_px(rho[j - 1])
                    _, c = predict(alpha, px)
                    bp = beta * px
                    ab = a_mat * bp[None, :]
                    xi += ab * alpha[:, None] / c
                    beta = ab.sum(-1) / c
                else:
                    beta = np.ones(k)
            gamma[s, c0:c0 + tc] = g[1:]
        xi_out[s] = xi
    return gamma, xi_out, phi


@pytest.mark.parametrize("name,tc", [("shared_ragged", 3), ("t1", 16),
                                     ("k1", 2), ("full_length", 7),
                                     ("full_length", 1)])
def test_kernel_algorithm_matches_plain(name, tc):
    case = make_case(5, **CASES[name])
    want = tfb.forward_backward(*port(case))
    gamma, xi, phi = kernel_transliteration(*case, tc)
    np.testing.assert_allclose(gamma, want.gamma.numpy(), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(xi, want.xi_sum.numpy(), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(phi, want.phi_norm.numpy(), rtol=1e-12)


def test_mask_lanes_shares_rows_between_restarts():
    lanes = (4, 3)
    mask = torch.rand(4, 1, 5, 6) < 0.5
    m8, rep = fb_cuda._mask_lanes(mask, lanes)
    assert rep == 3 and m8.shape == (4, 5, 6) and m8.dtype == torch.uint8
    full = torch.broadcast_to(mask, lanes + (5, 6)).reshape(12, 5, 6)
    b = torch.arange(12)
    assert torch.equal(m8[b // rep].bool(), full)
    for shape, want_rep in (((5, 6), 12), ((1, 1, 5, 6), 12),
                            ((4, 3, 5, 6), 1), ((1, 3, 5, 6), 1)):
        m = torch.rand(shape) < 0.5
        m8, rep = fb_cuda._mask_lanes(m, lanes)
        assert rep == want_rep
        full = torch.broadcast_to(m, lanes + (5, 6)).reshape(12, 5, 6)
        assert torch.equal(m8[torch.arange(12) // rep].bool(), full)


def test_validate_rejects_what_the_kernel_cannot_take():
    p, a, r, m = port(make_case(6, n=4, t=5, k=2))
    auto = fb_cuda.forward_backward_auto
    m0 = m.clone()
    m0[2, :] = False                     # a sequence with step 0 masked out
    with pytest.raises(ValueError, match="step 0"):
        auto(p, a, r, m0)
    with pytest.raises(ValueError, match="K=9"):
        auto(*port(make_case(6, n=4, t=3, k=9)))
    with pytest.raises(ValueError, match="empty"):
        auto(p, a, r[:, :0], m[:, :0])
    with pytest.raises(ValueError, match="dtype"):
        auto(p.float(), a, r, m)
    with pytest.raises(ValueError, match="dtype"):
        auto(p.half(), a.half(), r.half(), m)
    with pytest.raises(ValueError, match="bool"):
        auto(p, a, r, m.double())
    with pytest.raises(ValueError, match="meta"):
        auto(p, a.to("meta"), r, m)
    with pytest.raises(ValueError, match="contiguous"):
        auto(p, a, r.transpose(0, 1).contiguous().transpose(0, 1), m)
    with pytest.raises(ValueError, match="shape"):
        auto(p, a, r, m[:3])
    with pytest.raises(ValueError, match="log_trans"):
        auto(p, a.repeat(2, 2), r, m)


def test_cpu_dispatch_takes_the_plain_version():
    before = fb_cuda.LAUNCHES
    case = port(make_case(7, lanes=(2,)))
    got = fb_cuda.forward_backward_auto(*case)
    want = tfb.forward_backward(*case)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert fb_cuda.LAUNCHES == before == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        fb_cuda.forward_backward_cuda(*case)
    assert _build._lib is None
