"""The port's VBEM forward-backward (the plain version of kernel B2)
against the JAX package: against ``vbhem_tpu.ops.fb.forward_backward`` in
float64 (rtol 1e-10, atol 1e-12: the same recursion, differing only in
the order of a few roundings), against the brute-force path enumeration
of tests/test_fb.py, and in float32 against the JAX package's real Pallas
kernel in interpret mode, at the tolerances tests/test_fb.py:123-147
holds that kernel to (gamma atol 2e-6, xi_sum atol 2e-5, phi_norm rtol
2e-6).  Also line-by-line NumPy transliterations of both designs of
``csrc/fb.cuh`` (which cannot run here) against the plain version: the
streamed one, and the resident one with both of its entries (log_rho
given, or formed from x and the emission constants); the emission
constants against ``expected_log_gauss`` (1e-12); the design selector;
the wrappers' validation and the dispatch's behaviour on a machine with
no card.  The CUDA kernel itself is held against the plain version on
the card by chip_smoke.py."""
import math

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


def make_case(seed, n=6, t=7, k=3, lanes=(), per_seq=False, ragged=True,
              empty=False):
    """Sub-normalized scores (like exp of digamma expectations), emission
    scores and a ragged mask with a length-1 sequence (and with ``empty``
    a length-0 one, a padded trial), as numpy."""
    rng = np.random.default_rng(seed)
    ps = lanes + ((n,) if per_seq else ())
    log_pz1 = np.log(rng.dirichlet(np.ones(k), ps) * 0.8)
    log_trans = np.log(rng.dirichlet(np.ones(k), ps + (k,)) * 0.9)
    log_rho = rng.normal(size=lanes + (n, t, k)) * 2.0 - 1.0
    lengths = rng.integers(1, t + 1, size=n) if ragged else np.full(n, t)
    lengths[0] = 1
    lengths[-1] = t
    if empty:
        lengths[1] = 0
    mask = np.arange(t)[None, :] < lengths[:, None]
    return log_pz1, log_trans, log_rho, mask


CASES = {
    "shared_ragged": dict(),
    "per_seq": dict(per_seq=True),
    "t1": dict(t=1),
    "k1": dict(k=1),
    "k8": dict(k=8, t=4),
    "k9": dict(k=9, t=4),       # past the register bodies: the wide body
    "k12": dict(k=12, t=5),
    "full_length": dict(ragged=False),
    "lanes": dict(lanes=(2, 3)),
    "lanes_per_seq": dict(lanes=(3,), per_seq=True),
}
# empty sequences (length 0) beside real ones: the port's own cases
EMPTY_CASES = {"empty": dict(empty=True), "empty_t1": dict(t=1, empty=True),
               "empty_k9": dict(k=9, t=4, empty=True),
               "empty_lanes": dict(lanes=(2, 3), empty=True)}
ALL_CASES = {**CASES, **EMPTY_CASES}


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
    """``csrc/fb.cuh`` line by line for one lane of shared scores, in
    numpy: the block's sequences walk T in chunks of ``tc_max`` steps
    through tiles (the backward tile with alpha_{c0-1} in column 0),
    alpha is written into the gamma buffer and turned into gamma in
    place, c_p is recomputed from alpha_{p-1} in the backward pass, and
    the forward pass stores each log_rho tile with its padded steps
    zeroed."""
    n, t_max, k = log_rho.shape
    pz1, a_mat = np.exp(log_pz1), np.exp(log_trans)
    gamma = np.full_like(log_rho, np.nan)
    rho_out = np.full_like(log_rho, np.nan)
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
            rho_out[s, c0:c0 + tc] = np.where(msk[c0:c0 + tc, None], rho,
                                              0.0)
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
        phi[s] = sum_logc + sum_max if msk[0] else 0.0  # empty: 0
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
    return rho_out, gamma, xi_out, phi


@pytest.mark.parametrize("name,tc", [("shared_ragged", 3), ("t1", 16),
                                     ("k1", 2), ("full_length", 7),
                                     ("full_length", 1),
                                     # the wide body (csrc/fb_wide.cu) runs
                                     # this arithmetic over all of T at once
                                     ("k9", 4), ("k12", 5),
                                     ("empty", 3), ("empty_t1", 16),
                                     ("empty_k9", 4)])
def test_kernel_algorithm_matches_plain(name, tc):
    case = make_case(5, **ALL_CASES[name])
    want = tfb.forward_backward(*port(case))
    rho_out, gamma, xi, phi = kernel_transliteration(*case, tc)
    np.testing.assert_array_equal(rho_out, want.log_rho.numpy())
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
    m0[3, 0] = False                     # step 0 masked, later steps not
    with pytest.raises(ValueError, match="step 0"):
        auto(p, a, r, m0)
    m0[3, :] = False                     # an empty sequence: taken, and 0
    got = auto(p, a, r, m0)
    for f in FIELDS:
        assert torch.all(getattr(got, f)[3] == 0.0), f
    # K above 8 is taken (the wide body on the card; the plain version
    # here); empty shapes are not
    got = auto(*port(make_case(6, n=4, t=3, k=9)))
    assert got.gamma.shape == (4, 3, 9)
    with pytest.raises(ValueError, match="empty"):
        auto(p, a, r[:, :0], m[:, :0])
    with pytest.raises(ValueError, match="empty"):
        auto(p[..., :0], a[..., :0, :0], r[..., :0], m)
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


# ---------------------------------------------------------------------------
# the resident design and the fused E-step
# ---------------------------------------------------------------------------

def random_niw(rng, shape, d):
    """A random NIW posterior with fields [*shape, ...], as numpy."""
    a = rng.normal(size=shape + (d, d)) * 0.5
    return dict(beta=rng.uniform(1, 5, shape),
                v=rng.uniform(d + 1.5, 9, shape),
                m=rng.normal(size=shape + (d,)) * 1.5,
                w=np.einsum("...de,...fe->...df", a, a) + 0.3 * np.eye(d))


def to_niw(niw, dtype=torch.float64):
    return tc.NIW(**{f: torch.as_tensor(v, dtype=dtype)
                     for f, v in niw.items()})


@pytest.mark.parametrize("d", [1, 2, 3])
def test_emission_constants_give_expected_log_gauss(d):
    rng = np.random.default_rng(20 + d)
    lanes, n, t, k = (2, 3), 4, 5, 3
    x = torch.as_tensor(rng.normal(size=(2, 1, n, t, d)) * 2)
    niw = to_niw(random_niw(rng, lanes + (k,), d))
    emis = tfb.emission_constants(niw).numpy()
    assert emis.shape == lanes + (k, 1 + d + d * d)
    # log_rho_k(x) = c_k - 1/2 (x - m_k)^T P_k (x - m_k), in numpy
    c, m = emis[..., 0], emis[..., 1:1 + d]
    p = emis[..., 1 + d:].reshape(lanes + (k, d, d))
    diff = x.numpy()[..., None, :] - m[..., None, None, :, :]
    got = c[..., None, None, :] - 0.5 * np.einsum("...ke,...kef,...kf->...k",
                                                  diff,
                                                  p[..., None, None, :, :, :],
                                                  diff)
    want = tfb.expected_log_gauss(x, niw)
    assert got.shape == want.shape == lanes + (n, t, k)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-12)


def make_fused_case(seed, lanes=(2, 3), n=5, t=6, k=2, d=2, ragged=True,
                    per_seq=False, empty=False):
    """x and a mask with one row per subject (shared by its restarts), a
    random posterior per lane and its scores, as torch float64."""
    rng = np.random.default_rng(seed)
    rows = lanes[:1] + (1,) * (len(lanes) - 1)
    x = torch.as_tensor(rng.normal(size=rows + (n, t, d)) * 2)
    lengths = (rng.integers(1, t + 1, size=rows + (n,)) if ragged
               else np.full(rows + (n,), t))
    lengths[..., 0] = 1
    lengths[..., -1] = t
    if empty:
        lengths[..., 1] = 0
    mask = torch.as_tensor(np.arange(t) < lengths[..., None])
    niw = to_niw(random_niw(rng, lanes + (k,), d))
    ps = lanes + ((n,) if per_seq else ())
    log_pz1 = torch.as_tensor(np.log(rng.dirichlet(np.ones(k), ps) * 0.8))
    log_trans = torch.as_tensor(
        np.log(rng.dirichlet(np.ones(k), ps + (k,)) * 0.9))
    return x, mask, log_pz1, log_trans, niw


def resident_transliteration(log_pz1, log_trans, mw, mask_rep, rows, t, k,
                             log_rho=None, x=None, x_rep=1, emis=None,
                             warp=32):
    """``fb_resident_kernel`` of ``csrc/fb.cuh`` line by line, in numpy.

    Flat kernel arguments: log_pz1 [B, K] or [B*N, K], log_trans
    [B, K, K] or [B*N, K, K], the mask rows of bits mw [Bm, N, ldw]
    (int32); either log_rho [B*N, T*K] (entry 1) or x rows [Bx*N, T*D]
    with emis [B, K, 1+D+D*D] (the fused entry).  Each group of ``rows``
    sequences is a block of ``rows`` threads in warps of ``warp`` lanes
    (32 on the card; fewer here, so that a block has several).  Row
    strides come from the kernel's layout; the tiles start NaN, so a wrong
    index or a stale row shows.  Per block: each thread finds its
    sequence's input and mask rows (the last sequence's, past the end);
    the input rows land in the alpha tile at the staging stride, by one
    bulk copy per lane segment of the block (rows of an odd number of
    16-byte units, so staged densely) or by each warp copying its
    threads' rows element by element, their offsets taken by shuffle; the
    mask rows land by one bulk copy per lane segment; each thread forms its
    log_rho row with the padded steps zeroed, from its staged x row (the
    quadratic form folded onto its upper triangle) or its staged log_rho
    row; the block stores the masked log_rho from its tile; each thread
    runs the forward pass, forming px as each step comes (summing every
    step's max: a padded step's is 0), with its normalization one step
    late, leaving px_t / c_t in its row, then the branch-free backward
    pass on that row with gamma formed in place; the block stores
    gamma.  Stores are 16-byte vectors (2
    float64) of the group's contiguous span, each thread walking its
    vectors' (row, column) without a division."""
    n = mw.shape[1]
    d = 0 if x is None else x.shape[1] // t
    n_seq = log_rho.shape[0] if x is None else emis.shape[0] * n
    trans_per_seq = log_trans.shape[0] == n_seq
    pz1_per_seq = log_pz1.shape[0] == n_seq
    row_len = t * k
    ld = (t * k) | 1
    in_len = row_len if d == 0 else t * d
    ldi = (-(-in_len // 2) | 1) * 2       # whole, odd 16-byte units
    ldg = max(ld, ldi) | 1
    ldw = 4 * -(-(-(-t // 32)) // 4)
    assert (ld + ldg) * 8 + 4 * ldw == fb_cuda.resident_row_bytes(t, k, 8, d)
    assert mw.shape[-1] == ldw
    m_flat = mw.reshape(-1, ldw)
    bulk = ldi == in_len                  # rows staged densely

    def mask_bit(words, tt):
        return (int(words[tt >> 5]) >> (tt & 31)) & 1
    src = log_rho if d == 0 else x
    rho_out = np.full((n_seq, row_len), np.nan)
    gamma = np.full((n_seq, row_len), np.nan)
    xi_out = np.empty((n_seq, k, k))
    phi = np.empty(n_seq)

    def store(dst, tile, ldt, seq0, nrows):
        span = np.full(nrows * row_len, np.nan)
        nvec = len(span) // 2
        adv = (rows - 1) * 2                     # blockDim.x = rows threads
        adv_rows, adv_e = divmod(adv, row_len)
        for tid in range(rows):
            row, e = divmod(tid * 2, row_len)
            for v in range(tid, nvec, rows):
                for j in range(2):
                    span[2 * v + j] = tile[row * ldt + e]
                    e += 1
                    if e == row_len:
                        e, row = 0, row + 1
                row += adv_rows
                e += adv_e
                if e >= row_len:
                    e, row = e - row_len, row + 1
        for q in range(2 * nvec, len(span)):
            row = q // row_len
            span[q] = tile[row * ldt + q - row * row_len]
        dst[seq0:seq0 + nrows] = span.reshape(nrows, row_len)

    def quad_form(em):
        """c, m and Q (upper triangle of -P/2 folded) of one state."""
        c, m = em[0], em[1:1 + d]
        pm = em[1 + d:].reshape(d, d)
        q = []
        for e in range(d):
            q.append(-0.5 * pm[e, e])
            for f in range(e + 1, d):
                q.append(-0.5 * (pm[e, f] + pm[f, e]))
        return c, m, q

    for blk in range(-(-n_seq // rows)):
        seq0 = blk * rows
        nrows = min(rows, n_seq - seq0)
        s_g = np.full(rows * ldg, np.nan)      # the input rows land here
        s_rho = np.full(rows * ld, np.nan)
        s_mw = np.full(rows * ldw, -1, np.int64)
        own = []                                # each thread's rows
        for r in range(rows):
            s = seq0 + (r if r < nrows else nrows - 1)
            b = s // n
            i = s - b * n
            own.append((s if d == 0 else (b // x_rep) * n + i,
                        (b // mask_rep) * n + i))
        for r in range(nrows):          # bulk copies, one per lane segment
            i = (seq0 + r) % n
            if r and i:
                continue
            seg = min(n - i, nrows - r)
            in_row, m_row = own[r]
            s_mw[r * ldw:(r + seg) * ldw] = \
                m_flat[m_row:m_row + seg].reshape(-1)
            if bulk:
                s_g[r * ldi:(r + seg) * ldi] = \
                    src[in_row:in_row + seg].reshape(-1)
        if not bulk:                            # copy_rows_async, by warp
            for w0 in range(0, rows, warp):
                for j in range(min(warp, nrows - w0)):
                    in_row = own[w0 + j][0]     # __shfl_sync from lane j
                    row = w0 + j
                    s_g[row * ldi:row * ldi + in_len] = src[in_row]
        for r in range(nrows):                  # emission_row / copy_row
            b = (seq0 + r) // n
            msk = s_mw[r * ldw:(r + 1) * ldw]
            rho = s_rho[r * ld:(r + 1) * ld]
            staged = s_g[r * ldi:r * ldi + in_len].copy()
            if d == 0:
                for tt in range(t):
                    rho[tt * k:(tt + 1) * k] = \
                        staged[tt * k:(tt + 1) * k] if mask_bit(msk, tt) \
                        else 0.0
                continue
            for tt in range(t):
                valid = mask_bit(msk, tt) != 0
                xv = staged[tt * d:(tt + 1) * d]
                for kk in range(k):
                    c, m, q = quad_form(emis[b, kk])
                    diff = xv - m
                    acc, j = c, 0
                    for e in range(d):
                        y = 0.0
                        for f in range(e, d):
                            y += q[j] * diff[f]
                            j += 1
                        acc += diff[e] * y
                    rho[tt * k + kk] = acc if valid else 0.0
        store(rho_out, s_rho, ld, seq0, nrows)
        for r in range(nrows):                  # forward, backward
            s = seq0 + r
            b = s // n
            row = s_rho[r * ld:(r + 1) * ld]
            g = s_g[r * ldg:(r + 1) * ldg]
            msk = s_mw[r * ldw:(r + 1) * ldw]
            pz1 = np.exp(log_pz1[s if pz1_per_seq else b])
            a_mat = np.exp(log_trans[s if trans_per_seq else b])

            def load_px(tt):
                mx = row[tt * k:(tt + 1) * k].max()
                return np.exp(row[tt * k:(tt + 1) * k] - mx), mx

            p_prev, total = load_px(0)  # forward: px as it comes, the
            delta = pz1 * p_prev        # normalization a step late
            valid = True
            for tt in range(1, t):
                p, mx = load_px(tt)
                total += mx
                c = delta.sum()
                c = c if c > 0 else 1.0
                inv_c = 1.0 / c
                total += np.log(c) if valid else 0.0
                alpha = delta * inv_c
                g[(tt - 1) * k:tt * k] = alpha
                row[(tt - 1) * k:tt * k] = p_prev * inv_c
                valid = mask_bit(msk, tt) != 0
                nxt = (delta @ a_mat) * p
                delta = nxt * inv_c if valid else alpha
                p_prev = p
            c = delta.sum()
            c = c if c > 0 else 1.0
            total += np.log(c) if valid else 0.0
            g[(t - 1) * k:t * k] = delta * (1.0 / c)
            row[(t - 1) * k:t * k] = p_prev * (1.0 / c)
            phi[s] = total if mask_bit(msk, 0) else 0.0  # empty: 0
            beta, xi = np.ones(k), np.zeros((k, k))  # backward on px / c
            for pos in range(t - 1, 0, -1):
                valid = mask_bit(msk, pos) != 0
                g[pos * k:(pos + 1) * k] = \
                    g[pos * k:(pos + 1) * k] * beta if valid else 0.0
                w = g[(pos - 1) * k:pos * k] if valid else np.zeros(k)
                ab = a_mat * (beta * row[pos * k:(pos + 1) * k])[None, :]
                xi += ab * w[:, None]
                beta = ab.sum(-1) if valid else np.ones(k)
            g[0:k] = g[0:k] * beta if mask_bit(msk, 0) else 0.0
            xi_out[s] = xi
        store(gamma, s_g, ldg, seq0, nrows)
    return rho_out, gamma, xi_out, phi


def _flat_scores(log_pz1, log_trans, lanes, n, k):
    per_pz1 = log_pz1.dim() == len(lanes) + 2
    per_trans = log_trans.dim() == len(lanes) + 3
    p, a = fb_cuda._scores(log_pz1, log_trans, lanes, n, k, per_pz1,
                           per_trans)
    return p.reshape(-1, k).numpy(), a.reshape(-1, k, k).numpy()


def _check_against(got, want, rtol, atol):
    for f, g in zip(FIELDS, got):
        w = getattr(want, f).numpy().reshape(g.shape)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f)


@pytest.mark.parametrize("warp", [32, 2])
@pytest.mark.parametrize("name,rows", [("shared_ragged", 4), ("t1", 4),
                                       ("k1", 2), ("k8", 4), ("lanes", 4),
                                       ("lanes_per_seq", 5),
                                       ("full_length", 32), ("empty", 4),
                                       ("empty_t1", 4), ("empty_lanes", 4)])
def test_resident_entry1_algorithm_matches_plain(name, rows, warp):
    log_pz1, log_trans, log_rho, mask = port(make_case(8, **ALL_CASES[name]))
    want = tfb.forward_backward(log_pz1, log_trans, log_rho, mask)
    *lanes, n, t, k = log_rho.shape
    lanes = tuple(lanes)
    mw, rep = fb_cuda._mask_bits(mask, lanes)
    p, a = _flat_scores(log_pz1, log_trans, lanes, n, k)
    got = resident_transliteration(p, a, mw.numpy(), rep, rows, t, k,
                                   log_rho=log_rho.reshape(-1, t * k).numpy(),
                                   warp=warp)
    _check_against(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name,kw,rows", [
    ("d2_ragged", dict(), 4),
    ("d1", dict(d=1, k=3), 4),
    ("d3_k1", dict(d=3, k=1), 3),
    ("d3_k2", dict(d=3, k=2, per_seq=True), 7),
    ("k8", dict(k=8, t=4), 4),
    ("t1", dict(t=1), 4),
    ("one_lane_axis", dict(lanes=(3,), ragged=False), 32),
    ("empty", dict(empty=True), 4),
    ("empty_d3_k3", dict(d=3, k=3, empty=True), 3),
])
@pytest.mark.parametrize("warp", [32, 2])
def test_resident_fused_algorithm_matches_plain(name, kw, rows, warp):
    x, mask, log_pz1, log_trans, niw = make_fused_case(9, **kw)
    want = tfb.forward_backward(log_pz1, log_trans,
                                tfb.expected_log_gauss(x, niw), mask)
    lanes = tuple(niw.beta.shape[:-1])
    *_, n, t, d = x.shape
    k = niw.beta.shape[-1]
    xr, x_rep = fb_cuda._lane_rows(x, lanes, 3)
    mw, rep = fb_cuda._mask_bits(mask, lanes)
    assert x_rep == rep == math.prod(lanes[1:])
    p, a = _flat_scores(log_pz1, log_trans, lanes, n, k)
    emis = tfb.emission_constants(niw).reshape(-1, k, 1 + d + d * d)
    got = resident_transliteration(p, a, mw.numpy(), rep, rows, t, k,
                                   x=xr.reshape(-1, t * d).numpy(),
                                   x_rep=x_rep, emis=emis.numpy(), warp=warp)
    _check_against(got, want, rtol=1e-11, atol=1e-12)
    # the masked log_rho output is zero exactly where the mask is
    full = torch.broadcast_to(mask, lanes + (n, t)).reshape(-1, t)
    assert np.all(got[0].reshape(-1, t, k)[~full.numpy()] == 0.0)


def test_resident_entry1_ignores_padded_scores():
    """Entry 1 zeroes the padded steps of its input row before anything
    reads them, so what the caller left there (here inf and NaN) changes
    no output."""
    log_pz1, log_trans, log_rho, mask = port(make_case(12, n=5, t=9, k=3))
    want = tfb.forward_backward(log_pz1, log_trans, log_rho, mask)
    dirty = log_rho.clone()
    dirty[~mask] = torch.tensor([np.inf, np.nan, -np.inf],
                                dtype=dirty.dtype)
    mw, rep = fb_cuda._mask_bits(mask, ())
    p, a = _flat_scores(log_pz1, log_trans, (), 5, 3)
    got = resident_transliteration(p, a, mw.numpy(), rep, 4, 9, 3,
                                   log_rho=dirty.reshape(-1, 27).numpy(),
                                   warp=2)
    _check_against(got, want, rtol=1e-12, atol=1e-14)


def test_design_picks_resident_or_streamed_by_shape():
    # the VBEM main path: T=50, K=2; eight 32-row blocks share an SM (256
    # sequences, as four of 64 or two of 128: the fewest rows win); the
    # input rows land in the alpha rows, a mask row is four words
    assert fb_cuda.stage_ld(100, 4) == 100        # 25 16-byte units
    assert fb_cuda.resident_row_bytes(50, 2, 4) == 2 * 101 * 4 + 16
    assert fb_cuda.resident_row_bytes(50, 2, 4, d=2) == 2 * 101 * 4 + 16
    assert fb_cuda.design(50, 2, 4) == ("resident", 32, 32 * 824 + 16)
    assert fb_cuda.design(50, 2, 4, d=2) == ("resident", 32, 32 * 824 + 16)
    assert fb_cuda.resident_per_sm(32, 32 * 824 + 16) == 256
    # float64: the staged row is 51 units (102 elements), wider than 101
    assert fb_cuda.stage_ld(100, 8) == 102
    assert fb_cuda.design(50, 2, 8) == ("resident", 32, 32 * 1648 + 16)
    # D > K widens the alpha rows that hold x first: 150 floats stage in
    # 39 units (156), and the alpha stride is odd again
    assert fb_cuda.stage_ld(150, 4) == 156
    assert fb_cuda.resident_row_bytes(50, 1, 4, d=3) == (51 + 157) * 4 + 16
    # short rows: 32 blocks of 32 rows are the most an SM holds, so larger
    # blocks hold more, up to the SM's 2048 threads
    assert fb_cuda.design(1, 2, 4).rows == 64
    assert fb_cuda.resident_per_sm(64, 64 * 28) == 2048
    assert fb_cuda.resident_per_sm(32, 32 * 28) == 1024
    # one 32-row block still fits: resident, one block per SM
    big = fb_cuda.design(100, 8, 4)
    assert big.kind == "resident" and big.rows == 32
    assert big.smem_bytes <= fb_cuda.SMEM_PER_BLOCK
    assert 4 * big.smem_bytes > fb_cuda.SMEM_PER_SM
    # long sequences stream
    for t, k, size in ((2000, 8, 8), (2000, 8, 4), (1000, 8, 8)):
        for d in (0, 3):
            assert fb_cuda.design(t, k, size, d) == ("streamed", 0, 0)
    for t in (1, 7, 50, 300, 2000):
        for k in (1, 2, 8):
            for size in (4, 8):
                des = fb_cuda.design(t, k, size)
                assert des.smem_bytes <= fb_cuda.SMEM_PER_BLOCK
                assert des.kind == "streamed" or des.rows % 32 == 0
    # past the register bodies: the wide body, whatever T
    for t, k in ((1, 9), (50, 12), (2000, 40)):
        assert fb_cuda.design(t, k, 4) == ("wide", 0, 0)
    assert fb_cuda.wide_work_values(9) == 81 + 27


def test_mask_bits():
    """The resident design's mask: bit j of word w is step 32 w + j, rows
    padded to whole 16-byte units, one row per subject shared by its
    restarts."""
    mask = torch.rand(4, 1, 5, 70) < 0.5
    mw, rep = fb_cuda._mask_bits(mask, (4, 3))
    assert rep == 3 and mw.shape == (4, 5, 4) and mw.dtype == torch.int32
    words = mw.long() & 0xFFFFFFFF
    got = torch.stack([(words[..., t // 32] >> (t % 32)) & 1
                       for t in range(70)], dim=-1)
    assert torch.equal(got.bool(), mask[:, 0])
    assert not words[..., 3:].any()
    # all 32 steps of a word valid: every bit set, bit 31 included
    full, _ = fb_cuda._mask_bits(torch.ones(3, 32, dtype=torch.bool), ())
    assert full[..., 0].flatten().tolist() == [-1, -1, -1]
    for t, n_words in ((1, 4), (32, 4), (128, 4), (129, 8), (2000, 64)):
        assert fb_cuda.mask_row_words(t) == n_words


def test_lane_rows_shares_x_between_restarts():
    lanes = (4, 3)
    x = torch.rand(4, 1, 5, 6, 2)
    xr, rep = fb_cuda._lane_rows(x, lanes, 3)
    assert rep == 3 and xr.shape == (4, 5, 6, 2) and xr.is_contiguous()
    xr, rep = fb_cuda._lane_rows(torch.rand(5, 6, 2), lanes, 3)
    assert rep == 12 and xr.shape == (1, 5, 6, 2)
    xr, rep = fb_cuda._lane_rows(torch.rand(1, 3, 5, 6, 2), lanes, 3)
    assert rep == 1 and xr.shape == (12, 5, 6, 2)


def test_validate_fused_rejects_what_the_kernel_cannot_take():
    x, mask, p, a, niw = make_fused_case(10, d=2, k=2)
    emis = tfb.emission_constants(niw)
    fused = fb_cuda.e_step_fused
    x4, _, _, _, niw4 = make_fused_case(10, d=4, k=2)
    with pytest.raises(ValueError, match="D=4"):
        fused(x4, mask, p, a, tfb.emission_constants(niw4))
    with pytest.raises(ValueError, match="constants per state"):
        fused(x, mask, p, a, emis[..., :-1])
    with pytest.raises(ValueError, match="K=9"):
        x9, m9, p9, a9, niw9 = make_fused_case(10, k=9)
        fused(x9, m9, p9, a9, tfb.emission_constants(niw9))
    xl, ml, pl, al, niwl = make_fused_case(10, t=2000, k=8, d=3, n=1,
                                           lanes=(1,), ragged=False)
    with pytest.raises(ValueError, match="resident design"):
        fused(xl, ml, pl, al, tfb.emission_constants(niwl))
    with pytest.raises(ValueError, match="dtype"):
        fused(x.float(), mask, p, a, emis)
    with pytest.raises(ValueError, match="bool"):
        fused(x, mask.double(), p, a, emis)
    with pytest.raises(ValueError, match="meta"):
        fused(x, mask, p, a, emis.to("meta"))
    with pytest.raises(ValueError, match="x has shape"):
        fused(torch.cat([x, x, x]), mask, p, a, emis)
    with pytest.raises(ValueError, match="mask has shape"):
        fused(x, mask[..., :3, :], p, a, emis)
    with pytest.raises(ValueError, match="log_trans"):
        fused(x, mask, p, a.repeat(1, 1, 2, 2), emis)


def test_auto_on_cpu_takes_the_plain_version():
    """On CPU tensors the E-step dispatch runs the plain version: no
    launch, no build, no step-0 sync (a masked step 0 passes here; the EM
    loops check lengths once instead)."""
    x, mask, p, a, niw = make_fused_case(11, d=2, k=3)
    want = tfb.forward_backward(p, a, tfb.expected_log_gauss(x, niw), mask)
    auto = fb_cuda.e_step_auto(x, mask, p, a, niw)
    for f in FIELDS:
        assert torch.equal(getattr(auto, f), getattr(want, f)), f
    m0 = mask.clone()
    m0[..., 1, 0] = False
    fb_cuda.e_step_auto(x, m0, p, a, niw)
    assert fb_cuda.LAUNCHES == fb_cuda.FUSED_LAUNCHES == 0
    assert _build._lib is None


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_entry_needs_cuda_tensors(dtype):
    """The fused entry has no CPU branch: on CPU tensors it raises after
    validating them, launching and building nothing."""
    x, mask, p, a, niw = make_fused_case(11, d=2, k=3)
    emis = tfb.emission_constants(niw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fb_cuda.e_step_fused(x.to(dtype), mask, p.to(dtype), a.to(dtype),
                             emis.to(dtype))
    assert fb_cuda.LAUNCHES == fb_cuda.FUSED_LAUNCHES == 0
    assert _build._lib is None
