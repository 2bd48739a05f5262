"""The pair recursion of kernels B1 and B3 (``csrc/pair_recursion.cuh``),
which cannot run here, transliterated into NumPy: the scaled backward
step, the per-step state w kept for the forward pass, the underflow
guard, and the forward pass that forms Theta from the state without
exps.  Held to the
explicit-loop oracle of tests/test_pair_estep.py at rtol 1e-10 in float64,
and within the kernels' float32 gate (5e-5 of max |got - want| /
(|want| + 1)) of that oracle in float32, on ragged Sb, Sr=1, -inf log_a,
-1e30 masked reduced states and ell spreads of 10^3 nats; with the
checkpointed design's segments (``seg``) and the padded grid's body's
live states (``live``) held to the JAX package's recursion in float64.
Also the wrapper's choice of design and its shared-memory sizing by
shape."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pair_estep import oracle_pair
from vbhem_tpu.ops import pair_estep as jpe
from vbhem_tpu_torch.ops import pair_estep_cuda as tpc

KERNEL_TOL = 5e-5
FLOOR = {np.float32: 2.0 ** -64, np.float64: 2.0 ** -512}


def live_states(log_pi, log_a):
    """``live_states`` of ``csrc/pair_recursion.cuh``: Sr less the trailing
    states whose log_pi and every log_a into them are at most -1e29 (all
    Sr where every state is so masked)."""
    sr = len(log_pi)
    n = sr
    while n > 0 and log_pi[n - 1] <= -1e29 and np.all(log_a[:, n - 1]
                                                      <= -1e29):
        n -= 1
    return n if n > 0 else sr


def scaled_pair_transliteration(prior, trans, log_pi, log_a, ell, tau,
                                dtype=np.float64, seg=None, live=False):
    """``pair_recursion`` of ``csrc/pair_recursion.cuh`` for one pair, in
    ``dtype``: every step's state kept, as the resident and scratch
    designs keep it, or (``seg``) the checkpointed design's segment of
    ``seg`` steps and the carries at segments 1 .. nseg-2, each earlier
    segment's steps recomputed from its carry in the forward pass; with
    ``live``, at the live states only (the padded grid's body), zeros at
    the others.  Returns (ll_elbo, nu_1 [Sr], sum_xi [Sr, Sr], sum_t_nu
    [Sr, Sb], the count of columns the underflow guard took to the log
    domain)."""
    prior, trans, log_pi, log_a, ell = (np.asarray(x, dtype) for x in
                                        (prior, trans, log_pi, log_a, ell))
    if live:
        n, sr = live_states(log_pi, log_a), len(log_pi)
        ll, nu1, sxi, stn, fired = scaled_pair_transliteration(
            prior, trans, log_pi[:n], log_a[:n, :n], ell[:, :n], tau, dtype,
            seg)
        pad = np.zeros((sr, sr), dtype)
        pad[:n, :n] = sxi
        return (ll, np.concatenate([nu1, np.zeros(sr - n, dtype)]), pad,
                np.concatenate([stn, np.zeros((sr - n, len(prior)), dtype)]),
                fired)
    sb, sr = ell.shape
    floor, one, zero = dtype(FLOOR[dtype]), dtype(1), dtype(0)

    def fz(x):   # finite_or_zero
        return x if np.isfinite(x) else zero

    amax = np.array([fz(row.max()) for row in log_a], dtype)
    a = np.exp(log_a - amax[:, None])                 # [rp, rc], staged
    guarded = [0]

    def backward(llo, sh):
        z = ell + llo                                 # [c, rc]
        mc = np.array([fz(z[c].max()) for c in range(sb)], dtype)
        w = np.exp(z - mc[:, None])
        s = a @ w.T                                   # S[rp, c]
        with np.errstate(divide="ignore"):   # a guarded column's log(0)
            lse = amax[:, None] + np.log(s)           # lse - m_c
        state = w.copy()
        for c in np.flatnonzero(np.any(s < floor, axis=0)):   # the guard
            guarded[0] += 1
            for rp in range(sr):
                x = log_a[rp] + z[c]
                m = fz(x.max())
                lse[rp, c] = (np.log(np.exp(x - m).sum()) + m) - mc[c]
            state[c] = (z[c] - mc[c]) - one           # log w - 1 < 0
        # the carry keeps trans lse, the shift trans (m_c + shift)
        return trans @ lse.T, trans @ (mc + sh), state   # [b, rp]

    def forward(nu, state, hsum, sxi_log):
        """One step; sum_xi = A * hsum + sxi_log after the last."""
        foo = nu @ trans                              # [rp, c]
        nn = np.zeros((sr, sb), dtype)
        if np.any(state[:, 0] < 0):   # a guarded column: column by column
            for c in range(sb):
                w = state[c]
                for rp in range(sr):
                    if w[0] < 0:
                        x = log_a[rp] + w
                        e = np.exp(x - fz(x.max()))
                    else:
                        e = a[rp] * w
                    xi = (foo[rp, c] / e.sum()) * e
                    sxi_log[rp] += xi
                    nn[:, c] += xi
            return nn
        g = foo / (a @ state.T)                       # foo / S [rp, c]
        for c in range(sb):
            nn[:, c] = state[c] * (g[:, c] @ a)
        hsum += g @ state                             # [rp, rc]
        return nn

    ns = tau - 1
    length = seg or max(ns, 1)
    nseg = -(-ns // length) if ns > 0 else 0
    llo, sh = np.zeros((sb, sr), dtype), np.zeros(sb, dtype)
    carries, slots = {}, []   # slots: the segment's (all steps' unsegmented)
    for k in range(ns):
        if k % length == 0:
            if 0 < k // length < nseg - 1:
                carries[k // length] = llo.copy()
            slots = []
        llo, sh, state = backward(llo, sh)
        slots.append(state)
    if seg and ns > 0:   # the room the kernel's checkpointed design takes:
        # the segment, the carries and, where segments are recomputed, ell
        assert len(carries) + min(length, ns) + (nseg > 1) == \
            tpc.checkpointed_slots(tau, seg)

    x = log_pi[None, :] + ell + llo                   # [b, r]
    mx = np.array([fz(v) for v in x.max(axis=1)], dtype)
    e = np.exp(x - mx[:, None])
    tot = e.sum(axis=1)
    ll = prior @ ((np.log(tot) + mx) + sh)
    nu = ((prior / tot)[:, None] * e).T               # [r, b]
    nu1, stn = nu.sum(axis=1), nu.copy()
    hsum, sxi_log = np.zeros((sr, sr), dtype), np.zeros((sr, sr), dtype)
    for s_ in range(nseg - 1, -1, -1):
        if s_ < nseg - 1:   # segment s_'s states again, from its carry
            rl = carries.get(s_, np.zeros((sb, sr), dtype))
            slots = []
            for _ in range(min(length, ns - s_ * length)):
                rl, _, state = backward(rl, np.zeros(sb, dtype))
                slots.append(state)
        for state in reversed(slots):
            nu = forward(nu, state, hsum, sxi_log)
            stn += nu
    return ll, nu1, a * hsum + sxi_log, stn, guarded[0]


def make_pairs(seed, sb=3, sr=3, n=4, ragged=False, kind="plain"):
    """n pairs of (prior, trans, log_pi, log_a, ell) as float64 arrays.

    kind 'plain': random inputs; 'neg_inf': log_a[0][0] = -inf (a zero
    transition in VHEM's float32 log floor) and state 0's ell 1000 nats
    above the others, so for rp = 0 every rc with a non-negligible w has
    A = 0; 'masked': state sr-1 masked as the masked grid masks it
    (log_pi and its log_a row and column -1e30) with its ell 1000 nats
    above the others; 'masked_col': only its column masked; 'spread':
    ell spread over 2000 nats, no masking."""
    rng = np.random.default_rng(seed)
    out = []
    for q in range(n):
        prior = rng.dirichlet(np.ones(sb))
        trans = rng.dirichlet(np.ones(sb), sb)
        if ragged and q % 2 == 0:   # last base state zero-padded
            prior[-1] = 0.0
            prior /= prior.sum()
            trans[-1] = 0.0
            trans[:-1, -1] = 0.0
            trans[:-1] /= trans[:-1].sum(axis=1, keepdims=True)
        log_pi = np.log(rng.dirichlet(np.ones(sr)) * 0.9)
        log_a = np.log(rng.dirichlet(np.ones(sr), sr) * 0.85)
        ell = rng.normal(size=(sb, sr)) * 2.0 - 3.0
        with np.errstate(divide="ignore"):
            if kind == "neg_inf" and sr > 1:
                log_a[0, 0] = -np.inf
                ell[:, 0] += 1000.0
            elif kind in ("masked", "masked_col") and sr > 1:
                m = sr - 1
                log_pi[m] = -1e30
                log_a[:, m] = -1e30
                if kind == "masked":
                    log_a[m, :] = -1e30
                ell[:, m] += 1000.0
            elif kind == "spread":
                ell[:, 0] -= 2000.0 * rng.uniform(0.5, 1.0, sb)
            elif kind == "padded":   # a cell of S=2 padded as the grid pads
                log_pi[2:] = -1e30
                log_a[:, 2:] = -1e30
        out.append((prior, trans, log_pi, log_a, ell))
    return out


# name: (make_pairs keywords, whether the guard must fire)
CASES = {
    "plain": (dict(), False),
    "ragged_sb": (dict(ragged=True), False),
    "sr1": (dict(sr=1), False),
    "sb2_sr3": (dict(sb=2, sr=3), False),
    "neg_inf_log_a": (dict(sb=2, sr=3, kind="neg_inf"), True),
    "masked_state": (dict(kind="masked", ragged=True), True),
    "masked_column": (dict(sb=2, sr=2, kind="masked_col"), True),
    "spread_1e3": (dict(kind="spread"), False),
    # the padded grid's body: Sb=2, Sr=5, the cell's S=2
    "padded_sr5": (dict(sb=2, sr=5, kind="padded"), False),
    # past the register bodies: the wide body runs the same arithmetic
    "wide_s9": (dict(sb=9, sr=9), False),
    "wide_masked_s10": (dict(sb=9, sr=10, kind="masked"), True),
}
TAUS = (1, 2, 10, 50)


def _check(got, want, rtol, atol):
    np.testing.assert_allclose(got[0], want[0], rtol=rtol)
    for g, w in zip(got[1:4], want[1:]):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _rel(got, want):
    """max |got - want| / (|want| + 1) over the four outputs."""
    return max(float(np.max(np.abs(np.asarray(g, np.float64) - w)
                            / (np.abs(w) + 1.0)))
               for g, w in zip(got[:4], want))


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("name", list(CASES))
def test_scaled_recursion_f64_matches_loop_oracle(name, tau):
    """rtol 1e-10 against the oracle, and the guard fires in the cases
    built for it."""
    kw, must_guard = CASES[name]
    fired = 0
    for pair in make_pairs(20 + tau, **kw):
        want = oracle_pair(*pair, tau)
        got = scaled_pair_transliteration(*pair, tau)
        _check(got, want, 1e-10, 1e-13)
        fired += got[4]
    assert (fired > 0) == (must_guard and tau > 1), fired


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("name", list(CASES))
def test_scaled_recursion_f32_within_gate(name, tau):
    """float32 throughout, against the float64 oracle on the float32
    inputs: within the kernels' gate, no NaN, and the guard fires in the
    cases built for it."""
    kw, must_guard = CASES[name]
    fired, worst = 0, 0.0
    for pair in make_pairs(40 + tau, **kw):
        p32 = [np.asarray(x, np.float32) for x in pair]
        with np.errstate(over="ignore", under="ignore"):
            want = oracle_pair(*[x.astype(np.float64) for x in p32], tau)
            got = scaled_pair_transliteration(*p32, tau, np.float32)
            assert all(np.all(np.isfinite(g)) for g in got[:4])
            worst = max(worst, _rel(got, want))
            fired += got[4]
    assert worst <= KERNEL_TOL, worst
    assert (fired > 0) == (must_guard and tau > 1), fired


def jax_pairs(pairs, tau):
    """The JAX package's ``pair_bwd_fwd`` in float64 on each pair: the
    pairs as the diagonal of one Kb = Kr launch.  Returns per pair
    (ll_elbo, nu_1, sum_xi, sum_t_nu)."""
    prior, trans, log_pi, log_a, ell = (np.stack(x) for x in zip(*pairs))
    n = len(pairs)
    ell_all = np.broadcast_to(ell[:, None], (n, n) + ell.shape[1:])
    st = jpe.pair_bwd_fwd(*(jnp.asarray(x) for x in (
        prior, trans, log_pi, log_a, ell_all)), tau)
    return [tuple(np.asarray(f)[q, q] for f in st) for q in range(n)]


# the cases for the checkpointed design's segments: each design body's
# kinds of input, and the guard
SEG_CASES = ("plain", "ragged_sb", "sr1", "neg_inf_log_a", "masked_state",
             "masked_column", "padded_sr5")


@pytest.mark.parametrize("tau", (2, 10, 50))
@pytest.mark.parametrize("name", SEG_CASES)
def test_checkpointed_segments_f64_match_jax(name, tau):
    """The recursion with the checkpointed design's segments (the length
    the wrapper takes, one step, three, and all but one) at rtol 1e-10
    against the JAX package's recursion; the guard fires where built to,
    in the backward pass and again where a segment is recomputed."""
    kw, must_guard = CASES[name]
    pairs = make_pairs(60 + tau, **kw)
    want = jax_pairs(pairs, tau)
    for seg in sorted({1, 3, tau - 1, tpc.checkpoint_segment(tau)}):
        fired = 0
        for pair, w in zip(pairs, want):
            got = scaled_pair_transliteration(*pair, tau, seg=seg)
            _check(got, w, 1e-10, 1e-13)
            fired += got[4]
        assert (fired > 0) == must_guard, (seg, fired)


@pytest.mark.parametrize("tau", (2, 50))
@pytest.mark.parametrize("name", ("masked_state", "masked_column",
                                  "padded_sr5"))
def test_live_states_give_the_plain_zeros(name, tau):
    """The padded grid's body runs at the live states and writes zeros at
    the trailing masked ones: within rtol 1e-10 of the JAX package's
    recursion in float64 (which gives exact zeros there), every design;
    within the kernels' gate in float32."""
    kw, _ = CASES[name]
    pairs = make_pairs(80 + tau, **kw)
    want = jax_pairs(pairs, tau)
    for pair, w in zip(pairs, want):
        n = live_states(pair[2], pair[3])
        assert n < len(pair[2])
        assert np.all(w[1][n:] == 0) and np.all(w[2][n:] == 0)
        assert np.all(w[2][:, n:] == 0) and np.all(w[3][n:] == 0)
        for seg in (None, tpc.checkpoint_segment(tau)):
            got = scaled_pair_transliteration(*pair, tau, seg=seg, live=True)
            _check(got, w, 1e-10, 1e-13)
            assert np.all(got[1][n:] == 0) and np.all(got[2][n:] == 0)
            assert np.all(got[2][:, n:] == 0) and np.all(got[3][n:] == 0)
        p32 = [np.asarray(x, np.float32) for x in pair]
        with np.errstate(over="ignore", under="ignore"):
            got = scaled_pair_transliteration(
                *p32, tau, np.float32, tpc.checkpoint_segment(tau), True)
        assert _rel(got, w) <= KERNEL_TOL


def test_live_states_keep_every_state_of_an_all_masked_model():
    log_a = np.full((3, 3), -1e30)
    assert live_states(np.full(3, -1e30), log_a) == 3
    log_a[:, 1] = -0.5   # state 1 entered: only state 2 drops
    assert live_states(np.array([0.0, -1e30, -1e30]), log_a) == 2


def test_guard_keeps_log_zero_out_of_ragged_rows():
    """A zero row of trans (ragged Sb) times a log(0) would be NaN: with
    the guard the masked state's S never reaches the log."""
    pair = make_pairs(3, sb=3, sr=3, n=1, ragged=True, kind="masked")[0]
    assert np.all(pair[1][-1] == 0.0)
    for dtype in (np.float32, np.float64):
        got = scaled_pair_transliteration(*pair, 10, dtype)
        assert got[4] > 0
        assert all(np.all(np.isfinite(g)) for g in got[:4])


# ---------------------------------------------------------------------------
# the wrapper's design by shape
# ---------------------------------------------------------------------------

def test_pairs_per_sm():
    # no shared memory: the 2048-thread limit
    assert tpc.pairs_per_sm(128, 0) == 2048
    # 100 KB blocks: two fit in 228 KB
    assert tpc.pairs_per_sm(128, 100_000) == 256
    assert tpc.pairs_per_sm(32, tpc.SMEM_DYNAMIC_MAX) == 32


BENCH, MAIN, PIPE, VHEM = 8192 * 8, 8192 * 24, 8192 * 192, 8192 * 60


@pytest.mark.parametrize("sb,sr,tau,itemsize,pairs,kind", [
    (3, 3, 10, 4, BENCH, "resident"),      # bench
    (3, 3, 10, 4, MAIN, "resident"),       # main-path cell
    (3, 2, 10, 4, MAIN, "resident"),       # main-path cell at Sr=2
    (2, 2, 50, 4, PIPE, "resident"),       # pipeline, 64 lanes of Kr=3
    (2, 3, 10, 4, VHEM, "resident"),       # VHEM full width
    (2, 2, 50, 4, 8192 * 3, "resident"),   # DIC, float32
    (2, 2, 50, 8, 8192 * 2, "resident"),   # DIC, float64: all pairs held
    (2, 2, 50, 8, 8192 * 3, "scratch"),    # DIC, float64: 128 of 187 held
    (3, 3, 10, 8, MAIN, "resident"),       # float64 main-path cell
    (2, 2, 1, 4, MAIN, "resident"),        # no steps
    (2, 2, 200, 4, PIPE, "checkpointed"),  # long tau: 64 pairs per SM
    (2, 2, 200, 4, 8192 * 4, "checkpointed"),   # chip_smoke's long tau
    (2, 2, 200, 4, 4096, "resident"),      # long tau, a small launch
    (8, 8, 200, 8, 512, "scratch"),        # no block holds the segments
    (8, 8, 200, 4, 512, "checkpointed"),   # 32 a SM hold the segments
    (8, 8, 10, 8, 256, "resident"),        # f64, Sb = Sr = 8: 32 a SM held
    (8, 8, 10, 8, 8192, "scratch"),        # ... where 63 a SM are needed
    (8, 8, 10, 4, 8192 * 64, "checkpointed"),  # float32: 96 a SM held
    (2, 5, 50, 4, 8192 * 6 * 30, "checkpointed"),  # the padded grid
    (2, 5, 50, 4, 8192 * 2064, "checkpointed"),  # ... at 344 lanes
    (2, 5, 50, 4, 40 * 480, "checkpointed"),    # the hyp objective's
    (2, 5, 50, 8, 8192 * 6, "scratch"),    # the f64 rescoring's
    (9, 9, 2, 4, 64, "scratch"),           # the wide body: scratch only
    (2, 12, 1, 8, 64, "scratch"),
])
def test_design_by_shape(sb, sr, tau, itemsize, pairs, kind):
    des = tpc.design(sb, sr, tau, itemsize, pairs)
    assert des.kind == kind
    assert des.threads in tpc.THREAD_CHOICES
    per_sm = -(-pairs // tpc.SMS)
    need = min(tpc.RESIDENT_PAIRS_PER_SM, per_sm)
    res = tpc.design_of("resident", sb, sr, tau, itemsize)
    ck = tpc.design_of("checkpointed", sb, sr, tau, itemsize)
    if kind == "resident":
        # every step's state fits the dynamic shared memory of a block
        assert des == res
        assert des.smem_bytes == des.threads * (tau - 1) * sb * sr * itemsize
        assert des.smem_bytes <= tpc.SMEM_DYNAMIC_MAX
        assert tpc.pairs_per_sm(des.threads, des.smem_bytes) >= need
        return
    # the others only where the resident design holds too few pairs
    assert res is None or tpc.pairs_per_sm(res.threads,
                                           res.smem_bytes) < need
    held_ck = 0 if ck is None else tpc.pairs_per_sm(ck.threads,
                                                    ck.smem_bytes)
    need_ck = min(tpc.CHECKPOINTED_PAIRS_PER_SM, per_sm)
    if kind == "checkpointed":
        # a segment of seg steps and the carries at segments 1 .. nseg-2
        assert des == ck and des.seg == tpc.checkpoint_segment(tau)
        assert des.smem_bytes == des.threads * tpc.checkpointed_slots(
            tau, des.seg) * sb * sr * itemsize <= tpc.SMEM_DYNAMIC_MAX
        assert held_ck >= need_ck
    else:
        assert des.smem_bytes == 0 and des.seg == 0
        assert held_ck < need_ck


def test_resident_takes_every_step_where_it_holds_enough_pairs():
    # bench / main-path cell: 9 steps x 9 values x 4 bytes = 324 B a pair
    # (640 pairs per SM in blocks of 32, 64 or 128: the smallest taken)
    des = tpc.design(3, 3, 10, 4, MAIN)
    assert des == tpc.PairDesign("resident", 32, 32 * 324)
    assert tpc.pairs_per_sm(des.threads, des.smem_bytes) == 640
    assert tpc.pairs_per_sm(128, 128 * 324) == 640
    # the pipeline: 784 B a pair, 256 pairs per SM
    des = tpc.design(2, 2, 50, 4, PIPE)
    assert des == tpc.PairDesign("resident", 32, 32 * 784)
    assert tpc.pairs_per_sm(des.threads, des.smem_bytes) == 256
    # a card with fewer SMs needs more pairs per SM
    assert tpc.design(2, 2, 50, 8, 8192 * 2, sms=66).kind == "scratch"
    assert tpc.design(2, 2, 200, 4, 8192).kind == "resident"
    assert tpc.design(2, 2, 200, 4, 8192, sms=66).kind == "checkpointed"


def test_checkpointed_design_at_the_grid_launches():
    """The padded grid's launch (Sb=2, Sr=5, tau=50): segments of 7 steps,
    5 carries and ell, 13 slots of 10 values, 520 B a pair in float32
    instead of the 1,960 of every step; blocks of 32 (the hyp objective's
    Kb=40 fills 40 of 64 threads, not 40 of 128).  No checkpointed design
    in float64: the rescoring's launch takes the scratch."""
    assert tpc.checkpoint_segment(50) == 7
    assert tpc.checkpointed_slots(50, 7) == 13
    for tau, seg, slots in ((1, 1, 0), (2, 1, 1), (3, 2, 2), (10, 3, 5),
                            (200, 17, 28)):
        assert tpc.checkpoint_segment(tau) == seg
        assert tpc.checkpointed_slots(tau, seg) == slots
    # one segment holds every step and needs no ell; no segment length
    # takes fewer slots at tau = 50
    assert tpc.checkpointed_slots(50, 49) == 49
    assert min(tpc.checkpointed_slots(50, g) for g in range(1, 50)) == 13
    for pairs in (8192 * 2064, 40 * 480):
        des = tpc.design(2, 5, 50, 4, pairs)
        assert des == tpc.PairDesign("checkpointed", 32, 32 * 13 * 10 * 4, 7)
    assert tpc.pairs_per_sm(32, 32 * 520) == 416
    assert tpc.design_of("checkpointed", 2, 5, 50, 8) is None
    assert tpc.design(2, 5, 50, 8, 8192 * 6) == tpc.PairDesign("scratch",
                                                               128, 0)


def test_design_of_sizes_blocks_and_rejects_unknown_kinds():
    # tau = 1: no steps, no shared memory; 64 threads reach the 2048-thread
    # limit first
    assert tpc.design_of("resident", 3, 3, 1, 4) == tpc.PairDesign(
        "resident", 64, 0)
    # 1568 B a pair in float64 at the pipeline's shape: blocks of 32 hold
    # 4 x 32 = 128 pairs per SM, blocks of 128 only one
    des = tpc.design_of("resident", 2, 2, 50, 8)
    assert des == tpc.PairDesign("resident", 32, 32 * 1568)
    assert tpc.pairs_per_sm(des.threads, des.smem_bytes) == 128
    # no block of 32 holds 199 steps of 64 float64 values
    assert tpc.design_of("resident", 8, 8, 200, 8) is None
    assert tpc.design_of("scratch", 8, 8, 200, 8) == tpc.PairDesign(
        "scratch", 128, 0)
    # the checkpointed design's 28 slots fit in float32 (it has no
    # float64 build)
    assert tpc.design_of("checkpointed", 8, 8, 200, 8) is None
    assert tpc.design_of("checkpointed", 8, 8, 200, 4) == tpc.PairDesign(
        "checkpointed", 32, 32 * 28 * 64 * 4, 17)
    with pytest.raises(ValueError, match="design"):
        tpc.design_of("segmented", 2, 2, 50, 4)


def test_wide_body_sizes():
    """The wide body: only the scratch design; its workspace after the
    states (csrc/pair_recursion.cuh: WideWork) and its shared memory (the
    reduced model, and B1's emission constants) by shape."""
    assert not tpc.is_wide(8, 8) and tpc.is_wide(9, 2) and tpc.is_wide(2, 9)
    assert tpc.design_of("resident", 9, 9, 10, 4) is None
    # llo, lse, nu, stn, foo, nn, inv [Sb*Sr]; hsum, sxi [Sr^2]; sh, mc
    # [Sb]; x [Sr]; B1 adds E3logN [Sb*Sr]
    assert tpc.wide_work_values(9, 12, False) == 7 * 108 + 2 * 144 + 18 + 12
    assert tpc.wide_work_values(9, 12, True) == \
        tpc.wide_work_values(9, 12, False) + 108
    assert tpc.wide_smem_bytes(12, 0, 8) == (2 * 144 + 24) * 8
    assert tpc.wide_smem_bytes(12, 3, 4) == (2 * 144 + 24 + 36 + 108 + 24) * 4
    # the reduced model must fit a block's shared memory: Sr = 119 in
    # float64 (B3) does, 121 does not
    assert tpc.wide_smem_bytes(119, 0, 8) <= tpc.SMEM_DYNAMIC_MAX
    assert tpc.wide_smem_bytes(121, 0, 8) > tpc.SMEM_DYNAMIC_MAX
    with pytest.raises(ValueError, match="shared memory"):
        tpc._wide_checks(tpc.PairDesign("scratch", 128, 0), 2, 121, 0, 8)
    with pytest.raises(ValueError, match="scratch design"):
        tpc._wide_checks(tpc.PairDesign("resident", 32, 1024), 9, 9, 2, 4)
    scratch, _, _ = tpc._state_args(tpc.PairDesign("scratch", 128, 0),
                                    torch.device("cpu"), torch.float32, 6,
                                    40, 9, 9, 3,
                                    tpc.wide_work_values(9, 9, True))
    assert scratch.numel() == (2 * 81 + tpc.wide_work_values(9, 9, True)) \
        * 6 * 40


def test_state_args_allocate_scratch_only_for_the_scratch_design():
    dev, dt = torch.device("cpu"), torch.float32
    des = tpc.PairDesign("resident", 64, 4096)
    scratch, ptr, tail = tpc._state_args(des, dev, dt, 6, 40, 2, 3, 10)
    assert scratch is None and ptr is None
    assert tail == (0, 64, 4096, 0)
    des = tpc.PairDesign("scratch", 128, 0)
    scratch, ptr, tail = tpc._state_args(des, dev, dt, 6, 40, 2, 3, 10)
    assert scratch.numel() == 9 * 2 * 3 * 6 * 40
    assert ptr == scratch.data_ptr() and tail == (1, 128, 0, 0)
    des = tpc.PairDesign("checkpointed", 32, 32 * 5 * 6 * 4, 3)
    scratch, ptr, tail = tpc._state_args(des, dev, dt, 6, 40, 2, 3, 10)
    assert scratch is None and ptr is None
    assert tail == (2, 32, 32 * 5 * 6 * 4, 3)
    with pytest.raises(ValueError, match="design"):
        tpc._state_args(tpc.PairDesign("other", 128, 0), dev, dt, 6, 40,
                        2, 3, 10)
