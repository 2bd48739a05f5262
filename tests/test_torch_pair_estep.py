"""The port's pair E-step: the plain PyTorch version against the JAX
package's XLA path (f64, rtol 1e-10) and against the explicit-loop NumPy
oracle of tests/test_pair_estep.py; in f32 against the JAX package's real
Pallas kernel run in interpret mode (max |got - want| / (|want| + 1) <=
5e-5, the on-hardware gate of bench.py); plus the dispatch's and the
build's behaviour on a machine with no CUDA.  The CUDA kernel itself is
checked against the plain version on the card by chip_smoke.py."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import digamma

from tests.test_pair_estep import oracle_pair
from tests.test_torch_pair_recursion import scaled_pair_transliteration
from vbhem_tpu.ops import pair_estep as jpe
from vbhem_tpu.ops import pair_estep_pallas as jpp
from vbhem_tpu_torch.ops import _build
from vbhem_tpu_torch.ops import pair_estep as tpe
from vbhem_tpu_torch.ops import pair_estep_cuda as tpc

REPO = Path(__file__).resolve().parent.parent
KERNEL_TOL = 5e-5
ARGS = ("prior_b", "trans_b", "mean_b", "cov_b", "log_pi_r", "log_a_r",
        "m_r", "w_r", "v_r", "lam_r", "log_lam_r")


def make_case(seed, kb=40, kr=3, sb=3, sr=3, d=2, lanes=(), ragged=False,
              big_neg=False):
    """Inputs of the fused pair E-step, in the manner of bench.py's
    make_problem, as float64 numpy arrays in the order of ARGS."""
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=(kb, sb, d)) * 3.0
    a = rng.normal(size=(kb, sb, d, d)) * 0.3
    cov = np.einsum("ksde,ksfe->ksdf", a, a) + np.eye(d)
    prior = rng.dirichlet(np.ones(sb), kb)
    trans = rng.dirichlet(np.ones(sb), (kb, sb))
    if ragged:   # base HMM 0 has its last state zero-padded (vbhem.py:98-102)
        prior[0, :-1] = rng.dirichlet(np.ones(sb - 1))
        prior[0, -1] = 0.0
        trans[0, -1, :] = 0.0
        trans[0, :-1, :-1] = rng.dirichlet(np.ones(sb - 1), sb - 1)
        trans[0, :-1, -1] = 0.0
        mean[0, -1] = 0.0
        cov[0, -1] = np.eye(d)
    shp = lanes + (kr, sr)
    m = rng.normal(size=shp + (d,)) * 3.0
    a = rng.normal(size=shp + (d, d)) * 0.3
    w = np.einsum("...de,...fe->...df", a, a) + np.eye(d)
    v = rng.uniform(d + 2.0, d + 30.0, shp)
    lam = rng.uniform(1.0, 30.0, shp)
    log_lam = (digamma(0.5 * (v[..., None] + 1 - np.arange(1, d + 1)))
               .sum(-1) + d * np.log(2) + np.linalg.slogdet(w)[1])
    # sub-normalized reduced scores, like digamma expectations
    log_pi = np.log(rng.dirichlet(np.ones(sr), shp[:-1]) * 0.9)
    log_a = np.log(rng.dirichlet(np.ones(sr), shp) * 0.85)
    if big_neg:  # a masked state's score (numeric.py:182)
        log_pi[..., 1 % kr, 0] = -1e30
    return [prior, trans, mean, cov, log_pi, log_a, m, w, v, lam, log_lam]


CASES = {
    "tau10": dict(kw={}, tau=10),
    "tau1": dict(kw={}, tau=1),
    "tau2_ragged": dict(kw=dict(ragged=True), tau=2),
    "d3_sr1": dict(kw=dict(d=3, sr=1), tau=4),
    "logpi_neg1e30": dict(kw=dict(sb=2, sr=2, big_neg=True), tau=3),
    # sizes past the register bodies (the wide bodies on the card) and
    # past B1's emission dims (E3logN in PyTorch and B3 on the card)
    "sb9_sr9": dict(kw=dict(kb=6, kr=2, sb=9, sr=9), tau=4),
    "d5": dict(kw=dict(kb=6, kr=2, d=5), tau=4),
}


def port(case, dtype=torch.float64):
    return [torch.as_tensor(x, dtype=dtype) for x in case]


def rel_err(got, want):
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.max(np.abs(g - w) / (np.abs(w) + 1.0)))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_xla_f64(name):
    c = CASES[name]
    case = make_case(1, **c["kw"])
    j = [jnp.asarray(x) for x in case]
    jell = jpe.expected_pair_ll_variational(*j[2:4], *j[6:])
    want = jpe.pair_bwd_fwd(*j[:2], *j[4:6], jell, c["tau"])
    t = port(case)
    tell = tpe.expected_pair_ll_variational(*t[2:4], *t[6:])
    np.testing.assert_allclose(tell.numpy(), np.asarray(jell), rtol=1e-10)
    got = tpc.pair_estep_fused_auto(*t, c["tau"])
    for f in want._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-10, atol=1e-13, err_msg=f)
    if c["kw"].get("ragged"):
        assert np.all(got.sum_t_nu[0, :, :, -1].numpy() == 0.0)


def test_plain_matches_loop_oracle():
    tau = 6
    case = make_case(2, kb=4, kr=3, sb=3, sr=2)
    t = port(case)
    ell = tpe.expected_pair_ll_variational(*t[2:4], *t[6:])
    got = tpe.pair_bwd_fwd(*t[:2], *t[4:6], ell, tau)
    prior, trans, log_pi, log_a = case[0], case[1], case[4], case[5]
    for i in range(4):
        for j in range(3):
            ll, nu1, sxi, stn = oracle_pair(prior[i], trans[i], log_pi[j],
                                            log_a[j], ell[i, j].numpy(), tau)
            np.testing.assert_allclose(float(got.ll_elbo[i, j]), ll,
                                       rtol=1e-10)
            np.testing.assert_allclose(got.nu_1[i, j].numpy(), nu1,
                                       atol=1e-12)
            np.testing.assert_allclose(got.sum_xi[i, j].numpy(), sxi,
                                       atol=1e-12)
            np.testing.assert_allclose(got.sum_t_nu[i, j].numpy(), stn,
                                       atol=1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_f32_matches_jax_pallas_kernel(name):
    """The JAX package's fused Pallas kernel (interpret mode) and the
    port's plain path on the same float32 inputs."""
    c = CASES[name]
    case = [x.astype(np.float32) for x in make_case(3, **c["kw"])]
    want = jpp.pair_bwd_fwd_fused_pallas(*[jnp.asarray(x) for x in case],
                                         c["tau"], tile=128, interpret=True)
    got = tpc.pair_estep_fused_auto(*port(case, torch.float32), c["tau"])
    for f in want._fields:
        err = rel_err(getattr(got, f).numpy(), getattr(want, f))
        assert err <= KERNEL_TOL, (f, err)


def test_lanes_f32_match_jax_vmapped_kernel():
    """Three restart lanes: the port's leading lane axis against
    jax.vmap of the JAX package's trial-folding kernel wrapper."""
    tau, lanes = 5, 3
    case = [x.astype(np.float32)
            for x in make_case(4, kb=24, kr=2, lanes=(lanes,))]
    f = jpp._pallas_fused_vmappable(tau, interpret=True)
    want = jax.vmap(f, in_axes=(None,) * 4 + (0,) * 7)(
        *[jnp.asarray(x) for x in case])
    got = tpc.pair_estep_fused_auto(*port(case, torch.float32), tau)
    for fld in want._fields:
        g = getattr(got, fld)
        assert g.shape[0] == lanes
        err = rel_err(g.numpy(), getattr(want, fld))
        assert err <= KERNEL_TOL, (fld, err)
    # each lane alone gives the same as the batched call
    one = tpc.pair_estep_fused_auto(
        *port(case[:4], torch.float32),
        *[torch.as_tensor(x[1]) for x in case[4:]], tau)
    for fld in one._fields:
        torch.testing.assert_close(getattr(got, fld)[1], getattr(one, fld),
                                   rtol=1e-6, atol=1e-6)


def test_cpu_dispatch_never_launches():
    before = tpc.LAUNCHES
    tpc.pair_estep_fused_auto(*port(make_case(5, kb=8)), 3)
    assert tpc.LAUNCHES == before == 0


def test_modules_import_without_cuda_toolchain(tmp_path):
    """In a fresh process with no card visible, no nvcc on PATH and triton
    blocked, the port imports and its CPU path runs: nothing is built or
    loaded at import time."""
    code = (
        "import sys; sys.modules['triton'] = None\n"
        "import torch\n"
        "from vbhem_tpu_torch.ops import _build, pair_estep_cuda as p\n"
        "from vbhem_tpu_torch.models import vbhem\n"
        "x = [torch.ones(2, 1), torch.ones(2, 1, 1), torch.zeros(2, 1, 1),\n"
        "     torch.ones(2, 1, 1, 1), torch.zeros(1, 1), torch.zeros(1, 1, 1),\n"
        "     torch.zeros(1, 1, 1), torch.ones(1, 1, 1, 1),\n"
        "     torch.full((1, 1), 4.0), torch.ones(1, 1), torch.zeros(1, 1)]\n"
        "assert p.pair_estep_fused_auto(*x, 3).ll_elbo.shape == (2, 1)\n"
        "ell = torch.zeros(2, 1, 1, 1)\n"
        "assert p.pair_bwd_fwd_auto(*x[:2], *x[4:6], ell, 3).nu_1.shape \\\n"
        "    == (2, 1, 1)\n"
        "from vbhem_tpu_torch.models import dic, vhem\n"
        "assert _build._lib is None and p.LAUNCHES == p.BWD_FWD_LAUNCHES == 0\n"
        "print('imported', torch.cuda.is_available())\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PATH=str(tmp_path),
               PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported False"


def test_kernel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpc.pair_bwd_fwd_fused_cuda(*port(make_case(6, kb=8)), 3)
    assert _build._lib is None


def _bad(case, **over):
    t = port(case)
    named = dict(zip(ARGS, t))
    named.update(over)
    return [named[a] for a in ARGS]


def test_validate_rejects_what_the_kernel_cannot_take():
    case = make_case(7, kb=8, kr=2, sb=2, sr=2)
    t = port(case)
    with pytest.raises(ValueError, match="tau"):
        tpc.pair_estep_fused_auto(*t, 0)
    with pytest.raises(ValueError, match="dtype"):
        tpc.pair_estep_fused_auto(*port(case, torch.float16), 2)
    with pytest.raises(ValueError, match="dtype"):
        tpc.pair_estep_fused_auto(*_bad(case, v_r=t[8].float()), 2)
    with pytest.raises(ValueError, match="contiguous"):
        w_nc = t[7].transpose(-1, -2)           # a strided view
        tpc.pair_estep_fused_auto(*_bad(case, w_r=w_nc), 2)
    with pytest.raises(ValueError, match="shape"):
        tpc.pair_estep_fused_auto(*_bad(case, m_r=t[6][:, :1].contiguous()), 2)
    # Sb, Sr above 8 and D above 4 are taken (the wide bodies and the
    # route through B3 on the card; the plain version here); empty shapes
    # are not
    for kw in (dict(sb=9), dict(sr=9), dict(d=5), dict(sb=12, sr=12)):
        got = tpc.pair_estep_fused_auto(*port(make_case(8, kb=4, kr=1, **kw)),
                                        2)
        assert np.all(np.isfinite(got.ll_elbo.numpy()))
    for kw, msg in ((dict(kb=0), "empty bank"), (dict(kr=0), "empty bank"),
                    (dict(sr=0), "no states"), (dict(d=0), "D=0")):
        with pytest.raises(ValueError, match=msg):
            tpc.pair_estep_fused_auto(*port(make_case(8, **dict(
                dict(kb=4, kr=1), **kw))), 2)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_build_reports_compiler_errors(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake compiler refused' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    with pytest.raises(_build.KernelBuildError, match="fake compiler refused"):
        _build.build()
    # no half-built library left behind
    assert list((tmp_path / "build").iterdir()) == []


def test_library_path_keys_on_sources(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    header = tmp_path / "shared.cuh"
    header.write_text("// shared\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.library_path()
    assert first.parent == tmp_path / "build"
    src.write_text("// two\n")
    second = _build.library_path()
    assert second != first
    # an edit to a header that the sources include builds anew too
    header.write_text("// shared, edited\n")
    assert _build.library_path() != second
    assert _build.sources() == [src]


@pytest.mark.parametrize("tau,sr", [(1, 3), (2, 2), (10, 3), (50, 2)])
def test_kernel_rebased_carry_matches_loop_oracle(tau, sr):
    """The rebased, scaled recursion of the CUDA kernels, which cannot run
    here (tests/test_torch_pair_recursion.py transliterates it), on B1's
    E3logN, against the explicit-loop oracle of tests/test_pair_estep.py."""
    case = make_case(9, kb=3, kr=2, sb=3, sr=sr, ragged=True)
    t = port(case)
    ell = tpe.expected_pair_ll_variational(*t[2:4], *t[6:]).numpy()
    prior, trans, log_pi, log_a = case[0], case[1], case[4], case[5]
    for i in range(3):
        for j in range(2):
            want = oracle_pair(prior[i], trans[i], log_pi[j], log_a[j],
                               ell[i, j], tau)
            got = scaled_pair_transliteration(
                prior[i], trans[i], log_pi[j], log_a[j], ell[i, j], tau)
            np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
            for g, w in zip(got[1:4], want[1:]):
                np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("tau", [2, 50])
def test_plain_gives_exact_zeros_at_padded_states(dtype, tau):
    """The padded grid masks each cell's states past its S with -1e30 in
    log_pi and in every log_a column into them (masked_e_log_dirichlet),
    as ``vbhem.reduced_expectations`` does: every exp over them is exactly
    0, so the plain version gives exact zeros at those entries of nu_1,
    sum_xi (rows and columns) and sum_t_nu, the zeros the kernels' padded
    grid body writes without running those states
    (csrc/pair_recursion.cuh: live_states).  And the live states' results
    equal the unpadded model's: what the body computes."""
    from vbhem_tpu_torch.utils.numeric import masked_e_log_dirichlet
    rng = np.random.default_rng(tau)
    case = port(make_case(4, kb=6, kr=3, sb=2, sr=5), dtype)
    cells = [1, 3, 5]   # each reduced model j's S
    smask = torch.arange(5) < torch.tensor(cells)[:, None]
    eta = torch.as_tensor(rng.uniform(0.5, 3.0, (3, 5)), dtype=dtype)
    eps = torch.as_tensor(rng.uniform(0.5, 3.0, (3, 5, 5)), dtype=dtype)
    log_pi = masked_e_log_dirichlet(eta, smask)
    log_a = masked_e_log_dirichlet(eps, smask[:, None, :])
    assert torch.all(log_pi[0, 1:] == -1e30)
    assert torch.all(log_a[0, :, 1:] == -1e30)
    ell = tpe.expected_pair_ll_variational(*case[2:4], *case[6:])
    got = tpe.pair_bwd_fwd(case[0], case[1], log_pi, log_a, ell, tau)
    for j, s_ in enumerate(cells):
        assert torch.all(got.nu_1[:, j, s_:] == 0)
        assert torch.all(got.sum_xi[:, j, s_:, :] == 0)
        assert torch.all(got.sum_xi[:, j, :, s_:] == 0)
        assert torch.all(got.sum_t_nu[:, j, s_:] == 0)
        one = tpe.pair_bwd_fwd(case[0], case[1], log_pi[j:j + 1, :s_],
                               log_a[j:j + 1, :s_, :s_],
                               ell[:, j:j + 1, :, :s_], tau)
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        for f in one._fields:
            a = getattr(got, f)[:, j]
            b = getattr(one, f)[:, 0]
            a = a[..., :s_] if f == "nu_1" else (
                a[..., :s_, :s_] if f == "sum_xi" else (
                    a[..., :s_, :] if f == "sum_t_nu" else a))
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol,
                                       atol=tol)


# ---------------------------------------------------------------------------
# B3: the recursion on a precomputed emission matrix (VHEM, DIC)
# ---------------------------------------------------------------------------

BF_ARGS = ("prior_b", "trans_b", "log_pi_r", "log_a_r", "ell")


def make_bwd_fwd_case(seed, kb=40, kr=3, sb=3, sr=3, d=2, lanes=(),
                      ragged=False, neg_inf=False):
    """Inputs of B3 in the order of BF_ARGS, as float64 numpy arrays: the
    base bank of make_case, a reduced point-estimate bank, and ell from
    the point E3logN, as the VHEM E-step forms them.  With ``neg_inf`` a
    zero transition gives log_a a -inf entry, as log(max(0, 1e-300))
    does in float32."""
    case = make_case(seed, kb, kr, sb, sr, d, lanes, ragged)
    rng = np.random.default_rng(seed + 100)
    shp = lanes + (kr, sr)
    pi = rng.dirichlet(np.ones(sr), shp[:-1])
    a = rng.dirichlet(np.ones(sr), shp)
    if neg_inf:
        a[..., 0, -1] = 0.0
        a = a / a.sum(-1, keepdims=True)
    with np.errstate(divide="ignore"):
        log_pi, log_a = np.log(pi), np.log(a)
    ell = tpe.expected_pair_ll_point(*port([case[2], case[3], case[6],
                                            case[7]])).numpy()
    return [case[0], case[1], log_pi, log_a, ell]


BF_CASES = {
    "tau10": dict(kw={}, tau=10),
    "tau1": dict(kw={}, tau=1),
    "tau2_ragged": dict(kw=dict(ragged=True), tau=2),
    "sr1": dict(kw=dict(sr=1), tau=4),
    "log_a_neg_inf": dict(kw=dict(sb=2, sr=3, neg_inf=True), tau=5),
    "sb9_sr12": dict(kw=dict(kb=6, kr=2, sb=9, sr=12), tau=4),
}


def test_expected_pair_ll_point_matches_jax_f64():
    """The point E3logN at rtol 1e-12 (the same closed form), with and
    without restart lanes; its result is a view of a Kb-last buffer, the
    layout B3 reads, so the wrapper copies nothing."""
    for lanes in ((), (3,)):
        case = make_case(11, kb=9, kr=2, sb=3, sr=3, lanes=lanes)
        mean_b, cov_b, mean_r, cov_r = case[2], case[3], case[6], case[7]
        if lanes:
            want = jax.vmap(lambda m, c: jpe.expected_pair_ll_point(
                jnp.asarray(mean_b), jnp.asarray(cov_b), m, c))(
                    jnp.asarray(mean_r), jnp.asarray(cov_r))
        else:
            want = jpe.expected_pair_ll_point(
                *map(jnp.asarray, (mean_b, cov_b, mean_r, cov_r)))
        got = tpe.expected_pair_ll_point(*port([mean_b, cov_b, mean_r,
                                                cov_r]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
        assert got.shape == lanes + (9, 2, 3, 3)
        assert got.movedim(-4, -1).is_contiguous()


@pytest.mark.parametrize("name", list(BF_CASES))
def test_bwd_fwd_plain_matches_jax_xla_f64(name):
    c = BF_CASES[name]
    case = make_bwd_fwd_case(12, **c["kw"])
    want = jpe.pair_bwd_fwd(*map(jnp.asarray, case), c["tau"])
    got = tpc.pair_bwd_fwd_auto(*port(case), c["tau"])
    for f in want._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-10, atol=1e-13, err_msg=f)


@pytest.mark.parametrize("name", list(BF_CASES))
def test_bwd_fwd_f32_matches_jax_pallas_kernel(name):
    """The JAX package's Pallas kernel B3 (``pair_bwd_fwd_pallas``,
    interpret mode) and the port's dispatch on the same float32 inputs,
    within the on-card gate 5e-5."""
    c = BF_CASES[name]
    case = [x.astype(np.float32) for x in make_bwd_fwd_case(13, **c["kw"])]
    want = jpp.pair_bwd_fwd_pallas(*map(jnp.asarray, case), c["tau"],
                                   tile=128, interpret=True)
    got = tpc.pair_bwd_fwd_auto(*port(case, torch.float32), c["tau"])
    for f in want._fields:
        err = rel_err(getattr(got, f).numpy(), getattr(want, f))
        assert err <= KERNEL_TOL, (f, err)


def test_bwd_fwd_lanes_f32_match_jax_vmapped_kernel():
    """Three restart lanes: the port's leading lane axis against jax.vmap
    of the JAX package's trial-folding wrapper of B3, as
    tests/test_pair_pallas.py folds it."""
    tau, lanes = 4, 3
    case = [x.astype(np.float32)
            for x in make_bwd_fwd_case(14, kb=24, kr=2, lanes=(lanes,))]
    f = jpp._pallas_vmappable(tau, interpret=True)
    want = jax.vmap(f, in_axes=(None, None, 0, 0, 0))(
        *map(jnp.asarray, case))
    got = tpc.pair_bwd_fwd_auto(*port(case, torch.float32), tau)
    for fld in want._fields:
        g = getattr(got, fld)
        assert g.shape[0] == lanes
        err = rel_err(g.numpy(), getattr(want, fld))
        assert err <= KERNEL_TOL, (fld, err)


@pytest.mark.parametrize("tau,name", [(1, "tau10"), (10, "log_a_neg_inf"),
                                      (50, "tau2_ragged")])
def test_b3_kernel_indexing_matches_loop_oracle(tau, name):
    """Kernel B3, which cannot run here, in NumPy: each pair reads its
    ell[b][r] from the wrapper's [L*Kr, Sb, Sr, Kb] buffer at
    ((j*Sb + b)*Sr + r)*Kb + i, runs the rebased recursion (the shared
    pair_recursion.cuh, transliterated in test_torch_pair_recursion.py),
    and writes the kernel's
    Kb-last outputs, which the wrapper unfolds.  Held to the loop oracle
    per pair and to the plain version through the unfold."""
    kw = dict(BF_CASES[name]["kw"], kb=5, kr=2, lanes=(2,))
    prior, trans, log_pi, log_a, ell = make_bwd_fwd_case(15, **kw)
    lanes, kb, kr, sb, sr = (2,), *ell.shape[1:]
    lkr = 2 * kr
    ell_t = torch.as_tensor(ell).movedim(-4, -1).contiguous().numpy().ravel()
    pi_f, a_f = log_pi.reshape(lkr, sr), log_a.reshape(lkr, sr, sr)
    outs = [np.zeros((lkr, kb)), np.zeros((lkr, sr, kb)),
            np.zeros((lkr, sr, sr, kb)), np.zeros((lkr, sr, sb, kb))]
    for j in range(lkr):
        for i in range(kb):
            e = np.array([[ell_t[((j * sb + b) * sr + r) * kb + i]
                           for r in range(sr)] for b in range(sb)])
            got = scaled_pair_transliteration(prior[i], trans[i], pi_f[j],
                                              a_f[j], e, tau)
            want = oracle_pair(prior[i], trans[i], pi_f[j], a_f[j], e, tau)
            np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
            for g, w in zip(got[1:4], want[1:]):
                np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-13)
            outs[0][j, i] = got[0]
            outs[1][j, :, i], outs[2][j, :, :, i] = got[1], got[2]
            outs[3][j, :, :, i] = got[3]
    unfolded = tpc._unfold(*map(torch.as_tensor, outs), lanes, kr, kb, sb,
                           sr)
    plain = tpe.pair_bwd_fwd(*port([prior, trans, log_pi, log_a, ell]), tau)
    for f in plain._fields:
        torch.testing.assert_close(getattr(unfolded, f), getattr(plain, f),
                                   rtol=1e-10, atol=1e-13)


def test_bwd_fwd_cpu_dispatch_never_launches():
    before = tpc.BWD_FWD_LAUNCHES
    tpc.pair_bwd_fwd_auto(*port(make_bwd_fwd_case(16, kb=8)), 3)
    assert tpc.BWD_FWD_LAUNCHES == before == 0
    assert _build._lib is None
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpc.pair_bwd_fwd_cuda(*port(make_bwd_fwd_case(16, kb=8)), 3)
    assert tpc.BWD_FWD_LAUNCHES == 0


def test_validate_bwd_fwd_rejects_what_the_kernel_cannot_take():
    case = make_bwd_fwd_case(17, kb=8, kr=2, sb=2, sr=2)
    t = dict(zip(BF_ARGS, port(case)))

    def call(tau=2, **over):
        return tpc.pair_bwd_fwd_auto(*[over.get(a, t[a]) for a in BF_ARGS],
                                     tau)
    with pytest.raises(ValueError, match="tau"):
        call(tau=0)
    with pytest.raises(ValueError, match="tau"):
        call(tau=2.5)
    with pytest.raises(ValueError, match="dtype"):
        tpc.pair_bwd_fwd_auto(*port(case, torch.float16), 2)
    with pytest.raises(ValueError, match="dtype"):
        call(log_a_r=t["log_a_r"].float())
    with pytest.raises(ValueError, match="meta"):
        call(trans_b=t["trans_b"].to("meta"))
    with pytest.raises(ValueError, match="shape"):
        call(ell=t["ell"][:, :1])
    with pytest.raises(ValueError, match="shape"):
        call(log_a_r=t["log_a_r"][None])
    with pytest.raises(ValueError, match="tensor"):
        call(prior_b=case[0])
    for kw in (dict(sb=9), dict(sr=9)):
        got = tpc.pair_bwd_fwd_auto(*port(make_bwd_fwd_case(18, kb=4, kr=1,
                                                            **kw)), 2)
        assert np.all(np.isfinite(got.ll_elbo.numpy()))
    for kw, msg in ((dict(kb=0), "empty bank"), (dict(sr=0), "no states")):
        with pytest.raises(ValueError, match=msg):
            tpc.pair_bwd_fwd_auto(*port(make_bwd_fwd_case(18, **dict(
                dict(kb=4, kr=1), **kw))), 2)
    # any strides: the wrapper lays the tensors out for the kernel
    def strided(x):
        y = x.transpose(0, 1).contiguous().transpose(0, 1)
        assert not y.is_contiguous()
        return y
    np.testing.assert_array_equal(
        call(ell=strided(t["ell"]), log_a_r=strided(t["log_a_r"]),
             trans_b=strided(t["trans_b"])).sum_xi.numpy(),
        call().sum_xi.numpy())
