"""The port's foundations (config, containers, numeric primitives,
conversion) against the JAX package on the same float64 inputs, made
from a numpy seed.  Tolerance rtol 1e-12: the same closed forms in the
same precision, differing only in the order of a few roundings."""
import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbhem_tpu import config as jconfig
from vbhem_tpu import containers as jc
from vbhem_tpu.utils import numeric as jn
from vbhem_tpu_torch import config as tconfig
from vbhem_tpu_torch import containers as tc
from vbhem_tpu_torch import convert
from vbhem_tpu_torch.utils import numeric as tn

RTOL = 1e-12


def spd(rng, shape, d):
    a = rng.normal(size=shape + (d, d))
    return np.einsum("...de,...fe->...df", a, a) + d * np.eye(d)


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_config_defaults_match():
    for name in ("HypBounds", "VBConfig", "VBHEMConfig", "HEMConfig"):
        assert (dataclasses.asdict(getattr(tconfig, name)())
                == dataclasses.asdict(getattr(jconfig, name)())), name
    for d in (1, 2, 3, 4):
        assert (tconfig.VBHEMConfig().default_m0(d)
                == jconfig.VBHEMConfig().default_m0(d))


@pytest.mark.parametrize("d", [1, 2, 3, 5])
def test_inv_logdet_psd(d):
    a = spd(np.random.default_rng(d), (4, 3), d)
    close(tn.inv_psd(torch.as_tensor(a)), jn.inv_psd(jnp.asarray(a)))
    close(tn.logdet_psd(torch.as_tensor(a)), jn.logdet_psd(jnp.asarray(a)))
    # and against numpy's own inverse / determinant
    close(tn.inv_psd(torch.as_tensor(a)), np.linalg.inv(a), rtol=1e-10,
          atol=1e-14)
    close(tn.logdet_psd(torch.as_tensor(a)), np.linalg.slogdet(a)[1],
          rtol=1e-10)


def test_digamma_expectations_and_normalizers():
    rng = np.random.default_rng(1)
    conc = rng.uniform(0.1, 40.0, size=(3, 4, 5))
    for fn in ("e_log_dirichlet", "log_dirichlet_const"):
        close(getattr(tn, fn)(torch.as_tensor(conc)),
              getattr(jn, fn)(jnp.asarray(conc)))
    for d in (1, 2, 3):
        v = rng.uniform(d + 1.5, 50.0, size=(4, 3))
        w = spd(rng, (4, 3), d) * 0.1
        close(tn.e_log_det_lambda(torch.as_tensor(v), torch.as_tensor(w)),
              jn.e_log_det_lambda(jnp.asarray(v), jnp.asarray(w)))
        ld = rng.normal(size=(4, 3))
        close(tn.log_wishart_b(torch.as_tensor(ld), torch.as_tensor(v), d),
              jn.log_wishart_b(jnp.asarray(ld), jnp.asarray(v), d))
    # scalar v, as the ELBO passes the prior's v0
    close(tn.log_wishart_b(torch.tensor(-1.3, dtype=torch.float64), 5.0, 2),
          jn.log_wishart_b(jnp.asarray(-1.3), jnp.asarray(5.0), 2))


def test_logsumexp_and_small_helpers():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(5, 4)) * 30
    a[1] = -np.inf                  # all -inf row: the finite-max guard
    a[2, 1] = -1e30
    for dim in (0, 1, -1):
        for keep in (False, True):
            close(tn.logsumexp(torch.as_tensor(a), dim=dim, keepdim=keep),
                  jn.logsumexp(jnp.asarray(a), axis=dim, keepdims=keep))
    m = rng.normal(size=(2, 3, 3))
    close(tn.sym(torch.as_tensor(m)), jn.sym(jnp.asarray(m)))
    for dt in (torch.float32, torch.float64):
        npdt = np.float32 if dt == torch.float32 else np.float64
        assert tn.tiny(dt) == float(jn.tiny(npdt))


def _jax_niw(rng, lanes, k, d):
    return jc.NIW(beta=jnp.asarray(rng.uniform(1, 5, lanes + (k,))),
                  v=jnp.asarray(rng.uniform(0.5, 9, lanes + (k,))),
                  m=jnp.asarray(rng.normal(size=lanes + (k, d))),
                  w=jnp.asarray(spd(rng, lanes + (k,), d)))


@pytest.mark.parametrize("d", [2, 3])
def test_expected_cov_to_h3m_to_point(d):
    rng = np.random.default_rng(3 + d)
    niw = _jax_niw(rng, (2,), 3, d)       # v on both sides of D + 1
    close(convert.to_torch(niw, device="cpu").expected_cov(),
          niw.expected_cov())

    eps = rng.uniform(0.1, 4, (2, 3, 3))
    eps[0, 1] = 0.0                        # an all-zero row stays zero
    jpost = jc.H3MPosterior(alpha=jnp.asarray(rng.uniform(1, 9, (2,))),
                            eta=jnp.asarray(rng.uniform(1, 9, (2, 3))),
                            epsilon=jnp.asarray(eps), niw=niw)
    got = convert.to_torch(jpost, device="cpu").to_h3m()
    want = jpost.to_h3m()
    assert isinstance(got, tc.H3M)
    for g, w in zip(convert.to_numpy(got.hmm), want.hmm):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL)
    close(got.omega, want.omega)
    assert np.array_equal(convert.to_numpy(got.state_mask),
                          np.asarray(want.state_mask))

    jhp = jc.HMMPosterior(alpha=jpost.eta[0], epsilon=jpost.epsilon[0],
                          niw=jc.NIW(*[f[0] for f in niw]))
    for g, w in zip(convert.to_torch(jhp, device="cpu").to_point(),
                    jhp.to_point()):
        close(g, w)


def test_pack_sequences_and_seqbatch():
    rng = np.random.default_rng(7)
    seqs = [rng.normal(size=(t, 2)) for t in (5, 3, 7)]
    got, want = tc.pack_sequences(seqs, device="cpu"), jc.pack_sequences(seqs)
    close(got.x, want.x)
    close(got.lengths, want.lengths)
    assert np.array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert int(got.total) == int(want.total)


def test_convert_round_trip_numpy_port_numpy():
    rng = np.random.default_rng(8)
    kb, sb, d = 5, 3, 2
    bank = jc.H3M(omega=np.full((kb,), 1.0 / kb),
                  hmm=jc.HMM(prior=rng.dirichlet(np.ones(sb), kb),
                             trans=rng.dirichlet(np.ones(sb), (kb, sb)),
                             mean=rng.normal(size=(kb, sb, d)),
                             cov=spd(rng, (kb, sb), d)),
                  state_mask=np.ones((kb, sb), bool))
    t = convert.to_torch(bank, device="cpu")
    assert isinstance(t, tc.H3M) and isinstance(t.hmm, tc.HMM)
    assert t.hmm.mean.dtype == torch.float64
    assert t.state_mask.dtype == torch.bool
    back = convert.to_numpy(t)
    for g, w in zip(back.hmm, bank.hmm):
        assert isinstance(g, np.ndarray)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(back.state_mask, bank.state_mask)
    # dtype cast applies to floating leaves only
    t32 = convert.to_torch(bank, device="cpu", dtype=torch.float32)
    assert t32.hmm.cov.dtype == torch.float32
    assert t32.state_mask.dtype == torch.bool
    unknown = collections.namedtuple("Unknown", ["foo", "bar"])(1.0, 2.0)
    with pytest.raises(TypeError):
        convert.to_torch(unknown, device="cpu")


def test_entry_points_default_to_the_card():
    """Constructors that build tensors from host data put them on "cuda"
    unless told otherwise: with no card they raise, and never quietly
    return CPU tensors."""
    from vbhem_tpu_torch.models import vbhem, vbhmm
    from vbhem_tpu_torch.utils import planted
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults build on it")
    rng = np.random.default_rng(9)
    seqs = [rng.normal(size=(4, 2))]
    post = tc.HMMPosterior(alpha=torch.ones(2), epsilon=torch.ones(2, 2),
                           niw=tc.NIW(beta=torch.ones(2),
                                      v=torch.full((2,), 5.0),
                                      m=torch.zeros(2, 2),
                                      w=torch.eye(2).repeat(2, 1, 1)))
    res = tc.VBHMMResult(post=post, model=post.to_point(),
                         ll=torch.tensor(0.0), gamma=torch.zeros(1, 1, 2),
                         counts_n1=torch.ones(2), counts=torch.ones(2),
                         trans_counts=torch.ones(2, 2))
    calls = {
        "pack_sequences": lambda: tc.pack_sequences(seqs),
        "h3m_from_results": lambda: vbhem.h3m_from_results([res]),
        "h3m_from_hmms": lambda: vbhem.h3m_from_hmms([res.model]),
        "VBHEMHyps.from_config": lambda: vbhem.VBHEMHyps.from_config(
            tconfig.VBHEMConfig(), 2),
        "VBHyps.from_config": lambda: vbhmm.VBHyps.from_config(
            tconfig.VBConfig(), 2),
        "to_torch": lambda: convert.to_torch(np.ones(3)),
        "synthetic_subjects": lambda: planted.synthetic_subjects(1, 2, 3),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for explicitly, the CPU still works
    assert tc.pack_sequences(seqs, device="cpu").x.device.type == "cpu"
    assert vbhem.h3m_from_results([res], device="cpu").omega.device.type \
        == "cpu"


def test_port_imports_with_jax_blocked():
    """No module of the port, and not chip_smoke.py or the profiler,
    imports jax or the JAX package."""
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vbhem_tpu'] = None\n"
        "import vbhem_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    vbhem_tpu_torch.__path__, 'vbhem_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "sys.path.insert(0, 'tools')\n"
        "import chip_smoke, profile_em, restart_success\n"
        "print(' '.join(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 25
    assert {"vbhem_tpu_torch.models.vhem", "vbhem_tpu_torch.models.dic",
            "vbhem_tpu_torch.ops.kmeans", "vbhem_tpu_torch.utils.metrics",
            "vbhem_tpu_torch.experiments.synthetic",
            "vbhem_tpu_torch.models.vbhmm_groups",
            "vbhem_tpu_torch.models.hyp_heuristics",
            "vbhem_tpu_torch.utils.io", "vbhem_tpu_torch.utils.xls",
            "vbhem_tpu_torch.utils.native_io", "vbhem_tpu_torch.utils.plots",
            "vbhem_tpu_torch.utils.profiling",
            "vbhem_tpu_torch.experiments.demo_fixations"} <= names
