"""The port's log-depth forward-backward ``ops.fb.forward_backward_assoc``
against the JAX package's (``vbhem_tpu.ops.fb.forward_backward_assoc``)
and against the port's sequential ``forward_backward``, in float64 at the
tolerances tests/test_fb.py:178-196 holds the JAX one to (gamma atol
1e-9, xi_sum atol 1e-8, phi_norm rtol 1e-10): the case of that test
(n=6, T=33, K=4, ragged), lane-leading shapes with per-sequence scores,
T not a power of two, two steps and a single step."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbhem_tpu.ops import fb as jfb
from vbhem_tpu_torch.ops import fb as tfb


def jax_case(seed=7, n=6, t_max=33, k=4):
    """tests/test_fb.py:178-196's inputs."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, t_max + 1, size=n)
    lengths[0] = t_max
    mask = np.arange(t_max)[None, :] < lengths[:, None]
    log_rho = rng.normal(size=(n, t_max, k)) * 3.0
    log_pz1 = np.log(rng.dirichlet(np.ones(k))) - 0.2
    log_trans = np.log(rng.dirichlet(np.ones(k), size=k)) - 0.2
    return log_pz1, log_trans, log_rho, mask


def lane_case(seed, lanes, n, t_max, k):
    """Per-sequence scores on lane axes, ragged lengths with a length-1
    sequence."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, t_max + 1, size=lanes + (n,))
    lengths[..., 0] = t_max
    lengths[..., -1] = 1
    mask = np.arange(t_max) < lengths[..., None]
    log_rho = rng.normal(size=lanes + (n, t_max, k)) * 3.0
    log_pz1 = np.log(rng.dirichlet(np.ones(k), size=lanes + (n,))) - 0.2
    log_trans = np.log(rng.dirichlet(np.ones(k),
                                     size=lanes + (n, k))) - 0.2
    return log_pz1, log_trans, log_rho, mask


def close(got, want):
    np.testing.assert_array_equal(np.asarray(got.log_rho),
                                  np.asarray(want.log_rho))
    np.testing.assert_allclose(np.asarray(got.gamma), np.asarray(want.gamma),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(got.xi_sum),
                               np.asarray(want.xi_sum), rtol=0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(got.phi_norm),
                               np.asarray(want.phi_norm), rtol=1e-10)


def torch_args(case):
    return [torch.as_tensor(a) for a in case]


@pytest.mark.parametrize("t_max", [33, 1])
def test_assoc_matches_jax(t_max):
    """The JAX function runs eagerly, as tests/test_fb.py runs it: on this
    package's CPU XLA its jitted form is off by up to 0.64 in gamma on
    this case, while the eager one agrees with the sequential pass."""
    case = jax_case()
    if t_max == 1:   # the JAX function indexes the empty scan's last step
        lp, lt, lr, m = case
        case = (lp, lt, lr[:, :1], m[:, :1])
        want = jfb.forward_backward(*[jnp.asarray(a) for a in case])
    else:
        want = jfb.forward_backward_assoc(*[jnp.asarray(a) for a in case])
    close(tfb.forward_backward_assoc(*torch_args(case)), want)


@pytest.mark.parametrize("lanes,t_max,k", [((), 33, 4), ((2, 3), 45, 3),
                                           ((3,), 100, 2), ((2,), 2, 4)])
def test_assoc_matches_sequential(lanes, t_max, k):
    """Against the port's sequential pass: the JAX case, and lane-leading
    per-sequence scores at lengths that are not powers of two."""
    case = jax_case() if not lanes else lane_case(3, lanes, 5, t_max, k)
    args = torch_args(case)
    close(tfb.forward_backward_assoc(*args), tfb.forward_backward(*args))
