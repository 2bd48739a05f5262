"""Empirical-Bayes hyperparameter optimization for both engines: the
counterpart of :mod:`vbhem_tpu.hyp`.

Parity map: `src/hmm/vbhmm_em_hyp.m` + `src/hmm/get_hypinfo.m` (VBEM),
`src/vbhem/vbhem_h3m_c_hyp.m` + `src/vbhem/vbhem_get_hypinfo.m` (VBHEM),
and the Rasmussen BFGS minimizer `src/util/minimize_new.m`.

As in the JAX package, the gradient is the autograd of the bound at the
EM fixed point with the posterior held fixed (the kernels' outputs are
constants to autograd, so no kernel needs a backward pass), and every
objective evaluation is a whole EM run from the same initial posterior
(`vbhmm_em_hyp.m:166-200`).  Two outer loops:

  * :func:`optimize_hyps`: SciPy's L-BFGS-B over one solution's
    transformed hyps;
  * :func:`lbfgs_box`: the JAX package's projected L-BFGS (``optax.lbfgs``
    with a backtracking line search, vmapped over lanes there) written out
    over an explicit lane axis, so that every probe of every lane still
    searching is one batched objective call, and :func:`optimize_hyps_batched`
    on top of it.

Transforms (`get_hypinfo.m:18-80`): alpha0/epsilon0/eta0/beta0/lambda0
-> log;  v0 -> log(v0 - D + 1);  W0 -> log W0 (diag);  mu0/m0 ->
identity.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import HypBounds
from .containers import tree_map


class HypSpec(NamedTuple):
    name: str
    transform: Callable      # hyp -> opt space (torch tensors)
    inverse: Callable        # opt space -> hyp
    size: int                # number of scalars
    lo: float                # bound in hyp space (lower)
    hi: float                # bound in hyp space (upper)


def _log_spec(name, lo, hi, size=1):
    return HypSpec(name, torch.log, torch.exp, size, lo, hi)


def _identity_spec(name, size):
    return HypSpec(name, lambda x: x, lambda x: x, size, -np.inf, np.inf)


def _v0_spec(d, bounds):
    return HypSpec("v0", lambda v: torch.log(v - (d - 1.0)),
                   lambda t: torch.exp(t) + (d - 1.0), 1,
                   bounds.v0_min + (d - 1.0), bounds.v0_max)


def vb_specs(dim: int, bounds: HypBounds, keys: Sequence[str]):
    """Learnable-hyp registry for the VBEM engine (get_hypinfo.m)."""
    table = {
        "alpha0": _log_spec("alpha0", bounds.alpha0_min, bounds.alpha0_max),
        "epsilon0": _log_spec("epsilon0", bounds.epsilon0_min,
                              bounds.epsilon0_max),
        "beta0": _log_spec("beta0", bounds.beta0_min, bounds.beta0_max),
        "v0": _v0_spec(dim, bounds),
        "w0": _log_spec("w0", bounds.w0_min, bounds.w0_max, size=dim),
        "mu0": _identity_spec("m0", dim),  # config key mu0 -> VBHyps.m0
    }
    return [table[k] for k in keys]


def vbhem_specs(dim: int, bounds: HypBounds, keys: Sequence[str]):
    """Learnable-hyp registry for VBHEM (vbhem_get_hypinfo.m)."""
    table = {
        "alpha0": _log_spec("alpha0", bounds.alpha0_min, bounds.alpha0_max),
        "eta0": _log_spec("eta0", bounds.eta0_min, bounds.eta0_max),
        "epsilon0": _log_spec("epsilon0", bounds.epsilon0_min,
                              bounds.epsilon0_max),
        "lambda0": _log_spec("lambda0", bounds.beta0_min, bounds.beta0_max),
        "v0": _v0_spec(dim, bounds),
        "w0": _log_spec("w0", bounds.w0_min, bounds.w0_max, size=dim),
        "m0": _identity_spec("m0", dim),
    }
    return [table[k] for k in keys]


def pack(hyps, specs) -> np.ndarray:
    """Hyps (unbatched) -> flat optimization vector (transform space),
    float64."""
    parts = []
    for s in specs:
        val = torch.atleast_1d(getattr(hyps, s.name).detach())
        parts.append(s.transform(val).cpu().double().numpy().ravel())
    return np.concatenate(parts)


def _cast_inside(val: torch.Tensor, dtype, spec: HypSpec) -> torch.Tensor:
    """``val`` in ``dtype``, kept inside the spec's box: where the cast
    rounds a value at the box's edge out of it, the nearest value of
    ``dtype`` inside.  v0's lower bound D - 1 + e^-20 is D - 1 in float32,
    where the bound's Wishart normalizer lgamma((v0 + 1 - D) / 2) is
    lgamma(0) = inf: the bound is -inf and every EM run under it goes on
    to max_iter."""
    out = val.to(dtype)
    if out.dtype == val.dtype:
        return out
    lo, hi = (torch.tensor(b, dtype=dtype) for b in (spec.lo, spec.hi))
    if float(lo) < spec.lo:
        lo = torch.nextafter(lo, torch.tensor(np.inf, dtype=dtype))
    if float(hi) > spec.hi:
        hi = torch.nextafter(hi, torch.tensor(-np.inf, dtype=dtype))
    return torch.clamp(out, float(lo), float(hi))


def unpack(theta: torch.Tensor, hyps_template, specs):
    """Flat vectors theta [..., P] -> hyps whose learned leaves carry
    theta's leading axes ([...] for scalars, [..., D] for m0 and w0), in
    the template's dtypes and inside their boxes in those dtypes
    (:func:`_cast_inside`); the leaves not learned stay the template's.
    Differentiable in theta."""
    out = hyps_template
    i = 0
    for s in specs:
        seg = theta[..., i: i + s.size]
        i += s.size
        val = s.inverse(seg)
        ref = getattr(hyps_template, s.name)
        if ref.dim() == 0:
            val = val[..., 0]
        out = out._replace(**{s.name: _cast_inside(val, ref.dtype, s)})
    return out


def _bound_pairs(specs):
    """Per scalar, its box in transform space; None for an identity hyp."""
    pairs = []
    for s in specs:
        if np.isinf(s.lo) and np.isinf(s.hi):
            pairs.extend([None] * s.size)
        else:
            lo = float(s.transform(torch.tensor(s.lo, dtype=torch.float64)))
            hi = float(s.transform(torch.tensor(s.hi, dtype=torch.float64)))
            pairs.extend([(lo, hi)] * s.size)
    return pairs


def transform_bounds(specs) -> list:
    """Box bounds in transform space for L-BFGS-B."""
    return [p if p is not None else (None, None) for p in _bound_pairs(specs)]


def bound_vectors(specs) -> Tuple[np.ndarray, np.ndarray]:
    """Box bounds in transform space as (lo, hi) vectors (identity-
    transformed hyps get +-inf)."""
    pairs = [p if p is not None else (-np.inf, np.inf)
             for p in _bound_pairs(specs)]
    return (np.asarray([p[0] for p in pairs]),
            np.asarray([p[1] for p in pairs]))


def optimize_hyps(objective, hyps0, specs,
                  max_evals: int = 100) -> Tuple[object, dict]:
    """Box-constrained quasi-Newton outer loop: SciPy's L-BFGS-B over the
    transformed hyps of one solution.

    ``objective(hyps) -> -elbo`` (a 0-d tensor, differentiable in the hyps
    pytree); the gradient is ``torch.autograd.grad`` of the composition
    theta -> hyps -> -elbo, so the transform chain rule of
    `vbhmm_em_lb.m:387-396` falls out of autograd.  Returns (optimized
    hyps, info)."""
    from scipy.optimize import minimize

    dev = hyps0.alpha0.device
    theta0 = pack(hyps0, specs)

    def scipy_fun(theta_np):
        theta = torch.tensor(theta_np, dtype=torch.float64, device=dev,
                             requires_grad=True)
        with torch.enable_grad():
            v = objective(unpack(theta, hyps0, specs))
            g = _grad(v, theta)
        v = float(v.detach())
        g = g.cpu().numpy()
        if not np.isfinite(v):
            # unstable model: L=-inf in the reference; tell the line
            # search to back off
            return 1e300, np.zeros_like(g)
        return v, g

    res = minimize(scipy_fun, theta0, jac=True, method="L-BFGS-B",
                   bounds=transform_bounds(specs),
                   options={"maxfun": max_evals, "ftol": 1e-12,
                            "gtol": 1e-8})
    hyps_opt = tree_map(torch.Tensor.detach, unpack(
        torch.tensor(res.x, dtype=torch.float64, device=dev), hyps0, specs))
    return hyps_opt, {"fun": float(res.fun), "nfev": int(res.nfev),
                      "converged": bool(res.success),
                      "message": str(res.message)}


def _grad(v: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """d sum(v) / d theta; zeros where v does not depend on theta."""
    if not v.requires_grad:
        return torch.zeros_like(theta)
    (g,) = torch.autograd.grad(v.sum(), theta, allow_unused=True)
    return torch.zeros_like(theta) if g is None else g


class _Clip(torch.autograd.Function):
    """``jnp.clip``'s value and derivative: 1 inside the box, 1/2 exactly
    at a bound (where max/min split a tie), 0 outside.  torch.clamp's
    derivative is 1 at a bound, which would change the line search's
    stored gradients."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x, lo, hi)
        return torch.minimum(torch.maximum(x, lo), hi)

    @staticmethod
    def backward(ctx, g):
        x, lo, hi = ctx.saved_tensors
        half = torch.full_like(x, 0.5)
        w_lo = torch.where(x > lo, torch.ones_like(x),
                           torch.where(x == lo, half, torch.zeros_like(x)))
        w_hi = torch.where(x < hi, torch.ones_like(x),
                           torch.where(x == hi, half, torch.zeros_like(x)))
        return g * w_lo * w_hi, None, None


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


class _Memory(NamedTuple):
    """``optax.scale_by_lbfgs``'s state, one row per lane."""
    count: torch.Tensor     # [n] int64
    params: torch.Tensor    # [n, P]
    updates: torch.Tensor   # [n, P]
    dw: torch.Tensor        # [n, M, P] parameter differences
    du: torch.Tensor        # [n, M, P] gradient differences
    rho: torch.Tensor       # [n, M]


def _vdot(a, b):
    return torch.sum(a * b, dim=-1)


def _lbfgs_direction(g, theta, mem: _Memory):
    """``optax.scale_by_lbfgs``'s update on lanes (``scale_init_precond``
    on, its default): store the newest (parameter, gradient) difference,
    then precondition ``g`` by the two-loop recursion (Nocedal & Wright,
    algorithm 7.4).  Returns (P g, new memory)."""
    n, m = mem.rho.shape
    rows = torch.arange(n, device=g.device)
    memory_idx = torch.remainder(mem.count, m)
    prev_idx = torch.remainder(mem.count - 1, m)
    first = (mem.count > 0)
    diff_params = theta - mem.params
    diff_updates = g - mem.updates
    vdot_pu = _vdot(diff_updates, diff_params)
    weight = torch.where(vdot_pu == 0.0, torch.zeros_like(vdot_pu),
                         1.0 / vdot_pu)
    diff_params = torch.where(first[:, None], diff_params,
                              torch.zeros_like(diff_params))
    diff_updates = torch.where(first[:, None], diff_updates,
                               torch.zeros_like(diff_updates))
    weight = torch.where(first, weight, torch.zeros_like(weight))
    dw, du, rho = mem.dw.clone(), mem.du.clone(), mem.rho.clone()
    dw[rows, prev_idx] = diff_params
    du[rows, prev_idx] = diff_updates
    rho[rows, prev_idx] = weight

    num = _vdot(diff_updates, diff_params)
    den = _vdot(diff_updates, diff_updates)
    scale = torch.where(den > 0.0, num / den, torch.ones_like(num))
    # the first step: a capped reciprocal of the gradient norm
    capped = torch.clamp(1.0 / torch.sqrt(_vdot(g, g)), max=1.0)
    scale = torch.where(first, scale, capped)

    vec = g
    order = torch.remainder(memory_idx[:, None]
                            + torch.arange(m, device=g.device), m)  # [n, M]
    alphas = [None] * m
    for j in reversed(range(m)):
        idx = order[:, j]
        a = rho[rows, idx] * _vdot(dw[rows, idx], vec)
        vec = vec + (-a)[:, None] * du[rows, idx]
        alphas[j] = a
    vec = scale[:, None] * vec
    for j in range(m):
        idx = order[:, j]
        b = rho[rows, idx] * _vdot(du[rows, idx], vec)
        vec = vec + (alphas[j] - b)[:, None] * dw[rows, idx]
    return vec, _Memory(count=mem.count + 1, params=theta, updates=g,
                        dw=dw, du=du, rho=rho)


# optax.lbfgs's memory and the JAX package's line search: at most
# MAX_BACKTRACKING + 1 probes a step (`vbhem_tpu/hyp.py:217-219`)
MEMORY_SIZE = 10
MAX_BACKTRACKING = 10


def lbfgs_box(fun, theta0: torch.Tensor, lo, hi, max_steps: int = 50,
              gtol: float = 1e-8, ftol: float = 1e-12,
              stats: Optional[dict] = None):
    """Box-constrained L-BFGS on every lane of ``theta0`` [n, P] at once:
    :func:`vbhem_tpu.hyp.lbfgs_box` (``optax.lbfgs`` with
    ``scale_by_backtracking_linesearch(max_backtracking_steps=10,
    store_grad=True)``, vmapped over lanes there) with the lane axis
    written out.

    ``fun(theta, lanes) -> values``: theta [k, P] (already clipped into
    the box) for the lanes ``lanes`` (an int64 tensor of k lane indices),
    returning [k] values differentiable in theta, each depending on its
    own row only.  Each round of evaluations is ONE call over the lanes
    that need a value: every lane at its first step, then every lane
    still probing its line search; a lane that has accepted its step, or
    has stopped, waits.

    What the JAX function adds around optax is kept: probes are evaluated
    at their projection into the box (with ``jnp.clip``'s derivative),
    non-finite values map to 1e30, gradient components pushing out of an
    active bound are zeroed, the new iterate is clipped into the box, and
    the best iterate seen is returned (the objective, a whole EM run per
    evaluation, is not monotone along L-BFGS steps), the last iterate
    included.  A lane stops when its step count reaches ``max_steps``,
    its stored gradient's norm falls below ``gtol``, or its value moved
    by at most ``ftol`` relative.

    Returns (theta_opt clipped into the box [n, P], best values [n],
    steps [n]); ``stats`` (a dict), if given, receives the number of
    objective calls ('calls') and of lane evaluations ('lane_evals')."""
    squeeze = theta0.dim() == 1
    theta0 = torch.atleast_2d(theta0)
    dtype, dev = theta0.dtype, theta0.device
    lo = torch.as_tensor(lo, dtype=dtype, device=dev)
    hi = torch.as_tensor(hi, dtype=dtype, device=dev)
    n, p = theta0.shape
    big = torch.tensor(1e30, dtype=dtype, device=dev)
    calls = [0, 0]

    def evaluate(th, lanes, grad=True):
        """Safe value (and gradient) of ``fun`` at the probes ``th``."""
        calls[0] += 1
        calls[1] += int(lanes.numel())
        if not grad:
            with torch.no_grad():
                v = fun(_clip(th, lo, hi), lanes).to(dtype)
                return torch.where(torch.isfinite(v), v, big), None
        th = th.detach().requires_grad_(True)
        with torch.enable_grad():
            v = fun(_Clip.apply(th, lo, hi), lanes).to(dtype)
            v = torch.where(torch.isfinite(v), v, big)
            g = _grad(v, th)
        return v.detach(), g.detach()

    theta = _clip(theta0, lo, hi)
    zeros_np = torch.zeros((n, p), dtype=dtype, device=dev)
    mem = _Memory(count=torch.zeros(n, dtype=torch.int64, device=dev),
                  params=zeros_np.clone(), updates=zeros_np.clone(),
                  dw=torch.zeros((n, MEMORY_SIZE, p), dtype=dtype,
                                 device=dev),
                  du=torch.zeros((n, MEMORY_SIZE, p), dtype=dtype,
                                 device=dev),
                  rho=torch.zeros((n, MEMORY_SIZE), dtype=dtype, device=dev))
    ls_lr = torch.ones(n, dtype=dtype, device=dev)
    ls_value = torch.full((n,), float("inf"), dtype=dtype, device=dev)
    ls_grad = zeros_np.clone()
    best_theta = theta.clone()
    best_v = torch.full((n,), 1e30, dtype=dtype, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)

    while not bool(torch.all(done)):
        a = torch.nonzero(~done).flatten()
        th = theta[a]
        # optax.value_and_grad_from_state: the stored value and gradient
        # of the accepted probe, or a fresh evaluation where none is
        v, g = ls_value[a].clone(), ls_grad[a].clone()
        fresh = ~torch.isfinite(v)
        if bool(torch.any(fresh)):
            vf, gf = evaluate(th[fresh], a[fresh])
            v[fresh], g[fresh] = vf, gf
        ok = torch.isfinite(v) & torch.all(torch.isfinite(g), dim=-1)
        v = torch.where(ok, v, big)
        g = torch.where(ok[:, None], g, torch.zeros_like(g))
        better = v < best_v[a]
        best_theta[a] = torch.where(better[:, None], th, best_theta[a])
        best_v[a] = torch.where(better, v, best_v[a])
        # projected gradient: zero the components pushing out of an
        # active bound
        outward = ((th <= lo) & (g > 0)) | ((th >= hi) & (g < 0))
        g = torch.where(outward, torch.zeros_like(g), g)

        sub = _Memory(*[f[a] for f in mem])
        direction, sub = _lbfgs_direction(g, th, sub)
        for f_all, f_new in zip(mem, sub):
            f_all[a] = f_new
        updates = -direction
        slope = _vdot(updates, g)

        # backtracking line search (Armijo), store_grad=True
        lr = torch.clamp(1.5 * ls_lr[a], max=1.0)
        new_value = v.clone()
        new_grad = torch.zeros_like(g)
        dec_err = torch.full_like(v, float("inf"))
        it = torch.zeros(len(a), dtype=torch.int64, device=dev)
        searching = torch.ones(len(a), dtype=torch.bool, device=dev)
        while bool(torch.any(searching)):
            s = torch.nonzero(searching).flatten()
            lr_s = torch.where(it[s] > 0, 0.8 * lr[s], lr[s])
            lr[s] = lr_s
            probe = th[s] + lr_s[:, None] * updates[s]
            nv, ng = evaluate(probe, a[s])
            de = nv - v[s] - lr_s * 1e-4 * slope[s]
            de = torch.where(torch.isnan(de), torch.full_like(de, np.inf), de)
            de = torch.clamp(de, min=0.0)
            take = (de <= 0.0) | (it[s] == MAX_BACKTRACKING)
            new_grad[s] = torch.where(take[:, None], ng, new_grad[s])
            new_value[s] = nv
            dec_err[s] = de
            it[s] = it[s] + 1
            searching[s] = ~(de <= 0.0) & (it[s] <= MAX_BACKTRACKING)
        step_lr = torch.where(torch.isinf(dec_err), torch.zeros_like(lr), lr)
        ls_lr[a], ls_value[a], ls_grad[a] = step_lr, new_value, new_grad

        th_new = th + step_lr[:, None] * updates
        th_new = torch.where(torch.all(torch.isfinite(th_new), dim=-1)[:, None],
                             th_new, th)
        theta[a] = _clip(th_new, lo, hi)

        # the stop rule (`cont`), on the state after the step
        count = mem.count[a]
        small_grad = torch.sqrt(_vdot(new_grad, new_grad)) < gtol
        small_step = torch.abs(new_value - v) <= ftol * torch.clamp(
            torch.abs(new_value), min=1.0)
        cont = (count == 0) | ((count < max_steps) & ~small_grad
                               & ~small_step)
        done[a] = ~cont

    # the last iterate's value is known only once evaluated: compare it
    # too, so that a last accepted improvement is not lost
    lanes = torch.arange(n, device=dev)
    v_last, _ = evaluate(theta, lanes, grad=False)
    better = v_last < best_v
    best_theta = torch.where(better[:, None], _clip(theta, lo, hi), best_theta)
    best_v = torch.where(better, v_last, best_v)
    if stats is not None:
        stats["calls"] = stats.get("calls", 0) + calls[0]
        stats["lane_evals"] = stats.get("lane_evals", 0) + calls[1]
    out = (_clip(best_theta, lo, hi), best_v, mem.count)
    return tuple(x[0] for x in out) if squeeze else out


def optimize_hyps_batched(neg_elbo_fn, hyps0, specs, n_lanes: int,
                          max_steps: int = 50, stats: Optional[dict] = None):
    """Empirical-Bayes hyp optimization, one L-BFGS per lane, all lanes
    together (:func:`lbfgs_box`): the lane-batched form of the reference's
    parfor over unique restart solutions (`vbhem_h3m_c.m:96-160`,
    `vbhmm_learn.m:498-552`).

    ``neg_elbo_fn(hyps, lanes) -> [k]``: the negative bound of the lanes
    ``lanes`` (int64 indices) under ``hyps``, whose learned leaves carry
    a leading axis of k (already clipped into the box).  The objective
    sizes its own work (an EM over the k lanes, chunked as it needs).
    Returns (hyps with a leading lane axis of ``n_lanes``, final values,
    L-BFGS steps per lane)."""
    dev = hyps0.alpha0.device
    theta0 = torch.as_tensor(pack(hyps0, specs), device=dev)
    lo_np, hi_np = bound_vectors(specs)

    def fun(theta, lanes):
        return neg_elbo_fn(unpack(theta, hyps0, specs), lanes)

    theta_b, vals, iters = lbfgs_box(
        fun, theta0.expand(n_lanes, -1).clone(), lo_np, hi_np,
        max_steps=max_steps, stats=stats)
    hyps_b = unpack(theta_b, hyps0, specs)
    # leaves not learned get the lane axis too, so every leaf is per lane
    hyps_b = type(hyps_b)(*[
        h if h.dim() > h0.dim() else h.expand((n_lanes,) + h.shape).clone()
        for h, h0 in zip(hyps_b, hyps0)])
    return hyps_b, vals, iters


def tally(stats: Optional[dict], key: str, n: int):
    """Add ``n`` to ``stats[key]``; no-op without ``stats``."""
    if stats is not None:
        stats[key] = stats.get(key, 0) + n


def revert_lanes(sts, pre, hyps_b, hyps0, stats: dict, verbose: int = 0):
    """The repairs after a hyp stage (the monotone contract, C2): lanes
    whose bound degraded or went degenerate take back their
    pre-optimization state (:func:`fallback_degenerate_lanes`) and hyps
    (:func:`substitute_lanes`).  Returns (states, hyps, the stage's counts
    under 'hyp_*' keys from ``stats`` and the lanes' bounds before and
    after)."""
    sts, n_bad, bad = fallback_degenerate_lanes(sts, pre, pre.ll, sts.ll)
    hyps_b = substitute_lanes(hyps_b, hyps0, bad)
    if n_bad and verbose >= 1:
        print(f"  [hyp] {n_bad} degenerate or degraded hyp-optimized "
              f"lane(s) reverted to their pre-optimization solutions",
              flush=True)
    info = {"hyp_lanes": int(pre.ll.shape[0]), "hyp_steps": stats["steps"],
            "hyp_calls": stats["calls"], "hyp_lane_evals": stats["lane_evals"],
            "hyp_em_iters": stats["em_iters"], "hyp_e_steps": stats["e_steps"],
            "hyp_reverted": n_bad, "hyp_ll_pre": _host(pre.ll),
            "hyp_ll_post": _host(sts.ll)}
    return sts, hyps_b, info


def lane_slice(hyps, sl):
    """The lanes ``sl`` (a slice or index tensor) of hyps whose leaves may
    carry a leading lane axis (scalars [n], m0 and w0 [n, D]); unbatched
    leaves are shared by every lane and stay as they are."""
    def one(name, h):
        own = 1 if name in ("m0", "w0") else 0
        return h[sl] if h.dim() > own else h
    return type(hyps)(*[one(n, h) for n, h in zip(hyps._fields, hyps)])


def degenerate_mask(ll_pre, ll_post) -> np.ndarray:
    """Lanes whose hyp-optimized solution is degenerate
    (:func:`vbhem_tpu.hyp.degenerate_mask`): the reference only warns on
    `abs(LL_old./LL)>10` (`vbhmm_learn.m:567-571`, `vbhem_h3m_c.m:175-180`);
    here such lanes fall back to their pre-optimization solution:
      |post| < |pre|/10, pre < 0 and post > |pre| (a sign-flipped
      blow-up), or post non-finite while pre is finite."""
    pre = np.asarray(ll_pre, np.float64)
    post = np.asarray(ll_post, np.float64)
    finite_pre = np.isfinite(pre)
    bad = (~np.isfinite(post)) & finite_pre
    with np.errstate(invalid="ignore"):
        bad |= finite_pre & (np.abs(post) < np.abs(pre) / 10.0)
        bad |= finite_pre & (pre < 0) & (post > np.abs(pre))
    return bad


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


def _pick_lanes(bad: np.ndarray, new, old):
    """``old`` where ``bad`` (over the leading lane axis), else ``new``."""
    b = torch.as_tensor(bad, device=new.device)
    b = b.reshape(b.shape + (1,) * (new.dim() - b.dim()))
    return torch.where(b, torch.broadcast_to(old, new.shape).to(new.dtype),
                       new)


def fallback_degenerate_lanes(post_states, pre_states, ll_pre, ll_post):
    """Replace degenerate OR degraded hyp-optimized lanes (leading axis)
    with their pre-optimization states; returns (states, n_reverted,
    bad_mask).  A lane whose post-optimization bound is below its
    pre-optimization bound by more than max(1e-6 |pre|, 1e-3) reverts:
    the reference's `minimize_new` is monotone from hyps0, so post >= pre
    there by construction (the monotone contract, `RESULTS.md:35-47`).
    Callers keeping per-lane learned hyps revert those too
    (:func:`substitute_lanes`)."""
    bad = degenerate_mask(_host(ll_pre), _host(ll_post))
    pre = _host(ll_pre)
    post = _host(ll_post)
    with np.errstate(invalid="ignore"):
        tol = np.maximum(1e-6 * np.abs(pre), 1e-3)
        bad |= np.isfinite(pre) & ~(post >= pre - tol)
    if not bad.any():
        return post_states, 0, bad
    return (tree_map(lambda new, old: _pick_lanes(bad, new, old),
                     post_states, pre_states), int(bad.sum()), bad)


def substitute_lanes(hyps_b, hyps0, bad: np.ndarray):
    """The unbatched pre-optimization hyps ``hyps0`` in place of the
    lane-batched ``hyps_b`` wherever ``bad``, so reverted lanes carry the
    hyps their kept state converged under."""
    bad = np.asarray(bad)
    if not bad.any():
        return hyps_b
    return tree_map(lambda hb, h0: _pick_lanes(bad, hb, h0), hyps_b, hyps0)


def pad_lanes(idx: np.ndarray, bucket: int = 4) -> np.ndarray:
    """Pad a lane-index vector to the next multiple of ``bucket`` by
    repeating the first lane (the JAX package's static lane buckets;
    duplicates change no selection)."""
    idx = np.asarray(idx)
    rem = (-len(idx)) % bucket
    if rem:
        idx = np.concatenate([idx, np.full((rem,), idx[0], idx.dtype)])
    return idx


def unique_ll(lls, min_diff: float = 1e-5) -> np.ndarray:
    """Indices of unique restart solutions by LL, best first
    (`src/util/uniqueLL.m:41-80`): two LLs are duplicates when their
    relative difference is below 2 * min_diff * 10; non-finite LLs are
    dropped."""
    lls = np.asarray(lls, dtype=np.float64)
    order = np.argsort(-lls)
    thresh = 2.0 * min_diff * 10.0
    kept: list = []
    for i in order:
        if not np.isfinite(lls[i]):
            continue
        dup = any(abs(lls[i] - lls[j])
                  / max(abs(lls[j]), 1e-300) < thresh for j in kept)
        if not dup:
            kept.append(int(i))
    return np.asarray(kept, dtype=np.int64)
