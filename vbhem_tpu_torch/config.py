"""Typed configuration for the three engines: the dataclasses of
:mod:`vbhem_tpu.config`, with the same fields and defaults.

Replaces the reference's `setdefault`-normalized option structs:
  * ``VBConfig``   <- `vbopt`    (`src/hmm/vbhmm_learn.m:257-320`)
  * ``VBHEMConfig``<- `vbhemopt` (`src/vbhem/vbhem_h3m_cluster.m:150-229`)
  * ``HEMConfig``  <- `hemopt`   (`src/compare_mtds/hem/vhem_cluster.m:149-187`)

Defaults match the reference exactly.  Configs are frozen (hashable);
every learned model echoes its config for provenance, like the
reference stamps `hmm.vbopt` / `h3m_r.vbhemopt`.  Fields that select
JAX-package machinery (``use_pallas``) are kept so that the two
packages' configs stay interchangeable; the port ignores them.

One deliberate difference from the JAX package: ``max_hyp_solutions``
below 1 raises ValueError here.  There, 0 has two meanings: "none" in
``vbhmm.learn`` and ``vbhem.cluster``/``cluster_batched`` (the survivor
slice is emptied and falls back to the best restart) and "no cap" in
``batch.learn_bank`` (``max_hyp_solutions or numtrials``).  Here it is a
positive cap, or None for every uniqueLL survivor, in every engine.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

EXP30 = 1.0686474581524463e13      # exp(30), reference hyp bound
EXPM30 = 1.0686474581524463e-13    # exp(-30)
EXPM20 = 2.061153622438558e-9      # exp(-20)


@dataclasses.dataclass(frozen=True)
class HypBounds:
    """Min/max clip values for hyperparameters (`vbhmm_learn.m:291-307`).
    ``v0_min`` gets ``+ (D-1)`` added at clip time."""
    alpha0_min: float = EXPM30
    alpha0_max: float = EXP30
    epsilon0_min: float = EXPM30
    epsilon0_max: float = EXP30
    eta0_min: float = EXPM30       # VBHEM only
    eta0_max: float = EXP30
    v0_min: float = EXPM20         # + (D-1)
    v0_max: float = 1e4
    beta0_min: float = EXPM30      # aka lambda0 in VBHEM
    beta0_max: float = EXP30
    w0_min: float = EXPM30
    w0_max: float = EXP30


def _check_max_hyp_solutions(config):
    """Reject a cap below 1 on the hyp-optimized survivors (see the
    module docstring: 0 meant "none" or "no cap" by engine)."""
    n = config.max_hyp_solutions
    if n is not None and n < 1:
        raise ValueError(f"max_hyp_solutions must be None (every uniqueLL "
                         f"survivor) or at least 1, got {n}")


@dataclasses.dataclass(frozen=True)
class VBConfig:
    """Options for VBEM HMM learning (reference `vbopt`)."""
    # --- prior hyperparameters (vbhmm_learn.m:258-274) ---
    alpha0: float = 0.1
    epsilon0: float = 0.1
    mu0: Optional[Tuple[float, ...]] = None  # None -> image-center default
    w0: float = 0.005                        # isotropic W0 scale (or tuple for diag)
    beta0: float = 1.0
    v0: float = 5.0
    # --- EM control (vbhmm_learn.m:276-286) ---
    initmode: str = "random"      # random | initgmm | split | inithmm
    numtrials: int = 50
    max_iter: int = 100
    min_diff: float = 1e-5
    sortclusters: str = "f"       # standardization mode
    # --- hyp learning ---
    learn_hyps: bool = False
    learn_hyps_keys: Tuple[str, ...] = ("alpha0", "epsilon0", "v0", "beta0", "w0", "mu0")
    # unique restart solutions to hyp-optimize, at least 1; None = all
    # uniqueLL survivors (the reference optimizes every one,
    # `vbhmm_learn.m:498`)
    max_hyp_solutions: Optional[int] = None
    # L-BFGS iterations for the batched hyp optimizer (the reference's
    # minimize_new runs p.length=100 line searches, `vbhmm_em_hyp.m:73`)
    hyp_max_steps: int = 50
    bounds: HypBounds = HypBounds()
    # --- misc ---
    covar_type: str = "full"      # full | diag emission covariances
    # keep every uniqueLL restart solution in the output info
    # (`vbhmm_learn.m:159,417,600` keep_suboptimal_hmms)
    keep_suboptimal: bool = False
    verbose: int = 1
    use_pallas: bool = True       # Pallas FB kernel when on TPU (MEX analog)

    def __post_init__(self):
        _check_max_hyp_solutions(self)

    def default_mu0(self, dim: int) -> Tuple[float, ...]:
        """Image-center default for eye-fixation data (vbhmm_learn.m:261-269)."""
        if self.mu0 is not None:
            return tuple(float(v) for v in self.mu0)
        if dim == 2:
            return (256.0, 192.0)
        if dim == 3:
            return (256.0, 192.0, 150.0)
        return tuple(0.0 for _ in range(dim))


@dataclasses.dataclass(frozen=True)
class VBHEMConfig:
    """Options for VBHEM H3M clustering (reference `vbhemopt`,
    `vbhem_h3m_cluster.m:150-229`)."""
    # --- prior hyperparameters ---
    alpha0: float = 1.0
    eta0: float = 1.0
    epsilon0: float = 1.0
    m0: Optional[Tuple[float, ...]] = None
    w0: float = 0.005
    lambda0: float = 1.0
    v0: float = 5.0
    # --- EM control ---
    trials: int = 100
    max_iter: int = 200
    min_diff: float = 1e-5
    sortclusters: str = "f"
    initmode: str = "auto"        # auto | baseem | gmmNew | wtkmeans | random | inith3m
    # --- virtual-sample settings ---
    nv: int = 100                 # virtual samples per base component
    tau: int = 10                 # virtual sequence length
    # --- hyp learning ---
    learn_hyps: bool = True
    learn_hyps_keys: Tuple[str, ...] = (
        "alpha0", "eta0", "epsilon0", "v0", "lambda0", "w0", "m0")
    # unique restart solutions to hyp-optimize per cell, at least 1;
    # None = all (the reference optimizes every uniqueLL survivor,
    # `vbhem_h3m_c.m:96-160`)
    max_hyp_solutions: Optional[int] = None
    # L-BFGS iterations for the batched hyp optimizer
    # (`vbhem_h3m_c_hyp.m:38` runs p.length=100 line searches)
    hyp_max_steps: int = 50
    bounds: HypBounds = HypBounds()
    # --- posterior-expectation conversion of inputs ---
    use_post: bool = True
    remove_empty: bool = True
    covar_type: str = "full"      # full | diag emission covariances
    verbose: int = 1
    use_pallas: bool = True

    def __post_init__(self):
        _check_max_hyp_solutions(self)

    def default_m0(self, dim: int) -> Tuple[float, ...]:
        if self.m0 is not None:
            return tuple(float(v) for v in self.m0)
        if dim == 2:
            return (256.0, 192.0)
        if dim == 3:
            return (256.0, 192.0, 150.0)
        return tuple(0.0 for _ in range(dim))


@dataclasses.dataclass(frozen=True)
class HEMConfig:
    """Options for the VHEM baseline clusterer (reference `hemopt`,
    `vhem_cluster.m:149-187`)."""
    trials: int = 100
    nv: int = 100
    tau: int = 10
    max_iter: int = 100
    min_diff: float = 1e-5
    reg_cov: float = 1e-3
    initmode: str = "auto"        # auto | baseem | gmmNew | gmmNew2
    sortclusters: str = "f"
    covar_type: str = "full"
    inf_norm: str = "nt"          # normalize L_elbo by Nv*tau
    smooth: float = 1.0
    verbose: int = 1
