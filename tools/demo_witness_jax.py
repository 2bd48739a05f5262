"""The JAX package's VBHEM on the face demo's base banks, as a second
witness to the port's results on them: ``tools/demo_seeds.py --save DIR``
writes each seed's bank (the VBEM stage's HMMs, made by the port) with
the port's result; this script gives each bank to
``vbhem_tpu.models.vbhem.cluster_batched`` at the settings it was made
for, on the CPU, and prints the JAX package's selection beside the
port's.

  * ``reference_seed<n>.npz``: the reference demo's VBHEM settings
    (K=1..5 x S=1..3, wtkmeans, Nv=10, tau=5, 50 restarts, hyps on);
  * ``synthetic_seed<n>.npz``: the JAX example's synthetic-data settings
    (alpha0=1e6, m0 and W0 of the VBEM stage, Nv=50, tau=10, 'auto',
    10 restarts, hyps off).

    python3 tools/demo_witness_jax.py DIR/reference_seed0.npz [...]
        [--dtype float32|float64] [--key 1001] [--restarts]

One line per bank: the settings, the JAX package's grid selection, K_hat
(the clusters that survive ``vbh3m_remove_empty``), the Rand index
against the groups, the viewers whose cluster disagrees with their
group, each K's best score, and the port's K, K_hat and Rand index from
the file.  With ``--restarts``: instead, each bank's restarts of the
reference settings without hyps (``fit_single_ks``, 100 restarts of
wtkmeans and of baseem in cells (2, 2), (2, 3) and (3, 3)), and how many
recover the groups; ``tools/demo_restarts.py`` counts the port's.
Imports the JAX package only, never the port.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def witness(path: str, dtype: str, key: int) -> str:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from vbhem_tpu.config import VBHEMConfig
    from vbhem_tpu.containers import H3M, HMM
    from vbhem_tpu.models import vbhem
    from vbhem_tpu.utils.metrics import rand_index
    z = np.load(path)
    dt = jnp.float32 if dtype == "float32" else jnp.float64
    base = H3M(omega=jnp.asarray(z["omega"], dt),
               hmm=HMM(*(jnp.asarray(z[k], dt)
                         for k in ("prior", "trans", "mean", "cov"))),
               state_mask=jnp.asarray(z["state_mask"]))
    m0 = tuple(float(v) for v in z["mu0"])
    name = os.path.basename(path).split("_seed")[0]
    if name == "reference":
        cfg = VBHEMConfig(alpha0=1.0, eta0=1.0, epsilon0=1.0, lambda0=1.0,
                          v0=10.0, w0=0.001, m0=m0, trials=50, nv=10,
                          tau=5, initmode="wtkmeans", learn_hyps=True)
    else:
        cfg = VBHEMConfig(alpha0=1e6, m0=m0, w0=float(z["w0"]), trials=10,
                          nv=50, tau=10, initmode="auto", learn_hyps=False)
    t0 = time.perf_counter()
    res, info = vbhem.cluster_batched(jax.random.key(key), base,
                                      [1, 2, 3, 4, 5], [1, 2, 3], cfg)
    res, hmms = vbhem.vbh3m_remove_empty(res)
    labels = z["labels"]
    lab = np.asarray(res.label)
    ri = rand_index(lab, labels)[1]
    # viewers outside their group's majority cluster
    off = [int(i) for g in (0, 1) for i in np.where(labels == g)[0]
           if lab[i] != np.bincount(lab[labels == g]).argmax()]
    return (f"{os.path.basename(path)} {dtype}: JAX grid "
            f"K={info['model_best_k']} S={info['model_best_s']} "
            f"K_hat={len(hmms)} Rand index {ri:.6f} viewers off their "
            f"group {off}; per-K best "
            f"{np.max(info['model_ll'], axis=1).round(3).tolist()} "
            f"({time.perf_counter() - t0:.1f}s) | port K="
            f"{int(z['port_best_k'])} K_hat={int(z['port_k_hat'])} Rand "
            f"index {float(z['port_rand_index']):.6f}")


RESTART_CELLS = ((2, 2), (2, 3), (3, 3))


def restarts(path: str, dtype: str, key: int) -> list:
    """Per initmode and cell: the restarts (of 100) whose labels recover
    the groups, and the best bound."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from vbhem_tpu.config import VBHEMConfig
    from vbhem_tpu.containers import H3M, HMM
    from vbhem_tpu.models import vbhem
    from vbhem_tpu.utils.metrics import rand_index
    z = np.load(path)
    dt = jnp.float32 if dtype == "float32" else jnp.float64
    base = H3M(omega=jnp.asarray(z["omega"], dt),
               hmm=HMM(*(jnp.asarray(z[k], dt)
                         for k in ("prior", "trans", "mean", "cov"))),
               state_mask=jnp.asarray(z["state_mask"]))
    out = []
    for mode in ("wtkmeans", "baseem"):
        cfg = VBHEMConfig(alpha0=1.0, eta0=1.0, epsilon0=1.0, lambda0=1.0,
                          v0=10.0, w0=0.001,
                          m0=tuple(float(v) for v in z["mu0"]), trials=100,
                          nv=10, tau=5, initmode=mode, learn_hyps=False)
        for k, s_ in RESTART_CELLS:
            st = vbhem.fit_single_ks(jax.random.key(key), base, k, s_, cfg)
            lab = np.asarray(jnp.argmax(st.hat_z, -1))
            ok = sum(rand_index(lb, z["labels"])[1] == 1.0 for lb in lab)
            out.append(f"{os.path.basename(path)} {dtype} JAX {mode} "
                       f"({k}, {s_}): {ok} of 100 restarts recover the "
                       f"groups; best bound {float(np.max(st.ll)):.2f}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("banks", nargs="+")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--key", type=int, default=1001)
    ap.add_argument("--restarts", action="store_true")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for path in args.banks:
        if args.restarts:
            for line in restarts(path, args.dtype, args.key):
                print(line, flush=True)
        else:
            print(witness(path, args.dtype, args.key), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
