"""The port's multi-device VBHEM (``vbhem_tpu_torch.parallel.spmd``)
against the JAX package's (``vbhem_tpu.parallel.spmd``), on the CPU in
float64.

Four gloo ranks start once for the module (spawned processes meeting at a
``file://`` store under the test's temporary directory); each builds the
meshes (2, 2), (1, 4) and (4, 1) and runs every sharded function on an
8-HMM bank (two groups of 2-state HMMs of the JAX package's
tests/test_vbhem.py ground truth, perturbed, built by the JAX package's
``h3m_from_hmms``; the bank tests/test_spmd.py learns costs more JAX
compile time than this whole file may take) with starts drawn by the JAX
package's ``init_baseem``, and sends every result back.  The parent holds
them to:

  * ``sharded_em_step``: the JAX function on mesh (4, 2) of the virtual
    8-device mesh, ll and posts rtol 1e-10;
  * ``sharded_vbhem_em``: the JAX function on mesh (2, 4), equal
    iteration counts, ll rtol 1e-9, hat_z rtol 1e-7, posts rtol 1e-7;
  * ``sharded_fit_trials`` and ``sharded_grid_sweep``: the port's own
    unsharded ``fit_single_ks`` / ``fit_grid_batched`` from the same
    generator, rtol 1e-10 and equal iteration counts (the port's draws are
    not ``jax.random``'s);
  * the masked loop sharded over 'base': the unsharded
    ``vbhem_em_masked``, rtol 1e-10;
  * ``group`` of one rank: bit for bit the unsharded loop (``group=None``).

Ranks import neither JAX nor the JAX package (JAX is imported only inside
the parent's fixture and tests).  ``init_process_group`` has a 60 s
timeout and the parent joins the ranks by a deadline, so a hung rank fails
the tests instead of holding the suite."""
import datetime
import multiprocessing
import queue as queue_mod
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

WORLD = 4
NV, TAU = 10, 5
DEADLINE_S = 150
STEP_TRIALS, EM_TRIALS, FIT_TRIALS = 4, 4, 8
EM_MESHES = [(1, 4), (2, 2)]
FIT_MESHES = [(4, 1), (2, 2)]
# the masked lanes' cells at the padded (2, 2): one lane each
MASK_CELLS = [(1, 2), (2, 1), (2, 2), (1, 1)]
REPO = Path(__file__).resolve().parent.parent


def vbhem_config(**kw):
    from vbhem_tpu_torch import VBHEMConfig
    return VBHEMConfig(alpha0=1e6, m0=(1.5, 1.5), w0=1.0, nv=NV, tau=TAU,
                       **kw)


FIT_CONFIG = dict(trials=FIT_TRIALS, initmode="baseem", learn_hyps=False,
                  max_iter=20)
GRID_CONFIG = dict(trials=FIT_TRIALS, initmode="baseem", learn_hyps=False,
                   max_iter=15)
GRID = ([1, 2], [1, 2])


# ---------------------------------------------------------------------------
# the ranks (no JAX here)
# ---------------------------------------------------------------------------

def _raises(fn, exc) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


def _rank_work(inputs) -> dict:
    import torch.distributed as dist
    from vbhem_tpu_torch.containers import tree_map
    from vbhem_tpu_torch.convert import to_numpy, to_torch
    from vbhem_tpu_torch.models import vbhem
    from vbhem_tpu_torch.parallel import spmd

    base = to_torch(inputs["base"], "cpu")
    hyps = to_torch(inputs["hyps"], "cpu")
    posts_step = to_torch(inputs["posts_step"], "cpu")
    posts_em = to_torch(inputs["posts_em"], "cpu")
    cmask = torch.as_tensor(inputs["cmask"])
    smask = torch.as_tensor(inputs["smask"])
    out = {}

    posts, ll = spmd.sharded_em_step(spmd.make_mesh(2, 2), base, posts_step,
                                     hyps, NV, TAU)
    out["step"] = to_numpy(posts), ll.numpy()
    for shape in EM_MESHES:
        em = spmd.make_sharded_vbhem_em(spmd.make_mesh(*shape), NV, TAU,
                                        max_iter=50)
        out[("em", shape)] = to_numpy(em(base, posts_em, hyps))
    out["masked"] = to_numpy(spmd.sharded_vbhem_em(
        spmd.make_mesh(1, 4), base, posts_em, hyps, NV, TAU, max_iter=50,
        cmask=cmask, smask=smask))
    for shape, chunk in zip(FIT_MESHES, (None, 3)):
        mesh = spmd.make_mesh(*shape)
        out[("fit", shape)] = to_numpy(spmd.sharded_fit_trials(
            mesh, base, 2, 2, vbhem_config(**FIT_CONFIG), hyps,
            torch.Generator().manual_seed(3)))
        out[("grid", shape)] = to_numpy(spmd.sharded_grid_sweep(
            mesh, base, *GRID, vbhem_config(**GRID_CONFIG), hyps,
            torch.Generator().manual_seed(4), trial_chunk=chunk)[0])

    # a group of one rank: bit for bit the unsharded loop
    single, _ = dist.new_subgroups(group_size=1)
    a = vbhem.vbhem_em(base, posts_em, hyps, NV, TAU, max_iter=50,
                       group=single, kb_total=base.num_hmms)
    b = vbhem.vbhem_em(base, posts_em, hyps, NV, TAU, max_iter=50)
    same = []
    tree_map(lambda x, y: same.append(torch.equal(x, y)), a, b)
    out["single_group_bitwise"] = all(same)

    mesh = spmd.make_mesh(1, 4)
    rank = dist.get_rank()
    mine = base._replace(omega=torch.full((8,), float(rank)),
                         state_mask=base.state_mask & (rank == 0))
    out["replicated"] = to_numpy(spmd.replicate_to_mesh(mesh, mine))
    bank6 = tree_map(lambda x: x[:6], base)
    out["refusals"] = {
        "mesh size": _raises(lambda: spmd.make_mesh(3, 1), ValueError),
        "Kb": _raises(lambda: spmd.sharded_vbhem_em(
            mesh, bank6, posts_em, hyps, NV, TAU), ValueError),
        "trials": _raises(lambda: spmd.sharded_vbhem_em(
            spmd.make_mesh(4, 1), base, tree_map(lambda x: x[:2], posts_em),
            hyps, NV, TAU), ValueError),
        "generators": _raises(lambda: spmd.sharded_fit_trials(
            mesh, base, 2, 2, vbhem_config(**FIT_CONFIG), hyps,
            torch.Generator().manual_seed(rank)), ValueError),
    }
    return out


def _rank_main(rank, store, inputs, results):
    """One rank: join the gloo world, run :func:`_rank_work`, send back
    (rank, outputs, error)."""
    try:
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=WORLD, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        try:
            out = _rank_work(inputs)
        finally:
            dist.destroy_process_group()
        results.put((rank, out, None))
    except BaseException:
        results.put((rank, None, traceback.format_exc()))


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

def jax_bank():
    """Eight 2-state HMMs, four of each ground-truth transition structure
    of tests/test_vbhem.py, their means and transitions perturbed and
    their covariances full, from a seed."""
    import jax.numpy as jnp
    from vbhem_tpu.containers import HMM
    from vbhem_tpu.models import vbhem as jv
    rng = np.random.default_rng(0)
    hmms = []
    for trans in ([[0.6, 0.4], [0.4, 0.6]], [[0.4, 0.6], [0.6, 0.4]]):
        for _ in range(4):
            shift = rng.uniform(-0.05, 0.05, (2, 1)) * np.array([[1.0, -1.0]])
            a = rng.normal(0, 0.3, (2, 2, 2))
            cov = np.eye(2) + a @ np.swapaxes(a, -1, -2)
            hmms.append(HMM(
                prior=jnp.asarray([0.5, 0.5]),
                trans=jnp.asarray(np.asarray(trans) + shift),
                mean=jnp.asarray(np.array([[0.0, 0.0], [3.0, 3.0]])
                                 + rng.normal(0, 0.1, (2, 2))),
                cov=jnp.asarray(cov)))
    return jv.h3m_from_hmms(hmms)


def to_port_numpy(tree):
    """A JAX container -> the port's container with numpy leaves (the
    ranks unpickle it without importing JAX)."""
    from vbhem_tpu_torch.convert import to_numpy, to_torch
    return to_numpy(to_torch(tree, "cpu"))


def collect(procs, results) -> dict:
    """Every rank's outputs, or a failure naming the ranks that failed or
    did not answer by the deadline; no rank outlives the call."""
    end = time.monotonic() + DEADLINE_S
    outs, errors = {}, []
    try:
        while len(outs) + len(errors) < WORLD:
            try:
                rank, out, err = results.get(
                    timeout=max(0.1, end - time.monotonic()))
            except queue_mod.Empty:
                break
            if err:
                errors.append(f"rank {rank}:\n{err}")
            else:
                outs[rank] = out
        for p in procs:
            p.join(timeout=max(0.1, end - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    missing = sorted(set(range(WORLD)) - set(outs))
    if errors or missing:
        pytest.fail(f"ranks {missing} gave no result by the {DEADLINE_S} s "
                    f"deadline or failed:\n" + "\n".join(errors))
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from vbhem_tpu.config import VBHEMConfig as JConfig
    from vbhem_tpu.models import vbhem as jv
    from vbhem_tpu.parallel import spmd as jspmd

    assert len(jax.devices()) >= 8, "conftest should force 8 CPU devices"
    base = jax_bank()
    jcfg = JConfig(alpha0=1e6, m0=(1.5, 1.5), w0=1.0, nv=NV, tau=TAU)
    hyps = jv.VBHEMHyps.from_config(jcfg, 2)

    def starts(key, n):
        keys = jax.random.split(jax.random.key(key), n)
        return jax.vmap(lambda k: jv.init_baseem(k, base, 2, 2, hyps,
                                                 NV))(keys)

    posts_step, posts_em = starts(0, STEP_TRIALS), starts(7, EM_TRIALS)
    kmax, smax = 2, 2
    cmask = np.stack([np.arange(kmax) < k for k, _ in MASK_CELLS])
    smask = np.stack([np.arange(smax) < s for _, s in MASK_CELLS])
    inputs = {"base": to_port_numpy(base), "hyps": to_port_numpy(hyps),
              "posts_step": to_port_numpy(posts_step),
              "posts_em": to_port_numpy(posts_em),
              "cmask": cmask, "smask": smask}

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = tmp_path_factory.mktemp("spmd") / "store"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(store), inputs, results), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        # the JAX references, while the ranks run
        ref = {"step": jspmd.sharded_em_step(
            jspmd.make_mesh(n_trial=4, n_base=2), base, posts_step, hyps,
            NV, TAU)}
        ref["em"] = jspmd.sharded_vbhem_em(
            jspmd.make_mesh(n_trial=2, n_base=4), base, posts_em, hyps, NV,
            TAU, max_iter=50)
    finally:
        outs = collect(procs, results)
    return {"inputs": inputs, "ref": ref, "outs": outs}


def port_inputs(runs):
    from vbhem_tpu_torch.convert import to_torch
    inp = runs["inputs"]
    return (to_torch(inp["base"], "cpu"), to_torch(inp["hyps"], "cpu"),
            to_torch(inp["posts_em"], "cpu"))


def assert_tree_close(got, want, rtol, atol=0.0):
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        if hasattr(w, "_fields"):
            assert_tree_close(g, w, rtol, atol)
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=rtol, atol=atol, err_msg=f)


def test_sharded_em_step_matches_jax(runs):
    posts, ll = runs["outs"][0]["step"]
    ref_posts, ref_ll = runs["ref"]["step"]
    np.testing.assert_allclose(ll, np.asarray(ref_ll), rtol=1e-10)
    assert_tree_close(posts, ref_posts, rtol=1e-10)


@pytest.mark.parametrize("shape", EM_MESHES)
def test_sharded_vbhem_em_matches_jax(runs, shape):
    st = runs["outs"][0][("em", shape)]
    ref = runs["ref"]["em"]
    assert int(np.min(ref.it)) > 1, "EM should take several iterations"
    np.testing.assert_array_equal(st.it, np.asarray(ref.it))
    np.testing.assert_allclose(st.ll, np.asarray(ref.ll), rtol=1e-9)
    np.testing.assert_allclose(st.hat_z, np.asarray(ref.hat_z), rtol=1e-7,
                               atol=1e-12)
    # an empty cluster's W is diagonal; its off-diagonal entries are
    # round-off near 1e-308 on both sides
    assert_tree_close(st.post, ref.post, rtol=1e-7, atol=1e-300)


def test_sharded_masked_em_matches_unsharded(runs):
    """The masked loop with the bank sharded four ways equals the
    unsharded ``vbhem_em_masked`` from the same starts."""
    from vbhem_tpu_torch.convert import to_numpy
    from vbhem_tpu_torch.models import vbhem
    base, hyps, posts = port_inputs(runs)
    inp = runs["inputs"]
    want = to_numpy(vbhem.vbhem_em_masked(
        base, posts, hyps, NV, TAU, torch.as_tensor(inp["cmask"]),
        torch.as_tensor(inp["smask"]), max_iter=50))
    st = runs["outs"][0]["masked"]
    assert int(np.min(want.it)) > 1
    np.testing.assert_array_equal(st.it, want.it)
    assert_tree_close(st, want._replace(it=st.it, done=st.done), rtol=1e-10)


@pytest.mark.parametrize("shape", FIT_MESHES)
def test_sharded_fit_trials_matches_unsharded(runs, shape):
    from vbhem_tpu_torch.convert import to_numpy
    from vbhem_tpu_torch.models import vbhem
    base, hyps, _ = port_inputs(runs)
    want = to_numpy(vbhem.fit_single_ks(
        torch.Generator().manual_seed(3), base, 2, 2,
        vbhem_config(**FIT_CONFIG), hyps, initmode="baseem"))
    st = runs["outs"][0][("fit", shape)]
    np.testing.assert_array_equal(st.it, want.it)
    assert_tree_close(st, want._replace(it=st.it, done=st.done), rtol=1e-10)


@pytest.mark.parametrize("shape", FIT_MESHES)
def test_sharded_grid_sweep_matches_unsharded(runs, shape):
    from vbhem_tpu_torch.convert import to_numpy
    from vbhem_tpu_torch.models import vbhem
    base, hyps, _ = port_inputs(runs)
    want = to_numpy(vbhem.fit_grid_batched(
        torch.Generator().manual_seed(4), base, *GRID,
        vbhem_config(**GRID_CONFIG), hyps)[0])
    st = runs["outs"][0][("grid", shape)]
    assert st.ll.shape == (len(GRID[0]) * len(GRID[1]), FIT_TRIALS)
    np.testing.assert_array_equal(st.it, want.it)
    assert_tree_close(st, want._replace(it=st.it, done=st.done), rtol=1e-10)


def test_single_rank_group_is_bitwise_unsharded(runs):
    assert all(out["single_group_bitwise"] for out in runs["outs"].values())


def test_results_whole_and_equal_on_every_rank(runs):
    """Every rank returns the whole result, the same bits as rank 0's."""
    def same(a, b):
        if isinstance(a, dict):
            return all(same(a[k], b[k]) for k in a)
        if isinstance(a, tuple):
            return all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, np.ndarray):
            return np.array_equal(a, b, equal_nan=True)
        return a == b
    first = runs["outs"][0]
    for rank in range(1, WORLD):
        assert same(first, runs["outs"][rank]), rank


def test_replicate_and_refusals(runs):
    """``replicate_to_mesh`` gives every rank rank 0's bank (floats and the
    bool mask); meshes, banks, trials and generators that do not fit are
    refused on every rank alike."""
    bank = runs["inputs"]["base"]
    for out in runs["outs"].values():
        got = out["replicated"]
        np.testing.assert_array_equal(got.omega, np.zeros(8))
        np.testing.assert_array_equal(got.state_mask, bank.state_mask)
        np.testing.assert_array_equal(got.hmm.mean, bank.hmm.mean)
        assert out["refusals"] == {"mesh size": True, "Kb": True,
                                   "trials": True, "generators": True}


def test_make_mesh_needs_a_process_group():
    from vbhem_tpu_torch.parallel import spmd
    with pytest.raises(RuntimeError, match="init_process_group"):
        spmd.make_mesh(1, 1)


def test_parallel_runs_with_jax_blocked(tmp_path):
    """vbhem_tpu_torch.parallel imports and runs a one-rank world with
    jax and the JAX package blocked."""
    code = (
        "import sys, datetime\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vbhem_tpu'] = None\n"
        "import torch, torch.distributed as dist\n"
        "from vbhem_tpu_torch import VBHEMConfig\n"
        "from vbhem_tpu_torch.models import vbhem\n"
        "from vbhem_tpu_torch.parallel import spmd\n"
        "from vbhem_tpu_torch.utils.planted import planted_bank\n"
        f"dist.init_process_group('gloo', init_method='file://{tmp_path}/s',"
        " world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))\n"
        "base, _ = planted_bank(8, 'cpu', torch.float64)\n"
        "cfg = VBHEMConfig(trials=2, initmode='baseem', nv=10, tau=5,\n"
        "                  m0=(13.0, 10.0), w0=1.0, max_iter=10)\n"
        "hyps = vbhem.VBHEMHyps.from_config(cfg, 2, device='cpu')\n"
        "st = spmd.sharded_fit_trials(spmd.make_mesh(1, 1), base, 2, 2,\n"
        "                             cfg, hyps, torch.Generator())\n"
        "assert torch.isfinite(st.ll).all() and st.ll.shape == (2,)\n"
        "dist.destroy_process_group()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
