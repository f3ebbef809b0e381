"""Multi-device sharding tests on the 8-virtual-CPU mesh.

These mirror the driver's dryrun_multichip contract so entry-point /
sharded-path API drift fails CI instead of shipping (the round-2
regression: blen_round's signature changed and nothing here noticed).
Reference role: mpi_boot.c:27 Bootstrap_MPI — the reference's only
multi-process path; here the equivalents are the (boot, sites) mesh
axes of parallel/mesh.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def _require_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")


def _toy(n_otu=12, n_sites=200, seed=3):
    from phyml_tpu.io.alignment import compact
    from phyml_tpu.models.substitution import SubstModel
    from phyml_tpu.topology import Topology

    rng = np.random.default_rng(seed)
    states = rng.integers(0, 4, size=(n_otu, n_sites))
    enc = np.zeros((n_otu, n_sites, 4), dtype=np.float32)
    for i in range(n_otu):
        enc[i, np.arange(n_sites), states[i]] = 1.0
    aln = compact(enc, [f"t{i}" for i in range(n_otu)], "nt")
    model = SubstModel(datatype="nt", name="GTR", n_classes=4)
    topo = Topology.random(n_otu, rng)
    params = model.init_params(aln.obs_state_freqs)
    return aln, model, topo, params


def test_dryrun_multichip_contract():
    """The driver's exact entry point must run green on 8 devices."""
    _require_devices(8)
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__
    fn, args = __graft_entry__.entry()
    lnl = jax.jit(fn)(*args)
    assert np.isfinite(float(lnl))


def test_sharded_lnl_equals_unsharded():
    _require_devices(8)
    from phyml_tpu.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu.parallel.mesh import make_mesh, sharded_engine

    aln, model, topo, params = _toy()
    rv = topo.rooted()

    eng1 = LikelihoodEngine(aln, model, dtype=jnp.float64,
                            pattern_pad=128 * 8)
    tree = tree_arrays(rv, dtype=jnp.float64)
    lnl_ref = float(eng1.loglik(params, tree))

    mesh = make_mesh(n_boot=1, n_sites=8)
    eng8 = sharded_engine(aln, model, mesh, dtype=jnp.float64)
    lnl_shard = float(eng8.loglik(params, tree))
    assert lnl_shard == pytest.approx(lnl_ref, abs=1e-9)


def test_sharded_blen_round_matches():
    """One parallel-Newton branch-length round, sharded vs unsharded:
    identical optimized lengths and lnL."""
    _require_devices(8)
    from phyml_tpu.optim.blen import optimize_branch_lengths
    from phyml_tpu.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu.parallel.mesh import make_mesh, sharded_engine

    aln, model, topo, params = _toy()
    rv = topo.rooted()

    eng1 = LikelihoodEngine(aln, model, dtype=jnp.float64,
                            pattern_pad=128 * 8)
    tree1, lnl1 = optimize_branch_lengths(
        eng1, params, tree_arrays(rv, dtype=jnp.float64), max_rounds=3)

    mesh = make_mesh(n_boot=1, n_sites=8)
    eng8 = sharded_engine(aln, model, mesh, dtype=jnp.float64)
    tree8, lnl8 = optimize_branch_lengths(
        eng8, params, tree_arrays(rv, dtype=jnp.float64), max_rounds=3)

    assert lnl8 == pytest.approx(lnl1, abs=1e-8)
    np.testing.assert_allclose(np.asarray(tree8.blen),
                               np.asarray(tree1.blen), atol=1e-8)


def test_sharded_nni_round():
    """A full NNI round (scorer + swap application) runs and improves
    lnL on the sharded engine exactly as on the single-device one."""
    _require_devices(8)
    from phyml_tpu.search.nni import nni_round
    from phyml_tpu.ops.likelihood import LikelihoodEngine
    from phyml_tpu.parallel.mesh import make_mesh, sharded_engine

    aln, model, topo, params = _toy()

    eng1 = LikelihoodEngine(aln, model, dtype=jnp.float64,
                            pattern_pad=128 * 8)
    t1, lnl_1, n1 = nni_round(eng1, params, topo.copy())

    mesh = make_mesh(n_boot=1, n_sites=8)
    eng8 = sharded_engine(aln, model, mesh, dtype=jnp.float64)
    t8, lnl_8, n8 = nni_round(eng8, params, topo.copy())

    assert n8 == n1
    assert lnl_8 == pytest.approx(lnl_1, abs=1e-7)


def test_boot_axis_replicate_batch():
    """Replicate-weight matrices sharded over the boot axis produce
    the same per-replicate lnLs as a serial loop."""
    _require_devices(8)
    from phyml_tpu.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu.parallel.mesh import (
        boot_sharding, make_mesh, sharded_engine,
    )

    aln, model, topo, params = _toy()
    tree = tree_arrays(topo.rooted(), dtype=jnp.float64)

    mesh = make_mesh(n_boot=2, n_sites=4)
    eng = sharded_engine(aln, model, mesh, dtype=jnp.float64)

    rng = np.random.default_rng(7)
    R = 4
    wmat = np.stack([aln.resample_weights(rng) for _ in range(R)])
    wmat = np.pad(wmat, ((0, 0), (0, eng.P - wmat.shape[1])))
    wmat_d = jax.device_put(jnp.asarray(wmat), boot_sharding(mesh, 2))

    sys = eng.system_of(params)
    batched = jax.jit(jax.vmap(
        lambda w: eng._loglik_sys(sys, tree, w)
    ))(wmat_d)

    serial = np.array([
        float(eng.loglik(params, tree, jnp.asarray(wmat[r])))
        for r in range(R)
    ])
    np.testing.assert_allclose(np.asarray(batched), serial, atol=1e-9)


def test_bootstrap_farming_layout_independent():
    """Distributed bootstrap contract (mpi_boot.c): per-REPLICATE
    seeds make the counts identical however replicates are farmed.
    Simulate 2 processes by running disjoint replicate shards and
    summing — must equal the serial run exactly."""
    from phyml_tpu.ops.likelihood import LikelihoodEngine
    from phyml_tpu.parallel.boot import replicate_shard
    from phyml_tpu.search.support import bootstrap_supports

    aln, model, topo, params = _toy(n_otu=8, n_sites=120, seed=5)
    eng = LikelihoodEngine(aln, model, dtype=jnp.float64)

    from phyml_tpu.search.driver import nni_search
    topo, params, _ = nni_search(eng, model, params, topo,
                                 opt_params=False)

    R = 6
    serial = bootstrap_supports(eng, model, params, topo,
                                n_replicates=R, seed=11)

    shard0 = replicate_shard(R, 0, 2)
    shard1 = replicate_shard(R, 1, 2)
    assert sorted(shard0 + shard1) == list(range(R))
    c0 = bootstrap_supports(eng, model, params, topo, n_replicates=R,
                            seed=11, replicate_indices=shard0)
    c1 = bootstrap_supports(eng, model, params, topo, n_replicates=R,
                            seed=11, replicate_indices=shard1)
    merged = {e: (c0[e] + c1[e]) / R for e in c0}
    assert merged == serial


def test_sum_across_processes_single():
    from phyml_tpu.parallel.boot import _sum_across_processes
    x = np.array([1.0, 2.0, 3.0])
    np.testing.assert_array_equal(_sum_across_processes(x), x)
