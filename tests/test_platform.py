"""Platform, precision, compile cache and distributed start-up
(phyml_tpu/platform.py, parallel/boot.py), and the GPU's precision
configuration (float32 engine, x64 on) exercised on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phyml_tpu import platform


@pytest.fixture
def restore_config():
    """select_platform writes jax_platforms / the compile cache into
    the global config; put them back for the tests that follow."""
    keep = {k: getattr(jax.config, k) for k in (
        "jax_platforms", "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs",
        "jax_persistent_cache_min_entry_size_bytes")}
    yield
    for k, v in keep.items():
        jax.config.update(k, v)


def test_cpu_runs_float64_with_x64(restore_config):
    assert platform.select_platform("cpu") == jnp.float64
    assert jax.config.jax_enable_x64
    assert platform.select_platform(None) == jnp.float64
    assert platform.select_platform("cpu", float32=True) == jnp.float32


def test_gpu_without_a_gpu_is_an_error(restore_config):
    with pytest.raises(RuntimeError, match="gpu"):
        platform.select_platform("gpu")
    with pytest.raises(ValueError):
        platform.select_platform("metal")


def test_cli_platform_choices(restore_config, tmp_path):
    from phyml_tpu import cli
    from phyml_tpu.evolve import bench_problem, write_phylip

    p = cli.build_parser()
    assert p.parse_args(["-i", "x", "--platform", "gpu"]).platform == "gpu"
    assert p.parse_args(["-i", "x", "--platform", "cpu"]).platform == "cpu"
    with pytest.raises(SystemExit):
        p.parse_args(["-i", "x", "--platform", "metal"])
    *_, names, seqs = bench_problem("nt", n_taxa=5, n_sites=20, seed=1)
    phy = str(tmp_path / "a.phy")
    write_phylip(phy, names, seqs)
    with pytest.raises(RuntimeError, match="gpu"):
        cli.main(["-i", phy, "-o", "n", "--platform", "gpu", "--quiet"])
    assert not os.path.exists(phy + "_phyml_stats.txt")


def test_compile_cache_dir(monkeypatch, restore_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert platform.compile_cache_dir() == "/some/cache"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert platform.compile_cache_dir() == os.path.join(root,
                                                        ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()
    got = platform.enable_compile_cache()
    assert got == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0


def test_initialize_distributed_raises(monkeypatch):
    from phyml_tpu.parallel import boot

    seen = {}

    def fake(**kw):
        seen.update(kw)
        raise ValueError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", fake)
    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        boot.initialize_distributed(coordinator_address="localhost:9",
                                    num_processes=4, process_id=2)
    assert seen == dict(coordinator_address="localhost:9",
                        num_processes=4, process_id=2)
    seen.clear()
    with pytest.raises(RuntimeError):
        boot.initialize_distributed()
    assert seen == {}                    # None values are left to JAX


def test_initialize_distributed_after_backend_start_raises():
    """The real call: JAX refuses once the backend runs, and the error
    reaches the caller instead of a silent single-process run."""
    from phyml_tpu.parallel import boot

    jnp.ones(2).block_until_ready()
    with pytest.raises(RuntimeError, match="failed"):
        boot.initialize_distributed(coordinator_address="localhost:1",
                                    num_processes=2, process_id=0)


def test_cli_distributed_failure_is_an_error(tmp_path):
    from phyml_tpu import cli
    from phyml_tpu.evolve import bench_problem, write_phylip

    *_, names, seqs = bench_problem("nt", n_taxa=5, n_sites=20, seed=1)
    phy = str(tmp_path / "a.phy")
    write_phylip(phy, names, seqs)
    jnp.ones(2).block_until_ready()
    with pytest.raises(RuntimeError, match="distributed"):
        cli.main(["-i", phy, "-o", "n", "--distributed",
                  "--coordinator_address", "localhost:1",
                  "--num_processes", "2", "--process_id", "0",
                  "--quiet"])


def test_share_from_process0_single_process():
    from phyml_tpu.parallel.boot import share_from_process0
    from phyml_tpu.topology import Topology

    topo = Topology.random(6, np.random.default_rng(0))
    params = {"alpha": jnp.asarray(0.5)}
    t2, p2 = share_from_process0(topo, params)
    assert t2 is topo and p2 is params


def test_float32_engine_search_under_x64():
    """The GPU's configuration (float32 engine, float64 sums): the
    SPR scorer's Newton carry stays float32 and a search improves."""
    from phyml_tpu.evolve import bench_problem
    from phyml_tpu.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu.search.driver import spr_search
    from phyml_tpu.search.spr import spr_round

    aln, topo, m, p, *_ = bench_problem("nt", n_taxa=10, n_sites=200,
                                        seed=8)
    eng = LikelihoodEngine(aln, m, dtype=jnp.float32)
    start = topo.random(10, np.random.default_rng(3))
    lnl0 = float(eng.loglik(p, tree_arrays(start.rooted())))
    t1, lnl1, _ = spr_round(eng, p, start.copy())
    assert np.isfinite(lnl1) and lnl1 >= lnl0 - 1e-3
    t2, p2, lnl2 = spr_search(eng, m, p, start.copy(), opt_params=False)
    assert lnl2 > lnl0


def test_mala_gradient_rule():
    """MALA differentiates the chain's likelihood, the traced scan
    (_loglik): the move is on, and its gradient is right."""
    from phyml_tpu.bayes.chrono import TimeTree
    from phyml_tpu.bayes.mcmc import MCMC, MCMCSettings
    from phyml_tpu.bayes.rates import RateModel
    from phyml_tpu.bayes.times import TimePrior
    from phyml_tpu.evolve import bench_problem
    from phyml_tpu.ops.likelihood import LikelihoodEngine, TreeArrays

    aln, _, _, _, *_ = bench_problem("nt", n_taxa=6, n_sites=80, seed=4)
    from phyml_tpu.models.substitution import SubstModel
    model = SubstModel(datatype="nt", name="HKY85", n_classes=1)
    params = model.init_params(aln.obs_state_freqs)
    eng = LikelihoodEngine(aln, model, dtype=jnp.float64)
    tt = TimeTree.coalescent(6, np.random.default_rng(2), theta=0.4)
    chain = MCMC(eng, model, params, tt, RateModel(kind="strict"),
                 TimePrior(kind="coalescent"),
                 MCMCSettings(n_iter=10, burnin=0, batch=10, seed=1))
    mala = MCMC.MOVE_NAMES.index("mala_times")
    assert float(np.asarray(chain.move_w)[mala]) > 0

    child = jnp.asarray(tt.child, dtype=jnp.int32)
    blen0 = jnp.asarray(np.maximum(tt.edge_durations(), 0.0))

    def f(b):
        return eng._loglik(params, TreeArrays(child=child, blen=b),
                           eng.weights)

    g = np.asarray(jax.grad(f)(blen0))
    u = tt.child[0, 0]
    h = 1e-6
    e = jnp.zeros_like(blen0).at[u].set(h)
    fd = (float(f(blen0 + e)) - float(f(blen0 - e))) / (2 * h)
    assert np.all(np.isfinite(g))
    assert abs(g[u] - fd) < 1e-4 * max(1.0, abs(fd))
