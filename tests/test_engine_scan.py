"""The likelihood engine's scan path (ops/likelihood.py) in float32,
as a GPU runs it, against the plain float64 reference; its pattern
padding, dtypes and P-matrix cache.  The `gpu`-marked tests repeat the
parity check at the chip check's width (128 taxa x 4096 sites) on the
card.  Reference for the math: Lk_Core lk.c:767-860 and
Core_Default_Update_Partial_Lk lk.c:1659.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from phyml_tpu import reference
from phyml_tpu.evolve import bench_problem
from phyml_tpu.ops.likelihood import LikelihoodEngine, tree_arrays
from phyml_tpu.topology import Topology


def _problem(kind):
    if kind == "nt-150-sites":
        # 150 sites: a pattern count that is not a multiple of the pad
        aln, topo, m, p, *_ = bench_problem("nt", n_taxa=24,
                                            n_sites=150, seed=4)
        return aln, topo.rooted(), m, p
    if kind == "nt-caterpillar":
        # maximum depth: exercises the rescaling along 39 levels
        aln, _, m, p, *_ = bench_problem("nt", n_taxa=40, n_sites=60,
                                         seed=6)
        return aln, Topology.caterpillar(40, blen=0.25).rooted(), m, p
    # 200 taxa, 20 states
    aln, topo, m, p, *_ = bench_problem("aa", n_taxa=200, n_sites=40,
                                        seed=3)
    return aln, topo.rooted(), m, p


@pytest.mark.parametrize("kind", ["nt-150-sites", "nt-caterpillar",
                                  "aa-200-taxa"])
def test_float32_scan_matches_reference(kind):
    aln, rv, m, p = _problem(kind)
    k = aln.n_patterns
    eng = LikelihoodEngine(aln, m, dtype=jnp.float32)
    site = np.asarray(eng.site_logliks(
        p, tree_arrays(rv, dtype=jnp.float32)))[:k]
    want = reference.alignment_site_logliks(aln, rv, m, p)
    # float32 rounding of ~n_otu dependent products per site
    np.testing.assert_allclose(site, want, rtol=0, atol=2e-3)
    assert abs(float(np.sum((site - want) * aln.weights))) < 0.05


@pytest.mark.parametrize("quantum", [1, 24, 128])
def test_engine_pads_patterns_to_the_quantum(quantum):
    """The padded pattern axis is whole quanta; padded columns are
    all-ones tips with weight 0, so lnL does not depend on the pad."""
    aln, topo, m, p, *_ = bench_problem("nt", n_taxa=8, n_sites=70,
                                        seed=2)
    eng = LikelihoodEngine(aln, m, dtype=jnp.float64,
                           pattern_pad=quantum)
    k = aln.n_patterns
    assert eng.P % quantum == 0
    assert k <= eng.P < k + quantum or eng.P == quantum
    assert eng.tips.shape == (8, 4, eng.P)
    assert eng.weights.shape == (eng.P,)
    np.testing.assert_array_equal(np.asarray(eng.tips)[:, :, k:], 1.0)
    np.testing.assert_array_equal(np.asarray(eng.weights)[k:], 0.0)
    rv = topo.rooted()
    want = float(np.sum(reference.alignment_site_logliks(aln, rv, m, p)
                        * aln.weights))
    got = float(eng.loglik(p, tree_arrays(rv, dtype=jnp.float64)))
    assert got == pytest.approx(want, abs=1e-8)


def test_engine_dtypes_follow_self_dtype():
    aln, _, m, _, *_ = bench_problem("nt", n_taxa=6, n_sites=30, seed=1)
    for dt in (jnp.float32, jnp.float64):
        eng = LikelihoodEngine(aln, m, dtype=dt)
        assert eng.tips.dtype == eng.dtype == jnp.dtype(dt)
        assert eng.invar_ok.dtype == eng.dtype
        assert eng.weights.dtype == eng.acc_dtype == jnp.float64
        assert eng._tiny == np.finfo(eng.dtype).tiny


def test_weighted_loglik_is_the_weighted_site_sum():
    """Bootstrap scoring passes resampled weights to loglik; the result
    is the weighted sum of site_logliks, on a cached and a fresh
    P-matrix entry alike."""
    aln, topo, m, p, *_ = bench_problem("nt", n_taxa=10, n_sites=120,
                                        seed=7)
    eng = LikelihoodEngine(aln, m, dtype=jnp.float64)
    ta = tree_arrays(topo.rooted(), dtype=jnp.float64)
    site = np.asarray(eng.site_logliks(p, ta))
    rng = np.random.default_rng(0)
    w = np.zeros(eng.P)
    w[:aln.n_patterns] = rng.multinomial(
        aln.n_sites, aln.weights / aln.weights.sum())
    want = float(np.sum(site * w))
    assert float(eng.loglik(p, ta, jnp.asarray(w))) == \
        pytest.approx(want, abs=1e-8)
    ta2 = ta._replace(blen=ta.blen * 1.0)     # same lengths, new array
    assert float(eng.loglik(p, ta2, jnp.asarray(w))) == \
        pytest.approx(want, abs=1e-8)


def test_pmatrix_cache_follows_branch_lengths():
    aln, topo, m, p, *_ = bench_problem("nt", n_taxa=8, n_sites=80,
                                        seed=9)
    eng = LikelihoodEngine(aln, m, dtype=jnp.float64)
    rv = topo.rooted()
    ta = tree_arrays(rv, dtype=jnp.float64)
    a = float(eng.loglik(p, ta))
    assert float(eng.loglik(p, ta)) == a          # served from the cache
    longer = ta._replace(blen=ta.blen * 1.5)
    b = float(eng.loglik(p, longer))
    assert b != a
    rv2 = dataclasses.replace(rv, node_blen=np.asarray(longer.blen))
    want = float(np.sum(reference.alignment_site_logliks(aln, rv2, m, p)
                        * aln.weights))
    assert b == pytest.approx(want, abs=1e-8)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("datatype", ["nt", "aa"])
def test_scan_at_c1_width(gpu, datatype):
    """128 taxa x 4096 sites (c1 / c1-aa) in float32 on the card: the
    scan agrees with the float64 reference within the chip check's
    tolerances (per site 3e-3, total 1.5)."""
    aln, topo, m, p, *_ = bench_problem(datatype)
    rv = topo.rooted()
    eng = LikelihoodEngine(aln, m, dtype=jnp.float32)
    site = np.asarray(eng.site_logliks(
        p, tree_arrays(rv, dtype=jnp.float32)))[:aln.n_patterns]
    ref = reference.alignment_site_logliks(aln, rv, m, p)
    assert np.abs(site - ref).max() < 3e-3
    assert abs(float(np.sum((site - ref) * aln.weights))) < 1.5


@pytest.mark.gpu
def test_gpu_platform_runs_float32(gpu):
    import jax

    from phyml_tpu import platform

    assert jax.devices()[0].platform == "gpu"
    assert platform.select_platform("gpu") == jnp.float32
    assert jax.config.jax_enable_x64
