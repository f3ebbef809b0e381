"""The plain float64 reference (phyml_tpu/reference.py) against the
engine's scan path, on seeded in-repo data, for every class structure
the engine has: gamma rates, +I, the LG4X mixture and covarion."""

import jax.numpy as jnp
import numpy as np
import pytest

from phyml_tpu import reference
from phyml_tpu.evolve import bench_problem
from phyml_tpu.models.substitution import SubstModel, lg4x_model
from phyml_tpu.ops.likelihood import LikelihoodEngine, tree_arrays


def _model(kind):
    if kind == "nt-gtr-g4":
        m = SubstModel(datatype="nt", name="GTR", n_classes=4)
        p = m.init_params(np.array([0.3, 0.2, 0.3, 0.2]))
        p["rr_val"] = jnp.log(jnp.asarray([1.2, 3.0, 0.8, 1.1, 4.0, 1.0]))
        p["alpha"] = jnp.asarray(0.7)
        return "nt", m, p
    if kind == "aa-lg-g4-i":
        m = SubstModel(datatype="aa", name="LG", n_classes=4, invar=True,
                       freqs_mode="model")
        p = m.init_params()
        p["alpha"] = jnp.asarray(0.9)
        p["pinv"] = jnp.asarray(0.15)
        return "aa", m, p
    if kind == "aa-lg4x":
        m = lg4x_model()
        p = m.init_params()
        p["class_rates_raw"] = jnp.log(jnp.asarray([0.4, 0.7, 1.2, 2.8]))
        p["class_weights_raw"] = jnp.log(
            jnp.asarray([0.35, 0.32, 0.18, 0.15]))
        return "aa", m, p
    m = SubstModel(datatype="nt", name="HKY85", n_classes=2,
                   covarion=True)
    p = m.init_params(np.array([0.25, 0.25, 0.25, 0.25]))
    p["cov_delta"] = jnp.asarray(0.8)
    return "nt", m, p


@pytest.mark.parametrize("kind", ["nt-gtr-g4", "aa-lg-g4-i", "aa-lg4x",
                                  "nt-covarion"])
def test_reference_matches_scan(kind):
    datatype, model, params = _model(kind)
    aln, topo, *_ = bench_problem(datatype, n_taxa=12, n_sites=150,
                                  seed=5)
    rv = topo.rooted()
    eng = LikelihoodEngine(aln, model, dtype=jnp.float64)
    got = np.asarray(eng.site_logliks(
        params, tree_arrays(rv, dtype=jnp.float64)))[:aln.n_patterns]
    want = reference.alignment_site_logliks(aln, rv, model, params)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert abs(float(np.sum(got * aln.weights))
               - float(np.sum(want * aln.weights))) < 1e-7


def test_reference_rescaling_deep_tree():
    """A 600-taxon caterpillar's site likelihoods underflow float64
    (log below -745) without rescaling; the reference stays finite and
    matches the scan."""
    from phyml_tpu.topology import Topology

    aln, _, model, params, *_ = bench_problem("nt", n_taxa=600,
                                               n_sites=20, seed=2)
    rv = Topology.caterpillar(600, blen=0.3).rooted()
    eng = LikelihoodEngine(aln, model, dtype=jnp.float64)
    got = np.asarray(eng.site_logliks(
        params, tree_arrays(rv, dtype=jnp.float64)))[:aln.n_patterns]
    want = reference.alignment_site_logliks(aln, rv, model, params)
    assert np.all(np.isfinite(want)) and want.min() < -745
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_bench_problem_is_deterministic():
    a1, t1, _, _, n1, s1 = bench_problem("nt", n_taxa=10, n_sites=64,
                                         seed=11)
    a2, t2, _, _, n2, s2 = bench_problem("nt", n_taxa=10, n_sites=64,
                                         seed=11)
    assert s1 == s2 and n1 == n2
    np.testing.assert_array_equal(t1.edges, t2.edges)
    np.testing.assert_array_equal(t1.blen, t2.blen)
    np.testing.assert_array_equal(a1.weights, a2.weights)
    _, _, _, _, _, s3 = bench_problem("nt", n_taxa=10, n_sites=64,
                                      seed=12)
    assert s3 != s1


def test_bench_problem_shapes():
    aln, topo, model, _, names, seqs = bench_problem(
        "aa", n_taxa=9, n_sites=50, seed=3)
    assert aln.n_otu == 9 and aln.n_sites == 50 and model.ns == 20
    assert len(names) == len(seqs) == 9
    assert all(len(s) == 50 for s in seqs)
    assert topo.n_otu == 9
    with pytest.raises(ValueError):
        bench_problem("codon")
