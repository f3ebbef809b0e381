"""Gamma-MGF branch-length-integrated P(t) (PMat_MGF_Gamma
models.c:1044, the Guindon 2012 relaxed clock of lk.c:2310-2323)."""

import jax.numpy as jnp
import numpy as np


def _system():
    from phyml_tpu.models.substitution import SubstModel

    model = SubstModel(datatype="nt", name="HKY85", n_classes=4)
    params = model.init_params(np.asarray([0.3, 0.2, 0.3, 0.2]))
    lam, V, Vinv, pi, w, pinv = model.class_system(params)
    return lam, V, Vinv


def test_mgf_sigma_zero_is_plain_pmat():
    from phyml_tpu.models.eigen import pmat, pmat_mgf_gamma

    lam, V, Vinv = _system()
    t = jnp.asarray(np.linspace(0.01, 0.9, 12).reshape(3, 4))
    p0 = pmat(lam, V, Vinv, t)
    p1 = pmat_mgf_gamma(lam, V, Vinv, t, 0.0)
    np.testing.assert_allclose(np.asarray(p0), np.asarray(p1),
                               rtol=1e-10)


def test_mgf_matches_monte_carlo():
    """E[P(L)] over L ~ Gamma(mean t, var t*sigma), estimated by a
    dense quadrature over the Gamma density."""
    from phyml_tpu.models.eigen import pmat, pmat_mgf_gamma

    lam, V, Vinv = _system()
    t = 0.3
    sigma = 0.2
    tm = jnp.full((1, lam.shape[0]), t)
    got = np.asarray(pmat_mgf_gamma(lam, V, Vinv, tm, sigma))[0]

    # quadrature: L ~ Gamma(shape=t/sigma, scale=sigma)
    shape, scale = t / sigma, sigma
    from scipy import stats  # scipy ships with the jax stack
    xs = np.linspace(1e-8, t + 14 * np.sqrt(t * sigma), 8001)
    pdf = stats.gamma.pdf(xs, a=shape, scale=scale)
    pdf /= np.trapezoid(pdf, xs)
    C = lam.shape[0]
    t_all = jnp.asarray(np.repeat(xs[:, None], C, axis=1))
    p_all = np.asarray(pmat(lam, V, Vinv, t_all))     # [N, C, ns, ns]
    acc = np.trapezoid(p_all * pdf[:, None, None, None], xs, axis=0)
    np.testing.assert_allclose(got, acc, atol=2e-4)
    # rows remain probability vectors
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


def test_engine_loglik_mgf_limits(nucleic):
    """loglik_mgf(sigma->0) == loglik; larger sigma changes lnL."""
    from phyml_tpu.models.substitution import SubstModel
    from phyml_tpu.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu.topology import Topology

    model = SubstModel(datatype="nt", name="HKY85", n_classes=4)
    params = model.init_params(nucleic.obs_state_freqs)
    eng = LikelihoodEngine(nucleic, model, dtype=jnp.float64)
    rng = np.random.default_rng(2)
    topo = Topology.random(nucleic.n_otu, rng, mean_blen=0.08)
    ta = tree_arrays(topo.rooted(), dtype=jnp.float64)
    base = float(eng.loglik(params, ta))
    lim = float(eng.loglik_mgf(params, ta, 1e-14))
    assert abs(base - lim) < 1e-5 * abs(base)
    var = float(eng.loglik_mgf(params, ta, 0.5))
    assert abs(var - base) > 1.0


def test_mcmc_guindon_runs():
    """A short Guindon-clock chain runs, mixes, and its incremental
    lnL (computed through loglik_mgf) matches a recompute."""
    import pytest
    from phyml_tpu.bayes.chrono import TimeTree
    from phyml_tpu.bayes.mcmc import MCMC, MCMCSettings
    from phyml_tpu.bayes.rates import RateModel
    from phyml_tpu.bayes.times import TimePrior
    from phyml_tpu.models.substitution import SubstModel
    from phyml_tpu.ops.likelihood import LikelihoodEngine
    from tests.test_bayes import _sim_alignment

    rng = np.random.default_rng(9)
    tt = TimeTree.coalescent(6, rng, theta=0.4)
    aln = _sim_alignment(tt, rng, n_sites=120)
    model = SubstModel(datatype="nt", name="HKY85", n_classes=1)
    # float64 engine: the cached-vs-recomputed lnL audit below needs
    # cross-program reproducibility, and two differently-fused f32
    # XLA programs legitimately differ by ~1e-6 at |lnL|~5e2
    engine = LikelihoodEngine(aln, model, dtype=jnp.float64)
    params = model.init_params(aln.obs_state_freqs)

    mcmc = MCMC(engine, model, params, tt, RateModel(kind="guindon"),
                TimePrior(kind="coalescent"),
                MCMCSettings(n_iter=200, burnin=100, batch=50,
                             seed=4))
    st, trace, acc = mcmc.run()
    lnL_re = float(mcmc._lnL(st))
    assert float(st.lnL) == pytest.approx(lnL_re, abs=1e-6)
    assert np.isfinite(trace[:, 0]).all()


def test_il_model_ml_tier():
    """--il (integrated-length) support in the ML tier: with
    params["il_sigma"] set, the engine substitutes the MGF
    eigenvalues mu = -log(1 - lam*sigma)/sigma in _system, making
    EVERY path (kernels, eigen-LR Newton, searches) exact under IL.

    The reference binary cannot serve as the oracle here: its --il
    path errors out in optimiz.c:852 under `-o lr` and its `-o n`
    evaluation fails the sigma->0 limit (l_var=1e-6 gives -5783.08
    where the plain likelihood is -5681.82 — the Gamma(mean t,
    var t*sigma) expectation must converge to P(t); measured r4,
    bit-rotted upstream like --cov).  So the checks are the model's
    own mathematical properties plus agreement with the
    independently-implemented MGF path (pmat_mgf_gamma, which
    mirrors PMat_MGF_Gamma models.c:1044)."""
    import jax.numpy as jnp

    from phyml_tpu.io.alignment import read_alignment
    from phyml_tpu.models.substitution import SubstModel
    from phyml_tpu.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu.optim.blen import optimize_branch_lengths
    from phyml_tpu.optim.round import free_scalar_slots, round_optimize
    from phyml_tpu.topology import Topology

    aln = read_alignment("/root/reference/examples/nucleic",
                         datatype="nt")
    tree = Topology.from_newick(
        open("tests/golden/ref_tree_A.nwk").read(), aln.names)
    m = SubstModel(datatype="nt", name="HKY85", n_classes=4)
    eng = LikelihoodEngine(aln, m, dtype=jnp.float64)
    p = m.init_params(aln.obs_state_freqs)
    ta = tree_arrays(tree.rooted(), dtype=jnp.float64)
    plain = float(eng.loglik(p, ta))

    # equality with the explicit MGF path at several sigmas
    for sig in (0.05, 0.3, 1.0):
        p_il = dict(p)
        p_il["il_sigma"] = jnp.asarray(np.log(sig))
        l_sub = float(eng.loglik(p_il, ta))
        l_mgf = float(eng.loglik_mgf(p, ta, sig))
        assert abs(l_sub - l_mgf) < 1e-8, (sig, l_sub, l_mgf)
        assert l_sub < plain          # integrating noise costs lnL

    # sigma -> 0 recovers the plain likelihood (the limit the
    # reference binary's --il fails)
    p_il = dict(p)
    p_il["il_sigma"] = jnp.asarray(np.log(1e-13))
    assert abs(float(eng.loglik(p_il, ta)) - plain) < 1e-6

    # il_sigma is an optimizer slot, and joint optimization under IL
    # (branch lengths via the eigen-LR Newton with substituted
    # eigenvalues + scalars incl. sigma) improves and stays finite
    p_il = dict(p)
    p_il["il_sigma"] = jnp.asarray(np.log(0.1))
    names = [s[0] for s in free_scalar_slots(m, p_il)]
    assert "il_sigma" in names
    l0 = float(eng.loglik(p_il, ta))
    p_opt, ta_opt, l_opt = round_optimize(eng, m, p_il, ta,
                                          max_rounds=3)
    assert l_opt > l0
    # the fitted sigma should be small on data simulated without IL
    # noise; at minimum it must have moved off the init and the
    # optimized lnL must approach the plain-model optimum from below
    # IL nests the plain model at sigma->0, so its joint optimum can
    # only match or beat the plain branch-length optimum
    ta2, l_plain_opt = optimize_branch_lengths(eng, p, ta)
    assert l_opt >= l_plain_opt - 1e-6, (l_opt, l_plain_opt)
