"""ML pairwise distances, all pairs at once.

The reference computes per-pair ML distances with a host Brent loop
(ML_Dist lk.c:1783 -> Opt_Dist_F optimiz.c:1958 -> Lk_Dist lk.c:2416),
building for each pair a joint state-count matrix F[ns, ns] so the
two-sequence likelihood is a dot product: lnL(t) = sum_xy F_xy log
(pi_x sum_c w_c P_xy(t r_c)).  Pairs are independent, so here all
n(n-1)/2 pairs run together on device: F is one einsum over patterns,
the optimizer is a log-spaced grid scan refined by vectorized Newton.

Ambiguity handling follows the reference (lk.c:1852-1860): site pairs
where either sequence is ambiguous (gap, N, partial codes) are
excluded from F entirely.  Rate-across-site classes are disabled for
distance estimation, also matching the reference (lk.c:1817-1824).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from phyml_tpu.models.eigen import pmat

DIST_MIN = 1e-8
DIST_MAX = 2.0  # utilities.h:351
_GRID = 64
_NEWTON = 25


@jax.jit
def _all_pair_counts(tips, weights):
    """F [n_pairs, ns, ns] joint weighted state counts for all pairs
    (i < j, row-major), counting only site pairs where BOTH sequences
    have a single definite state (reference: Assign_State > -1 check,
    lk.c:1852-1860).  tips: [n_otu, ns, P]; weights: [P]."""
    definite = (jnp.sum(tips > 0, axis=1) == 1).astype(tips.dtype)
    t = tips * definite[:, None, :]
    tw = t * weights[None, None, :]
    F = jnp.einsum("axp,byp->abxy", tw, t)
    n = tips.shape[0]
    iu = jnp.triu_indices(n, k=1)
    return F[iu[0], iu[1]]


@jax.jit
def _pair_loglik(F, lam, V, Vinv, pi, w, t):
    """lnL [n_pairs] at distances t [n_pairs]."""
    P = pmat(lam, V, Vinv, t[:, None] * jnp.ones((1, lam.shape[0])))
    mix = jnp.einsum("c,ncxy->nxy", w, P)          # [n_pairs, ns, ns]
    site = pi[0][None, :, None] * mix
    return jnp.sum(F * jnp.log(jnp.maximum(site, 1e-300)), axis=(1, 2))


@jax.jit
def _grid_start(F, lam, V, Vinv, pi, w, grid):
    def eval_at(t_scalar):
        t = jnp.full((F.shape[0],), t_scalar, dtype=F.dtype)
        return _pair_loglik(F, lam, V, Vinv, pi, w, t)

    lls = jax.lax.map(eval_at, grid)               # [G, n_pairs]
    return grid[jnp.argmax(lls, axis=0)]


@jax.jit
def _refine(F, lam, V, Vinv, pi, w, t0):
    """Newton refinement with secant curvature, vectorized over pairs.
    Module-level jit with F as an ARGUMENT: per-call closures would
    recompile for every bootstrap replicate and embed F as a program
    constant."""
    def total(t):
        return jnp.sum(_pair_loglik(F, lam, V, Vinv, pi, w, t))

    g = jax.grad(total)

    def body(_, t):
        d1 = g(t)
        eps = 1e-5
        d2e = (g(t + eps) - d1) / eps
        step = d1 / jnp.where(d2e < 0, -d2e, 1.0)
        tn = jnp.where(d2e < -1e-12, t + step,
                       jnp.where(d1 > 0, t * 1.5, t / 1.5))
        tn = jnp.clip(tn, t / 2.0, t * 2.0)
        return jnp.clip(tn, DIST_MIN, DIST_MAX).astype(t.dtype)

    return jax.lax.fori_loop(0, _NEWTON, body, t0)


def ml_pairwise_distances(engine, params, weights=None) -> np.ndarray:
    """Full symmetric [n_otu, n_otu] ML distance matrix."""
    # single unit-rate class (reference disables gamma, lk.c:1817-1824)
    lam, V, Vinv, pi, w_, _ = engine.model.class_system(
        params, fold_rates=False
    )
    c = lambda x: jnp.asarray(x, dtype=engine.dtype)
    lam, V, Vinv, pi = c(lam[:1]), c(V[:1]), c(Vinv[:1]), c(pi[:1])
    w = jnp.ones((1,), dtype=engine.dtype)
    tips = engine.tips
    weights = engine.weights if weights is None else weights
    F = _all_pair_counts(tips, weights.astype(engine.dtype))

    # grid scan (log-spaced) for a robust start
    grid = jnp.logspace(np.log10(1e-4), np.log10(DIST_MAX), _GRID
                        ).astype(engine.dtype)
    t0 = _grid_start(F, lam, V, Vinv, pi, w, grid)
    t_hat = np.asarray(_refine(F, lam, V, Vinv, pi, w, t0))
    n = engine.n_otu
    D = np.zeros((n, n))
    iu = np.triu_indices(n, k=1)
    D[iu] = t_hat
    D = D + D.T
    return D
