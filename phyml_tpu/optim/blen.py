"""Branch-length optimization: all edges at once, on device.

The reference optimizes one edge at a time with Newton steps on the
eigen-LR reparameterized likelihood (Br_Len_Opt optimiz.c:607,
Br_Len_Spline optimiz.c:2244, dLk lk.c:655), sweeping edges in post-
order (Optimize_Br_Len_Serie optimiz.c:714).  On TPU a sequential
sweep wastes the machine; instead each round is:

  1. one up+down pass producing every edge's eigen-basis dot products
     (LikelihoodEngine.edge_dotprods - the vectorized Update_Eigen_Lr),
  2. a fixed number of safeguarded Newton iterations on ALL edge
     lengths in parallel (each edge maximizing the tree likelihood as
     a function of its own length, others held fixed - block-Jacobi),
  3. a global backtracking line search toward the previous lengths if
     the joint update overshot (the reference instead error-exits on
     non-monotonicity, optimiz.c:656-661; Jacobi coupling makes a
     safeguard mandatory here).

Rounds repeat until the gain is below tol.  Each round costs ~3 full
likelihood passes regardless of edge count, vs n_edges passes for the
reference's sweep.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

from phyml_tpu.ops.likelihood import TreeArrays

BL_MIN = 1e-8   # utilities.h:483
BL_MAX = 100.0  # utilities.h:484
_N_NEWTON = 10
_MAX_BACKTRACK = 15


def _round_core(engine):
    """The un-jitted one-round update (embedded by both the single-
    round entry point and the on-device convergence loop)."""

    def newton_all_edges(d, sc_d, aux, t0, mask):
        def body(_, t):
            _, d1, d2 = engine.edge_lnl_terms(d, sc_d, aux, t)
            newton = t - d1 / jnp.where(d2 < 0, d2, -1.0)
            # fall back to a multiplicative probe when curvature is
            # useless; clamp each step to a factor-of-3 move
            probe = jnp.where(d1 > 0, t * 3.0, t / 3.0)
            t_new = jnp.where(d2 < -1e-12, newton, probe)
            t_new = jnp.clip(t_new, t / 3.0, t * 3.0)
            t_new = jnp.clip(t_new, BL_MIN, BL_MAX)
            # edge_lnl_terms accumulates in float64; keep the carry at
            # the engine dtype so the fori_loop types stay fixed
            return jnp.where(mask, t_new, t0).astype(t0.dtype)

        return lax.fori_loop(0, _N_NEWTON, body, jnp.where(mask, t0, t0))

    def round_fn(sys, tree: TreeArrays, lnl0, weights):
        d, sc_d, aux = engine.edge_dotprods_sys(sys, tree, weights)
        n_nodes = engine.n_nodes
        idx = jnp.arange(n_nodes)
        root = n_nodes - 1
        zero_child = tree.child[-1, 1]  # root's zero-length side
        mask = (idx != root) & (idx != zero_child)

        t0 = tree.blen
        t1 = newton_all_edges(d, sc_d, aux, jnp.clip(t0, BL_MIN, BL_MAX),
                              mask)
        t1 = jnp.where(mask, t1, t0)

        def lnl_at(t):
            return engine._loglik_sys(sys, TreeArrays(tree.child, t),
                                      weights)

        def cond(state):
            t, lnl, k = state
            return (lnl < lnl0) & (k < _MAX_BACKTRACK)

        def back(state):
            t, _, k = state
            t = jnp.where(mask, 0.5 * (t + t0), t0)
            return t, lnl_at(t), k + 1

        t_fin, lnl_fin, _ = lax.while_loop(
            cond, back, (t1, lnl_at(t1), jnp.asarray(0))
        )
        # final guard: never return a worse tree than we started with
        worse = lnl_fin < lnl0
        t_fin = jnp.where(worse, t0, t_fin)
        lnl_fin = jnp.where(worse, lnl0, lnl_fin)
        return TreeArrays(tree.child, t_fin), lnl_fin

    return round_fn


def _make_blen_round(engine):
    """Jitted single-round update (driver dryrun / callers embedding
    one round in their own programs)."""
    return jax.jit(engine.bind_data(_round_core(engine)))


def _blen_opt_core(engine, tol: float, max_rounds: int):
    """Unjitted whole-optimization core (see _make_blen_opt); also
    vmapped over stacked replicate (tree, weights) pairs by the
    batched bootstrap (search/support.py)."""
    round_fn = _round_core(engine)

    def opt(sys, tree: TreeArrays, weights):
        lnl0 = engine._loglik_sys(sys, tree, weights)
        tree1, lnl1 = round_fn(sys, tree, lnl0, weights)

        def cond(c):
            _, lnl, prev, i = c
            return (i < max_rounds) & ((lnl - prev) >= tol)

        def body(c):
            tr, lnl, _, i = c
            tr2, lnl2 = round_fn(sys, tr, lnl, weights)
            return tr2, lnl2, lnl, i + 1

        tree_f, lnl_f, _, _ = lax.while_loop(
            cond, body, (tree1, lnl1, lnl0, jnp.asarray(1)))
        return tree_f, lnl_f

    return opt


def _make_blen_opt(engine, tol: float, max_rounds: int):
    """Whole optimization as ONE device program: rounds repeat in a
    lax.while_loop until the gain drops below tol, with a single final
    transfer instead of one device->host scalar sync per round."""
    return jax.jit(engine.bind_data(_blen_opt_core(engine, tol,
                                                   max_rounds)))


def optimize_branch_lengths_batched(engine, params, trees, weights,
                                    tol: float = 1e-4,
                                    max_rounds: int = 32):
    """All replicates' branch-length optimization in ONE dispatch:
    trees is a stacked TreeArrays (leading replicate axis), weights
    [R, P].  vmap of the on-device while_loop runs until every
    replicate converges.  Returns (stacked trees, lnL [R])."""
    import jax as _jax

    cache = getattr(engine, "_blen_opt_batched_fns", None)
    if cache is None:
        cache = engine._blen_opt_batched_fns = {}
    key = (float(tol), int(max_rounds))
    fn = cache.get(key)
    if fn is None:
        core = _blen_opt_core(engine, tol, max_rounds)
        fn = cache[key] = _jax.jit(engine.bind_data(
            _jax.vmap(core, in_axes=(None, 0, 0))))
    trees_f, lnls = fn(engine.data(), engine.system_of(params),
                       trees, weights)
    return trees_f, np.asarray(lnls)


def optimize_branch_lengths(
    engine,
    params,
    tree: TreeArrays,
    tol: float = 1e-4,
    max_rounds: int = 32,
    weights=None,
):
    """Maximize lnL over all branch lengths; returns (tree, lnL).

    tol: stop when a full parallel-Newton round gains less than this
    many log units (reference default min_diff_lk_local = 1e-5 with
    per-edge Brent tolerances much looser).
    """
    cache = getattr(engine, "_blen_opt_fns", None)
    if cache is None:
        cache = engine._blen_opt_fns = {}
    key = (float(tol), int(max_rounds))
    fn = cache.get(key)
    if fn is None:
        fn = cache[key] = _make_blen_opt(engine, tol, max_rounds)
    weights = engine.weights if weights is None else weights
    tree, lnl = fn(engine.data(), engine.system_of(params), tree,
                   weights)
    return tree, float(lnl)
