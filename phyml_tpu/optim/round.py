"""Coordinate-ascent parameter optimization (Round_Optimize).

Mirrors the reference's outer loop (optimiz.c:669 Round_Optimize:
alternate branch-length optimization with model-parameter
optimization until the gain stalls) and its per-parameter Brent
searches (Optimiz_All_Free_Param optimiz.c:962).  Parameter bounds
follow utilities.h: TSTV in [0.05, 100], ALPHA in [0.01, 1000],
PINV in [1e-5, 0.99999], RR in [1e-4, 1e4].

Positive parameters are searched in log space; pinv in logit space;
FreeRate raws and frequency logits unconstrained.  Each Brent
evaluation is one compiled likelihood call on device.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
from jax import lax

from phyml_tpu.optim.blen import optimize_branch_lengths


def _logit(p):
    return math.log(p / (1.0 - p))


def _inv_logit(x):
    return 1.0 / (1.0 + math.exp(-x))


def free_scalar_slots(model, params):
    """List of (name, index_or_None, transform, lo, hi) Brent slots.
    transform maps the searched variable -> parameter value."""
    slots = []
    exp = math.exp
    if model.optimize_kappa and "kappa" in params:
        slots.append(("kappa", None, exp,
                      math.log(0.05), math.log(100.0)))
    if model.optimize_kappa and "lambda" in params:
        slots.append(("lambda", None, exp,
                      math.log(0.01), math.log(100.0)))
    if model.optimize_rr and "rr_val" in params:
        n_rr = int(np.asarray(params["rr_val"]).shape[0])
        # last rate is the normalizer (G<->T for GTR); keep it fixed
        for i in range(n_rr - 1):
            slots.append(("rr_val", i, lambda x: x,
                          math.log(1e-4), math.log(1e4)))
    if model.optimize_alpha and "alpha" in params:
        slots.append(("alpha", None, exp,
                      math.log(0.01), math.log(1000.0)))
    if model.optimize_pinv and "pinv" in params:
        slots.append(("pinv", None, _inv_logit,
                      _logit(1e-5), _logit(0.99)))
    if "class_rates_raw" in params:
        n = int(np.asarray(params["class_rates_raw"]).shape[0])
        for i in range(n):
            slots.append(("class_rates_raw", i, lambda x: x, -7.0, 7.0))
        for i in range(n - 1):
            # weights are softmax-normalized; fix the last logit
            slots.append(("class_weights_raw", i, lambda x: x,
                          -9.0, 9.0))
    if "il_sigma" in params:
        # IL branch-length variance (reference l_var_sigma, optimized
        # by Generic_Brent optimiz.c:2953); stored as log(sigma)
        slots.append(("il_sigma", None, lambda x: x,
                      math.log(1e-4), math.log(100.0)))
    if "freqs_raw" in params:
        n = int(np.asarray(params["freqs_raw"]).shape[0])
        for i in range(n - 1):
            slots.append(("freqs_raw", i, lambda x: x, -9.0, 9.0))
    if getattr(model, "covarion", False) and model.optimize_cov:
        # Optimize_M4mod bounds: delta in [0.01, 10] (optimiz.c:1016),
        # covarion alpha in [0.01, 10] (:1087), free multipliers and
        # class freqs in [0.1, 100] (:1047/:1068)
        if "cov_delta" in params:
            slots.append(("cov_delta", None, exp,
                          math.log(0.01), math.log(10.0)))
        if "cov_alpha" in params:
            slots.append(("cov_alpha", None, exp,
                          math.log(0.01), math.log(10.0)))
        if "cov_multipl_raw" in params:
            for i in range(model.n_hidden):
                slots.append(("cov_multipl_raw", i, exp,
                              math.log(0.1), math.log(100.0)))
            for i in range(model.n_hidden):
                slots.append(("cov_h_fq_raw", i, exp,
                              math.log(0.1), math.log(100.0)))
    return slots


def _get(params, name, idx):
    v = np.asarray(params[name])
    return float(v) if idx is None else float(v[idx])


def _set(params, name, idx, value):
    p = dict(params)
    if idx is None:
        p[name] = jnp.asarray(value, dtype=jnp.result_type(params[name]))
    else:
        p[name] = jnp.asarray(params[name]).at[idx].set(value)
    return p


def _x0_of(tf, cur):
    if tf is math.exp:
        return math.log(max(cur, 1e-12))
    if tf is _inv_logit:
        return _logit(min(max(cur, 1e-6), 1.0 - 1e-6))
    return cur


def _tf_kind(tf):
    """Static transform tag for a slot (device dispatch by tag)."""
    if tf is math.exp:
        return "exp"
    if tf is _inv_logit:
        return "inv_logit"
    return "id"


def _apply_tf_jnp(kind, x):
    if kind == "exp":
        return jnp.exp(x)
    if kind == "inv_logit":
        return 1.0 / (1.0 + jnp.exp(-x))
    return x


def _make_scalar_optimizer(engine, slot_sig, grid, zooms):
    """Compile the ENTIRE multi-zoom joint line search into ONE
    device program (a `lax.while_loop` over zoom levels).

    A host-driven version would pay ~2 device round-trips per zoom;
    on-device zooming costs one dispatch for arbitrarily many zoom
    levels and runs until the bracket step drops below brent_tol.

    slot_sig: static tuple of (name, idx, tf_kind, lo, hi).
    Equivalent of the reference's per-parameter Brent searches
    (Generic_Brent_Lk optimiz.c:2475, Optimiz_All_Free_Param
    optimiz.c:962), all parameters jointly with a guarded step."""
    import jax

    n_slots = len(slot_sig)

    def set_all(params, s):
        p = dict(params)
        for j, (name, idx, kind, lo, hi) in enumerate(slot_sig):
            v = _apply_tf_jnp(kind, s[j])
            if idx is None:
                p[name] = jnp.asarray(
                    v, dtype=jnp.result_type(params[name]))
            else:
                p[name] = jnp.asarray(p[name]).at[idx].set(v)
        return p

    def run(tree, weights, params, s0, lnl0, brent_tol):
        lnl_of = lambda s: engine._loglik(set_all(params, s), tree,
                                          weights)
        lo = jnp.asarray([sl[3] for sl in slot_sig], dtype=s0.dtype)
        hi = jnp.asarray([sl[4] for sl in slot_sig], dtype=s0.dtype)

        def body(state):
            zoom, a, b, s_cur, lnl_cur = state
            step = (b - a) / (grid - 1)
            # candidate matrix [n_slots, grid+1]: linspace + current
            g = jnp.arange(grid, dtype=s0.dtype)
            xs = a[:, None] + step[:, None] * g[None, :]
            xs = jnp.concatenate([xs, s_cur[:, None]], axis=1)
            # variant s-vectors: slot j takes xs[j, k], others current
            eye = jnp.eye(n_slots, dtype=s0.dtype)
            svar = (s_cur[None, None, :] * (1.0 - eye)[:, None, :]
                    + xs[:, :, None] * eye[:, None, :])
            vals = jax.vmap(lnl_of)(
                svar.reshape(n_slots * (grid + 1), n_slots))
            vals = jnp.where(jnp.isfinite(vals), vals, -jnp.inf)
            vals = vals.reshape(n_slots, grid + 1)
            k_best = jnp.argmax(vals, axis=1)
            best_val = jnp.take_along_axis(
                vals, k_best[:, None], axis=1)[:, 0]
            best_x = jnp.take_along_axis(
                xs, k_best[:, None], axis=1)[:, 0]
            improved = best_val > lnl_cur + 1e-9
            s_joint = jnp.where(improved, best_x, s_cur)
            i_star = jnp.argmax(jnp.where(improved, best_val,
                                          -jnp.inf))
            s_single = s_cur.at[i_star].set(best_x[i_star])
            pair = jax.vmap(lnl_of)(jnp.stack([s_joint, s_single]))
            any_improved = jnp.any(improved)
            take_joint = any_improved & (pair[0] >= pair[1]) & \
                (pair[0] > lnl_cur)
            take_single = any_improved & ~take_joint & \
                (pair[1] > lnl_cur)
            s_new = jnp.where(take_joint, s_joint,
                              jnp.where(take_single, s_single, s_cur))
            lnl_new = jnp.where(
                take_joint, pair[0],
                jnp.where(take_single, pair[1], lnl_cur))
            # shrink every bracket around its best grid point
            a_new = jnp.maximum(lo, best_x - step)
            b_new = jnp.minimum(hi, best_x + step)
            return zoom + 1, a_new, b_new, s_new, lnl_new

        def cond(state):
            zoom, a, b, _, _ = state
            step = jnp.max((b - a) / (grid - 1))
            return (zoom < zooms) & (step >= brent_tol)

        state = (jnp.asarray(0), lo, hi, s0,
                 jnp.asarray(lnl0, dtype=jnp.float64))
        _, _, _, s_fin, lnl_fin = lax.while_loop(cond, body, state)
        return s_fin, lnl_fin

    return jax.jit(engine.bind_data(run))


def optimize_scalars(engine, model, params, tree, lnl0=None,
                     brent_tol: float = 1e-4, weights=None,
                     grid: int = 12, zooms: int = 16):
    """Joint line search over ALL free scalars; returns (params, lnL).

    Every slot's `grid` candidate values are scored by one vmapped
    likelihood (batched eigensystems + likelihoods), per-slot winners
    are applied jointly with a single-best fallback guard, and the
    per-slot brackets shrink geometrically — the whole zoom loop runs
    ON DEVICE in one dispatch (see _make_scalar_optimizer)."""
    slots = free_scalar_slots(model, params)
    if not slots:
        if lnl0 is None:
            lnl0 = float(engine.loglik(params, tree, weights))
        return params, lnl0
    weights_v = engine.weights if weights is None else weights
    lnl = float(engine.loglik(params, tree, weights)) \
        if lnl0 is None else lnl0

    slot_sig = tuple(
        (name, idx, _tf_kind(tf), float(lo), float(hi))
        for name, idx, tf, lo, hi in slots)
    key = (slot_sig, grid, zooms)
    cache = getattr(engine, "_scalar_opt_cache", None)
    if cache is None:
        cache = engine._scalar_opt_cache = {}
    fn = cache.get(key)
    if fn is None:
        fn = cache[key] = _make_scalar_optimizer(engine, slot_sig,
                                                 grid, zooms)

    s0 = np.asarray([
        _x0_of(tf, _get(params, name, idx))
        for name, idx, tf, lo, hi in slots
    ])
    s_fin, lnl_fin = fn(engine.data(), tree, weights_v, params,
                        jnp.asarray(s0), lnl,
                        jnp.asarray(brent_tol))
    s_fin = np.asarray(s_fin)
    for j, (name, idx, tf, lo, hi) in enumerate(slots):
        params = _set(params, name, idx, tf(float(s_fin[j])))
    return params, float(lnl_fin)


def round_optimize(
    engine,
    model,
    params,
    tree,
    opt_blen: bool = True,
    opt_params: bool = True,
    tol: float = 1e-3,
    max_rounds: int = 20,
    blen_tol: float = 1e-4,
    verbose: bool = False,
    weights=None,
):
    """Alternate branch-length and model-parameter optimization until
    a full round gains < tol log units (Round_Optimize optimiz.c:669).
    Returns (params, tree, lnL)."""
    lnl = float(engine.loglik(params, tree, weights))
    for it in range(max_rounds):
        start = lnl
        if opt_blen:
            tree, lnl = optimize_branch_lengths(
                engine, params, tree, tol=blen_tol, weights=weights
            )
        if opt_params:
            params, lnl = optimize_scalars(engine, model, params, tree,
                                           lnl0=lnl, weights=weights)
        if verbose:
            print(f"  round {it}: lnL {lnl:.5f}")
        if lnl - start < tol:
            break
    return params, tree, lnl
