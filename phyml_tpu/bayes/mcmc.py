"""Jitted Metropolis-Hastings machinery (≙ mcmc.c, 14,901 lines).

Design: the reference implements ~90 hand-specialized moves, each
with its own partial-likelihood bookkeeping and tuning state
(mcmc.c:6591-6668, MCMC_Adjust_Tuning_Parameter).  TPU-native, the
chain state is a pytree, every move is one branch of a single
`lax.switch` returning (proposed state, log-Hastings), the joint
log-posterior is one pure function (likelihood-engine call + rate
prior + time prior + calibrations + hyperpriors), and a whole batch
of iterations runs on-device under `lax.scan`.  Moves that do not
touch branch lengths skip the likelihood recompute via `lax.cond`
(the reference's equivalent: per-move `Lk` on the affected subtree).

Step-size auto-tuning happens on host between scan batches during
burn-in, targeting the reference's acceptance window (0.234-0.44,
MCMC_Adjust_Tuning_Parameter mcmc.c); tuned sizes are traced scan
arguments, so retuning never recompiles.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from phyml_tpu.bayes.rates import STRICT, RateModel
from phyml_tpu.bayes.times import TimePrior
from phyml_tpu.ops.likelihood import TreeArrays

NEG_INF = -1e30


class ChainState(NamedTuple):
    child: jnp.ndarray      # int32 [n-1, 2] postorder child table —
    #                         topology is CHAIN STATE (tree moves,
    #                         ≙ mcmc.c MCMC_Prune_Regraft family)
    parent: jnp.ndarray     # int32 [2n-1]
    heights: jnp.ndarray    # [2n-1] node heights (tips fixed)
    log_r: jnp.ndarray      # [2n-1] per-edge log relative rates
    log_clock: jnp.ndarray  # scalar
    log_nu: jnp.ndarray     # scalar rate-variation hyperparam
    hyper: dict             # birth/death/rho/theta/growth scalars
    subst: dict             # substitution params (kappa, alpha, ...)
    log_s2x: jnp.ndarray    # scalar: log trait/location sigma^2
    trait_lr: jnp.ndarray   # [2n-1] RRW log edge scalers (phyrex)
    lnL: jnp.ndarray
    lp: jnp.ndarray         # total prior log-density


@dataclass
class MCMCSettings:
    n_iter: int = 20000
    burnin: int = 2000
    batch: int = 250        # iterations per on-device scan
    thin: int = 10
    seed: int = 0
    tune_every: int = 250
    target_accept: tuple = (0.234, 0.44)
    clock_prior_mean_log: float = 0.0
    clock_prior_sd_log: float = 3.0


class MCMC:
    """Joint sampler over (node times, lineage rates, clock,
    hyperparameters, substitution parameters) on a fixed rooted
    topology — the phytime posterior (date.c:779 DATE_MCMC)."""

    MOVE_NAMES = [
        "height_slide", "root_scale", "tree_scale", "clock_scale",
        "rate_walk", "nu_scale", "hyper_scale", "subst_kappa",
        "subst_alpha", "rates_clock_swap", "trait_s2", "trait_scaler",
        "tree_clock_swap", "subtree_scale",
        # r4 mixing additions (≙ mcmc.c:6591-6668 tuned-move depth):
        "updown_root_clock", "rate_exchange", "nu_rates_updown",
        "height_jitter", "updown_t_br", "subtree_rates",
        # r5: the times-slice family (≙ MCMC_Time_Slice /
        # MCMC_Times windows) + covarion parameters (≙ cov_rates /
        # cov_switch, mcmc.c:6614-6615)
        "time_slice", "time_slice_br", "cov_switch", "cov_rates",
        # r5: gradient-informed joint move over (all heights, clock)
        # - a capability the C reference cannot have; jax.grad flows
        # through the likelihood scan, so one move updates every
        # height with curvature-aware drift (MALA)
        "mala_times",
    ]

    def __init__(self, engine, model, subst_params, time_tree,
                 rate_model: RateModel, time_prior: TimePrior,
                 settings: MCMCSettings | None = None,
                 trait_x=None, trait_kind: str = "rrw",
                 trait_nu: float = 1.0, fastlk: bool = False,
                 sample_topology: bool = False,
                 topo_moves_per_batch: int | None = None):
        """trait_x [n_otu, D] (optional): observed tip coordinates /
        continuous traits; when given, the chain jointly samples the
        movement model (trait_kind in rw/rrw/ibm/iwn/iou) — the
        phyrex posterior (PHYREX_MCMC phyrex.c:1234) with the
        genealogy informed by both sequences and locations."""
        # The chain accumulates |lnL| ~ 1e3-1e5 and audits per-move
        # consistency to ~1e-5 (≙ date.c:1013-1031); float32 rounding
        # (0.01-1 log units at that magnitude) would corrupt the
        # Metropolis accept ratios, so the whole bayes tier requires
        # real float64 scalars.
        jax.config.update("jax_enable_x64", True)
        if fastlk and rate_model.kind == "guindon":
            # the quadratic lnL expansion is a function of expected
            # branch lengths only; it cannot represent the Guindon-2012
            # within-branch variance nu, so sampling nu against it
            # would silently draw nu from the prior alone
            raise ValueError(
                "fastlk is incompatible with the Guindon (2012) "
                "integrated relaxed clock: the normal approximation "
                "ignores the within-branch rate variance nu. Use the "
                "exact likelihood (fastlk=False) for this clock model."
            )
        self.engine = engine
        self.model = model
        self.tt = time_tree
        self.fastlk = fastlk
        self._normal_approx = None
        self.rate_model = rate_model
        self.time_prior = time_prior.resolve(time_tree)
        self.s = settings or MCMCSettings()
        self.trait_x = None if trait_x is None else jnp.asarray(trait_x)
        self.trait_kind = trait_kind
        self.trait_nu = trait_nu
        self.sample_topology = sample_topology
        if sample_topology and fastlk:
            raise ValueError("fastlk expands around ONE topology; "
                             "it cannot support tree moves")
        # r4: the integrated movement models (ibm/iwn/iou) derive
        # their MRCA table inside the trace (_mrca_table_traced), so
        # the genealogy can be chain state for every trait kind
        self.topo_moves_per_batch = (
            topo_moves_per_batch if topo_moves_per_batch is not None
            else max(4, time_tree.n_otu))

        n = time_tree.n_otu
        self.n_otu = n
        self.n_nodes = time_tree.n_nodes
        self.root = time_tree.root
        self.child = jnp.asarray(time_tree.child, dtype=jnp.int32)
        self.parent = jnp.asarray(time_tree.parent, dtype=jnp.int32)
        self.tip_heights = jnp.asarray(time_tree.heights[:n])
        self.subst_fixed = dict(subst_params)
        self._movable_subst = [
            k for k in ("kappa", "alpha", "cov_delta", "cov_alpha")
            if k in subst_params]
        self.hyper_names = self.time_prior.hyper_names()

        # per-move step sizes (tuned on host during burn-in)
        self.step = np.array([
            0.5,   # height_slide (fraction of the (lo,hi) window: n/a)
            0.5,   # root_scale log-multiplier width
            0.2,   # tree_scale
            0.3,   # clock_scale
            0.3,   # rate_walk sd
            0.5,   # nu_scale
            0.3,   # hyper_scale
            0.3,   # kappa
            0.3,   # alpha
            1.0,   # rates_clock_swap
            0.5,   # trait_s2
            0.5,   # trait_scaler
            1.5,   # tree_clock_swap
            0.3,   # subtree_scale
            0.5,   # updown_root_clock
            0.3,   # rate_exchange
            0.3,   # nu_rates_updown
            0.5,   # height_jitter (fraction of the (lo,hi) window)
            0.5,   # updown_t_br
            0.3,   # subtree_rates
            0.3,   # time_slice
            0.4,   # time_slice_br
            0.3,   # cov_switch (delta)
            0.3,   # cov_rates (alpha)
            0.01,  # mala_times step (epsilon)
        ])
        has_tr = trait_x is not None
        w = np.array([
            3.0 * (n - 2), 2.0, 2.0, 2.0,
            (1.5 * (2 * n - 2)) if rate_model.kind != STRICT else 0.0,
            2.0 if rate_model.kind != STRICT else 0.0,
            2.0 * len(self.hyper_names), 7.0, 7.0,
            6.0 if rate_model.kind != STRICT else 0.0,
            2.0 if has_tr else 0.0,
            (1.5 * (2 * n - 2)) if has_tr and trait_kind == "rrw"
            else 0.0,
            6.0,                    # tree_clock_swap (lnL-invariant)
            1.0 * max(n - 3, 0),    # subtree_scale
            6.0,                    # updown_root_clock
            (1.0 * (n - 1)) if rate_model.kind != STRICT else 0.0,
            2.0 if rate_model.kind in ("lognormal", "thorne")
            else 0.0,               # nu_rates_updown
            2.0 * (n - 2),          # height_jitter
            3.0 if rate_model.kind != STRICT else 0.0,  # updown_t_br
            2.0 if rate_model.kind != STRICT else 0.0,  # subtree_rates
            1.5,                    # time_slice
            (2.0 if rate_model.kind != STRICT else 0.0),
            # time_slice_br (lnL-invariant, needs free rates)
            5.0 if "cov_delta" in subst_params else 0.0,
            5.0 if "cov_alpha" in subst_params else 0.0,
            # mala_times: one move updates ALL heights + the clock;
            # costs ~2 gradient evaluations, so weight it like a
            # handful of scalar moves.  It differentiates _lnL, the
            # engine's traced scan (_loglik); only the quadratic
            # fastlk surface has no gradient rule here.
            (0.5 * n) if not fastlk else 0.0,
        ])
        if "kappa" not in subst_params:
            w[7] = 0.0
        if "alpha" not in subst_params:
            w[8] = 0.0
        if fastlk:
            # expansion is only valid at the expansion-point model
            w[7] = w[8] = 0.0
            w[self.MOVE_NAMES.index("cov_switch")] = 0.0
            w[self.MOVE_NAMES.index("cov_rates")] = 0.0
            self._movable_subst = []
        self._mala_enabled = bool(w[-1] > 0)
        self.move_w = jnp.asarray(w / w.sum())
        # fixed MALA metric: per-node height scales from the initial
        # tree's feasible windows (tips get 1 but are masked out)
        h0 = np.asarray(time_tree.heights, dtype=np.float64)
        par0 = np.asarray(time_tree.parent)
        ch0 = np.asarray(time_tree.child)
        mh = np.ones(self.n_nodes)
        for i in range(n - 1):
            u = n + i
            lo = max(h0[ch0[i, 0]], h0[ch0[i, 1]])
            hi = h0[par0[u]] if u != self.n_nodes - 1 \
                else h0[u] * 1.5 + 1e-6
            mh[u] = max(abs(hi - lo), 1e-4)
        self._mala_mh = jnp.asarray(mh)

        if fastlk:
            from phyml_tpu.optim.fastlk import fit_normal_approx
            h = np.asarray(time_tree.heights, dtype=np.float64)
            dt0 = h[np.asarray(time_tree.parent)] - h
            dt0[self.root] = 0.0
            tree0 = TreeArrays(
                child=self.child,
                blen=jnp.asarray(np.maximum(dt0, 0.0),
                                 dtype=engine.dtype))
            self._normal_approx = fit_normal_approx(
                engine, self.subst_fixed, tree0, engine.weights)

        # engine data rides in as traced arguments (bind_data): a
        # closure-captured tips tensor would embed MBs of constants in
        # the batch program and cripple dispatch (see likelihood.py)
        self._jit_batch = jax.jit(engine.bind_data(self._run_batch),
                                  static_argnames=("n_steps",))

    # ------------------------------------------------------------------
    # joint posterior
    # ------------------------------------------------------------------
    def _blen(self, state: ChainState):
        dt = (state.heights[state.parent] - state.heights
              ).at[self.root].set(0.0)
        rates = self.rate_model.rates(state.log_r, self.root)
        blen = jnp.exp(state.log_clock) * rates * dt
        return blen.at[self.root].set(0.0), dt

    def _lnL(self, state: ChainState):
        blen, _ = self._blen(state)
        if self._normal_approx is not None:
            # --fastlk path (≙ Lk_Normal_Approx lk.c:2521): quadratic
            # expansion of lnL around the expansion-point branch
            # lengths — no tree traversal per move.  Only valid while
            # substitution parameters stay at their expansion values,
            # so fastlk chains hold them fixed (as the reference does).
            return self._normal_approx.loglik(
                blen.astype(self.engine.dtype))
        tree = TreeArrays(child=state.child,
                          blen=blen.astype(self.engine.dtype))
        subst = {**self.subst_fixed, **state.subst}
        if self.rate_model.kind == "guindon":
            # Guindon 2012 branch-length-integrated clock: P matrices
            # are the Gamma-MGF expectation E[P(L)] with within-branch
            # rate variance nu (gamma_mgf_bl path, lk.c:2310-2323 ->
            # PMat_MGF_Gamma models.c:1044)
            return self.engine._loglik_mgf(
                subst, tree,
                jnp.exp(state.log_nu).astype(self.engine.dtype),
                self.engine.weights)
        return self.engine._loglik(subst, tree, self.engine.weights)

    def _log_prior(self, state: ChainState):
        dt = (state.heights[state.parent] - state.heights
              ).at[self.root].set(0.0)
        feasible = jnp.min(dt) >= -1e-12
        nu = jnp.exp(state.log_nu)
        lp = self.rate_model.log_prior(state.log_r, dt, state.parent,
                                       nu, self.root)
        lp = lp + self.time_prior.log_prior(state.heights, self.n_otu,
                                            state.hyper)
        lp = lp + self.time_prior.log_calibrations(state.heights)
        # hyperpriors: Exp(1) on positive hypers + nu, N(m, sd) on
        # log clock, N(0, 3^2) on growth
        for nm in self.hyper_names:
            v = state.hyper[nm]
            if nm == "growth":
                lp = lp - 0.5 * (v / 3.0) ** 2
            else:
                lp = lp - v
        lp = lp - nu
        z = ((state.log_clock - self.s.clock_prior_mean_log)
             / self.s.clock_prior_sd_log)
        lp = lp - 0.5 * z * z
        if self.trait_x is not None:
            # location/trait likelihood rides in the prior slot so it
            # is recomputed for every move touching heights or the
            # movement parameters (it is cheap relative to the
            # sequence likelihood)
            from phyml_tpu.bayes.traits import location_loglik
            s2x = jnp.exp(state.log_s2x)
            dtc = jnp.maximum(dt, 0.0)
            if self.trait_kind in ("rw", "rrw"):
                lk_x = location_loglik(
                    self.trait_kind, self.trait_x, state.child, dtc,
                    s2x, log_scalers=state.trait_lr,
                    nu=jnp.asarray(self.trait_nu))
            else:
                # integrated models (ibm/iwn/iou): state.child so
                # genealogy moves re-derive the MRCA table in-trace
                lk_x = location_loglik(
                    self.trait_kind, self.trait_x,
                    state.child, dtc, s2x)
            lp = lp + lk_x - s2x  # Exp(1) hyperprior on sigma^2
        return jnp.where(feasible, lp, NEG_INF)

    # ------------------------------------------------------------------
    # moves: each returns (proposed_state, log_hastings, affects_lk)
    # ------------------------------------------------------------------
    def _mv_height_slide(self, st, key, step):
        k1, k2 = jax.random.split(key)
        # random internal non-root node
        i = jax.random.randint(k1, (), 0, self.n_otu - 2)
        u = self.n_otu + i
        lo = jnp.maximum(st.heights[st.child[i, 0]],
                         st.heights[st.child[i, 1]])
        hi = st.heights[st.parent[u]]
        h = jax.random.uniform(k2, (), minval=lo, maxval=hi)
        return st._replace(heights=st.heights.at[u].set(h)), 0.0, True

    def _mv_root_scale(self, st, key, step):
        i = self.root - self.n_otu
        lo = jnp.maximum(st.heights[st.child[i, 0]],
                         st.heights[st.child[i, 1]])
        m = jnp.exp(step * (jax.random.uniform(key, ()) - 0.5))
        h = lo + m * (st.heights[self.root] - lo)
        return (st._replace(heights=st.heights.at[self.root].set(h)),
                jnp.log(m), True)

    def _mv_tree_scale(self, st, key, step):
        m = jnp.exp(step * (jax.random.uniform(key, ()) - 0.5))
        h = st.heights.at[self.n_otu:].multiply(m)
        log_h = (self.n_otu - 1) * jnp.log(m)
        return st._replace(heights=h), log_h, True

    def _mv_clock_scale(self, st, key, step):
        d = step * (jax.random.uniform(key, ()) - 0.5)
        return st._replace(log_clock=st.log_clock + d), 0.0, True

    def _mv_rate_walk(self, st, key, step):
        k1, k2 = jax.random.split(key)
        u = jax.random.randint(k1, (), 0, self.n_nodes - 1)
        d = step * jax.random.normal(k2, ())
        return (st._replace(log_r=st.log_r.at[u].add(d)), 0.0, True)

    def _mv_nu_scale(self, st, key, step):
        d = step * (jax.random.uniform(key, ()) - 0.5)
        # under the Guindon integrated clock, nu is the within-branch
        # rate variance fed to the MGF likelihood (loglik_mgf), so a
        # nu move changes lnL, not just the prior
        affects = self.rate_model.kind == "guindon"
        return st._replace(log_nu=st.log_nu + d), 0.0, affects

    def _mv_hyper_scale(self, st, key, step):
        if not self.hyper_names:
            return st, 0.0, False
        k1, k2 = jax.random.split(key)
        j = jax.random.randint(k1, (), 0, len(self.hyper_names))
        hyper = dict(st.hyper)
        log_h = jnp.asarray(0.0)
        for idx, nm in enumerate(self.hyper_names):
            if nm == "growth":
                prop = hyper[nm] + step * jax.random.normal(k2, ())
                lh = 0.0
            else:
                m = jnp.exp(step * (jax.random.uniform(k2, ()) - 0.5))
                prop = hyper[nm] * m
                lh = jnp.log(m)
            hyper[nm] = jnp.where(j == idx, prop, hyper[nm])
            log_h = jnp.where(j == idx, lh, log_h)
        return st._replace(hyper=hyper), log_h, False

    def _mv_subst(self, name, lo, hi):
        def mv(st, key, step):
            if name not in st.subst:
                return st, 0.0, False
            m = jnp.exp(step * (jax.random.uniform(key, ()) - 0.5))
            v = st.subst[name] * m
            # A proposal outside [lo, hi] is REJECTED (log-Hastings
            # -inf), not clipped: clipping puts an atom at the bound
            # with no matching reverse density and biases the
            # posterior near the bounds.
            ok = (v >= lo) & (v <= hi)
            subst = dict(st.subst)
            subst[name] = jnp.where(ok, v, st.subst[name])
            lh = jnp.where(ok, jnp.log(m), NEG_INF)
            return st._replace(subst=subst), lh, True
        return mv

    def _mv_rates_clock_swap(self, st, key, step):
        """Mixing move: scale all relative rates by m and the clock by
        1/m — leaves branch lengths (and lnL) invariant, moves the
        prior decomposition (≙ MCMC_Rates_Shrink-style moves)."""
        log_m = step * (jax.random.uniform(key, ()) - 0.5)
        # pure translation in (log_r, log_clock) space: |J| = 1 and the
        # proposal is symmetric, so the Hastings term vanishes
        return (st._replace(log_r=st.log_r + log_m,
                            log_clock=st.log_clock - log_m),
                0.0, False)

    def _mv_trait_s2(self, st, key, step):
        d = step * (jax.random.uniform(key, ()) - 0.5)
        return st._replace(log_s2x=st.log_s2x + d), 0.0, False

    def _mv_trait_scaler(self, st, key, step):
        k1, k2 = jax.random.split(key)
        u = jax.random.randint(k1, (), 0, self.n_nodes - 1)
        d = step * jax.random.normal(k2, ())
        return (st._replace(trait_lr=st.trait_lr.at[u].add(d)),
                0.0, False)

    def _mv_tree_clock_swap(self, st, key, step):
        """Scale ALL internal heights by m and the clock by 1/m:
        branch lengths (and lnL) are invariant, the (times, rate)
        decomposition moves (≙ MCMC_Updown_T_Cr mcmc.c).  Hastings:
        (n-1) log m from the height scaling, 0 from the clock
        translation in log space."""
        m = jnp.exp(step * (jax.random.uniform(key, ()) - 0.5))
        h = st.heights.at[self.n_otu:].multiply(m)
        log_h = (self.n_otu - 1) * jnp.log(m)
        # blen invariance (lnL reuse) only holds when every tip sits
        # at height 0: with heterochronous tips the tip-edge dt is not
        # scaled uniformly, so the likelihood must be recomputed
        affects = bool(np.any(np.asarray(self.tip_heights) != 0.0))
        return (st._replace(heights=h,
                            log_clock=st.log_clock - jnp.log(m)),
                log_h, affects)

    def _mv_subtree_scale(self, st, key, step):
        """Scale the internal heights STRICTLY below a random internal
        non-root node u by m (≙ the reference's subtree-height moves);
        infeasible proposals (child older than parent) die in the
        prior's feasibility check."""
        k1, k2 = jax.random.split(key)
        n = self.n_otu
        u = jax.random.randint(k1, (), n, self.root)   # internal, non-root
        # descendant mask via a reverse sweep over the postorder table
        def body(j, mask):
            i = self.n_otu - 2 - j                     # high -> low
            node = n + i
            on = mask[node]
            c0 = st.child[i, 0]
            c1 = st.child[i, 1]
            return mask.at[c0].set(mask[c0] | on)                        .at[c1].set(mask[c1] | on)
        mask = jnp.zeros(self.n_nodes, dtype=bool).at[u].set(True)
        mask = lax.fori_loop(0, self.n_otu - 1, body, mask)
        scaled = mask.at[u].set(False)                 # strict subtree
        scaled = scaled & (jnp.arange(self.n_nodes) >= n)  # internal
        m = jnp.exp(step * (jax.random.uniform(k2, ()) - 0.5))
        h = jnp.where(scaled, st.heights * m, st.heights)
        log_hast = jnp.sum(scaled) * jnp.log(m)
        return st._replace(heights=h), log_hast, True

    def _mv_updown_root_clock(self, st, key, step):
        """Scale the root height toward/away from its children by m
        and the clock by 1/m: the root-edge lengths stay near-constant
        while (root age, clock) decorrelate (≙ MCMC_Updown_T_Cr,
        mcmc.c).  Hastings: log m from the height part."""
        i = self.root - self.n_otu
        lo = jnp.maximum(st.heights[st.child[i, 0]],
                         st.heights[st.child[i, 1]])
        m = jnp.exp(step * (jax.random.uniform(key, ()) - 0.5))
        h = lo + m * (st.heights[self.root] - lo)
        return (st._replace(
            heights=st.heights.at[self.root].set(h),
            log_clock=st.log_clock - jnp.log(m)), jnp.log(m), True)

    def _mv_rate_exchange(self, st, key, step):
        """Antithetic rate update on the two child edges of a random
        internal node: +d on one, -d on the other.  Keeps the local
        rate mass while changing both branch lengths — mixes the
        autocorrelated (Thorne) and lognormal rate fields much faster
        than independent single-edge walks (≙ the reference's
        exchange-between-adjacent-edges moves)."""
        k1, k2 = jax.random.split(key)
        i = jax.random.randint(k1, (), 0, self.n_otu - 1)
        c0 = st.child[i, 0]
        c1 = st.child[i, 1]
        d = step * jax.random.normal(k2, ())
        log_r = st.log_r.at[c0].add(d).at[c1].add(-d)
        return st._replace(log_r=log_r), 0.0, True

    def _mv_nu_rates_updown(self, st, key, step):
        """Scale the per-edge log-rate deviations by m and nu by m^2:
        the standardized rate field is invariant, so the move slides
        along the (nu, spread) ridge that traps single-variable nu
        walks.  Hastings: (n_edges) log m from the log_r scaling (the
        log_nu translation has unit Jacobian)."""
        m = jnp.exp(step * (jax.random.uniform(key, ()) - 0.5))
        used = jnp.arange(self.n_nodes) != self.root
        log_r = jnp.where(used, st.log_r * m, st.log_r)
        n_used = self.n_nodes - 1
        return (st._replace(log_r=log_r,
                            log_nu=st.log_nu + 2.0 * jnp.log(m)),
                n_used * jnp.log(m), True)

    def _mv_height_jitter(self, st, key, step):
        """Reflected local jitter of one internal non-root height
        within its (oldest child, parent) window — a tuned companion
        to the uniform-window redraw of height_slide (which jumps far
        but accepts rarely; ≙ MCMC_Times windowed slides)."""
        k1, k2 = jax.random.split(key)
        i = jax.random.randint(k1, (), 0, self.n_otu - 2)
        u = self.n_otu + i
        lo = jnp.maximum(st.heights[st.child[i, 0]],
                         st.heights[st.child[i, 1]])
        hi = st.heights[st.parent[u]]
        w = hi - lo
        d = step * w * (jax.random.uniform(k2, ()) - 0.5)
        x = jnp.mod(st.heights[u] + d - lo, 2.0 * w)
        h = lo + jnp.minimum(x, 2.0 * w - x)     # reflect into (lo,hi)
        return st._replace(heights=st.heights.at[u].set(h)), 0.0, True

    def _mv_updown_t_br(self, st, key, step):
        """Move one internal non-root height while RESCALING the three
        incident edges' relative rates so every branch length is
        exactly invariant — lnL is reused, only the (times, rates)
        prior decomposition moves (≙ MCMC_Updown_T_Br mcmc.c).
        Jacobian: m from the height map times dt_e/dt'_e per rescaled
        rate."""
        k1, k2 = jax.random.split(key)
        i = jax.random.randint(k1, (), 0, self.n_otu - 2)
        u = self.n_otu + i
        c0 = st.child[i, 0]
        c1 = st.child[i, 1]
        lo = jnp.maximum(st.heights[c0], st.heights[c1])
        hi = st.heights[st.parent[u]]
        m = jnp.exp(step * (jax.random.uniform(k2, ()) - 0.5))
        h_new = lo + m * (st.heights[u] - lo)
        h_new = jnp.clip(h_new, lo + 1e-12, hi - 1e-12)
        dt_u = hi - st.heights[u]
        dt_u2 = hi - h_new
        dt0 = st.heights[u] - st.heights[c0]
        dt0_2 = h_new - st.heights[c0]
        dt1 = st.heights[u] - st.heights[c1]
        dt1_2 = h_new - st.heights[c1]
        # blen invariance (the basis for reusing lnL) requires the
        # rate compensation r' = r * dt/dt' to be EXACT: reject any
        # proposal touching a near-degenerate gap rather than clamp
        # (a clamped log would silently change branch lengths and
        # cache a stale likelihood)
        eps = 1e-9
        feasible = (h_new > lo) & (h_new < hi) \
            & (dt_u > eps) & (dt_u2 > eps) \
            & (dt0 > eps) & (dt0_2 > eps) \
            & (dt1 > eps) & (dt1_2 > eps)
        safe = lambda x: jnp.maximum(x, eps)
        lr = st.log_r
        lr = lr.at[u].add(jnp.log(safe(dt_u)) - jnp.log(safe(dt_u2)))
        lr = lr.at[c0].add(jnp.log(safe(dt0)) - jnp.log(safe(dt0_2)))
        lr = lr.at[c1].add(jnp.log(safe(dt1)) - jnp.log(safe(dt1_2)))
        # |J| = m (height) x 1 per log-rate translation
        log_h = jnp.where(feasible, jnp.log(m), NEG_INF)
        return (st._replace(heights=st.heights.at[u].set(
            jnp.where(feasible, h_new, st.heights[u])), log_r=lr),
            log_h, False)

    def _mv_subtree_rates(self, st, key, step):
        """Translate the log-rates of every edge strictly below a
        random internal node by d (≙ MCMC_Subtree_Rates): moves a
        whole clade's rate level in one step."""
        k1, k2 = jax.random.split(key)
        n = self.n_otu
        u = jax.random.randint(k1, (), n, self.root)

        def body(j, mask):
            i = self.n_otu - 2 - j
            node = n + i
            on = mask[node]
            c0 = st.child[i, 0]
            c1 = st.child[i, 1]
            return mask.at[c0].set(mask[c0] | on)                        .at[c1].set(mask[c1] | on)

        mask = jnp.zeros(self.n_nodes, dtype=bool).at[u].set(True)
        mask = lax.fori_loop(0, self.n_otu - 1, body, mask)
        mask = mask.at[u].set(False)
        d = step * jax.random.normal(k2, ())
        log_r = jnp.where(mask, st.log_r + d, st.log_r)
        return st._replace(log_r=log_r), 0.0, True

    def _mv_time_slice(self, st, key, step):
        """Scale every node height ABOVE a random time slice tau by m
        (h' = tau + m (h - tau)): a correlated update of all deep
        nodes at once (≙ MCMC_Time_Slice, the reference's times-
        window family mcmc.c:6591-6668).  Hastings: n_above log m."""
        k1, k2 = jax.random.split(key)
        tau = jax.random.uniform(k1, ()) * st.heights[self.root]
        m = jnp.exp(step * (jax.random.uniform(k2, ()) - 0.5))
        internal = jnp.arange(self.n_nodes) >= self.n_otu
        above = internal & (st.heights > tau)
        h = jnp.where(above, tau + m * (st.heights - tau), st.heights)
        # Hastings: height Jacobian PLUS the state-dependent slice
        # draw (tau ~ U(0, h_root); the reverse draws from
        # U(0, h_root')): + log h_root - log h_root'
        log_h = (jnp.sum(above) * jnp.log(m)
                 + jnp.log(st.heights[self.root])
                 - jnp.log(h[self.root]))
        return st._replace(heights=h), log_h, True

    def _mv_time_slice_br(self, st, key, step):
        """time_slice with exact branch-length compensation: rates on
        every edge whose duration changed are rescaled by dt/dt', so
        all branch lengths (and lnL) are invariant and only the
        (times, rates) decomposition moves — the lnL-reuse companion
        that makes deep-time mixing cheap (≙ MCMC_Updown_T_Br
        generalized to a slice)."""
        k1, k2 = jax.random.split(key)
        tau = jax.random.uniform(k1, ()) * st.heights[self.root]
        m = jnp.exp(step * (jax.random.uniform(k2, ()) - 0.5))
        internal = jnp.arange(self.n_nodes) >= self.n_otu
        above = internal & (st.heights > tau)
        h_new = jnp.where(above, tau + m * (st.heights - tau),
                          st.heights)
        dt_old = (st.heights[st.parent] - st.heights
                  ).at[self.root].set(1.0)
        dt_new = (h_new[st.parent] - h_new).at[self.root].set(1.0)
        eps = 1e-9
        changed = jnp.abs(dt_new - dt_old) > 0.0
        feasible = jnp.all(~changed | ((dt_new > eps)
                                       & (dt_old > eps)))
        safe = lambda x: jnp.maximum(x, eps)
        comp = jnp.where(changed,
                         jnp.log(safe(dt_old)) - jnp.log(safe(dt_new)),
                         0.0)
        # Hastings: height Jacobian + the state-dependent tau draw
        # (see _mv_time_slice)
        log_h = jnp.where(
            feasible,
            jnp.sum(above) * jnp.log(m)
            + jnp.log(st.heights[self.root])
            - jnp.log(h_new[self.root]),
            NEG_INF)
        prop = st._replace(
            heights=jnp.where(feasible, h_new, st.heights),
            log_r=st.log_r + jnp.where(feasible, comp, 0.0))
        return prop, log_h, False

    def _mv_mala_times(self, st, key, step):
        """Metropolis-adjusted Langevin move over (all internal
        heights, log clock): one gradient of the joint log-posterior
        drives a curvature-aware drift, so every height moves together
        in the direction the data wants.  The C reference has no
        autodiff and cannot express this move; here jax.grad flows
        through the same likelihood scan the chain already compiles.
        Exact MALA Hastings with the reverse-gradient term."""
        n = self.n_otu
        internal = (jnp.arange(self.n_nodes) >= n).astype(jnp.float64)
        non_root = (jnp.arange(self.n_nodes) != self.root
                    ).astype(jnp.float64)
        use_r = self.rate_model.kind != STRICT
        r_mask = non_root * (1.0 if use_r else 0.0)
        snames = list(self._movable_subst)

        def logpost(h, lc, lr, lsub):
            subst = dict(st.subst)
            for j, nm in enumerate(snames):
                subst[nm] = jnp.exp(lsub[j])
            s2 = st._replace(heights=h, log_clock=lc, log_r=lr,
                             subst=subst)
            # + sum(lsub): Jacobian of the log-parameterization so
            # the move targets the posterior of the ORIGINAL scalars
            return self._lnL(s2) + self._log_prior(s2) + (
                jnp.sum(lsub) if snames else 0.0)

        lsub0 = (jnp.stack([jnp.log(st.subst[nm]) for nm in snames])
                 if snames else jnp.zeros((0,)))
        grad_fn = jax.grad(logpost, argnums=(0, 1, 2, 3))

        def clean(g, mask):
            return jnp.where(jnp.isfinite(g), g, 0.0) * mask

        g_h, g_c, g_r, g_s = grad_fn(st.heights, st.log_clock,
                                     st.log_r, lsub0)
        g_h = clean(g_h, internal)
        g_c = clean(g_c, 1.0)
        g_r = clean(g_r, r_mask)
        g_s = clean(g_s, 1.0)
        eps = step
        # diagonal preconditioner: each height moves on the scale of
        # its feasible window in the INITIAL tree — a fixed metric,
        # so the kernel is exact MALA (a state-dependent metric would
        # need the Riemannian correction terms)
        m_h = self._mala_mh
        k1, k2, k3, k4 = jax.random.split(key, 4)
        xi_h = jax.random.normal(k1, (self.n_nodes,)) * internal
        xi_c = jax.random.normal(k2, ())
        xi_r = jax.random.normal(k3, (self.n_nodes,)) * r_mask
        xi_s = jax.random.normal(k4, (len(snames),))
        e2h = eps * eps * m_h * m_h
        h_new = st.heights + 0.5 * e2h * g_h + eps * m_h * xi_h * internal
        c_new = st.log_clock + 0.5 * eps * eps * g_c + eps * xi_c
        r_new = st.log_r + 0.5 * eps * eps * g_r + eps * xi_r
        s_new = lsub0 + 0.5 * eps * eps * g_s + eps * xi_s
        # reverse drift at the proposal
        g_h2, g_c2, g_r2, g_s2 = grad_fn(h_new, c_new, r_new, s_new)
        g_h2 = clean(g_h2, internal)
        g_c2 = clean(g_c2, 1.0)
        g_r2 = clean(g_r2, r_mask)
        g_s2 = clean(g_s2, 1.0)

        def logq(x_to, x_from, g_from, mask, scale):
            mu = x_from + 0.5 * eps * eps * scale * scale * g_from
            r = (x_to - mu) * mask / (eps * scale)
            return -jnp.sum(r * r) / 2.0

        log_h = (logq(st.heights, h_new, g_h2, internal, m_h)
                 + logq(st.log_clock, c_new, g_c2, 1.0, 1.0)
                 + logq(st.log_r, r_new, g_r2, r_mask, 1.0)
                 + logq(lsub0, s_new, g_s2, 1.0, 1.0)
                 - logq(h_new, st.heights, g_h, internal, m_h)
                 - logq(c_new, st.log_clock, g_c, 1.0, 1.0)
                 - logq(r_new, st.log_r, g_r, r_mask, 1.0)
                 - logq(s_new, lsub0, g_s, 1.0, 1.0))
        # the chain's accept ratio uses the ORIGINAL-space densities,
        # so the log-parameterization's Jacobian enters as Hastings
        if snames:
            log_h = log_h + (jnp.sum(s_new) - jnp.sum(lsub0))
        subst_new = dict(st.subst)
        for j, nm in enumerate(snames):
            subst_new[nm] = jnp.exp(s_new[j])
        return (st._replace(heights=h_new, log_clock=c_new,
                            log_r=r_new, subst=subst_new),
                log_h, True)

    # ------------------------------------------------------------------
    def _step(self, st: ChainState, key, steps):
        kmv, kprop, kacc = jax.random.split(key, 3)
        mv = jax.random.choice(kmv, len(self.MOVE_NAMES),
                               p=self.move_w)
        branches = [
            self._mv_height_slide, self._mv_root_scale,
            self._mv_tree_scale, self._mv_clock_scale,
            self._mv_rate_walk, self._mv_nu_scale,
            self._mv_hyper_scale,
            self._mv_subst("kappa", 0.05, 100.0),
            self._mv_subst("alpha", 0.01, 100.0),
            self._mv_rates_clock_swap,
            self._mv_trait_s2,
            self._mv_trait_scaler,
            self._mv_tree_clock_swap,
            self._mv_subtree_scale,
            self._mv_updown_root_clock,
            self._mv_rate_exchange,
            self._mv_nu_rates_updown,
            self._mv_height_jitter,
            self._mv_updown_t_br,
            self._mv_subtree_rates,
            self._mv_time_slice,
            self._mv_time_slice_br,
            self._mv_subst("cov_delta", 0.01, 100.0),
            self._mv_subst("cov_alpha", 0.01, 100.0),
            self._mv_mala_times if self._mala_enabled
            else self._mv_clock_scale,
        ]

        def branch(fn, i):
            def run(st_key):
                st_, key_ = st_key
                prop, lh, aff = fn(st_, key_, steps[i])
                return prop, jnp.asarray(lh, dtype=jnp.float64), \
                    jnp.asarray(aff)
            return run

        prop, log_h, affects = lax.switch(
            mv, [branch(f, i) for i, f in enumerate(branches)],
            (st, kprop))

        lp_new = self._log_prior(prop)
        lnL_new = lax.cond(
            affects & (lp_new > NEG_INF / 2),
            lambda p: jnp.asarray(self._lnL(p), dtype=jnp.float64),
            lambda p: st.lnL, prop)
        log_alpha = (lnL_new + lp_new) - (st.lnL + st.lp) + log_h
        accept = jnp.log(jax.random.uniform(kacc, ())) < log_alpha
        prop = prop._replace(lnL=lnL_new, lp=lp_new)
        new = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, a, b), prop, st)
        return new, mv, accept

    def _run_batch(self, st: ChainState, key, steps, n_steps: int):
        def body(carry, k):
            st, tries, accs = carry
            st, mv, acc = self._step(st, k, steps)
            tries = tries.at[mv].add(1)
            accs = accs.at[mv].add(acc.astype(jnp.int32))
            trace = jnp.stack([
                st.lnL + st.lp, st.lnL, st.heights[self.root],
                st.log_clock, st.log_nu,
            ])
            return (st, tries, accs), trace

        keys = jax.random.split(key, n_steps)
        tries = jnp.zeros(len(self.MOVE_NAMES), dtype=jnp.int32)
        accs = jnp.zeros(len(self.MOVE_NAMES), dtype=jnp.int32)
        (st, tries, accs), trace = lax.scan(body, (st, tries, accs),
                                            keys)
        return st, tries, accs, trace

    # ------------------------------------------------------------------
    # topology moves (host-side, between jitted batches)
    # ------------------------------------------------------------------
    # The reference's dating MCMC mixes rare structural moves
    # (MCMC_Prune_Regraft + variants, mcmc.c:6591-6668) with the dense
    # scalar moves.  Here the dense moves run on-device in lax.scan
    # batches; topology proposals run on host between batches (each
    # needs tree surgery + one posterior evaluation), with the
    # postorder child table renumbered after every accepted move so
    # the engine's scan schedule stays valid.

    def _eval_posterior(self, st: ChainState):
        fn = getattr(self, "_jit_eval_", None)
        if fn is None:
            fn = jax.jit(self.engine.bind_data(
                lambda s: (self._lnL(s), self._log_prior(s))))
            self._jit_eval_ = fn
        lnL, lp = fn(self.engine.data(), st)
        return (jnp.asarray(lnL, dtype=jnp.float64),
                jnp.asarray(lp, dtype=jnp.float64))

    def _narrow_exchange(self, child, parent, heights, rng):
        """Narrow exchange: swap a random child g of internal node c
        with c's sibling s (symmetric proposal; invalid if the moved
        sibling would be older than its new parent).  Returns
        (child', parent', log_hastings) or None."""
        n = self.n_otu
        c = int(rng.integers(n, self.root))       # internal, non-root
        p = int(parent[c])
        row_p = child[p - n]
        s = int(row_p[1] if int(row_p[0]) == c else row_p[0])
        gi = int(rng.integers(0, 2))
        g = int(child[c - n][gi])
        if heights[c] <= heights[s]:
            return None                            # h(c) must exceed h(s)
        ch = child.copy()
        pa = parent.copy()
        ch[p - n] = [c, g]
        ch[c - n][gi] = s
        pa[g] = p
        pa[s] = c
        return ch, pa, 0.0

    def _spr_times(self, child, parent, heights, rng):
        """Prune-regraft at fixed height: detach node x (with its
        parent p), regraft p into a random edge spanning h(p)
        (≙ MCMC_Prune_Regraft, mcmc.c).  Hastings = log F - log R
        where F/R count spanning edges before/after."""
        n = self.n_otu
        x = int(rng.integers(0, self.root))        # any non-root node
        p = int(parent[x])
        if p == self.root:
            return None
        g = int(parent[p])
        row_p = child[p - n]
        s = int(row_p[1] if int(row_p[0]) == x else row_p[0])
        hp = heights[p]

        def in_subtree(b, root_of):
            while b != self.root:
                if b == root_of:
                    return True
                b = int(parent[b])
            return b == root_of

        def spanning(ch, pa, exclude_sib):
            out = []
            for b in range(self.root):
                a = int(pa[b])
                if heights[a] > hp >= heights[b] and b != x \
                        and b != p and b != exclude_sib \
                        and not in_subtree(b, x):
                    out.append(b)
            return out

        cands = spanning(child, parent, s)
        if not cands:
            return None
        b = int(cands[rng.integers(0, len(cands))])
        a = int(parent[b])
        ch = child.copy()
        pa = parent.copy()
        # detach: g adopts s in place of p
        row_g = ch[g - n]
        ch[g - n] = [s if int(v) == p else int(v) for v in row_g]
        pa[s] = g
        # attach: a adopts p in place of b; p's children = {x, b}
        row_a = ch[a - n]
        ch[a - n] = [p if int(v) == b else int(v) for v in row_a]
        pa[p] = a
        ch[p - n] = [x, b]
        pa[b] = p
        # reverse move count: spanning edges in the NEW tree for the
        # same pivot height, excluding x's NEW sibling b
        def spanning_new():
            def in_sub_new(bb):
                q = bb
                while q != self.root:
                    if q == x:
                        return True
                    q = int(pa[q])
                return False
            out = []
            for bb in range(self.root):
                aa = int(pa[bb])
                if heights[aa] > hp >= heights[bb] and bb != x \
                        and bb != p and bb != b and not in_sub_new(bb):
                    out.append(bb)
            return out

        R = len(spanning_new())
        if R == 0:
            return None
        log_h = float(np.log(len(cands)) - np.log(R))
        return ch, pa, log_h

    def _spr_times_weighted(self, child, parent, heights, rng,
                            lam: float = 0.7):
        """Prune-regraft at fixed height with LOCALITY-WEIGHTED target
        choice: a spanning edge b is picked with probability
        proportional to lam^hops(p, b) (topological distance), so
        most proposals are small rearrangements that actually accept,
        with the exact Hastings correction for the asymmetric choice
        (≙ MCMC_Prune_Regraft_Weighted / spr_weighted,
        mcmc.c:6604-6607)."""
        n = self.n_otu
        x = int(rng.integers(0, self.root))
        p = int(parent[x])
        if p == self.root:
            return None
        g = int(parent[p])
        row_p = child[p - n]
        s = int(row_p[1] if int(row_p[0]) == x else row_p[0])
        hp = heights[p]

        def path_to_root(pa, u):
            out = [u]
            while out[-1] != self.root:
                out.append(int(pa[out[-1]]))
            return out

        def hops(pa, u, v):
            pu = path_to_root(pa, u)
            pv = path_to_root(pa, v)
            su = {q: k for k, q in enumerate(pu)}
            for k, q in enumerate(pv):
                if q in su:
                    return su[q] + k
            return len(pu) + len(pv)

        def in_subtree(pa, b, root_of):
            while b != self.root:
                if b == root_of:
                    return True
                b = int(pa[b])
            return b == root_of

        def spanning(pa, exclude):
            out = []
            for b in range(self.root):
                a = int(pa[b])
                if heights[a] > hp >= heights[b] and b != x \
                        and b != p and b not in exclude \
                        and not in_subtree(pa, b, x):
                    out.append(b)
            return out

        cands = spanning(parent, {s})
        if not cands:
            return None
        wts = np.array([lam ** hops(parent, p, b) for b in cands])
        wts = wts / wts.sum()
        bi = int(rng.choice(len(cands), p=wts))
        b = int(cands[bi])
        log_p_fwd = float(np.log(wts[bi]))
        a = int(parent[b])
        ch = child.copy()
        pa = parent.copy()
        row_g = ch[g - n]
        ch[g - n] = [s if int(v) == p else int(v) for v in row_g]
        pa[s] = g
        row_a = ch[a - n]
        ch[a - n] = [p if int(v) == b else int(v) for v in row_a]
        pa[p] = a
        ch[p - n] = [x, b]
        pa[b] = p
        # reverse: from the NEW tree, the reverse move regrafts p
        # onto edge s; its choice probability uses the NEW distances
        rev_cands = []
        for bb in range(self.root):
            aa = int(pa[bb])
            if heights[aa] > hp >= heights[bb] and bb != x \
                    and bb != p and bb != b \
                    and not in_subtree(pa, bb, x):
                rev_cands.append(bb)
        if s not in rev_cands:
            return None
        wts_r = np.array([lam ** hops(pa, p, bb) for bb in rev_cands])
        wts_r = wts_r / wts_r.sum()
        log_p_rev = float(np.log(wts_r[rev_cands.index(s)]))
        return ch, pa, log_p_rev - log_p_fwd

    def _spr_times_root(self, child, parent, heights, rng):
        """Prune-regraft restricted to the DEEP region: prune nodes
        whose parent sits in the oldest quartile of internal heights —
        the slowest-mixing part of a dated genealogy (the reference
        gives root-adjacent rearrangements their own tuned moves,
        spr_root mcmc.c:6604-6607).  Hastings adds the forward /
        reverse prune-set size ratio on top of the target-count
        ratio."""
        n = self.n_otu
        hint = np.sort(heights[n:])
        thresh = float(hint[int(0.75 * len(hint))])

        def deep_set(pa):
            return [x for x in range(self.root)
                    if int(pa[x]) != self.root
                    and heights[int(pa[x])] >= thresh]

        deep = deep_set(parent)
        if not deep:
            return None
        x = int(deep[rng.integers(0, len(deep))])
        res = self._spr_times_at(child, parent, heights, rng, x)
        if res is None:
            return None
        ch, pa, log_h = res
        deep_new = deep_set(pa)
        if x not in deep_new:
            return None
        log_h += float(np.log(len(deep)) - np.log(len(deep_new)))
        return ch, pa, log_h

    def _spr_times_at(self, child, parent, heights, rng, x):
        """_spr_times with the pruned node given (shared machinery)."""
        n = self.n_otu
        p = int(parent[x])
        if p == self.root:
            return None
        g = int(parent[p])
        row_p = child[p - n]
        s = int(row_p[1] if int(row_p[0]) == x else row_p[0])
        hp = heights[p]

        def in_subtree(pa, b, root_of):
            while b != self.root:
                if b == root_of:
                    return True
                b = int(pa[b])
            return b == root_of

        cands = []
        for b in range(self.root):
            a = int(parent[b])
            if heights[a] > hp >= heights[b] and b != x \
                    and b != p and b != s \
                    and not in_subtree(parent, b, x):
                cands.append(b)
        if not cands:
            return None
        b = int(cands[rng.integers(0, len(cands))])
        a = int(parent[b])
        ch = child.copy()
        pa = parent.copy()
        row_g = ch[g - n]
        ch[g - n] = [s if int(v) == p else int(v) for v in row_g]
        pa[s] = g
        row_a = ch[a - n]
        ch[a - n] = [p if int(v) == b else int(v) for v in row_a]
        pa[p] = a
        ch[p - n] = [x, b]
        pa[b] = p
        R = 0
        for bb in range(self.root):
            aa = int(pa[bb])
            if heights[aa] > hp >= heights[bb] and bb != x \
                    and bb != p and bb != b \
                    and not in_subtree(pa, bb, x):
                R += 1
        if R == 0:
            return None
        return ch, pa, float(np.log(len(cands)) - np.log(R))

    @staticmethod
    def _renumber_postorder(child, parent, n_otu):
        """Renumber internal nodes of a (possibly non-postorder) child
        table into valid postorder (children strictly below parents).
        Returns (child', parent', perm) with perm[old_id] = new_id
        (identity on tips; root maps to root)."""
        n_nodes = 2 * n_otu - 1
        root = n_nodes - 1
        kids = {n_otu + i: [int(child[i, 0]), int(child[i, 1])]
                for i in range(n_otu - 1)}
        # find current root: node that is its own parent
        cur_root = int(np.nonzero(parent == np.arange(n_nodes))[0][0])
        perm = np.arange(n_nodes)
        order = []
        stack = [(cur_root, False)]
        while stack:
            u, done = stack.pop()
            if u < n_otu:
                continue
            if done:
                order.append(u)
            else:
                stack.append((u, True))
                for v in kids[u]:
                    stack.append((v, False))
        for new_i, old in enumerate(order):
            perm[old] = n_otu + new_i
        assert perm[cur_root] == root
        new_child = np.zeros_like(child)
        new_parent = np.zeros(n_nodes, dtype=parent.dtype)
        for old in order:
            i_new = perm[old] - n_otu
            new_child[i_new] = [perm[kids[old][0]], perm[kids[old][1]]]
        for u in range(n_nodes):
            new_parent[perm[u]] = perm[int(parent[u])]
        return new_child, new_parent, perm

    def topology_step(self, st: ChainState, rng) -> tuple:
        """One host-side topology proposal (narrow exchange or
        prune-regraft-on-times, 50/50) + MH accept.  Returns
        (state, kind, accepted)."""
        child = np.asarray(st.child)
        parent = np.asarray(st.parent)
        heights = np.asarray(st.heights)
        kind = str(rng.choice(
            ["narrow", "spr", "spr_weighted", "spr_root"],
            p=[0.35, 0.25, 0.25, 0.15]))
        fns = {"narrow": self._narrow_exchange,
               "spr": self._spr_times,
               "spr_weighted": self._spr_times_weighted,
               "spr_root": self._spr_times_root}
        res = fns[kind](child, parent, heights, rng)
        if res is None:
            return st, kind, False
        ch, pa, log_h = res
        ch2, pa2, perm = self._renumber_postorder(ch, pa, self.n_otu)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        prop = st._replace(
            child=jnp.asarray(ch2, dtype=jnp.int32),
            parent=jnp.asarray(pa2, dtype=jnp.int32),
            heights=jnp.asarray(heights[inv]),
            log_r=st.log_r[inv],
            trait_lr=st.trait_lr[inv],
        )
        lnL_new, lp_new = self._eval_posterior(prop)
        log_alpha = float(lnL_new + lp_new - st.lnL - st.lp) + log_h
        if np.log(rng.random()) < log_alpha:
            return (prop._replace(lnL=lnL_new, lp=lp_new), kind, True)
        return st, kind, False

    # ------------------------------------------------------------------
    def init_state(self, subst_params=None) -> ChainState:
        heights = jnp.asarray(self.tt.heights, dtype=jnp.float64)
        st = ChainState(
            child=self.child,
            parent=self.parent,
            heights=heights,
            log_r=jnp.zeros(self.n_nodes, dtype=jnp.float64),
            log_clock=jnp.asarray(0.0, dtype=jnp.float64),
            log_nu=jnp.asarray(-1.0, dtype=jnp.float64),
            hyper=self.time_prior.default_hyper(),
            subst={k: v for k, v in
                   (subst_params or self.subst_fixed).items()
                   if k in self._movable_subst},
            log_s2x=jnp.asarray(0.0, dtype=jnp.float64),
            trait_lr=jnp.zeros(self.n_nodes, dtype=jnp.float64),
            lnL=jnp.asarray(0.0, dtype=jnp.float64),
            lp=jnp.asarray(0.0, dtype=jnp.float64),
        )
        lnL = jnp.asarray(self._lnL(st), dtype=jnp.float64)
        return st._replace(lnL=lnL, lp=self._log_prior(st))

    def run(self, state: ChainState | None = None, trace_fh=None,
            verbose=False, checkpoint_path: str | None = None,
            checkpoint_every_s: float = 300.0):
        """Run the chain; returns (final state, trace [T, 5],
        acceptance-rate vector).  Trace columns: posterior, lnL,
        root height, log clock, log nu (≙ the phytime trace file,
        mcmc.c:2588 MCMC_Print_Param).

        checkpoint_path: persist (state, iteration, tuned steps, PRNG
        key) atomically every checkpoint_every_s seconds and resume
        from it when it exists (green-field: the reference's
        checkpoint.c is an empty stub)."""
        s = self.s
        st = state if state is not None else self.init_state()
        steps = jnp.asarray(self.step)
        done = 0
        traces = []
        ck_last = [__import__("time").monotonic()]
        resumed_key = None
        resumed_extra: dict = {}
        if checkpoint_path is not None:
            from phyml_tpu.utils.checkpoint import load_chain, save_chain
            hit = load_chain(checkpoint_path, ChainState)
            if hit is not None:
                st, done, self.step, resumed_key, resumed_extra = hit
                steps = jnp.asarray(self.step)
                if verbose:
                    print(f"  mcmc resumed at iteration {done}")
        tot_tries = np.zeros(len(self.MOVE_NAMES), dtype=np.int64)
        tot_accs = np.zeros(len(self.MOVE_NAMES), dtype=np.int64)
        key = (jnp.asarray(resumed_key, dtype=jnp.uint32)
               if resumed_key is not None
               else jax.random.PRNGKey(s.seed))
        if trace_fh is not None:
            trace_fh.write("iter\tposterior\tlnL\troot_height\t"
                           "clock\tnu\n")
        topo_rng = np.random.default_rng(s.seed + 77003)
        self.topo_tries = int(resumed_extra.get("topo_tries", 0))
        self.topo_accepts = int(resumed_extra.get("topo_accepts", 0))
        if "topo_rng_state" in resumed_extra:
            # resume the host topology-proposal stream where it left
            # off instead of replaying it from the start
            topo_rng.bit_generator.state = \
                resumed_extra["topo_rng_state"]
        self.topo_samples = []   # (iter, child table) after each batch
        while done < s.n_iter:
            n = min(s.batch, s.n_iter - done)
            key, sub = jax.random.split(key)
            st, tries, accs, trace = self._jit_batch(
                self.engine.data(), st, sub, steps, n_steps=n)
            if self.sample_topology:
                for _ in range(self.topo_moves_per_batch):
                    st, _kind, acc = self.topology_step(st, topo_rng)
                    self.topo_tries += 1
                    self.topo_accepts += int(acc)
                self.topo_samples.append(
                    (done + n, np.asarray(st.child).copy()))
            tries = np.asarray(tries)
            accs = np.asarray(accs)
            tot_tries += tries
            tot_accs += accs
            traces.append(np.asarray(trace))
            if trace_fh is not None:
                tr = np.asarray(trace)
                for j in range(0, n, s.thin):
                    it = done + j
                    trace_fh.write(
                        f"{it}\t{tr[j,0]:.4f}\t{tr[j,1]:.4f}\t"
                        f"{tr[j,2]:.6f}\t{np.exp(tr[j,3]):.6g}\t"
                        f"{np.exp(tr[j,4]):.6g}\n")
            done += n
            if checkpoint_path is not None:
                import time as _time
                if (_time.monotonic() - ck_last[0]
                        >= checkpoint_every_s) or done >= s.n_iter:
                    save_chain(checkpoint_path, st, done, self.step,
                               key=np.asarray(key),
                               extra={
                                   "topo_rng_state":
                                       topo_rng.bit_generator.state,
                                   "topo_tries": self.topo_tries,
                                   "topo_accepts": self.topo_accepts,
                               })
                    ck_last[0] = _time.monotonic()
            if done <= s.burnin:
                # host-side tuning (≙ MCMC_Adjust_Tuning_Parameter)
                rate = accs / np.maximum(tries, 1)
                lo, hi = s.target_accept
                for i in range(len(self.step)):
                    if i == 0 or tries[i] == 0:
                        continue  # window slide is self-tuning
                    if rate[i] < lo:
                        self.step[i] *= 0.7
                    elif rate[i] > hi:
                        self.step[i] *= 1.4
                self.step = np.clip(self.step, 1e-4, 20.0)
                steps = jnp.asarray(self.step)
            if verbose:
                print(f"  mcmc iter {done}/{s.n_iter} "
                      f"posterior={float(st.lnL + st.lp):.3f} "
                      f"lnL={float(st.lnL):.3f}")
        acc_rate = tot_accs / np.maximum(tot_tries, 1)
        if not traces:
            # resumed at (or past) n_iter: no batches ran this call
            self.ess = {}
            return st, np.zeros((0, 5)), acc_rate
        trace_all = np.concatenate(traces, axis=0)
        from phyml_tpu.bayes.diagnostics import ess_report
        self.ess = ess_report(trace_all,
                              burnin_rows=min(s.burnin,
                                              trace_all.shape[0] // 2))
        if trace_fh is not None:
            trace_fh.write("# ESS: " + "  ".join(
                f"{k}={v:.1f}" for k, v in self.ess.items()) + "\n")
            if self.sample_topology and self.topo_tries:
                trace_fh.write(
                    f"# topology moves: {self.topo_accepts}/"
                    f"{self.topo_tries} accepted\n")
        if verbose:
            print("  ESS:", {k: round(v, 1)
                             for k, v in self.ess.items()})
        return st, trace_all, acc_rate
