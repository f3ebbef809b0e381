"""The likelihood engine: Felsenstein pruning as one compiled program.

This replaces the reference's hot core
(lk.c:443 Lk, lk.c:1659 Core_Default_Update_Partial_Lk, the SIMD
kernels avx.c/sse.c, and the per-edge conditional-likelihood storage
of t_edge).  Design:

  * Topology is *data*: a postorder child table (int32 [n_int, 2]) and
    a branch-length vector indexed by rooted node.  Every topology of
    the same taxon count runs the same XLA executable - no recompiles
    during tree search.
  * The up (postorder) pass is a `lax.scan` over internal nodes.  Each
    step combines two child partials (elementwise product), rescales
    per (class, pattern) with an exact log accumulator (replacing the
    reference's 2^256-block scheme, utilities.h:493-520 +
    lk.c:1748-1758), and pushes through the edge's P(t) as an
    (ns x ns) @ (ns x P) matmul batched over classes, with the
    pattern axis last.
  * The down (preorder) pass produces, for every node u, the "outside"
    partial O[u] (the likelihood of all data outside subtree(u),
    conditional on the state at u's parent, with the stationary
    distribution folded in at the root).  This generalizes the
    reference's per-edge p_lk_left/p_lk_rght pairs.
  * Per-edge eigen-basis dot products d_i = (V^T O)_i (V^-1 up)_i give
    L_site(t) = sum_i d_i exp(lam_i t) for *every* edge at once -
    the eigen-LR reparameterization (lk.c:1038 Update_Eigen_Lr,
    lk.c:655 dLk) vectorized over all edges, which powers the
    parallel-Newton branch-length optimizer.
  * Class mixing (Gamma / FreeRate / LG4X mixtures) is a leading axis;
    the +I invariant fraction mixes at the root exactly as
    lk.c:820-837.  Per-site logs accumulate in float64 wherever x64
    is on (`acc_dtype`).

Sites (patterns) are the sharding axis: all arrays carry the pattern
dimension last, and `parallel/mesh.py` shards it across devices; the
only cross-device communication is the final weighted reduction.
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from phyml_tpu.io.alignment import Alignment
from phyml_tpu.models.eigen import pmat, pmat_mgf_gamma
from phyml_tpu.models.substitution import SubstModel

_PREC = lax.Precision.HIGHEST  # fp32 matmuls must not round to TF32


class TreeArrays(NamedTuple):
    """Device-side topology + branch lengths (see topology.RootedView)."""
    child: jnp.ndarray   # int32 [n_internal, 2], postorder, last row=root
    blen: jnp.ndarray    # [n_nodes] edge length to parent (root slot 0)


class Partials(NamedTuple):
    """All per-node conditional likelihoods from one full pass."""
    clv: jnp.ndarray     # [n_nodes, C, ns, P] normalized below-partials
    pup: jnp.ndarray     # [n_nodes, C, ns, P] P(t_u) @ clv[u]
    sc: jnp.ndarray      # [n_nodes, C, P] log-scale of clv/pup
    out: jnp.ndarray     # [n_nodes, C, ns, P] outside partials O[u]
    sc_out: jnp.ndarray  # [n_nodes, C, P]


def tree_arrays(rv, dtype=jnp.float32) -> TreeArrays:
    return TreeArrays(
        child=jnp.asarray(rv.child, dtype=jnp.int32),
        blen=jnp.asarray(rv.node_blen, dtype=dtype),
    )


class LikelihoodEngine:
    """Compiled likelihood programs for one (alignment, model) pair."""

    def __init__(
        self,
        aln: Alignment,
        model: SubstModel,
        dtype=jnp.float32,
        pattern_pad: int = 128,
    ):
        """To run SPMD over a device mesh, build the engine then
        re-place the pattern-axis arrays with a sharding
        (parallel.mesh.shard_pattern_arrays): sites are the data-
        parallel axis, and XLA turns the weighted per-site reduction
        into the program's only collective (replacing mpi_boot.c)."""
        self.aln = aln
        self.model = model
        # the dtype the arrays really get (float32 when x64 is off)
        self.dtype = jax.dtypes.canonicalize_dtype(dtype)
        # per-site sums accumulate in float64 wherever x64 is on
        self.acc_dtype = jax.dtypes.canonicalize_dtype(jnp.float64)
        self.n_otu = aln.n_otu
        self.ns = model.ns
        self.C = model.n_classes
        self.n_nodes = 2 * self.n_otu - 1
        self.n_internal = self.n_otu - 1

        # P-matrix cache for host entry points: pmats depend only on
        # (eigensystem, branch lengths), so repeated evaluations of the
        # same tree (bootstrap weight resampling, support statistics,
        # parameter-held sweeps) skip rebuilding them
        self._pm_cache: collections.OrderedDict = \
            collections.OrderedDict()

        P_raw = aln.n_patterns
        quantum = pattern_pad
        self.P = max(quantum, int(
            math.ceil(P_raw / quantum) * quantum
        ))
        pad = self.P - P_raw

        tips = np.transpose(aln.partials, (0, 2, 1))  # [n_otu, ns, P_raw]
        tips = np.pad(tips, ((0, 0), (0, 0), (0, pad)),
                      constant_values=1.0)
        if self.ns != tips.shape[1]:
            # covarion: replicate the observed-state tip vector for
            # every hidden class (M4_Init_Partial_Lk_Tips m4.c:528)
            tips = np.tile(tips, (1, self.ns // tips.shape[1], 1))
        self.tips = jnp.asarray(tips, dtype=self.dtype)
        self.weights = jnp.asarray(
            np.pad(aln.weights, (0, pad)), dtype=self.acc_dtype
        )
        inv = np.pad(aln.invariant, (0, pad), constant_values=-1)
        self.invar_state = jnp.asarray(np.maximum(inv, 0),
                                       dtype=jnp.int32)
        self.invar_ok = jnp.asarray(inv >= 0, dtype=self.dtype)

        self._tiny = np.finfo(self.dtype).tiny

        # compiled entry points (weights default to the alignment's
        # pattern counts; bootstrap passes resampled vectors).
        # ALL device data (tips, invariant masks) rides in as jit
        # ARGUMENTS via bind_data, never as closure constants, so one
        # compiled program serves every engine of the same shapes.
        self._jit_loglik = jax.jit(self.bind_data(self._loglik))
        self._jit_loglik_full = jax.jit(
            self.bind_data(self._loglik_full))
        self._jit_site_logliks = jax.jit(
            self.bind_data(self._site_logliks))
        # host-cached eigensystem path: the eigendecomposition only
        # changes when model parameters change (the reference runs
        # Update_Eigen models.c:881 once per parameter update, then
        # PMat per edge), so host-driven loops (branch-length rounds,
        # bootstrap scoring, search scorers) reuse one device-resident
        # system instead of re-tracing eigh into every program
        self._jit_system = jax.jit(self._system)
        self._jit_loglik_sys = jax.jit(self.bind_data(self._loglik_sys))
        self._jit_site_logliks_sys = jax.jit(
            self.bind_data(self._site_logliks_sys))
        self._sys_cache = None

    # ------------------------------------------------------------------
    # device-data threading: tips + invariant masks as jit arguments
    # ------------------------------------------------------------------
    def data(self):
        """The engine's device-resident data arrays, to be passed as
        the first argument of any bind_data-wrapped jitted program."""
        return (self.tips, self.invar_state, self.invar_ok)

    def bind_data(self, fn):
        """Wrap fn so its first argument is the data() tuple: during
        tracing the engine attributes are swapped for the traced
        values, so every internal method reads traced arguments
        instead of baking device arrays into the program."""
        # NB: no functools.wraps — copying fn's signature would make
        # jax.jit resolve static_argnames against the UNSHIFTED
        # argument positions (the data tuple prepends one)
        def wrapped(data, *args, **kw):
            old = (self.tips, self.invar_state, self.invar_ok)
            self.tips, self.invar_state, self.invar_ok = data
            try:
                return fn(*args, **kw)
            finally:
                self.tips, self.invar_state, self.invar_ok = old

        return wrapped

    def _w(self, weights):
        return self.weights if weights is None else weights

    def system_of(self, params):
        """Device-resident (lam, V, Vinv, pi, w, pinv), cached by the
        CONTENT identity of the params dict: its tree structure plus
        the object identity of every leaf.  jax/np arrays are replaced
        (never mutated) when a parameter changes, so a stale hit would
        require writing into an existing ndarray in place — guarded
        against dict-level mutation (params["alpha"] = x), which dict-
        identity keying silently missed."""
        leaves, treedef = jax.tree_util.tree_flatten(params)
        key = (treedef, tuple(id(l) for l in leaves))
        hit = self._sys_cache
        if hit is not None and hit[0] == key:
            return hit[2]
        sys = self._jit_system(params)
        # keep a strong ref to the leaves so their ids cannot be reused
        self._sys_cache = (key, leaves, sys)
        return sys

    def invalidate_system_cache(self):
        self._sys_cache = None

    # ------------------------------------------------------------------
    # host-side P-matrix cache (system x branch-length identity)
    # ------------------------------------------------------------------
    def _pm_get(self, sys, tree):
        key = (id(sys), id(tree.blen))
        hit = self._pm_cache.get(key)
        if hit is None:
            return None
        self._pm_cache.move_to_end(key)
        return hit[2]

    def _pm_store(self, sys, tree, pmats):
        # strong refs to sys and blen keep their ids from being reused
        self._pm_cache[(id(sys), id(tree.blen))] = (sys, tree.blen,
                                                    pmats)
        while len(self._pm_cache) > 32:
            self._pm_cache.popitem(last=False)

    def _jit_cached(self, name, f):
        fn = getattr(self, name, None)
        if fn is None:
            fn = jax.jit(self.bind_data(f))
            setattr(self, name, fn)
        return fn

    @property
    def _jit_loglik_sys2(self):
        def f(sys, tree, weights):
            lam, V, Vinv, pi, w, pinv = sys
            pmats = self._pmats(lam, V, Vinv,
                                tree.blen.astype(self.dtype))
            site = self._site_logliks_pm(sys, pmats, tree.child)
            return jnp.sum(site.astype(self.acc_dtype) * weights), pmats
        return self._jit_cached("_jit_loglik_sys2_", f)

    @property
    def _jit_loglik_pm(self):
        def f(sys, pmats, child, weights):
            site = self._site_logliks_pm(sys, pmats, child)
            return jnp.sum(site.astype(self.acc_dtype) * weights)
        return self._jit_cached("_jit_loglik_pm_", f)

    @property
    def _jit_site_logliks_pm(self):
        return self._jit_cached("_jit_site_logliks_pm_",
                                self._site_logliks_pm)

    def loglik(self, params, tree, weights=None):
        sys = self.system_of(params)
        pm = self._pm_get(sys, tree)
        if pm is not None:
            return self._jit_loglik_pm(self.data(), sys, pm,
                                       tree.child, self._w(weights))
        lnl, pmats = self._jit_loglik_sys2(self.data(), sys, tree,
                                           self._w(weights))
        self._pm_store(sys, tree, pmats)
        return lnl

    def site_logliks(self, params, tree):
        sys = self.system_of(params)
        pm = self._pm_get(sys, tree)
        if pm is not None:
            return self._jit_site_logliks_pm(self.data(), sys, pm,
                                             tree.child)
        return self._jit_site_logliks_sys(self.data(), sys, tree)

    def loglik_full(self, params, tree, weights=None):
        return self._jit_loglik_full(self.data(), params, tree,
                                     self._w(weights))

    # ------------------------------------------------------------------
    # model plumbing
    # ------------------------------------------------------------------
    def _system(self, params):
        lam, V, Vinv, pi, w, pinv = self.model.class_system(params)
        if "il_sigma" in params:
            # Integrated-length (IL) model (reference --il,
            # gamma_mgf_bl cl.c:430-434): each branch length is
            # Gamma-distributed with mean t and variance t*sigma, and
            # E[P(L)] = V diag((1-lam*sigma)^(-t/sigma)) V^-1
            #         = V diag(exp(t*mu)) V^-1,
            # with mu = -log(1-lam*sigma)/sigma — an exponential
            # family in t again.  Substituting mu for lam here makes
            # EVERY downstream path (scans, eigen-LR
            # Newton, NNI/SPR scorers, full topology search) exact
            # under IL with zero further changes; the reference
            # instead special-cases PMat (models.c:1044) and falls
            # back to per-edge Brent for lengths.
            sig = jnp.exp(params["il_sigma"])
            lam_il = -jnp.log(jnp.maximum(1.0 - lam * sig, 1e-30)) \
                / jnp.maximum(sig, 1e-30)
            lam = jnp.where(sig > 1e-12, lam_il, lam)
        c = lambda x: jnp.asarray(x, dtype=self.dtype)
        return c(lam), c(V), c(Vinv), c(pi), c(w), c(pinv)

    def _pmats(self, lam, V, Vinv, blen):
        """P [n_nodes, C, ns, ns]; class rates are folded into lam."""
        t = jnp.broadcast_to(blen[:, None], (self.n_nodes, self.C))
        return pmat(lam, V, Vinv, t.astype(self.dtype))

    # ------------------------------------------------------------------
    # up (postorder) pass
    # ------------------------------------------------------------------
    def _up_pass(self, pmats, child, mask=None):
        """mask (optional) [n_internal, 2] in {0., 1.}: a 1 makes the
        corresponding child contribute a unit factor, i.e. the node
        behaves as if that child subtree were pruned.  Because P
        matrices of the same Q compose (P(a)P(b) = P(a+b)), the
        resulting partials are exactly those of the healed tree with
        the two link edges merged - the device-side equivalent of the
        reference's Prune_Subtree (utilities.c:6152)."""
        n, C, ns, P = self.n_otu, self.C, self.ns, self.P
        dtype = self.dtype

        pup = jnp.zeros((self.n_nodes, C, ns, P), dtype=dtype)
        clv = jnp.zeros((self.n_nodes, C, ns, P), dtype=dtype)
        sc = jnp.zeros((self.n_nodes, C, P), dtype=dtype)

        tip_clv = jnp.broadcast_to(
            self.tips[:, None, :, :], (n, C, ns, P)
        )
        pup_tips = jnp.einsum(
            "ncxy,ncyp->ncxp", pmats[:n], tip_clv, precision=_PREC
        )
        pup = pup.at[:n].set(pup_tips)
        clv = clv.at[:n].set(tip_clv)

        def step(carry, args):
            pup, clv, sc = carry
            i, pm = args
            c0 = child[i, 0]
            c1 = child[i, 1]
            u = n + i
            if mask is None:
                p0, p1 = pup[c0], pup[c1]
                s0, s1 = sc[c0], sc[c1]
            else:
                m0 = mask[i, 0]
                m1 = mask[i, 1]
                p0 = pup[c0] * (1.0 - m0) + m0
                p1 = pup[c1] * (1.0 - m1) + m1
                s0 = sc[c0] * (1.0 - m0)
                s1 = sc[c1] * (1.0 - m1)
            x = p0 * p1                                 # [C, ns, P]
            m = jnp.max(x, axis=1, keepdims=True)
            m = jnp.maximum(m, self._tiny)
            x = x / m
            sc_u = s0 + s1 + jnp.log(m[:, 0, :])
            pup_u = jnp.einsum("cxy,cyp->cxp", pm, x, precision=_PREC)
            return (
                pup.at[u].set(pup_u),
                clv.at[u].set(x),
                sc.at[u].set(sc_u),
            ), None

        idx = jnp.arange(self.n_internal)
        (pup, clv, sc), _ = lax.scan(
            step, (pup, clv, sc), (idx, pmats[n:])
        )
        return pup, clv, sc

    # ------------------------------------------------------------------
    # down (preorder) pass
    # ------------------------------------------------------------------
    def _down_pass(self, pmats, child, pup, sc, pi, mask=None):
        """Outside partials; `mask` as in _up_pass (a masked child's
        sibling sees a unit factor in place of the masked subtree)."""
        n, C, ns, P = self.n_otu, self.C, self.ns, self.P
        out = jnp.zeros_like(pup)
        sc_out = jnp.zeros_like(sc)

        r0 = child[-1, 0]
        r1 = child[-1, 1]
        pi_b = pi[:, :, None]
        out = out.at[r0].set(pi_b * pup[r1])
        sc_out = sc_out.at[r0].set(sc[r1])
        out = out.at[r1].set(pi_b * pup[r0])
        sc_out = sc_out.at[r1].set(sc[r0])

        def step(carry, i):
            out, sc_out = carry
            u = n + i
            c0 = child[i, 0]
            c1 = child[i, 1]
            if mask is None:
                p0, p1 = pup[c0], pup[c1]
                s0, s1 = sc[c0], sc[c1]
            else:
                m0 = mask[i, 0]
                m1 = mask[i, 1]
                p0 = pup[c0] * (1.0 - m0) + m0
                p1 = pup[c1] * (1.0 - m1) + m1
                s0 = sc[c0] * (1.0 - m0)
                s1 = sc[c1] * (1.0 - m1)
            grand = jnp.einsum(
                "cwz,cwp->czp", pmats[u], out[u], precision=_PREC
            )
            o0 = grand * p1
            o1 = grand * p0
            m0_ = jnp.maximum(jnp.max(o0, axis=1, keepdims=True),
                              self._tiny)
            m1_ = jnp.maximum(jnp.max(o1, axis=1, keepdims=True),
                              self._tiny)
            base = sc_out[u]
            return (
                out.at[c0].set(o0 / m0_).at[c1].set(o1 / m1_),
                sc_out
                .at[c0].set(base + s1 + jnp.log(m0_[:, 0, :]))
                .at[c1].set(base + s0 + jnp.log(m1_[:, 0, :])),
            ), None

        # reverse preorder: internal nodes except the root row
        idx = jnp.arange(self.n_internal - 2, -1, -1)
        (out, sc_out), _ = lax.scan(step, (out, sc_out), idx)
        return out, sc_out

    # ------------------------------------------------------------------
    # root reduction
    # ------------------------------------------------------------------
    def _inv_lk(self, pi, w):
        """Per-pattern invariant-site likelihood pi[invar_state]
        (lk.c:1240), 0 for non-invariant patterns."""
        pi_mix = jnp.einsum("c,cx->x", w, pi)
        if self.model.covarion:
            # invariant patterns are defined over OBSERVED states;
            # marginalize the hidden classes out of pi
            pi_mix = pi_mix.reshape(self.model.n_hidden, -1).sum(0)
        return pi_mix[self.invar_state] * self.invar_ok

    def _root_site_loglik(self, pup, sc, pi, w, pinv):
        """log L per pattern [P], mixing classes and +I exactly as the
        reference root loop (lk.c:767-860 Lk_Core; invariant mix
        lk.c:820-837: L = (1-p) L_var + p pi[invar])."""
        root = self.n_nodes - 1
        lroot = jnp.einsum(
            "cx,cxp->cp", pi, pup[root], precision=_PREC
        )
        lroot = jnp.maximum(lroot, self._tiny)
        a = jnp.log(w)[:, None] + sc[root] + jnp.log(lroot)  # [C, P]
        lse = jax.scipy.special.logsumexp(a, axis=0)         # [P]
        return self._mix_invar(lse, pi, w, pinv)

    def _mix_invar(self, lse, pi, w, pinv):
        """Fold the +I invariant fraction into the variable-rate site
        log-likelihoods (lk.c:820-837: L = (1-p) L_var + p pi[invar])."""
        if not self.model.invar:
            return lse
        inv_lk = self._inv_lk(pi, w)
        var_part = jnp.log1p(-pinv) + lse
        inv_part = jnp.log(jnp.maximum(pinv * inv_lk, self._tiny))
        return jnp.where(
            self.invar_ok > 0,
            jnp.logaddexp(var_part, inv_part),
            var_part,
        )

    def _site_logliks_pm(self, sys, pmats, child):
        """Site log-likelihoods from precomputed P-matrices (the
        host pm-cache path)."""
        lam, V, Vinv, pi, w, pinv = sys
        pup, _, sc = self._up_pass(pmats, child)
        return self._root_site_loglik(pup, sc, pi, w, pinv)

    # ------------------------------------------------------------------
    # public computations.  Every entry point takes the pattern-weight
    # vector as a traced ARGUMENT (not a baked closure constant) so
    # bootstrap replicates - which only change weights
    # (mpi_boot.c:119-135) - reuse the same compiled executables.
    # ------------------------------------------------------------------
    def loglik_mgf(self, params, tree, sigma, weights=None):
        """lnL with branch-length-integrated P matrices: each branch
        length is Gamma-distributed with mean blen and variance
        blen*sigma, and P is its expectation (PMat_MGF_Gamma
        models.c:1044; gamma_mgf_bl path of lk.c:2310-2323).  This is
        the exact likelihood of the Guindon 2012 relaxed clock."""
        return self._jit_loglik_mgf(self.data(),
                                    self.system_of(params), tree,
                                    jnp.asarray(sigma, self.dtype),
                                    self._w(weights))

    @property
    def _jit_loglik_mgf(self):
        fn = getattr(self, "_jit_loglik_mgf_", None)
        if fn is None:
            fn = jax.jit(self.bind_data(self._loglik_mgf_sys))
            self._jit_loglik_mgf_ = fn
        return fn

    def _loglik_mgf(self, params, tree, sigma, weights):
        """Untraced-callable MGF lnL (for use inside callers' jits)."""
        return self._loglik_mgf_sys(self._system(params), tree, sigma,
                                    weights)

    def _loglik_mgf_sys(self, sys, tree: TreeArrays, sigma, weights):
        lam, V, Vinv, pi, w, pinv = sys
        t = jnp.broadcast_to(
            tree.blen.astype(self.dtype)[:, None],
            (self.n_nodes, self.C))
        pmats = pmat_mgf_gamma(lam, V, Vinv, t, sigma)
        pup, _, sc = self._up_pass(pmats, tree.child)
        site = self._root_site_loglik(pup, sc, pi, w, pinv)
        return jnp.sum(site.astype(self.acc_dtype) * weights)

    def _loglik(self, params, tree: TreeArrays, weights):
        return self._loglik_sys(self._system(params), tree, weights)

    def _loglik_sys(self, sys, tree: TreeArrays, weights):
        site = self._site_logliks_sys(sys, tree)
        return jnp.sum(site.astype(self.acc_dtype) * weights)

    _loglik_weighted = _loglik  # vmap-friendly alias

    def _site_logliks(self, params, tree: TreeArrays):
        return self._site_logliks_sys(self._system(params), tree)

    def _site_logliks_sys(self, sys, tree: TreeArrays):
        lam, V, Vinv, pi, w, pinv = sys
        pmats = self._pmats(lam, V, Vinv, tree.blen.astype(self.dtype))
        pup, _, sc = self._up_pass(pmats, tree.child)
        return self._root_site_loglik(pup, sc, pi, w, pinv)

    def _loglik_full(self, params, tree: TreeArrays, weights):
        """lnL plus all partials (for edge ops / search scoring)."""
        lam, V, Vinv, pi, w, pinv = self._system(params)
        pmats = self._pmats(lam, V, Vinv, tree.blen.astype(self.dtype))
        pup, clv, sc = self._up_pass(pmats, tree.child)
        out, sc_out = self._down_pass(pmats, tree.child, pup, sc, pi)
        site = self._root_site_loglik(pup, sc, pi, w, pinv)
        lnl = jnp.sum(site.astype(self.acc_dtype) * weights)
        return lnl, Partials(clv=clv, pup=pup, sc=sc, out=out,
                             sc_out=sc_out)

    # ------------------------------------------------------------------
    # eigen-LR edge machinery (lk.c:1038 / lk.c:655, all edges at once)
    # ------------------------------------------------------------------
    def edge_dotprods(self, params, tree: TreeArrays, weights):
        """Eigen-basis dot products for every edge simultaneously:
        d [n_nodes, C, ns, P], sc_d [n_nodes, C, P] such that the
        per-(class, pattern) site likelihood as a function of edge-u's
        length alone is
            L_u(t)[c, p] = exp(sc_d[u, c, p]) * sum_i d[u,c,i,p] e^{lam[c,i] t}.
        The rows for the root and for the zero-length root child are
        meaningless and must be masked by the caller (they do not
        correspond to free unrooted edges)."""
        return self.edge_dotprods_sys(self._system(params), tree,
                                      weights)

    def edge_dotprods_sys(self, sys, tree: TreeArrays, weights):
        lam, V, Vinv, pi, w, pinv = sys
        pmats = self._pmats(lam, V, Vinv, tree.blen.astype(self.dtype))
        pup, clv, sc = self._up_pass(pmats, tree.child)
        out, sc_out = self._down_pass(pmats, tree.child, pup, sc, pi)
        b = jnp.einsum("ciy,ncyp->ncip", Vinv, clv, precision=_PREC)
        a = jnp.einsum("czi,nczp->ncip", V, out, precision=_PREC)
        d = a * b
        sc_d = sc_out + sc
        aux = dict(lam=lam, w=w, pinv=pinv, weights=weights,
                   inv_lk=self._inv_lk(pi, w) if self.model.invar
                   else jnp.zeros((self.P,), dtype=self.dtype))
        return d, sc_d, aux

    def edge_site_terms(self, d_n, sc_n, aux, t):
        """Per-site (log-likelihood, dlnL, d2lnL) as a function of ONE
        edge length t, from that edge's dot products.  Shapes: site
        [..., P]; used by edge_lnl_terms (reduction) and by the
        SH/RELL branch supports, which need per-site log-likelihoods
        of the NNI configurations (alrt.c log_lks_aLRT)."""
        lam, w, pinv = aux["lam"], aux["w"], aux["pinv"]
        inv_lk = aux["inv_lk"]
        lam_b = lam[..., :, :, None]                     # [C, ns, 1]
        t_b = jnp.asarray(t)[..., None, None, None]      # scalar or [E]
        e = jnp.exp(lam_b * t_b)
        s0 = jnp.sum(d_n * e, axis=-2)                   # [..., C, P]
        s1 = jnp.sum(d_n * lam_b * e, axis=-2)
        s2 = jnp.sum(d_n * lam_b * lam_b * e, axis=-2)

        m = jnp.max(sc_n, axis=-2, keepdims=True)        # [..., 1, P]
        ew = w[:, None] * jnp.exp(sc_n - m)              # [..., C, P]
        A0 = jnp.maximum(jnp.sum(ew * s0, axis=-2), self._tiny)
        A1 = jnp.sum(ew * s1, axis=-2)
        A2 = jnp.sum(ew * s2, axis=-2)
        m = m[..., 0, :]                                 # [..., P]

        one_m_p = 1.0 - pinv
        log_var = jnp.log(one_m_p) + jnp.log(A0) + m if self.model.invar \
            else jnp.log(A0) + m
        if self.model.invar:
            inv_part = jnp.log(jnp.maximum(pinv * inv_lk, self._tiny))
            site = jnp.where(
                self.invar_ok > 0,
                jnp.logaddexp(log_var, inv_part),
                log_var,
            )
        else:
            site = log_var
        # d site / dt = (1-p) A1 e^{m - site}; stable in both regimes
        ratio = one_m_p * jnp.exp(
            jnp.log(jnp.maximum(jnp.abs(A1), self._tiny)) + m - site
        ) * jnp.sign(A1)
        ratio2 = one_m_p * jnp.exp(
            jnp.log(jnp.maximum(jnp.abs(A2), self._tiny)) + m - site
        ) * jnp.sign(A2)
        dln = ratio
        d2ln = ratio2 - ratio ** 2
        return site, dln, d2ln

    def edge_lnl_terms(self, d_n, sc_n, aux, t):
        """(lnL, dlnL, d2lnL) of the whole tree as a function of ONE
        edge length t, from that edge's dot products d_n [C, ns, P] and
        scales sc_n [C, P].  O(C*ns*P), no traversal (the reference's
        dLk, lk.c:655 + Br_Len_Spline Newton, optimiz.c:2244).
        Broadcasts: t may be [n_edges] with d_n [n_edges, C, ns, P]."""
        site, dln, d2ln = self.edge_site_terms(d_n, sc_n, aux, t)
        wts = aux["weights"]
        lnL = jnp.sum(site.astype(self.acc_dtype) * wts, axis=-1)
        dlnL = jnp.sum(dln.astype(self.acc_dtype) * wts, axis=-1)
        d2lnL = jnp.sum(d2ln.astype(self.acc_dtype) * wts, axis=-1)
        return lnL, dlnL, d2lnL
