"""Plain float64 likelihood: the independent check of the engine.

Felsenstein pruning in numpy, one rate class at a time, with P(t)
from scipy's matrix exponential and per-node rescaling.  No JAX, no
caches, no eigen shortcuts: the tests, chip_smoke.py and the
benchmark compare the engine's scan against it.
Its only input from the package is the model's rate matrices
(`model_terms`).
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import expm


def site_logliks(tips, child, node_blen, q, pi, w, pinv=0.0,
                 invariant=None, n_hidden=1):
    """Per-pattern log-likelihoods [P], float64.

    tips [n_otu, P, s] tip partials (Alignment.partials; repeated
    over hidden classes when the model has ns = n_hidden * s states);
    child [n_int, 2] postorder children of internal node n_otu + i
    (RootedView.child, last row the root); node_blen [n_nodes] length
    of each node's edge to its parent; q [C, ns, ns] per-class rate
    matrices with the class rate folded in; pi [C, ns]; w [C];
    pinv the invariant fraction; invariant [P] the constant observed
    state of each pattern or -1 (Alignment.invariant)."""
    tips = np.asarray(tips, np.float64)
    child = np.asarray(child)
    node_blen = np.asarray(node_blen, np.float64)
    q = np.asarray(q, np.float64)
    pi = np.asarray(pi, np.float64)
    w = np.asarray(w, np.float64)
    C = q.shape[0]
    n = tips.shape[0]
    tips = np.tile(tips, (1, 1, n_hidden))
    n_int = child.shape[0]
    root = n + n_int - 1
    tiny = np.finfo(np.float64).tiny

    per_class = []
    for c in range(C):
        pm = [expm(q[c] * t) for t in node_blen]
        part: dict[int, np.ndarray] = {u: tips[u] for u in range(n)}
        logsc = np.zeros((n + n_int, tips.shape[1]))
        for i in range(n_int):
            u = n + i
            a, b = int(child[i, 0]), int(child[i, 1])
            x = (part.pop(a) @ pm[a].T) * (part.pop(b) @ pm[b].T)
            m = np.maximum(x.max(axis=1), tiny)
            part[u] = x / m[:, None]
            logsc[u] = logsc[a] + logsc[b] + np.log(m)
        lroot = np.maximum(part[root] @ pi[c], tiny)
        per_class.append(np.log(w[c]) + logsc[root] + np.log(lroot))
    a = np.stack(per_class)
    amax = a.max(axis=0)
    site = amax + np.log(np.exp(a - amax).sum(axis=0))
    if pinv > 0.0:
        # L = (1 - pinv) L_var + pinv pi[invariant state] (lk.c:820-837)
        inv = np.asarray(invariant)
        pi_obs = (w @ pi).reshape(n_hidden, -1).sum(axis=0)
        inv_lk = np.where(inv >= 0, pi_obs[np.maximum(inv, 0)], 0.0)
        site = np.logaddexp(np.log1p(-pinv) + site,
                            np.log(np.maximum(pinv * inv_lk, tiny)))
    return site


def model_terms(model, params):
    """(q [C, ns, ns], pi [C, ns], w [C], pinv) in float64 from the
    model's class system: q_c = V diag(lam_c) V^-1, with the class
    rate and the +I rescaling folded in as the engine folds them."""
    lam, V, Vinv, pi, w, pinv = model.class_system(params)
    lam, V, Vinv, pi, w = (np.asarray(x, np.float64)
                           for x in (lam, V, Vinv, pi, w))
    q = np.einsum("cxi,ci,ciy->cxy", V, lam, Vinv)
    return q, pi, w, float(np.asarray(pinv))


def alignment_site_logliks(aln, rooted, model, params):
    """site_logliks for an Alignment, a RootedView and a model."""
    q, pi, w, pinv = model_terms(model, params)
    return site_logliks(
        aln.partials, rooted.child, rooted.node_blen, q, pi, w,
        pinv=pinv if model.invar else 0.0, invariant=aln.invariant,
        n_hidden=model.n_hidden if model.covarion else 1)
