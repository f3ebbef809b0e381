"""Reversible-Q eigendecomposition and batched P(t).

The reference diagonalizes Q with a dense nonsymmetric QR solver
(eigen.c:43 Eigen, with a retry-and-rescale loop in models.c:954-993
when the inverse of the eigenvector matrix is ill-conditioned).  For
reversible models this is unnecessary: B = D^{1/2} Q D^{-1/2} with
D = diag(pi) is symmetric, so `jnp.linalg.eigh` gives an orthogonal
eigenbasis U with guaranteed-real eigenvalues, and
    V = D^{-1/2} U,   V^{-1} = U^T D^{1/2},   Q = V diag(lam) V^{-1}.
This is jittable, batchable over mixture components, differentiable,
and has no failure path.

P(t) = V exp(diag(lam * t)) V^{-1}  (reference PMat_Empirical
models.c:257), batched over (edge, class) in a single einsum.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

# P(t) reconstruction must not round through bf16 or TF32: a 2^-10
# matmul error in P is a ~1e-3 per-site likelihood error.
_PREC = lax.Precision.HIGHEST


def build_q(S, pi):
    """Q_ij = S_ij pi_j (i != j), diagonal = -rowsum, scaled so the
    mean substitution rate -sum_i pi_i Q_ii = 1 (models.c:296-298,
    :580-584).  S: [..., ns, ns] symmetric, pi: [..., ns]."""
    ns = S.shape[-1]
    eye = jnp.eye(ns, dtype=S.dtype)
    off = S * pi[..., None, :] * (1.0 - eye)
    diag = -jnp.sum(off, axis=-1)
    q = off + jnp.einsum("...i,ij->...ij", diag, eye)
    mr = -jnp.sum(pi * diag, axis=-1)
    return q / mr[..., None, None]


def reversible_eigen(S, pi, normalize: bool = True):
    """Return (lam [..., ns], V [..., ns, ns], Vinv [..., ns, ns])
    such that Q = V diag(lam) Vinv with mean rate 1 (normalize=False
    skips the mean-rate scaling - used by the covarion model, whose
    M4-specific normalization counts observed substitutions only,
    m4.c:463-474)."""
    ns = S.shape[-1]
    eye = jnp.eye(ns, dtype=S.dtype)
    pi = jnp.clip(pi, 1e-12, None)
    off = S * pi[..., None, :] * (1.0 - eye)
    diag = -jnp.sum(off, axis=-1)
    if normalize:
        mr = -jnp.sum(pi * diag, axis=-1)[..., None]
    else:
        mr = jnp.ones_like(pi[..., :1])
    sqrt_pi = jnp.sqrt(pi)
    # B = D^{1/2} Q D^{-1/2}; built directly from off/diag (symmetric).
    b_off = off * (sqrt_pi[..., :, None] / sqrt_pi[..., None, :])
    b = b_off + jnp.einsum("...i,ij->...ij", diag, eye)
    lam, u = jnp.linalg.eigh(b)
    v = u / sqrt_pi[..., :, None]
    vinv = jnp.swapaxes(u, -1, -2) * sqrt_pi[..., None, :]
    return lam / mr, v, vinv


def pmat(lam, v, vinv, t):
    """Batched P(t) = V exp(lam t) V^{-1}.

    lam, v, vinv: per-class eigensystem [C, ns], [C, ns, ns].
    t: branch "time" per (node, class) [N, C] (class rate already
    folded into either lam or t by the caller).
    Returns P [N, C, ns, ns] with rows summing to 1.

    Entries are clamped to a small positive floor: eigendecomposition
    roundoff can give tiny negative values, which would otherwise feed
    sign flips into the CLV recursion (the reference clamps to
    SMALL_PIJ = 1e-100, models.c:293).
    """
    elt = jnp.exp(lam[None, :, :] * t[:, :, None])          # [N, C, ns]
    p = jnp.einsum("cxi,nci,ciy->ncxy", v, elt, vinv, precision=_PREC)
    floor = 1e-100 if p.dtype == jnp.float64 else 1e-30
    return jnp.maximum(p, floor)


def pmat_mgf_gamma(lam, v, vinv, t, sigma):
    """Branch-length-integrated P: E[P(L)] with L ~ Gamma of mean t
    and variance t*sigma (reference PMat_MGF_Gamma models.c:1044,
    called with mean = l*r_c, var = l*sigma*r_c^2, lk.c:2296-2323 —
    the Guindon 2012 relaxed-clock model).

    With the class rate r_c folded into lam (as in `pmat`), the
    reference's (1 - lam*var/mean)^(-mean^2/var) reduces exactly to
        elt_i = (1 - lam_i * sigma)^(-t / sigma),
    which converges to exp(lam_i t) as sigma -> 0 (plain P(t)).

    t: [N, C]; sigma: scalar (l_var_sigma, utilities.h mod->l_var_sigma).
    """
    sig = jnp.maximum(jnp.asarray(sigma, dtype=t.dtype), 0.0)
    lam_b = lam[None, :, :]
    t_b = t[:, :, None]
    use_mgf = sig > 1e-12
    base = jnp.maximum(1.0 - lam_b * sig, 1e-30)  # lam <= 0: base >= 1
    elt = jnp.where(
        use_mgf,
        jnp.exp((-t_b / jnp.maximum(sig, 1e-12)) * jnp.log(base)),
        jnp.exp(lam_b * t_b),
    )
    p = jnp.einsum("cxi,nci,ciy->ncxy", v, elt, vinv, precision=_PREC)
    floor = 1e-100 if p.dtype == jnp.float64 else 1e-30
    return jnp.maximum(p, floor)
