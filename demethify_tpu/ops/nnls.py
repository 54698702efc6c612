"""On-device weighted NNLS with intercept — the reference-based solver.

Reference: `wls_intercept` (`demethify/init_func.py:8-14`) =
``sklearn.LinearRegression(fit_intercept=True, positive=True)`` with sample
weights, coefficients normalized to the simplex with a 1e-10 sum floor.

sklearn's procedure (reproduced exactly, see sklearn _preprocess_data):
  1. weighted centering: X -= avg_w(X), y -= avg_w(y)   (this is the intercept)
  2. rescale rows by sqrt(w)
  3. scipy.optimize.nnls on the centered/rescaled system

The device equivalent works on the (p x p) normal equations — one pass over
the CpG axis builds G = X'WX - centering terms and c = X'Wy, then the NNLS
itself is solved on the tiny system with monotone FISTA + an exact KKT
polish (solve the unconstrained LS on the detected support), which matches
scipy's active-set answer to ~1e-10 on well-conditioned problems. vmapping
over samples batches all per-sample regressions into one kernel — the
reference loops them serially in Python (`demethify/demethify.py:209-213`).
"""

import jax
import jax.numpy as jnp

from demethify_tpu.ops.gram import HIGHEST, accum_dtype


def _mm(a, b):
    return jnp.matmul(a, b, precision=HIGHEST)


def _power_iteration_sqnorm(G, n_iter=50):
    """Largest eigenvalue of PSD G (spectral norm), via power iteration."""
    p = G.shape[0]
    v = jnp.full((p,), 1.0 / jnp.sqrt(p), dtype=G.dtype)

    def body(_, v):
        w = _mm(G, v)
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

    v = jax.lax.fori_loop(0, n_iter, body, v)
    return jnp.maximum(_mm(v, _mm(G, v)), 1e-30)


def nnls_gram(G, c, n_iter: int = 600):
    """min_x>=0 0.5 x'Gx - c'x via monotone FISTA + exact support polish.

    G: (p, p) PSD, c: (p,). Returns x >= 0.
    """
    p = G.shape[0]
    L = _power_iteration_sqnorm(G) * 1.0001
    x0 = jnp.zeros((p,), dtype=G.dtype)

    def body(_, carry):
        x, z, t = carry
        x_new = jnp.maximum(z - (_mm(G, z) - c) / L, 0.0)
        t_new = (1.0 + jnp.sqrt(1.0 + 4.0 * t * t)) / 2.0
        z_new = x_new + ((t - 1.0) / t_new) * (x_new - x)
        return (x_new, z_new, t_new)

    # unroll=8: fuses 8-step chains of these tiny ops per loop iteration
    # (dispatch latency dominates at p ~ 6)
    x, _, _ = jax.lax.fori_loop(0, n_iter, body,
                                (x0, x0, jnp.ones((), G.dtype)),
                                unroll=8)

    # KKT polish: exact LS solve restricted to the detected support.
    support = x > 1e-9
    diag_off = jnp.where(support, 0.0, 1.0)
    G_m = jnp.where(support[:, None] & support[None, :], G, 0.0) \
        + jnp.diag(diag_off)
    c_m = jnp.where(support, c, 0.0)
    x_polish = jnp.linalg.solve(
        G_m + 1e-12 * jnp.eye(p, dtype=G.dtype), c_m)
    ok = jnp.all(jnp.where(support, x_polish >= 0.0, x_polish == 0.0)) \
        & jnp.all(jnp.isfinite(x_polish))
    return jnp.where(ok, jnp.where(support, x_polish, 0.0), x)


def nnls(A, y, n_iter: int = 600):
    """min_x>=0 ||Ax - y||^2 (scipy.optimize.nnls semantics, fixed budget)."""
    G = _mm(A.T, A)
    c = _mm(A.T, y)
    return nnls_gram(G, c, n_iter=n_iter)


def wls_intercept(y, w, X, n_iter: int = 600):
    """Reference `wls_intercept` for one sample.

    y: (n_cpg,) target, w: (n_cpg,) weights, X: (n_cpg, p) reference profiles.
    Returns (p,) simplex-normalized nonneg coefficients (intercept discarded,
    as the reference does at `init_func.py:12`).
    """
    acc = accum_dtype(X)
    y = y.astype(acc)
    w = w.astype(acc)
    X = X.astype(acc)
    wsum = jnp.maximum(jnp.sum(w), 1e-30)
    x_off = _mm(w, X) / wsum
    y_off = _mm(w, y) / wsum
    Xc = X - x_off[None, :]
    yc = y - y_off
    # normal equations of the sqrt(w)-rescaled centered system, one CpG pass
    G = _mm(Xc.T, w[:, None] * Xc)
    c = _mm(Xc.T, w * yc)
    coef = nnls_gram(G, c, n_iter=n_iter)
    return coef / jnp.maximum(coef.sum(), 1e-10)


def wls_intercept_batch(Y, W, X, n_iter: int = 600):
    """All samples at once: Y, W: (n_cpg, n_s); X: (n_cpg, p) -> (p, n_s)."""
    coefs = jax.vmap(wls_intercept, in_axes=(1, 1, None, None), out_axes=1)(
        Y, W, X, n_iter)
    return coefs
