"""Unsupervised weighted NMF (no reference profiles): R = U.

Reference: `unsupervised_deconv` (`demethify/deconvolution.py:107-184`), with
its inlined inner loops — including the reference's quirk that the inner-U
gradient is evaluated at the *previous iterate* u (not the extrapolated
u_temp; `deconvolution.py:163`), which we replicate for trajectory parity.

Same Gram-form dataflow as partial_ref.py, with the whole factor playing the
role of the unknown block.
"""

from functools import partial

import jax
import jax.numpy as jnp

from demethify_tpu.ops.fista import _run_steps
from demethify_tpu.ops.cost import weighted_cost, weighted_cost_gram
from demethify_tpu.ops.gram import (
    HIGHEST,
    accum_dtype,
    sample_grams,
    site_curvature,
    u_constant_term,
)
from demethify_tpu.ops.pallas_small import alpha_loop


def _fista_u_lagged_gram(u, u_prev, a, l_prev, l_cur, C, M, n_steps):
    """U FISTA steps with the gradient at the previous iterate (reference
    unsupervised semantics, `deconvolution.py:157-164`)."""

    def body(_, carry):
        u, u_prev, a, l_p = carry
        a0 = a
        a1 = (1.0 + jnp.sqrt(1.0 + 4.0 * a0 * a0)) / 2.0
        beta = jnp.minimum((a0 - 1.0) / a1, 0.9999 * jnp.sqrt(l_p / l_cur))
        u_t = u + beta * (u - u_prev)
        # gradient at old u
        grad = C - jnp.einsum("iuv,iv->iu", M, u, precision=HIGHEST)
        u_new = jnp.clip(u_t + grad / l_cur, 0.0, 1.0)
        return (u_new, u, a1, l_cur)

    return _run_steps(body, (u, u_prev, a, l_prev), n_steps)


def _fista_u_lagged_direct(u, u_prev, a, l_prev, l_cur, y, d, alpha, n_steps):
    def body(_, carry):
        u, u_prev, a, l_p = carry
        a0 = a
        a1 = (1.0 + jnp.sqrt(1.0 + 4.0 * a0 * a0)) / 2.0
        beta = jnp.minimum((a0 - 1.0) / a1, 0.9999 * jnp.sqrt(l_p / l_cur))
        u_t = u + beta * (u - u_prev)
        # gradient at old u
        resid = y - jnp.matmul(u, alpha, precision=HIGHEST)
        grad = jnp.matmul(d * resid, alpha.T, precision=HIGHEST)
        u_new = jnp.clip(u_t + grad / l_cur, 0.0, 1.0)
        return (u_new, u, a1, l_cur)

    return _run_steps(body, (u, u_prev, a, l_prev), n_steps)


@partial(jax.jit, static_argnames=("n_u", "n_iter1", "n_iter2", "use_gram_u",
                                   "record_trace", "tol_relative"))
def unsupervised_solve(u, alpha, y, d, n_u: int,
                       n_iter1: int = 10000, n_iter2: int = 20,
                       tol: float = 1e-2, use_gram_u: bool = True,
                       record_trace: bool = False,
                       tol_relative: bool = False,
                       row_mask=None, row_weights=None):
    """u: (n_cpg, n_u), alpha: (n_u, n_s). Returns (u, alpha, info).

    ``row_weights`` ((n_cpg,) nonneg, optional) solves the
    ROW-MULTIPLICITY problem (the bootstrap's with-replacement resample
    without gathered copies — same contract as
    `partial_ref_solve(row_weights=)`): the row-separable U update is
    untouched (duplicated rows share one trajectory; the lagged gradient
    C - M u is per-row), while the cross-row reductions — alpha Grams,
    cost, the Lipschitz norms and max(D) — take the multiplicity weights.
    """
    dtype = accum_dtype(y)
    u = u.astype(dtype)
    alpha = alpha.astype(dtype)
    if row_weights is None:
        dmax2 = jnp.max(d).astype(dtype) ** 2

        def u_sq(u):
            return jnp.sum(u * u)
    else:
        w = row_weights.astype(dtype)[:, None]
        rowmax = jnp.max(d, axis=1)
        dmax2 = jnp.max(jnp.where(row_weights > 0, rowmax,
                                  0.0)).astype(dtype) ** 2

        def u_sq(u):
            return jnp.sum(w * u * u)
    l_w0 = jnp.sum(alpha * alpha) * dmax2  # alpha[-n_u:] == whole alpha here
    l_h0 = u_sq(u) * dmax2
    cf0 = weighted_cost(y, u, alpha, d, row_weights=row_weights)
    tol = tol * cf0 if tol_relative else tol

    trace0 = (jnp.full((n_iter1,), jnp.nan, dtype) if record_trace
              else jnp.zeros((0,), dtype))

    def cond(carry):
        (_, _, _, _, _, _, _, _, _, cf, cf_prev, k, _) = carry
        return (k < n_iter1) & (jnp.abs(cf - cf_prev) >= tol)

    def body(carry):
        (u, u_prev, alpha, alpha_prev, a1, a2,
         l_w, l_w_prev, l_h_prev, cf, _, k, trace) = carry

        if use_gram_u:
            C = u_constant_term(y, d, None, None, alpha)
            M = site_curvature(d, alpha)
            u, u_prev, a1, l_w_prev = _fista_u_lagged_gram(
                u, u_prev, a1, l_w_prev, l_w, C, M, n_iter2)
        else:
            u, u_prev, a1, l_w_prev = _fista_u_lagged_direct(
                u, u_prev, a1, l_w_prev, l_w, y, d, alpha, n_iter2)

        G, b, ydy = sample_grams(u, d, y, row_weights=row_weights)
        l_h = u_sq(u) * dmax2

        alpha, alpha_prev, a2, l_h_prev = alpha_loop(
            alpha, alpha_prev, a2, l_h_prev, l_h, G, b, n_iter2,
            row_mask=row_mask)

        l_w = jnp.sum(alpha * alpha) * dmax2
        cf_new = weighted_cost_gram(G, b, ydy, alpha)

        if record_trace:
            trace = trace.at[k].set(cf_new)
        return (u, u_prev, alpha, alpha_prev, a1, a2,
                l_w, l_w_prev, l_h_prev, cf_new, cf, k + 1, trace)

    init = (u, u, alpha, alpha,
            jnp.ones((), dtype), jnp.ones((), dtype),
            l_w0, l_w0, l_h0,
            cf0, jnp.asarray(jnp.inf, dtype), jnp.zeros((), jnp.int32),
            trace0)
    out = jax.lax.while_loop(cond, body, init)
    u, _, alpha, _, _, _, _, _, _, cf, _, k, trace = out
    return u, alpha, {"cost": cf, "n_iter": k, "trace": trace}
