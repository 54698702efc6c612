"""Partial-reference deconvolution: FISTA block-coordinate descent.

Reference: `mdwbssmf_deconv` (`demethify/deconvolution.py:190-223`). The whole
outer loop is ONE `lax.while_loop` jitted end-to-end — the reference re-enters
Python every outer iteration; here only the converged factors cross back to
host.

Per outer iteration (Gram dataflow, see ops/gram.py):
  1. one fused pass over (Y, D):  C = (D ⊙ (Y - Rt a1)) a2',
     M_i = a2 diag(d_i) a2'
  2. inner U FISTA loop on (C, M) — elementwise over (n_cpg, n_u)
  3. one fused pass over (Y, D, R): per-sample Grams G, b; l_h = ||R||^2 dmax^2
  4. inner alpha FISTA loop on (G, b) — O(p^2 n_s), no CpG passes
  5. cost via the Gram identity (free), reference termination
     |cf - cf_prev| < tol

Traffic: ~2 passes over the big arrays per outer iteration vs the
reference's ~40 (n_iter2 x 2 blocks). Gradients are mathematically identical.

Sharding: Y/D/R/U row-sharded on the 'cpg' mesh axis make steps 1-2 fully
local; step 3's Grams are cross-shard reductions XLA lowers to psum.
alpha and all O(p^2) state is replicated.
"""

from functools import partial

import jax
import jax.numpy as jnp

from demethify_tpu.ops import fista
from demethify_tpu.ops.cost import weighted_cost, weighted_cost_gram
from demethify_tpu.ops.gram import (
    accum_dtype,
    sample_grams,
    sample_grams_incremental,
    site_curvature,
    u_constant_term,
)
from demethify_tpu.ops.pallas_small import alpha_loop


@partial(jax.jit, static_argnames=("n_u", "n_iter1", "n_iter2", "use_gram_u",
                                   "record_trace", "tol_relative"))
def partial_ref_solve(u, alpha, y, d, R_trunc, n_u: int,
                      n_iter1: int = 10000, n_iter2: int = 20,
                      tol: float = 1e-2, use_gram_u: bool = True,
                      record_trace: bool = False,
                      tol_relative: bool = False,
                      row_mask=None, row_weights=None):
    """Run the partial-reference BCD to convergence.

    u: (n_cpg, n_u) initial unknown profiles; alpha: (p, n_s) initial
    proportions (p = n_ct + n_u); y, d: (n_cpg, n_s); R_trunc: (n_cpg, n_ct).

    Returns (u, alpha, info) where info = {'cost': final cost,
    'n_iter': outer iterations run, 'trace': (n_iter1,) cost history
    (NaN-padded) if record_trace}.

    ``row_mask`` ((p,) bool, optional) restricts alpha to active rows for
    the padded compile-once model-selection sweep: with inactive u
    columns and alpha rows initialized to zero, the masked solve is
    exactly the lower-rank solve (see selection/batched_sweep.py).

    ``row_weights`` ((n_cpg,) nonneg, optional) solves the ROW-MULTIPLICITY
    problem: the solve on data where row i appears row_weights[i] times
    (the bootstrap's with-replacement resample, expressed without
    materializing gathered copies — see uncertainty/bootstrap.py). The
    U update is row-separable, so duplicated rows share one trajectory
    and only the cross-row reductions change: alpha Grams / cost use
    w-weighted coverage, the Lipschitz norms use the w-weighted ||R||^2,
    and max(D) runs over rows with w > 0 (a resample can drop the
    max-coverage row). Rows with w = 0 still carry their own
    (alpha-conditional) u estimate; they contribute nothing to alpha.
    """
    dtype = accum_dtype(y)
    u = u.astype(dtype)
    alpha = alpha.astype(dtype)
    R0 = jnp.concatenate([R_trunc.astype(dtype), u], axis=1)
    if row_weights is None:
        dmax2 = jnp.max(d).astype(dtype) ** 2
        rt_sq = jnp.sum(R_trunc * R_trunc)
        l_h0 = jnp.sum(R0 * R0) * dmax2

        def u_sq(u):
            return jnp.sum(u * u)
    else:
        w = row_weights.astype(dtype)[:, None]
        rowmax = jnp.max(d, axis=1)
        dmax2 = jnp.max(jnp.where(row_weights > 0, rowmax,
                                  0.0)).astype(dtype) ** 2
        rt_sq = jnp.sum(w * R_trunc * R_trunc)
        l_h0 = (rt_sq + jnp.sum(w * u * u)) * dmax2

        def u_sq(u):
            return jnp.sum(w * u * u)
    l_w0 = jnp.sum(alpha[-n_u:] ** 2) * dmax2
    cf0 = weighted_cost(y, R0, alpha, d, row_weights=row_weights)
    tol = tol * cf0 if tol_relative else tol
    # loop-invariant known-block Grams and ||Rt||^2 (ops/gram.py);
    # row_weights joins the contractions fused (no materialized w*D)
    G_tt, b_t, ydy = sample_grams(R_trunc, d, y,
                                       row_weights=row_weights)

    trace0 = (jnp.full((n_iter1,), jnp.nan, dtype) if record_trace
              else jnp.zeros((0,), dtype))

    def cond(carry):
        (_, _, _, _, _, _, _, _, _, cf, cf_prev, k, _) = carry
        return (k < n_iter1) & (jnp.abs(cf - cf_prev) >= tol)

    def body(carry):
        (u, u_prev, alpha, alpha_prev, a1, a2,
         l_w, l_w_prev, l_h_prev, cf, _, k, trace) = carry

        a1_block = alpha[:-n_u]
        a2_block = alpha[-n_u:]
        if use_gram_u:
            C = u_constant_term(y, d, R_trunc, a1_block, a2_block)
            M = site_curvature(d, a2_block)
            u, u_prev, a1, l_w_prev = fista.fista_u_gram(
                u, u_prev, a1, l_w_prev, l_w, C, M, n_iter2)
        else:
            u, u_prev, a1, l_w_prev = fista.fista_u_direct(
                u, u_prev, a1, l_w_prev, l_w, y, d, R_trunc,
                a1_block, a2_block, n_iter2)

        G, b = sample_grams_incremental(G_tt, b_t, R_trunc, u, d, y,
                                        row_weights=row_weights)
        l_h = (rt_sq + u_sq(u)) * dmax2

        alpha, alpha_prev, a2, l_h_prev = alpha_loop(
            alpha, alpha_prev, a2, l_h_prev, l_h, G, b, n_iter2,
            row_mask=row_mask)

        l_w = jnp.sum(alpha[-n_u:] ** 2) * dmax2
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
