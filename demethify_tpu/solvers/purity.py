"""Purity-constrained partial-reference deconvolution.

Reference: `mdwbssmf_deconv_p` (`demethify/deconvolution.py:305-337`):
same FISTA U-update as the partial-reference solver, but the alpha update is
`n_iter2` (default 500) Frank-Wolfe steps over per-sample purity-scaled
simplexes.

Gram dataflow: after the U update, one pass over (Y, D, R) builds the
per-sample Grams; the 500 FW steps then run on O(p^2 n_s) data (see
ops/frank_wolfe.py), and the termination cost falls out of the same Grams.
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
from demethify_tpu.ops.pallas_small import fw_loop


@partial(jax.jit, static_argnames=("n_u", "n_iter1", "n_iter2", "use_gram_u",
                                   "record_trace", "tol_relative"))
def purity_solve(u, alpha, y, d, R_trunc, purity, n_u: int,
                 n_iter1: int = 100, n_iter2: int = 500,
                 tol: float = 1e-2, use_gram_u: bool = True,
                 record_trace: bool = False,
                 tol_relative: bool = False,
                 row_weights=None):
    """u: (n_cpg, n_u); alpha: (p, n_s) stacked [known; unknown];
    purity: (n_s,) already flipped to 1 - p/100 by the CLI
    (reference `demethify.py:77`). Returns (u, alpha, info).

    ``row_weights`` solves the row-multiplicity (bootstrap-resample)
    problem without gathered copies — same semantics as
    partial_ref_solve's row_weights."""
    dtype = accum_dtype(y)
    n_ct = R_trunc.shape[1]
    u = u.astype(dtype)
    alpha = alpha.astype(dtype)
    if row_weights is None:
        dmax2 = jnp.max(d).astype(dtype) ** 2
    else:
        rowmax = jnp.max(d, axis=1)
        dmax2 = jnp.max(jnp.where(row_weights > 0, rowmax,
                                  0.0)).astype(dtype) ** 2
    R0 = jnp.concatenate([R_trunc.astype(dtype), u], axis=1)
    l_w0 = jnp.sum(alpha[-n_u:] ** 2) * dmax2
    cf0 = weighted_cost(y, R0, alpha, d, row_weights=row_weights)
    tol = tol * cf0 if tol_relative else tol
    G_tt, b_t, ydy = sample_grams(R_trunc, d, y,
                                       row_weights=row_weights)

    trace0 = (jnp.full((n_iter1,), jnp.nan, dtype) if record_trace
              else jnp.zeros((0,), dtype))

    def cond(carry):
        (_, _, _, _, _, _, cf, cf_prev, k, _) = carry
        return (k < n_iter1) & (jnp.abs(cf - cf_prev) >= tol)

    def body(carry):
        (u, u_prev, alpha, a1, l_w, l_w_prev, cf, _, k, trace) = carry

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

        alpha1, alpha2 = fw_loop(
            alpha[:-n_u], alpha[-n_u:], G, b, purity, n_iter2)
        alpha = jnp.concatenate([alpha1, alpha2], axis=0)

        l_w = jnp.sum(alpha2 * alpha2) * dmax2
        cf_new = weighted_cost_gram(G, b, ydy, alpha)

        if record_trace:
            trace = trace.at[k].set(cf_new)
        return (u, u_prev, alpha, a1, l_w, l_w_prev, cf_new, cf, k + 1, trace)

    init = (u, u, alpha, jnp.ones((), dtype),
            l_w0, l_w0, cf0, jnp.asarray(jnp.inf, dtype),
            jnp.zeros((), jnp.int32), trace0)
    out = jax.lax.while_loop(cond, body, init)
    u, _, alpha, _, _, _, cf, _, k, trace = out
    return u, alpha, {"cost": cf, "n_iter": k, "trace": trace}
