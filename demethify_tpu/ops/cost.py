"""Weighted Frobenius cost ``||sqrt(D) * (Y - R @ alpha)||^2``.

Reference: `cost_f_w`, `demethify/deconvolution.py:14-17`. Two forms:

- ``weighted_cost``: direct single pass over (Y, D) — fused by XLA into one
  matmul + elementwise-reduce, used where Y/D are being read anyway.
- ``weighted_cost_gram``: the Gram-identity form
  ``cost_s = y'Dy_s - 2 b_s . a_s + a_s' G_s a_s`` which costs O(p^2 n_s)
  given precomputed per-sample Grams — zero passes over the big arrays.
  Used inside solver loops where (G, b, ydy) are already available.
"""

import jax.numpy as jnp

from demethify_tpu.ops.gram import HIGHEST, accum_dtype


def weighted_cost(y, R, alpha, d, row_weights=None) -> jnp.ndarray:
    """sum(d * (y - R @ alpha)**2), scalar. ``row_weights`` additionally
    scales each row (the bootstrap's row-multiplicity form); the
    multiply fuses into the reduction.

    With bfloat16 storage the whole computation runs in float32 (see
    ops.gram.accum_dtype): the model matmul accumulates f32, and the
    residual/square/sum stay f32 in registers — the upcasts are fused
    into the read, so memory traffic is still the bf16 arrays. Keeping
    the residual in storage dtype instead would put a ~1e-2 relative
    error on every term, which is what made bf16 costs untrustworthy."""
    acc = accum_dtype(y)
    resid = y.astype(acc) - jnp.einsum("ip,ps->is", R, alpha,
                                       preferred_element_type=acc,
                                       precision=HIGHEST)
    sq = d.astype(acc) * resid * resid
    if row_weights is not None:
        sq = row_weights.astype(acc)[:, None] * sq
    return jnp.sum(sq)


def weighted_cost_gram(G, b, ydy, alpha) -> jnp.ndarray:
    """Gram-identity cost: Sigma_s (ydy_s - 2 b_s.a_s + a_s' G_s a_s).

    G: (n_s, p, p), b: (p, n_s), ydy: (n_s,), alpha: (p, n_s).
    Exactly equal (in exact arithmetic) to ``weighted_cost`` with the R, d, y
    used to build the Grams.
    """
    quad = jnp.einsum("spq,ps,qs->s", G, alpha, alpha, precision=HIGHEST)
    lin = jnp.sum(b * alpha, axis=0)
    return jnp.sum(ydy - 2.0 * lin + quad)
