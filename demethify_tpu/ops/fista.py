"""FISTA (extrapolated projected-gradient) inner loops.

Reference semantics: `update_u` (`demethify/deconvolution.py:80-90`) and
`update_alpha` (`deconvolution.py:92-102`): Nesterov sequence
``a1 <- (1 + sqrt(1 + 4 a0^2))/2``, momentum
``beta = min((a0-1)/a1, 0.9999 sqrt(L_prev/L))``, gradient step with fixed
Lipschitz estimate, then clip-to-[0,1] (U) or simplex projection (alpha).

Two dataflows, numerically identical gradients:

- *gram* form: inner steps contract precomputed G/b (alpha) or C/M (u);
  zero passes over the big (n_cpg x n_s) arrays — the default.
- *direct* form: mirrors the reference dataflow exactly (re-reads Y/D each
  step); used when n_u is so large that the (n_cpg, n_u, n_u) curvature
  tensor would exceed the traffic it saves, and as a test oracle.

All loops have static trip counts and are UNROLLED (Python loop) up to
`_UNROLL_LIMIT` steps: each FISTA step is elementwise in the loop-carried
arrays, so unrolling turns the whole inner loop into one elementwise DAG
that XLA can fuse into one kernel (the `lax.fori_loop` form re-reads
u/u_prev/C/M from device memory every step; the fused form reads each
operand once). Beyond the limit we fall back to fori_loop to bound
compile time.
"""


import jax
import jax.numpy as jnp

from demethify_tpu.ops.gram import HIGHEST
from demethify_tpu.ops.simplex import (
    project_columns_to_simplex,
    project_columns_to_simplex_masked,
)


_UNROLL_LIMIT = 64


def _nesterov_step(a0):
    a1 = (1.0 + jnp.sqrt(1.0 + 4.0 * a0 * a0)) / 2.0
    return a1


def _momentum(a0, a1, l_prev, l_cur):
    return jnp.minimum((a0 - 1.0) / a1, 0.9999 * jnp.sqrt(l_prev / l_cur))


def _run_steps(body, carry, n_steps: int):
    """Unrolled when small (fusable elementwise DAG); partially-unrolled
    fori_loop otherwise (unroll=8 still fuses 8-step chains per loop
    iteration while keeping the program small)."""
    if n_steps <= _UNROLL_LIMIT:
        for _ in range(n_steps):
            carry = body(None, carry)
        return carry
    return jax.lax.fori_loop(0, n_steps, body, carry, unroll=8)


# ---------------------------------------------------------------------------
# U block (clip to [0, 1])
# ---------------------------------------------------------------------------

def fista_u_gram(u, u_prev, a, l_w_prev, l_w, C, M, n_steps: int):
    """n_steps FISTA steps on U in Gram form.

    u, u_prev: (n_cpg, n_u); C: (n_cpg, n_u); M: (n_cpg, n_u, n_u).
    Gradient term (D ⊙ (Y - Rt a1 - u_t a2)) a2' == C - (M @ u_t rows).
    Returns (u, u_prev, a, l_w_prev) matching the reference's carry.
    """

    def body(_, carry):
        u, u_prev, a, l_prev = carry
        a0 = a
        a1 = _nesterov_step(a0)
        beta = _momentum(a0, a1, l_prev, l_w)
        u_t = u + beta * (u - u_prev)
        grad = C - jnp.einsum("iuv,iv->iu", M, u_t, precision=HIGHEST)
        u_new = jnp.clip(u_t + grad / l_w, 0.0, 1.0)
        return (u_new, u, a1, l_w)

    return _run_steps(body, (u, u_prev, a, l_w_prev), n_steps)


def fista_u_direct(u, u_prev, a, l_w_prev, l_w, y, d, R_trunc, a1_block,
                   a2_block, n_steps: int):
    """Reference-dataflow U loop (`deconvolution.py:80-90`).

    R_trunc may be None (unsupervised: R = U, no known block).
    """
    if R_trunc is None:
        y_eff = y
    else:
        y_eff = y - jnp.matmul(R_trunc, a1_block, precision=HIGHEST)

    def body(_, carry):
        u, u_prev, a, l_prev = carry
        a0 = a
        a1 = _nesterov_step(a0)
        beta = _momentum(a0, a1, l_prev, l_w)
        u_t = u + beta * (u - u_prev)
        resid = y_eff - jnp.matmul(u_t, a2_block, precision=HIGHEST)
        grad = jnp.matmul(d * resid, a2_block.T, precision=HIGHEST)
        u_new = jnp.clip(u_t + grad / l_w, 0.0, 1.0)
        return (u_new, u, a1, l_w)

    return _run_steps(body, (u, u_prev, a, l_w_prev), n_steps)


# ---------------------------------------------------------------------------
# alpha block (simplex projection)
# ---------------------------------------------------------------------------

def fista_alpha_gram(alpha, alpha_prev, a, l_h_prev, l_h, G, b,
                     n_steps: int, row_mask=None):
    """n_steps FISTA steps on alpha in Gram form.

    alpha: (p, n_s); G: (n_s, p, p); b: (p, n_s).
    Gradient R'(D ⊙ (Y - R a_t)) == b - G a_t per sample. The whole loop
    touches only O(p^2 n_s) data — no pass over the CpG axis.

    ``row_mask`` (p,) restricts the simplex projection to active rows
    (padded model-selection sweep); None = all rows active.
    """

    def project(v):
        if row_mask is None:
            return project_columns_to_simplex(v)
        return project_columns_to_simplex_masked(v, row_mask)

    def body(_, carry):
        alpha, alpha_prev, a, l_prev = carry
        a0 = a
        a2 = _nesterov_step(a0)
        beta = _momentum(a0, a2, l_prev, l_h)
        a_t = alpha + beta * (alpha - alpha_prev)
        grad = b - jnp.einsum("spq,qs->ps", G, a_t, precision=HIGHEST)
        a_new = project(a_t + grad / l_h)
        return (a_new, alpha, a2, l_h)

    return _run_steps(body, (alpha, alpha_prev, a, l_h_prev), n_steps)


def fista_alpha_direct(alpha, alpha_prev, a, l_h_prev, l_h, y, d, R,
                       n_steps: int):
    """Reference-dataflow alpha loop (`deconvolution.py:92-102`)."""

    def body(_, carry):
        alpha, alpha_prev, a, l_prev = carry
        a0 = a
        a2 = _nesterov_step(a0)
        beta = _momentum(a0, a2, l_prev, l_h)
        a_t = alpha + beta * (alpha - alpha_prev)
        resid = y - jnp.matmul(R, a_t, precision=HIGHEST)
        grad = jnp.matmul(R.T, d * resid, precision=HIGHEST)
        a_new = project_columns_to_simplex(a_t + grad / l_h)
        return (a_new, alpha, a2, l_h)

    return _run_steps(body, (alpha, alpha_prev, a, l_h_prev), n_steps)


def use_gram_u(n_u: int, n_s: int, n_iter2: int) -> bool:
    """Heuristic: gram-form U saves traffic when the curvature tensor
    (n_cpg * n_u^2) is smaller than the Y/D traffic it avoids
    (~2 * n_iter2 * n_s)."""
    return n_u * n_u <= 2 * n_iter2 * n_s
