"""Gram-form precomputations: the restructuring of the hot loops.

The reference's inner FISTA loops (`update_u`/`update_alpha`,
`demethify/deconvolution.py:80-102`) re-read the full (n_cpg x n_s) arrays
Y and D on *every* inner step — ~40 full passes per outer iteration. The
workload is memory-bandwidth-bound (arithmetic intensity ~p flops/element),
so we restructure algebraically:

  alpha-gradient:  R' (d_s ⊙ (y_s - R a_s)) = b_s - G_s a_s
      with  G_s = R' diag(d_s) R   (p x p per sample)
            b_s = R' (d_s ⊙ y_s)   (p per sample)
  u-gradient row i:  (d_i ⊙ (y_i - Rt a1 - u_i a2)) a2'
                   = C_i - M_i u_i
      with  C = (D ⊙ (Y - Rt a1)) a2'      (n_cpg x n_u)
            M_i = a2 diag(d_i) a2'          (n_u x n_u per CpG site)

G/b/C/M are computed in ONE pass over the big arrays per outer iteration;
the inner loops then run on tiny / elementwise tensors. The gradients are
mathematically identical to the reference's (floating-point reassociation
aside).

Sharding: with Y/D/R row-sharded on the 'cpg' mesh axis, G/b/ydy are
cross-shard reductions (XLA inserts a cross-device sum); C and M inherit
the row sharding with no communication.

Precision: every contraction here sums over the CpG axis or feeds one that
does, and is pinned to ``HIGHEST``. On a GPU an f32 einsum at DEFAULT
precision may run in TF32 (10-bit mantissa), and the Gram-identity cost
``ydy - 2 b.a + a'Ga`` (ops/cost.py) then cancels to noise. These
contractions are skinny and bandwidth-bound, so full f32 costs little.
"""

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def _einsum(spec, *operands, acc):
    return jnp.einsum(spec, *operands, preferred_element_type=acc,
                      precision=HIGHEST)


def accum_dtype(x):
    """Accumulation dtype for reductions over the CpG axis: low-precision
    storage (bfloat16 mixed mode — halves memory traffic) still
    accumulates in float32; float32/float64 stay as-is."""
    if x.dtype in (jnp.bfloat16, jnp.float16):
        return jnp.float32
    return x.dtype


def sample_grams(R, d, y, row_weights=None):
    """Per-sample Gram system for the alpha subproblem.

    Returns (G, b, ydy):
      G: (n_s, p, p) = R' diag(d_s) R
      b: (p, n_s)    = R' (d_s * y_s)
      ydy: (n_s,)    = sum_i d_is y_is^2
    One pass over (Y, D, R); all outputs are tiny and replicated. With
    R = Rt (the known panel) these are the loop-invariant blocks G_tt,
    b_t and ydy, computed once before the outer loop.

    ``row_weights`` ((n_cpg,), the bootstrap's row-multiplicity form)
    joins the contractions as an extra einsum operand — XLA fuses the
    multiply into the reduction, so no (n_cpg, n_s) weighted-coverage
    array is ever materialized (which matters when this is vmapped over
    B replicates).
    """
    acc = accum_dtype(y)
    if row_weights is None:
        G = _einsum("ip,is,iq->spq", R, d, R, acc=acc)
        b = _einsum("ip,is->ps", R, d * y, acc=acc)
        ydy = jnp.sum((d * y * y).astype(acc), axis=0)
        return G, b, ydy
    w = row_weights
    G = _einsum("i,ip,is,iq->spq", w, R, d, R, acc=acc)
    b = _einsum("i,ip,is->ps", w, R, d * y, acc=acc)
    ydy = _einsum("i,is->s", w, (d * y * y).astype(acc), acc=acc)
    return G, b, ydy


def sample_grams_incremental(G_tt, b_t, R_trunc, u, d, y,
                             row_weights=None):
    """Per-iteration Gram assembly: only the u-involved blocks are
    recomputed (G_tu, G_uu, b_u), ~70% fewer FLOPs than rebuilding the
    full p x p Grams when n_ct dominates p. Exactly equals
    sample_grams([Rt|u], d, y)[:2] (w-weighted when row_weights is
    given; see sample_grams).
    """
    acc = accum_dtype(y)
    if row_weights is None:
        G_tu = _einsum("ip,is,iu->spu", R_trunc, d, u, acc=acc)
        G_uu = _einsum("iu,is,iv->suv", u, d, u, acc=acc)
        b_u = _einsum("iu,is->us", u, d * y, acc=acc)
    else:
        w = row_weights
        G_tu = _einsum("i,ip,is,iu->spu", w, R_trunc, d, u, acc=acc)
        G_uu = _einsum("i,iu,is,iv->suv", w, u, d, u, acc=acc)
        b_u = _einsum("i,iu,is->us", w, u, d * y, acc=acc)
    top = jnp.concatenate([G_tt, G_tu], axis=2)
    bottom = jnp.concatenate([jnp.swapaxes(G_tu, 1, 2), G_uu], axis=2)
    G = jnp.concatenate([top, bottom], axis=1)
    b = jnp.concatenate([b_t, b_u], axis=0)
    return G, b


def site_curvature(d, a2):
    """Per-site curvature M_i = a2 diag(d_i) a2' for the u subproblem.

    d: (n_cpg, n_s), a2: (n_u, n_s)  ->  M: (n_cpg, n_u, n_u).
    """
    return _einsum("us,is,vs->iuv", a2, d, a2, acc=accum_dtype(d))


def u_constant_term(y, d, R_trunc, a1, a2):
    """C = (D ⊙ (Y - R_trunc a1)) a2'  (n_cpg x n_u).

    For the unsupervised case pass R_trunc=None / a1=None and the
    Y-only form is used (R = U so the 'known block' is empty).
    """
    acc = accum_dtype(y)
    if R_trunc is None:
        resid = y
    else:
        resid = y - _einsum("ic,cs->is", R_trunc, a1,
                            acc=acc).astype(y.dtype)
    return _einsum("is,us->iu", d * resid, a2, acc=acc)
