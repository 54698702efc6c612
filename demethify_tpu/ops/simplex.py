"""Column-wise Euclidean projection onto the probability simplex.

Reference semantics: `projection_simplex_sort_2d` (Michelot/Condat sort-based
projection), `demethify/deconvolution.py:20-37`. The reference loops over
columns and scans for the *last* index j where ``u_j - (cumsum_j - z)/(j+1) > 0``;
here the whole thing is a single vectorized sort + cumsum + masked-argmax over
all columns at once, with no per-column control flow. p (= n_celltypes + n_unknown) is tiny, so the sort is cheap and the op
is safe to replicate across shards.
"""

import jax.numpy as jnp

from demethify_tpu.ops.gram import HIGHEST

# Columns here are tiny (p = n_celltypes + n_unknown, ~6-30) but the op sits
# inside latency-critical inner loops, where a `sort` primitive is a
# separate, comparatively slow op. So the descending sort is computed via
# a stable rank matrix + permutation contraction, the cumsum via a
# triangular matmul, and the threshold gather via a one-hot contraction —
# elementwise ops and small dots that XLA fuses. The contractions carry
# VALUES (a 0/1 matrix times v), so they are pinned to full f32: a TF32
# dot would round the sorted values. Tie order cannot affect the result
# (only sorted VALUES enter the threshold), so this is exactly the
# reference's projection.
_SORT_FALLBACK_P = 128


def _sorted_desc_small(v: jnp.ndarray) -> jnp.ndarray:
    """Descending-sorted columns of v (p, n) without a sort primitive."""
    p = v.shape[0]
    gt = (v[:, None, :] > v[None, :, :]).astype(v.dtype)     # (p, p, n)
    eq = (v[:, None, :] == v[None, :, :]).astype(v.dtype)
    lower = jnp.tril(jnp.ones((p, p), v.dtype), k=-1)
    # stable descending rank of element i within its column
    rank = (jnp.sum(gt, axis=0)
            + jnp.einsum("ij,ijn->jn", lower, eq,
                         precision=HIGHEST))                 # (p, n)
    perm = (rank[None, :, :] ==
            jnp.arange(p, dtype=v.dtype)[:, None, None]).astype(v.dtype)
    return jnp.einsum("kin,in->kn", perm, v, precision=HIGHEST)


def project_columns_to_simplex(v: jnp.ndarray, z: float = 1.0) -> jnp.ndarray:
    """Project each column of ``v`` (shape (p, n)) onto {x >= 0, sum(x) = z}.

    Matches the reference's threshold behavior: rho is the largest sorted
    index with ``u_j - (cumsum_j - z)/(j+1) > 0`` (guaranteed to exist for
    z > 0 since j=0 always satisfies it).
    """
    p = v.shape[0]
    if p <= _SORT_FALLBACK_P:
        u = _sorted_desc_small(v)
    else:
        u = jnp.flip(jnp.sort(v, axis=0), axis=0)
    tri = jnp.tril(jnp.ones((p, p), v.dtype))
    pi = (jnp.matmul(tri, u, precision=HIGHEST)
          - jnp.asarray(z, v.dtype))                         # cumsum - z
    j1 = jnp.arange(1, p + 1, dtype=v.dtype)[:, None]
    cond = (u - pi / j1) > 0
    idx = jnp.where(cond, jnp.arange(p)[:, None], -1)
    rho = jnp.max(idx, axis=0)                               # (n,)
    rho_onehot = (jnp.arange(p)[:, None] == rho[None, :]).astype(v.dtype)
    theta = jnp.sum(pi * rho_onehot, axis=0) / (rho + 1).astype(v.dtype)
    return jnp.maximum(v - theta[None, :], jnp.zeros((), v.dtype))


_MASK_NEG = -1e30


def project_columns_to_simplex_masked(v: jnp.ndarray, row_mask,
                                      z: float = 1.0) -> jnp.ndarray:
    """Simplex projection restricted to the rows where ``row_mask`` is True.

    Inactive rows come out exactly 0 and the active rows get EXACTLY the
    same values as projecting the length-``sum(mask)`` subvector: inactive
    entries are pushed to -1e30, so they sort last, never satisfy the
    threshold condition, and clip to zero. This is what makes the padded
    compile-once model-selection sweep (selection/batched_sweep.py)
    bit-identical to per-rank solves.
    """
    v_m = jnp.where(row_mask[:, None], v, jnp.asarray(_MASK_NEG, v.dtype))
    return project_columns_to_simplex(v_m, z=z)
