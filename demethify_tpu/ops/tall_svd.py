"""SVD for tall-skinny matrices via the small Gram eigendecomposition.

SURVEY.md §7 hard-parts: "Megabase-scale SVD/ICA init across shards — use
randomized/sharded SVD rather than dense scipy.linalg.svd". For this
framework's matrices the column count is tiny (n_samples, or n_celltypes),
so the EXACT factorization is cheap and fully shardable:

    G = V' V              (m x m, ONE psum-reducible pass over the rows)
    G = W diag(s^2) W'    (host-scale eigh)
    U = V W diag(1/s)     (one more row-local pass)

With V row-sharded on the 'cpg' mesh axis, G is a cross-shard reduction
(a cross-device sum) and U inherits the row sharding — no all-gather of the
tall matrix ever happens. Used by NNDSVD init, Minka rank selection, and
SVD feature selection at scale.
"""

import jax.numpy as jnp

from demethify_tpu.ops.gram import HIGHEST


def tall_svd(V, full_matrices: bool = False):
    """Thin SVD of V (n x m, n >> m): returns (U (n,m), s (m,), Wt (m,m))
    with U @ diag(s) @ Wt == V, singular values descending.

    Exact up to the conditioning of V'V (singular values below
    ~sqrt(eps)*s_max lose relative accuracy — irrelevant for the
    rank-selection / init uses here).
    """
    G = jnp.matmul(V.T, V, precision=HIGHEST)
    evals, W = jnp.linalg.eigh(G)                  # ascending
    evals = jnp.flip(evals, 0)
    W = jnp.flip(W, 1)
    s = jnp.sqrt(jnp.maximum(evals, 0.0))
    inv_s = jnp.where(s > 0, 1.0 / jnp.maximum(s, 1e-300), 0.0)
    U = jnp.matmul(V, W, precision=HIGHEST) * inv_s[None, :]
    return U, s, W.T


def tall_svd_singular_values(V):
    """Singular values only — one Gram pass, no U materialization."""
    G = jnp.matmul(V.T, V, precision=HIGHEST)
    evals = jnp.linalg.eigvalsh(G)
    return jnp.sqrt(jnp.maximum(jnp.flip(evals, 0), 0.0))
