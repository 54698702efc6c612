"""Frank-Wolfe solver for the purity-constrained alpha subproblem.

Reference: `frank_wolfe_nmf` + `argmin_vertex_in_simplex`
(`demethify/deconvolution.py:269-302`). Each sample's proportions are split
into a known block alpha1 (mass = purity_s) and an unknown block alpha2
(mass = 1 - purity_s); each FW step moves toward the vertex
``purity_s * e_argmin(grad)`` of the scaled simplex with step 2/(k+2).

Gram form: with G = R' diag(d_s) R and b = R' (d_s y_s) over the stacked
R = [W1 | W2], the block gradients are just slices of ``-(b - G a)``, so all
`max_iter` (default 500) FW steps run on O(p^2 n_s) data with zero passes
over the CpG axis. The LMO is a vectorized argmin + one-hot over columns —
no per-column Python loop.
"""

import jax
import jax.numpy as jnp

from demethify_tpu.ops.gram import HIGHEST


def _lmo_columns(grad, mass):
    """Per-column vertex: mass_s * e_{argmin_col grad}. grad: (k, n_s)."""
    idx = jnp.argmin(grad, axis=0)
    return jax.nn.one_hot(idx, grad.shape[0], dtype=grad.dtype).T * mass[None, :]


def frank_wolfe_gram(alpha1, alpha2, G, b, purity, max_iter: int):
    """max_iter FW steps on the stacked alpha = [alpha1; alpha2].

    alpha1: (p1, n_s), alpha2: (n_u, n_s); G: (n_s, p, p), b: (p, n_s) built
    from the stacked R; purity: (n_s,).
    """
    p1 = alpha1.shape[0]
    alpha = jnp.concatenate([alpha1, alpha2], axis=0)

    def body(k, alpha):
        # = -(b - G a)
        grad = jnp.einsum("spq,qs->ps", G, alpha, precision=HIGHEST) - b
        s1 = _lmo_columns(grad[:p1], purity)
        s2 = _lmo_columns(grad[p1:], 1.0 - purity)
        s = jnp.concatenate([s1, s2], axis=0)
        gamma = 2.0 / (k.astype(alpha.dtype) + 2.0)
        return (1.0 - gamma) * alpha + gamma * s

    alpha = jax.lax.fori_loop(0, max_iter, body, alpha, unroll=8)
    return alpha[:p1], alpha[p1:]


def frank_wolfe_direct(W1, W2, y, alpha1, alpha2, purity, max_iter: int, d):
    """Reference-dataflow FW loop (`deconvolution.py:279-302`), as oracle."""

    def body(k, carry):
        alpha1, alpha2 = carry
        resid = d * (y - W1 @ alpha1 - W2 @ alpha2)
        grad1 = -(W1.T @ resid)
        grad2 = -(W2.T @ resid)
        s1 = _lmo_columns(grad1, purity)
        s2 = _lmo_columns(grad2, 1.0 - purity)
        gamma = 2.0 / (k.astype(alpha1.dtype) + 2.0)
        return ((1.0 - gamma) * alpha1 + gamma * s1,
                (1.0 - gamma) * alpha2 + gamma * s2)

    return jax.lax.fori_loop(0, max_iter, body, (alpha1, alpha2))
