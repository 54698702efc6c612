"""Pallas kernels (Triton route) for the alpha FISTA and Frank-Wolfe loops.

Both loops run 20 (FISTA) to 500 (Frank-Wolfe, purity mode) strictly
sequential steps per outer iteration on kilobytes of data: the per-sample
Grams G (n_s, p, p), b (p, n_s) and alpha (p, n_s). In plain XLA every step
is a handful of separate kernels (the G a contraction, the simplex
projection's comparisons and sums, the elementwise tail), so the loop costs
one launch per operation per step. Here one program per sample column holds
G_s, b_s and its alpha column in registers and runs the whole loop with
``lax.fori_loop``; alpha is written once.

Columns are independent: the gradient, the simplex projection and the
Frank-Wolfe vertex choice act per sample, and the Nesterov scalars are
data-independent. So the grid is one program per sample, p is padded to a
power of two (masked), and batched members (restarts, bootstrap
replicates, masked sweep ranks) come from ``jax.vmap`` over the call,
which adds a grid axis.

The math is that of ``ops.fista.fista_alpha_gram`` and
``ops.frank_wolfe.frank_wolfe_gram``; the simplex projection uses the
sort-free form "theta from the largest value set whose shifted mean stays
below its smallest member", which gives the same threshold as the
reference's sorted cumsum scan (ties cannot straddle the threshold).
``interpret`` is always passed by the caller: the kernels run interpreted
only where a test asks for it.
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from demethify_tpu.ops.fista import (
    _nesterov_step,
    _run_steps,
    fista_alpha_gram,
)
from demethify_tpu.ops.frank_wolfe import frank_wolfe_gram

MAX_P = 32          # largest padded p kept in one program's registers
_MIN_P = 8
_MASK_NEG = -1e30
_BIG = 3.0e38


def padded_p(p: int) -> int:
    """Power-of-two row count a column occupies inside the kernels."""
    return max(_MIN_P, 1 << (p - 1).bit_length())


def use_kernel(platform: str, p: int, dtype) -> bool:
    """Whether the loops on (p, n_s) columns of ``dtype`` take the kernel
    on ``platform`` (a ``lax.platform_dependent`` platform name)."""
    return (platform == "cuda" and padded_p(p) <= MAX_P
            and jnp.dtype(dtype) == jnp.float32)


def _per_sample(*block):
    return pl.BlockSpec((None,) + block, lambda s: (s,) + (0,) * len(block))


def _whole(n):
    return pl.BlockSpec((n,), lambda s: (0,))


def _pad_rows(x, P):
    """(p, n_s) -> (n_s, P), zero rows appended."""
    return jnp.pad(x.T, ((0, 0), (0, P - x.shape[0])))


def _pad_grams(G, P):
    p = G.shape[1]
    return jnp.pad(G, ((0, 0), (0, P - p), (0, P - p)))


def _call(kernel, n_s, P, in_specs, out_count, dtype, interpret, args):
    out = jax.ShapeDtypeStruct((n_s, P), dtype)
    return pl.pallas_call(
        kernel,
        grid=(n_s,),
        in_specs=in_specs,
        out_specs=[_per_sample(P)] * out_count,
        out_shape=[out] * out_count,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
    )(*args)


def _gram_matvec(G, v):
    """(G v) for one column: G (P, P), v (P,)."""
    return jnp.sum(G * v[None, :], axis=1)


def _project_simplex(v, active):
    """Euclidean projection of one column onto {x >= 0, sum(x) = 1} over
    the ``active`` rows; inactive rows come out 0.

    For each i, C_i = #{j: v_j >= v_i} and S_i = sum of those v_j. Row i
    is in the support iff v_i > (S_i - 1) / C_i, and theta is that mean
    at the support row with the largest C_i."""
    v = jnp.where(active, v, _MASK_NEG)
    ge = v[None, :] >= v[:, None]                     # ge[i, j]: v_j >= v_i
    count = jnp.sum(ge.astype(v.dtype), axis=1)
    total = jnp.sum(jnp.where(ge, v[None, :], 0.0), axis=1)
    shift = (total - 1.0) / count
    support = active & (v - shift > 0)
    c_max = jnp.max(jnp.where(support, count, 0.0))
    theta = jnp.max(jnp.where(support & (count == c_max), shift, -_BIG))
    return jnp.maximum(v - theta, 0.0)


# ---------------------------------------------------------------------------
# alpha FISTA
# ---------------------------------------------------------------------------

def _fista_kernel(scal_ref, g_ref, b_ref, a_ref, ap_ref, mask_ref,
                  a_out_ref, ap_out_ref, *, n_steps):
    a0 = scal_ref[0]
    l_prev0 = scal_ref[1]
    l_h = scal_ref[2]
    G = g_ref[...]
    b = b_ref[...]
    active = mask_ref[...] > 0

    def body(_, carry):
        alpha, alpha_prev, a, l_prev = carry
        a2 = (1.0 + jnp.sqrt(1.0 + 4.0 * a * a)) / 2.0
        beta = jnp.minimum((a - 1.0) / a2, 0.9999 * jnp.sqrt(l_prev / l_h))
        a_t = alpha + beta * (alpha - alpha_prev)
        grad = b - _gram_matvec(G, a_t)
        return (_project_simplex(a_t + grad / l_h, active), alpha, a2, l_h)

    alpha, alpha_prev, _, _ = jax.lax.fori_loop(
        0, n_steps, body, (a_ref[...], ap_ref[...], a0, l_prev0))
    a_out_ref[...] = alpha
    ap_out_ref[...] = alpha_prev


def fista_alpha(alpha, alpha_prev, a, l_h_prev, l_h, G, b, n_steps: int,
                row_mask=None, *, interpret: bool):
    """The whole alpha FISTA loop in one launch; same arguments and
    results as ``fista_alpha_gram``."""
    p, n_s = alpha.shape
    P = padded_p(p)
    dtype = alpha.dtype
    # the three Nesterov scalars, padded to 4: Triton blocks are powers
    # of two
    scal = jnp.stack([jnp.asarray(x, dtype)
                      for x in (a, l_h_prev, l_h, 0.0)])
    mask = jnp.ones((p,), dtype) if row_mask is None else \
        row_mask.astype(dtype)
    mask = jnp.pad(mask, (0, P - p))
    a_new, ap_new = _call(
        functools.partial(_fista_kernel, n_steps=n_steps), n_s, P,
        [_whole(4), _per_sample(P, P), _per_sample(P), _per_sample(P),
         _per_sample(P), _whole(P)], 2, dtype, interpret,
        (scal, _pad_grams(G.astype(dtype), P), _pad_rows(b.astype(dtype), P),
         _pad_rows(alpha, P), _pad_rows(alpha_prev, P), mask))

    # the scalar Nesterov carry is data-independent: replay it here
    def scal_body(_, carry):
        return (_nesterov_step(carry[0]), l_h)

    a_out, l_prev_out = _run_steps(scal_body, (a, l_h_prev), n_steps)
    return a_new[:, :p].T, ap_new[:, :p].T, a_out, l_prev_out


# ---------------------------------------------------------------------------
# Frank-Wolfe
# ---------------------------------------------------------------------------

def _first_argmin(g, iota, P):
    return jnp.min(jnp.where(g == jnp.min(g), iota, P))


def _fw_kernel(g_ref, b_ref, a_ref, mass_ref, a_out_ref, *, n_steps, p1,
               p):
    G = g_ref[...]
    b = b_ref[...]
    mass = mass_ref[...]
    P = b.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, (P,), 0)
    known = iota < p1
    unknown = (iota >= p1) & (iota < p)

    def body(k, alpha):
        grad = _gram_matvec(G, alpha) - b
        i1 = _first_argmin(jnp.where(known, grad, _BIG), iota, P)
        i2 = _first_argmin(jnp.where(unknown, grad, _BIG), iota, P)
        vertex = jnp.where((iota == i1) | (iota == i2), mass, 0.0)
        gamma = 2.0 / (k.astype(alpha.dtype) + 2.0)
        return (1.0 - gamma) * alpha + gamma * vertex

    a_out_ref[...] = jax.lax.fori_loop(0, n_steps, body, a_ref[...])


def frank_wolfe(alpha1, alpha2, G, b, purity, max_iter: int, *,
                interpret: bool):
    """The whole Frank-Wolfe loop in one launch; same arguments and
    results as ``frank_wolfe_gram``."""
    p1 = alpha1.shape[0]
    alpha = jnp.concatenate([alpha1, alpha2], axis=0)
    p, n_s = alpha.shape
    P = padded_p(p)
    dtype = alpha.dtype
    purity = purity.astype(dtype)
    rows = jnp.arange(P)[None, :]
    mass = jnp.where(rows < p1, purity[:, None],
                     jnp.where(rows < p, 1.0 - purity[:, None], 0.0))
    (out,) = _call(
        functools.partial(_fw_kernel, n_steps=max_iter, p1=p1, p=p), n_s, P,
        [_per_sample(P, P), _per_sample(P), _per_sample(P), _per_sample(P)],
        1, dtype, interpret,
        (_pad_grams(G.astype(dtype), P), _pad_rows(b.astype(dtype), P),
         _pad_rows(alpha, P), mass))
    out = out[:, :p].T
    return out[:p1], out[p1:]


# ---------------------------------------------------------------------------
# the choice between the kernels and the jnp loops
# ---------------------------------------------------------------------------

def _on_platform(p, dtype, kernel_fn, jnp_fn, *args):
    def branch(platform):
        if use_kernel(platform, p, dtype):
            return functools.partial(kernel_fn, interpret=False)
        return jnp_fn
    return jax.lax.platform_dependent(*args, cuda=branch("cuda"),
                                      default=branch("default"))


def alpha_loop(alpha, alpha_prev, a, l_h_prev, l_h, G, b, n_steps: int,
               row_mask=None):
    """``fista_alpha_gram`` semantics; the kernel where ``use_kernel``
    says so for the platform the computation is lowered for."""
    def kern(*args, interpret):
        return fista_alpha(*args, n_steps, row_mask, interpret=interpret)

    def xla(*args):
        return fista_alpha_gram(*args, n_steps, row_mask=row_mask)

    return _on_platform(alpha.shape[0], alpha.dtype, kern, xla,
                        alpha, alpha_prev, a, l_h_prev, l_h, G, b)


def fw_loop(alpha1, alpha2, G, b, purity, max_iter: int):
    """``frank_wolfe_gram`` semantics, chosen like ``alpha_loop``."""
    def kern(*args, interpret):
        return frank_wolfe(*args, max_iter, interpret=interpret)

    def xla(*args):
        return frank_wolfe_gram(*args, max_iter)

    p = alpha1.shape[0] + alpha2.shape[0]
    return _on_platform(p, alpha1.dtype, kern, xla,
                        alpha1, alpha2, G, b, purity)
