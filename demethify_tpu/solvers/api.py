"""High-level deconvolution facade: init + solve + vmapped random restarts.

Maps the reference's four solver paths (`demethify/demethify.py:148-217`)
onto the jitted solvers. Random restarts run as ONE batched (vmapped) solve
on the device, instead of the reference's serial Python loop
(`demethify.py:167-203`); the restart with the lowest weighted cost wins
(first minimum, matching the reference's strict `<` update).

Note a deliberate divergence: the reference re-seeds the global RNG with the
same seed on every restart, making all restarts identical
(`demethify.py:196` + `deconvolution.py:9-11`); here each restart gets a
distinct fold of the PRNG key, which is what makes restarts meaningful.
"""

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp

from demethify_tpu.ops import fista
from demethify_tpu.ops.cost import weighted_cost
from demethify_tpu.ops.nnls import wls_intercept_batch
from demethify_tpu.solvers.init import (
    init_partial,
    init_purity,
    init_unsupervised,
)
from demethify_tpu.solvers.partial_ref import partial_ref_solve
from demethify_tpu.solvers.purity import purity_solve
from demethify_tpu.solvers.unsupervised import unsupervised_solve

_DETERMINISTIC_INITS = ("SVD", "ICA")


def _is_deterministic(init, n_u, n_samples, init_provided):
    # SVD/ICA inits are deterministic EXCEPT when n_u > n_samples
    # forces the silent fallback to random uniform_ (solvers/init.py)
    # -- restarts are meaningful again in that case
    if init_provided is not None:
        return True
    return init in _DETERMINISTIC_INITS and n_u <= n_samples


@dataclass
class DeconvolutionResult:
    """u: (n_cpg, n_u) unknown profiles (None for supervised);
    proportions: (p, n_s); cost: final weighted cost; n_iter: outer
    iterations of the winning restart; trace: optional cost history."""

    u: Optional[jnp.ndarray]
    proportions: jnp.ndarray
    cost: float
    n_iter: int
    trace: Optional[jnp.ndarray] = None
    extras: Optional[dict] = None


def _select_best(u_b, alpha_b, info_b):
    # NaN-proof: a diverged restart (NaN cost) must never win (matches
    # the reference's strict `<` update, demethify.py:171)
    costs = info_b["cost"]
    costs = jnp.where(jnp.isnan(costs), jnp.inf, costs)
    best = jnp.argmin(costs)
    return (u_b[best], alpha_b[best],
            {"cost": costs[best], "n_iter": info_b["n_iter"][best],
             "trace": info_b["trace"][best]})


def _restarts(key, n_restarts, init_fn, solve_fn, deterministic_init):
    """Run init+solve for n_restarts keys as one batched computation: a
    vmap of ``solve_fn``, which follows its inputs' sharding (row-sharded
    data keeps the Gram reductions as cross-device sums)."""
    if deterministic_init or n_restarts == 1:
        u0, a0 = init_fn(key)
        return solve_fn(u0, a0)
    keys = jax.random.split(key, n_restarts)
    u0_b, a0_b = jax.vmap(init_fn)(keys)
    u_b, alpha_b, info_b = jax.vmap(solve_fn)(u0_b, a0_b)
    return _select_best(u_b, alpha_b, info_b)


def supervised_deconv(y, d, R) -> DeconvolutionResult:
    """Reference-based mode: per-sample weighted NNLS with intercept on
    methylated counts (reference `demethify.py:209-213`: target = d*y,
    weights = d), batched over samples."""
    proportions = wls_intercept_batch(d * y, d, R)
    cost = weighted_cost(y, R, proportions, d)
    return DeconvolutionResult(u=None, proportions=proportions,
                               cost=float(cost), n_iter=0)


def partial_reference_deconv(y, d, R_trunc, n_u: int, *,
                             init: str = "uniform_",
                             key=None, seed: int = 1,
                             n_restarts: int = 1,
                             n_iter1: int = 10000, n_iter2: int = 20,
                             tol: float = 1e-2,
                             tol_relative: bool = False,
                             record_trace: bool = False,
                             init_provided=None) -> DeconvolutionResult:
    """Partial-reference mode (`--ref --nbunknown k`)."""
    if key is None:
        key = jax.random.PRNGKey(seed)

    def init_fn(k):
        if init_provided is not None:
            return init_provided
        return init_partial(k, init, y, d, R_trunc, n_u)

    gram_u = fista.use_gram_u(n_u, y.shape[1], n_iter2)

    def solve_fn(u0, a0):
        return partial_ref_solve(u0, a0, y, d, R_trunc, n_u,
                                 n_iter1=n_iter1, n_iter2=n_iter2, tol=tol,
                                 use_gram_u=gram_u,
                                 tol_relative=tol_relative,
                                 record_trace=record_trace)

    det = _is_deterministic(init, n_u, y.shape[1], init_provided)
    u, alpha, info = _restarts(key, n_restarts, init_fn, solve_fn, det)
    return DeconvolutionResult(u=u, proportions=alpha,
                               cost=float(info["cost"]),
                               n_iter=int(info["n_iter"]),
                               trace=info.get("trace"))


def purity_deconv(y, d, R_trunc, n_u: int, purity, *,
                  init: str = "uniform_",
                  key=None, seed: int = 1,
                  n_restarts: int = 1,
                  n_iter1: int = 100, n_iter2: int = 500,
                  tol: float = 1e-2,
                  tol_relative: bool = False,
                  record_trace: bool = False,
                  init_provided=None) -> DeconvolutionResult:
    """Purity-constrained mode (`--ref --nbunknown k --purity ...`);
    purity is the already-flipped (1 - p/100) per-sample vector."""
    if key is None:
        key = jax.random.PRNGKey(seed)
    purity = jnp.asarray(purity, y.dtype)

    def init_fn(k):
        if init_provided is not None:
            return init_provided
        return init_purity(k, init, y, d, R_trunc, n_u, purity)

    def solve_fn(u0, a0):
        return purity_solve(u0, a0, y, d, R_trunc, purity, n_u,
                            n_iter1=n_iter1, n_iter2=n_iter2, tol=tol,
                            tol_relative=tol_relative,
                            record_trace=record_trace)

    det = _is_deterministic(init, n_u, y.shape[1], init_provided)
    u, alpha, info = _restarts(key, n_restarts, init_fn, solve_fn, det)
    return DeconvolutionResult(u=u, proportions=alpha,
                               cost=float(info["cost"]),
                               n_iter=int(info["n_iter"]),
                               trace=info.get("trace"))


def unsupervised_deconv(y, d, n_u: int, *,
                        init: str = "uniform_",
                        key=None, seed: int = 1,
                        n_restarts: int = 1,
                        n_iter1: int = 10000, n_iter2: int = 20,
                        tol: float = 1e-2,
                        tol_relative: bool = False,
                        record_trace: bool = False,
                        init_provided=None) -> DeconvolutionResult:
    """Unsupervised mode (no `--ref`)."""
    if key is None:
        key = jax.random.PRNGKey(seed)

    def init_fn(k):
        if init_provided is not None:
            return init_provided
        return init_unsupervised(k, init, y, d, n_u)

    gram_u = fista.use_gram_u(n_u, y.shape[1], n_iter2)

    def solve_fn(u0, a0):
        return unsupervised_solve(u0, a0, y, d, n_u,
                                  n_iter1=n_iter1, n_iter2=n_iter2, tol=tol,
                                  use_gram_u=gram_u,
                                  tol_relative=tol_relative,
                                  record_trace=record_trace)

    det = _is_deterministic(init, n_u, y.shape[1], init_provided)
    u, alpha, info = _restarts(key, n_restarts, init_fn, solve_fn, det)
    return DeconvolutionResult(u=u, proportions=alpha,
                               cost=float(info["cost"]),
                               n_iter=int(info["n_iter"]),
                               trace=info.get("trace"))


def deconvolve(y, d, R=None, n_u: int = 0, purity=None,
               **kwargs) -> DeconvolutionResult:
    """Dispatch to one of the four modes, mirroring the reference CLI
    dispatch (`demethify/demethify.py:151-217`)."""
    if R is None:
        return unsupervised_deconv(y, d, n_u, **kwargs)
    if n_u == 0:
        return supervised_deconv(y, d, R)
    if purity is not None:
        return purity_deconv(y, d, R, n_u, purity, **kwargs)
    return partial_reference_deconv(y, d, R, n_u, **kwargs)
