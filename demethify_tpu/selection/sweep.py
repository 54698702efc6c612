"""Model-selection sweep: pick the number of unknown cell types.

Reference: `evaluate_best_ic` (`demethify/ic.py:169-218`) — sweeps
n_u = 1..25, computes the chosen criterion (AIC / BIC / CCC / BCV / minka),
keeps the argmin. Differences from the reference, by design:

- the minka path here actually works (the reference's follow-up call at
  `ic.py:189` is a TypeError as shipped);
- CCC restarts run as ONE vmapped batched solve per n_u instead of a serial
  restart loop;
- the sweep range is configurable (`n_u_max`, default 25 like the
  reference's hardcoded `range(1, 26)` at `ic.py:171`).

Each n_u is a different factor shape, hence its own XLA compilation; the
compile cache makes repeated sweeps cheap.
"""

import jax
import jax.numpy as jnp
import numpy as np

from demethify_tpu.ops.cost import weighted_cost
from demethify_tpu.selection.bcv import bicross_validation
from demethify_tpu.selection.ccc import compute_ccc
from demethify_tpu.selection.criteria import compute_aic, compute_bic
from demethify_tpu.selection.minka import select_rank_minka

IC_CHOICES = ("AIC", "BIC", "CCC", "BCV", "minka")


def _run_deconv(y, d, ref, n_u, init_option, key, iter1, iter2, tol):
    """Reference `run_deconvolution` facade (`ic.py:47-55`):
    returns (u, R, alpha)."""
    from demethify_tpu.solvers.api import (
        partial_reference_deconv,
        unsupervised_deconv,
    )

    if ref is not None:
        res = partial_reference_deconv(y, d, ref, n_u, init=init_option,
                                       key=key, n_iter1=iter1,
                                       n_iter2=iter2, tol=tol)
        R = jnp.concatenate([ref, res.u], axis=1)
    else:
        res = unsupervised_deconv(y, d, n_u, init=init_option, key=key,
                                  n_iter1=iter1, n_iter2=iter2, tol=tol)
        R = res.u
    return res.u, R, res.proportions


def _ccc_restart_alphas(y, d, ref, n_u, init_option, key, n_restarts,
                        iter1, iter2, tol):
    """All restart alphas for the consensus, as one vmapped solve."""
    from demethify_tpu.solvers.init import init_partial, init_unsupervised
    from demethify_tpu.solvers.partial_ref import partial_ref_solve
    from demethify_tpu.solvers.unsupervised import unsupervised_solve

    keys = jax.random.split(key, n_restarts)
    if ref is not None:
        u0, a0 = jax.vmap(
            lambda k: init_partial(k, init_option, y, d, ref, n_u))(keys)
        us, alphas, _ = jax.vmap(
            lambda u, a: partial_ref_solve(u, a, y, d, ref, n_u,
                                           n_iter1=iter1, n_iter2=iter2,
                                           tol=tol))(u0, a0)
    else:
        u0, a0 = jax.vmap(
            lambda k: init_unsupervised(k, init_option, y, d, n_u))(keys)
        us, alphas, _ = jax.vmap(
            lambda u, a: unsupervised_solve(u, a, y, d, n_u,
                                            n_iter1=iter1, n_iter2=iter2,
                                            tol=tol))(u0, a0)
    alpha_list = [np.asarray(alphas[i]) for i in range(n_restarts)]
    # the reference keeps the LAST restart's factors for this n_u (ic.py:196)
    return alpha_list, us[-1], alphas[-1]


def _rank_criterion(y, d, ref, n_u, init_option, ic, key, iter1, iter2,
                    tol, n_restarts):
    """Criterion value + the rank's factors for one sweep member.
    Deterministic given (key, n_u): the sweep can be partitioned across
    processes and any member recomputed bit-identically anywhere."""
    n_cpg, n_samples = y.shape
    n_ct = 0 if ref is None else ref.shape[1]
    k_nu = jax.random.fold_in(key, n_u)
    if ic == "CCC":
        alpha_runs, u, alpha = _ccc_restart_alphas(
            y, d, ref, n_u, init_option, k_nu, n_restarts,
            iter1, iter2, tol)
        ic_result = -compute_ccc(alpha_runs)
    elif ic == "BCV":
        ic_result, u, alpha = bicross_validation(
            y, d, n_u, ref=ref, init_option=init_option,
            iter1=iter1, iter2=iter2, tol=tol,
            n_folds=n_restarts, fraction=0.3, key=k_nu)
    else:
        u, R, alpha = _run_deconv(y, d, ref, n_u, init_option, k_nu,
                                  iter1, iter2, tol)
        cost = float(weighted_cost(y, R, alpha, d))
        fn = compute_bic if ic == "BIC" else compute_aic
        ic_result = fn(cost, n_u, n_cpg, n_ct, n_samples)
    return float(ic_result), u, alpha


def _evaluate_best_ic_multihost(y, d, ref, init_option, ic, key,
                                iter1, iter2, tol, n_restarts, n_u_max,
                                process_count, process_index):
    """Rank-partitioned sweep across processes: process p computes the
    criterion for ranks {p+1, p+1+nproc, ...} (strided — higher ranks
    cost more, striding balances), the tiny criterion vectors are
    allgathered, and EVERY process recomputes the winning rank's solve
    locally (deterministic keys make this bit-identical to a broadcast,
    without moving the (n_cpg, n_u) factors between hosts). y/d/ref must be
    process-local full arrays.

    AIC/BIC ranks solve through the masked compile-once machinery
    (batched_sweep.solve_sweep_members) with GLOBAL member keys, so the
    multihost sweep is bit-identical to the single-process batched
    sweep for every init option. CCC/BCV keep the serial per-rank
    criterion (their restart/fold keying is process-partition-stable
    but differs from the single-process batched draws — documented
    divergence, both are valid random restarts)."""
    import numpy as np
    from jax.experimental import multihost_utils

    from demethify_tpu.selection import batched_sweep as bs

    n_cpg, n_samples = y.shape
    n_ct = 0 if ref is None else ref.shape[1]
    batched = (ic in ("AIC", "BIC")
               and init_option in bs.RANDOM_INITS + ("SVD", "ICA"))

    def member_criterion(ranks):
        """(criteria, u_b, alpha_b) for the given ranks via the masked
        batch (padded layout)."""
        u_b, alpha_b, costs, _ = bs.solve_sweep_members(
            y, d, ref, ranks, n_u_max=n_u_max, key=key, iter1=iter1,
            iter2=iter2, tol=tol, init_option=init_option)
        fn = compute_bic if ic == "BIC" else compute_aic
        costs = np.asarray(costs, dtype=np.float64)
        vals = [float(fn(costs[j], r, n_cpg, n_ct, n_samples))
                for j, r in enumerate(ranks)]
        return vals, u_b, alpha_b

    crit = np.full(n_u_max, np.inf)
    owned = list(range(1 + process_index, n_u_max + 1, process_count))
    if batched:
        if owned:
            vals, _, _ = member_criterion(owned)
            for j, r in enumerate(owned):
                crit[r - 1] = vals[j]
    else:
        for n_u in owned:
            crit[n_u - 1], _, _ = _rank_criterion(
                y, d, ref, n_u, init_option, ic, key, iter1, iter2, tol,
                n_restarts)
    all_crit = np.asarray(multihost_utils.process_allgather(
        crit, tiled=False))              # (nproc, n_u_max)
    merged = all_crit.min(axis=0)        # each rank owned by one process
    best_n_u = int(np.argmin(np.where(np.isfinite(merged), merged,
                                      np.inf))) + 1
    if batched:
        _, u_b, alpha_b = member_criterion([best_n_u])
        best_u = np.asarray(u_b[0])[:, :best_n_u]
        alpha_full = np.asarray(alpha_b[0])
        best_alpha = np.concatenate(
            [alpha_full[:n_ct], alpha_full[n_ct:n_ct + best_n_u]],
            axis=0)
    else:
        _, best_u, best_alpha = _rank_criterion(
            y, d, ref, best_n_u, init_option, ic, key, iter1, iter2,
            tol, n_restarts)
    return best_u, best_alpha, best_n_u, [float(v) for v in merged]


def evaluate_best_ic(y, d, ref, init_option: str, ic: str, *,
                     key=None, seed: int = 1,
                     iter1: int, iter2: int, tol: float,
                     tol_relative: bool = False,
                     n_restarts: int = 5, n_u_max: int = 25,
                     progress: bool = False,
                     process_count: int = 1, process_index: int = 0):
    """Returns (best_u, best_alpha, best_n_u, list_ic)."""
    if ic not in IC_CHOICES:
        raise ValueError(f"--ic must be one of {IC_CHOICES}, got {ic!r}")
    if key is None:
        key = jax.random.PRNGKey(seed)

    y = jnp.asarray(y)
    d = jnp.asarray(d)
    ref = None if ref is None else jnp.asarray(ref)

    if process_count > 1 and ic != "minka":
        return _evaluate_best_ic_multihost(
            y, d, ref, init_option, ic, key, iter1, iter2, tol,
            n_restarts, n_u_max, process_count, process_index)

    random_inits = ("uniform_", "beta", "uniform")
    batched_inits = random_inits + ("SVD", "ICA")
    if ((init_option in random_inits and ic == "CCC")
            or (init_option in batched_inits and ic in ("AIC", "BIC",
                                                        "BCV"))):
        # compile-once padded sweeps: every rank (x restart/fold) solved
        # under ONE solver compilation (selection/batched_sweep.py) — vs
        # n_u_max separate shape-specialized compiles. SVD/ICA inits are
        # deterministic, so their AIC/BIC sweep members equal the
        # per-rank solves exactly; their BCV members init per fold on the
        # masked data (serial-path semantics). CCC with deterministic
        # inits is degenerate — identical restarts — and keeps the
        # serial path.
        from demethify_tpu.selection import batched_sweep as bs

        if ic in ("AIC", "BIC"):
            return bs.evaluate_ic_batched(y, d, ref, ic, key=key,
                                          iter1=iter1, iter2=iter2,
                                          tol=tol, n_u_max=n_u_max,
                                          tol_relative=tol_relative,
                                          init_option=init_option)
        if ic == "CCC":
            return bs.batched_ccc_sweep(y, d, ref, n_u_max=n_u_max,
                                        n_restarts=n_restarts, key=key,
                                        iter1=iter1, iter2=iter2, tol=tol,
                                        tol_relative=tol_relative,
                                        init_option=init_option)
        return bs.batched_bcv_sweep(y, d, ref, n_u_max=n_u_max,
                                    n_folds=n_restarts, key=key,
                                    iter1=iter1, iter2=iter2, tol=tol,
                                    tol_relative=tol_relative,
                                    progress=progress,
                                    init_option=init_option)

    if ic == "minka":
        # pass the (possibly sharded) arrays through: minka keeps the
        # residual on device for large/distributed inputs
        best_n_u, minka_result = select_rank_minka(y, d, ref)
        u, _, alpha = _run_deconv(y, d, ref, best_n_u, init_option,
                                  key, iter1, iter2, tol)
        neg_ll = [-v for v in minka_result["log_liks"].values()]
        return u, alpha, best_n_u, neg_ll

    n_u_values = range(1, n_u_max + 1)
    best_ic = float("inf")
    best_n_u = None
    best_u = None
    best_alpha = None
    list_result = []

    iterator = n_u_values
    if progress:
        from demethify_tpu.utils import optional_import

        tqdm = optional_import("tqdm", "the progress bar")
        iterator = tqdm.tqdm(n_u_values)

    for n_u in iterator:
        ic_result, u, alpha = _rank_criterion(
            y, d, ref, n_u, init_option, ic, key, iter1, iter2, tol,
            n_restarts)
        list_result.append(float(ic_result))
        if ic_result < best_ic:
            best_ic = ic_result
            best_n_u = n_u
            best_u = u
            best_alpha = alpha

    return best_u, best_alpha, best_n_u, list_result
