"""Compile-once model-selection sweep: all candidate ranks in ONE batch.

The reference sweeps n_u = 1..25 serially (`demethify/ic.py:192-207`), and
a naive port re-jits the solver for every rank (every n_u is a new factor
shape). On a TPU runtime where each fresh compilation goes through a remote
compile service, 25 compiles dominate wall-clock by orders of magnitude.

This module pads every candidate to a common shape and solves ALL ranks as
one vmapped computation:

- member i solves with n_u = i+1 unknowns, padded to n_u_max;
- inactive u columns and alpha rows start at zero: the Gram-form gradients
  then keep them at exactly zero (C/M/b/G contributions vanish), and the
  simplex projection is restricted to active rows by pushing inactive
  entries to -1e30 before the sort (`project_columns_to_simplex_masked`),
  which reproduces the lower-dimensional projection EXACTLY;
- per-member Lipschitz constants, costs, and the cost-delta termination
  come out identical to standalone solves (verified to machine precision
  in tests/test_batched_sweep.py);
- the vmapped while_loop freezes converged members until all are done.

One compilation, one device dispatch, n_u_max-way batch parallelism.
"""

import jax
import jax.numpy as jnp
import numpy as np

from demethify_tpu.selection.criteria import compute_aic, compute_bic


def _member_masks(n_ct: int, n_u_max: int):
    """(n_u_max, n_ct + n_u_max) alpha row masks; member i activates
    n_u = i+1 unknown rows."""
    n_active = jnp.arange(1, n_u_max + 1)
    unknown = jnp.arange(n_u_max)[None, :] < n_active[:, None]
    known = jnp.ones((n_u_max, n_ct), bool)
    return jnp.concatenate([known, unknown], axis=1)


def _masked_uniform_init(key, n_cpg, n_ct, n_u_max, n_s, dtype, row_mask):
    """uniform_ init on the active support: u ~ U(0,1) on active columns,
    alpha ~ Dirichlet(ones(active)) per sample via gamma normalization."""
    k1, k2 = jax.random.split(key)
    u_mask = row_mask[n_ct:]
    u0 = jax.random.uniform(k1, (n_cpg, n_u_max), dtype) * u_mask[None, :]
    g = jax.random.gamma(k2, 1.0, (n_ct + n_u_max, n_s)).astype(dtype)
    g = g * row_mask[:, None]
    alpha0 = g / jnp.sum(g, axis=0, keepdims=True)
    return u0, alpha0


def _masked_random_init(key, init_option: str, y, d, ref, n_ct: int,
                        n_u_max: int, row_mask):
    """``beta`` / ``uniform`` (WLS-alpha) inits on the active support,
    vmappable over sweep members (one compile for all ranks).

    Matches `solvers.init.init_partial` / `init_unsupervised` semantics
    per member: Beta(.5,.5) u draws (`deconvolution.py:48-49`), or the
    WLS alpha (`deconvolution.py:50-52`) computed on the MASKED design
    [ref | u0] — inactive u columns are exactly zero, so their NNLS
    coefficients stay exactly zero (zero column -> zero gradient from
    the zero start, zero polish) and the masked WLS equals the
    truncated-design WLS. Ranks above n_samples take the reference's
    silent uniform_ fallback (`deconvolution.py:44-45`), selected per
    member under vmap.
    """
    n_cpg, n_s = y.shape
    dtype = y.dtype
    k1, k2 = jax.random.split(key)
    u_mask = row_mask[n_ct:]
    fallback = jnp.sum(u_mask) > n_s

    u_uni = jax.random.uniform(k1, (n_cpg, n_u_max), dtype)
    if init_option == "beta":
        u_opt = jax.random.beta(k1, 0.5, 0.5,
                                (n_cpg, n_u_max)).astype(dtype)
    else:
        u_opt = u_uni
    u0 = jnp.where(fallback, u_uni, u_opt) * u_mask[None, :]

    g = jax.random.gamma(k2, 1.0, (n_ct + n_u_max, n_s)).astype(dtype)
    g = g * row_mask[:, None]
    alpha_dir = g / jnp.sum(g, axis=0, keepdims=True)

    if init_option == "uniform" and ref is not None:
        from demethify_tpu.ops.nnls import wls_intercept_batch

        X = jnp.concatenate([ref.astype(dtype), u0], axis=1)
        alpha_wls = wls_intercept_batch(y, d, X)
        alpha0 = jnp.where(fallback, alpha_dir, alpha_wls)
    else:
        # unsupervised 'uniform' is uniform_ (reference NameError
        # fallback, see solvers/init.py); beta keeps the Dirichlet alpha
        alpha0 = alpha_dir
    if ref is not None:
        alpha0 = _masked_zero_guard(alpha0, n_ct)
    return u0, alpha0


RANDOM_INITS = ("uniform_", "beta", "uniform")


def _masked_init_batch(keys, init_option, y, d, ref, n_ct, n_u_max,
                       masks):
    """Vmapped masked init for the random options (one draw batch)."""
    n_cpg, n_s = y.shape
    dtype = y.dtype
    if init_option == "uniform_":
        def init_one(k, row_mask):
            return _masked_uniform_init(k, n_cpg, n_ct, n_u_max, n_s,
                                        dtype, row_mask)
    else:
        def init_one(k, row_mask):
            return _masked_random_init(k, init_option, y, d, ref, n_ct,
                                       n_u_max, row_mask)
    return jax.vmap(init_one)(keys, masks)


def _masked_zero_guard(alpha, n_ct: int):
    """Padded-layout form of ``solvers.init._zero_guard``
    (`deconvolution.py:74-76`): the FIRST unknown row sits at index
    ``n_ct``; inactive (zero) rows beyond the member's rank are
    untouched, so the guard acts exactly as it would on the unpadded
    (n_ct + k, n_s) alpha."""
    first_unknown = alpha[n_ct]
    trigger = jnp.any(first_unknown == 0.0)
    fixed = jnp.where(trigger, jnp.full_like(first_unknown, 1e-10),
                      first_unknown)
    alpha = alpha.at[n_ct].set(fixed)
    known = alpha[:n_ct] * jnp.where(trigger, 1.0 - 1e-10, 1.0)
    return jnp.concatenate([known, alpha[n_ct:]], axis=0)


def _padded_init_batch(y, d, ref, init_option: str, n_u_max: int, key,
                       masks):
    """Per-rank inits padded into the masked batch layout.

    The random options (uniform_, beta, uniform — see
    `_masked_random_init` for the WLS-alpha story) draw every member
    masked in one vmapped computation. The deterministic options
    reproduce `solvers.init.init_partial` / `init_unsupervised` per rank
    VALUE-EXACTLY:

    - SVD: ONE rank-n_u_max NNDSVD serves every member — NNDSVD
      component j depends only on singular triplet j
      (`ops/nndsvd.py`), so the rank-k init is an exact column
      truncation; the per-member masked simplex projection and masked
      zero-guard equal the k-dimensional ops exactly. Total fresh HLOs:
      one NNDSVD + one projection shape.
    - ICA: the Givens rotation search couples components, so its init
      runs per rank (small per-rank HLOs; the expensive solve still
      compiles once), keyed like the serial sweep (fold_in(key, rank)).

    Ranks above n_samples take the reference's silent uniform_ fallback
    (`deconvolution.py:44-45`) with the serial sweep's per-rank keys.
    """
    from demethify_tpu.ops.nndsvd import (
        constrained_nndsvd,
        nndsvd_initialize,
    )
    from demethify_tpu.ops.simplex import (
        project_columns_to_simplex_masked,
    )
    from demethify_tpu.solvers.init import init_partial, init_unsupervised

    n_cpg, n_s = y.shape
    dtype = y.dtype
    n_ct = 0 if ref is None else ref.shape[1]
    p_max = n_ct + n_u_max

    if init_option in RANDOM_INITS:
        keys = jax.random.split(key, masks.shape[0])
        return _masked_init_batch(keys, init_option, y, d, ref, n_ct,
                                  n_u_max, masks)

    svd_parts = None
    if init_option == "SVD" and n_u_max >= 1:
        # ranks above n_samples fall back to uniform_ below, so the
        # shared NNDSVD only needs the deterministic ranks' components
        svd_rank = min(n_u_max, n_s)
        if ref is not None:
            W, H = constrained_nndsvd(y, ref, d, rank=svd_rank, flag=0)
            u_det, a_det = W[:, n_ct:], H
        else:
            W2, H2 = nndsvd_initialize(y, rank=svd_rank)
            u_det, a_det = jnp.clip(W2, 0.0, 1.0), H2
        # pad the component axes up to the batch width (padded columns /
        # rows are masked off for every member that could use them)
        u_det = jnp.pad(u_det, ((0, 0), (0, n_u_max - svd_rank)))
        a_det = jnp.pad(a_det, ((0, n_u_max - svd_rank), (0, 0)))
        svd_parts = (u_det, a_det)

    u0_rows, a0_rows = [], []
    for i in range(masks.shape[0]):
        rank = int(jnp.sum(masks[i])) - n_ct
        k_rank = jax.random.fold_in(key, rank)
        if rank > n_s:
            # reference fallback: deterministic inits silently become
            # uniform_ when the rank exceeds the sample count
            u0, a0 = _masked_uniform_init(k_rank, n_cpg, n_ct, n_u_max,
                                          n_s, dtype, masks[i])
        elif init_option == "SVD":
            u_full, a_full = svd_parts
            u0 = u_full * masks[i][n_ct:][None, :]
            a0 = project_columns_to_simplex_masked(a_full, masks[i])
            if ref is not None:
                a0 = _masked_zero_guard(a0, n_ct)
        else:                                      # ICA
            if ref is not None:
                u_k, a_k = init_partial(k_rank, init_option, y, d, ref,
                                        rank)
            else:
                u_k, a_k = init_unsupervised(k_rank, init_option, y, d,
                                             rank)
            u0 = jnp.zeros((n_cpg, n_u_max), dtype).at[:, :rank].set(u_k)
            a0 = jnp.zeros((p_max, n_s), dtype)
            a0 = a0.at[:n_ct].set(a_k[:n_ct])
            a0 = a0.at[n_ct:n_ct + rank].set(a_k[n_ct:])
        u0_rows.append(u0)
        a0_rows.append(a0)
    return jnp.stack(u0_rows), jnp.stack(a0_rows)


# Device-memory budget for the padded sweep's member batch: each member
# carries ~(6 n_u_max + 3 n_s + min(n_u_max^2, 3 n_s)) values per CpG row
# through the vmapped solver (u/u_prev/momentum + the Gram-or-direct
# dataflow temporaries, ops/fista.py). Batches whose footprint exceeds
# the budget solve in fixed-size member chunks under ONE compilation —
# a large --icmax chunks instead of OOMing.
_SWEEP_MEMBER_BUDGET = 4 * 2 ** 30


def _sweep_member_chunk(n_cpg: int, n_s: int, n_u_max: int,
                        itemsize: int) -> int:
    per_member = n_cpg * itemsize * (
        6 * n_u_max + 3 * n_s + min(n_u_max * n_u_max, 3 * n_s))
    return int(max(1, _SWEEP_MEMBER_BUDGET // max(per_member, 1)))


def batched_rank_sweep(y, d, ref, *, n_u_max: int, key,
                       iter1: int, iter2: int, tol: float,
                       tol_relative: bool = False,
                       init_option: str = "uniform_",
                       member_chunk: int = 0):
    """Solve partial-reference (ref given) or unsupervised (ref None)
    deconvolution for every n_u in 1..n_u_max as one vmapped computation.

    Returns (u_b, alpha_b, costs, n_iters): u_b (n_u_max, n_cpg, n_u_max)
    padded factors, alpha_b (n_u_max, p_max, n_s), per-member final costs
    and iteration counts. Member i's valid slice is u_b[i][:, :i+1] /
    the active alpha rows.

    ``member_chunk`` (0 = auto from _SWEEP_MEMBER_BUDGET): ranks solved
    per device dispatch. Chunking is value-invariant — per-chunk inits
    reuse the same per-member keys / deterministic components, the last
    chunk pads by repeating its first member, and all chunks share one
    jitted program.
    """
    from demethify_tpu.solvers.partial_ref import partial_ref_solve
    from demethify_tpu.solvers.unsupervised import unsupervised_solve

    y = jnp.asarray(y)
    d = jnp.asarray(d)
    n_cpg, n_s = y.shape
    n_ct = 0 if ref is None else ref.shape[1]
    if ref is not None:
        ref = jnp.asarray(ref)
    masks = _member_masks(n_ct, n_u_max)

    if ref is not None:
        def solve_one(u0, a0, row_mask):
            return partial_ref_solve(
                u0, a0, y, d, ref, n_u_max, n_iter1=iter1, n_iter2=iter2,
                tol=tol, tol_relative=tol_relative, row_mask=row_mask)
    else:
        def solve_one(u0, a0, row_mask):
            return unsupervised_solve(
                u0, a0, y, d, n_u_max, n_iter1=iter1, n_iter2=iter2,
                tol=tol, tol_relative=tol_relative, row_mask=row_mask)

    chunk = member_chunk or _sweep_member_chunk(
        n_cpg, n_s, n_u_max, jnp.dtype(y.dtype).itemsize)
    if chunk >= n_u_max:
        u0_b, a0_b = _padded_init_batch(y, d, ref, init_option, n_u_max,
                                        key, masks)
        u_b, alpha_b, info = jax.vmap(solve_one)(u0_b, a0_b, masks)
        return u_b, alpha_b, info["cost"], info["n_iter"]

    # chunked: inits are ALSO per-chunk (the full (K, n_cpg, n_u_max)
    # init batch alone can exceed the budget at large --icmax)
    keys = (jax.random.split(key, n_u_max)
            if init_option in RANDOM_INITS else None)
    fn = jax.jit(jax.vmap(solve_one))
    outs = []
    for s in range(0, n_u_max, chunk):
        e = min(s + chunk, n_u_max)
        cm = masks[s:e]
        if init_option in RANDOM_INITS:
            cu0, ca0 = _masked_init_batch(keys[s:e], init_option, y, d,
                                          ref, n_ct, n_u_max, cm)
        else:
            cu0, ca0 = _padded_init_batch(y, d, ref, init_option,
                                          n_u_max, key, cm)
        pad = chunk - (e - s)
        if pad:
            cu0, ca0, cm = (
                jnp.concatenate([x, jnp.repeat(x[:1], pad, axis=0)],
                                axis=0) for x in (cu0, ca0, cm))
        u_c, a_c, info_c = fn(cu0, ca0, cm)
        outs.append(jax.tree.map(lambda x: x[:e - s],
                                 (u_c, a_c, info_c)))
    u_b, alpha_b, info = jax.tree.map(
        lambda *xs: jnp.concatenate(xs, axis=0), *outs)
    return u_b, alpha_b, info["cost"], info["n_iter"]


def solve_sweep_members(y, d, ref, ranks, *, n_u_max: int, key,
                        iter1: int, iter2: int, tol: float,
                        tol_relative: bool = False,
                        init_option: str = "uniform_"):
    """Masked solves for an arbitrary subset of sweep members, selected
    by GLOBAL rank (1-based). Member inits use the member's global
    identity — split(key, n_u_max)[rank-1] for the random options,
    fold_in(key, rank) for the deterministic components — so ANY
    partition of 1..n_u_max across processes reproduces the full
    batched sweep's members exactly. This keeps the multihost
    rank-partitioned AIC/BIC sweep (selection/sweep.py) bit-identical
    to the single-process compile-once sweep.

    Returns (u_b, alpha_b, costs, n_iters) for the given ranks, in the
    padded batch layout (member i's valid slice is u_b[i][:, :ranks[i]]).
    """
    from demethify_tpu.solvers.partial_ref import partial_ref_solve
    from demethify_tpu.solvers.unsupervised import unsupervised_solve

    y = jnp.asarray(y)
    d = jnp.asarray(d)
    n_ct = 0 if ref is None else ref.shape[1]
    if ref is not None:
        ref = jnp.asarray(ref)
    masks = _member_masks(n_ct, n_u_max)
    idx = np.asarray([r - 1 for r in ranks])
    masks_sel = masks[idx]
    if init_option in RANDOM_INITS:
        keys = jax.random.split(key, n_u_max)[idx]
        u0_b, a0_b = _masked_init_batch(keys, init_option, y, d, ref,
                                        n_ct, n_u_max, masks_sel)
    else:
        u0_b, a0_b = _padded_init_batch(y, d, ref, init_option, n_u_max,
                                        key, masks_sel)

    if ref is not None:
        def solve_one(u0, a0, row_mask):
            return partial_ref_solve(
                u0, a0, y, d, ref, n_u_max, n_iter1=iter1, n_iter2=iter2,
                tol=tol, tol_relative=tol_relative, row_mask=row_mask)
    else:
        def solve_one(u0, a0, row_mask):
            return unsupervised_solve(
                u0, a0, y, d, n_u_max, n_iter1=iter1, n_iter2=iter2,
                tol=tol, tol_relative=tol_relative, row_mask=row_mask)

    u_b, alpha_b, info = jax.vmap(solve_one)(u0_b, a0_b, masks_sel)
    return u_b, alpha_b, info["cost"], info["n_iter"]


def batched_ccc_sweep(y, d, ref, *, n_u_max: int, n_restarts: int, key,
                      iter1: int, iter2: int, tol: float,
                      tol_relative: bool = False,
                      init_option: str = "uniform_"):
    """CCC sweep: ALL (rank, restart) members as one vmapped solve.

    Cluster assignments (argmax over alpha rows, `ic.py:30`) are untouched
    by the zero padding — inactive rows are exactly 0 and every column has
    a positive active entry — so the consensus matrices match per-rank
    solves. Returns (best_u, best_alpha, best_n_u, list_ic) with the
    reference's convention of keeping the LAST restart's factors per rank.
    """
    from demethify_tpu.selection.ccc import compute_ccc
    from demethify_tpu.solvers.partial_ref import partial_ref_solve
    from demethify_tpu.solvers.unsupervised import unsupervised_solve

    y = jnp.asarray(y)
    d = jnp.asarray(d)
    n_cpg, n_s = y.shape
    dtype = y.dtype
    n_ct = 0 if ref is None else ref.shape[1]
    masks = _member_masks(n_ct, n_u_max)                    # (K, p)
    masks_b = jnp.repeat(masks, n_restarts, axis=0)         # (K*R, p)
    keys = jax.random.split(key, n_u_max * n_restarts)
    u0_b, a0_b = _masked_init_batch(keys, init_option, y, d, ref, n_ct,
                                    n_u_max, masks_b)

    if ref is not None:
        ref = jnp.asarray(ref)

        def solve_one(u0, a0, row_mask):
            return partial_ref_solve(
                u0, a0, y, d, ref, n_u_max, n_iter1=iter1, n_iter2=iter2,
                tol=tol, tol_relative=tol_relative, row_mask=row_mask)
    else:
        def solve_one(u0, a0, row_mask):
            return unsupervised_solve(
                u0, a0, y, d, n_u_max, n_iter1=iter1, n_iter2=iter2,
                tol=tol, tol_relative=tol_relative, row_mask=row_mask)

    chunk = _sweep_member_chunk(n_cpg, n_s, n_u_max,
                                jnp.dtype(y.dtype).itemsize)
    if chunk >= masks_b.shape[0]:
        u_b, alpha_b, _ = jax.vmap(solve_one)(u0_b, a0_b, masks_b)
    else:
        fn = jax.jit(jax.vmap(solve_one))
        outs = []
        for s in range(0, masks_b.shape[0], chunk):
            e = min(s + chunk, masks_b.shape[0])
            cu0, ca0, cm = u0_b[s:e], a0_b[s:e], masks_b[s:e]
            pad = chunk - (e - s)
            if pad:
                cu0, ca0, cm = (
                    jnp.concatenate([x, jnp.repeat(x[:1], pad, axis=0)],
                                    axis=0) for x in (cu0, ca0, cm))
            u_c, a_c, _ = fn(cu0, ca0, cm)
            outs.append((u_c[:e - s], a_c[:e - s]))
        u_b = jnp.concatenate([o[0] for o in outs], axis=0)
        alpha_b = jnp.concatenate([o[1] for o in outs], axis=0)
    alpha_np = np.asarray(alpha_b).reshape(n_u_max, n_restarts,
                                           n_ct + n_u_max, n_s)
    u_np = np.asarray(u_b).reshape(n_u_max, n_restarts, n_cpg, n_u_max)

    list_ic = []
    best = None
    for i in range(n_u_max):
        runs = [alpha_np[i, r] for r in range(n_restarts)]
        ic_val = -compute_ccc(runs)
        list_ic.append(float(ic_val))
        if best is None or ic_val < best[0]:
            n_u = i + 1
            alpha_last = np.concatenate(
                [alpha_np[i, -1][:n_ct],
                 alpha_np[i, -1][n_ct:n_ct + n_u]], axis=0)
            best = (ic_val, u_np[i, -1][:, :n_u], alpha_last, n_u)
    return best[1], best[2], best[3], list_ic


def batched_bcv_sweep(y, d, ref, *, n_u_max: int, n_folds: int, key,
                      iter1: int, iter2: int, tol: float,
                      fraction: float = 0.3, tol_relative: bool = False,
                      progress: bool = False,
                      init_option: str = "uniform_"):
    """Bi-cross-validation sweep with ONE compilation: the vmapped masked
    solver is jitted once over all ranks, and the host loops folds (the
    reference redraws the same fold masks for every rank, `ic.py:59`, so
    sharing masks across ranks matches its semantics). Returns
    (best_u, best_alpha, best_n_u, list_press)."""
    from demethify_tpu.solvers.partial_ref import partial_ref_solve
    from demethify_tpu.solvers.unsupervised import unsupervised_solve

    y = jnp.asarray(y)
    d = jnp.asarray(d)
    n_cpg, n_s = y.shape
    dtype = y.dtype
    n_ct = 0 if ref is None else ref.shape[1]
    masks = _member_masks(n_ct, n_u_max)
    k_folds, k_init = jax.random.split(key)
    # 'uniform' with a reference initializes alpha by WLS on the (masked)
    # data, and SVD/ICA factor the masked data directly, so their inits
    # are per-fold like the serial path's (bcv.py: k_init drawn per fold,
    # init on y_tr); the data-independent options draw once. For SVD/ICA
    # the per-fold init is small fresh HLO (one NNDSVD / per-rank ICA);
    # the expensive masked SOLVE still compiles exactly once — vs
    # n_u_max shape-specialized solver compiles on the serial path
    # (200-500 s each on this remote-compile runtime).
    data_dependent = ((init_option == "uniform" and ref is not None)
                      or init_option not in RANDOM_INITS)
    if not data_dependent:
        keys = jax.random.split(k_init, n_u_max)
        u0_b, a0_b = _masked_init_batch(keys, init_option, y, d, ref,
                                        n_ct, n_u_max, masks)
    elif init_option in RANDOM_INITS:
        @jax.jit
        def init_fold(y_tr, d_tr, ks):
            return _masked_init_batch(ks, init_option, y_tr, d_tr, ref,
                                      n_ct, n_u_max, masks)
    else:                                   # SVD / ICA (deterministic)
        def init_fold_det(y_tr, d_tr, kf):
            return _padded_init_batch(y_tr, d_tr, ref, init_option,
                                      n_u_max, kf, masks)

    if ref is not None:
        ref_j = jnp.asarray(ref)

        @jax.jit
        def solve_all_ranks(y_tr, d_tr, u0_b, a0_b):
            def one(u0, a0, row_mask):
                return partial_ref_solve(
                    u0, a0, y_tr, d_tr, ref_j, n_u_max, n_iter1=iter1,
                    n_iter2=iter2, tol=tol, tol_relative=tol_relative,
                    row_mask=row_mask)
            return jax.vmap(one)(u0_b, a0_b, masks)
    else:
        @jax.jit
        def solve_all_ranks(y_tr, d_tr, u0_b, a0_b):
            def one(u0, a0, row_mask):
                return unsupervised_solve(
                    u0, a0, y_tr, d_tr, n_u_max, n_iter1=iter1,
                    n_iter2=iter2, tol=tol, tol_relative=tol_relative,
                    row_mask=row_mask)
            return jax.vmap(one)(u0_b, a0_b, masks)

    total_press = np.zeros(n_u_max)
    best_per_rank = [None] * n_u_max

    fold_iter = range(n_folds)
    if progress:
        from demethify_tpu.utils import optional_import

        tqdm = optional_import("tqdm", "the progress bar")

        fold_iter = tqdm.tqdm(fold_iter, desc="BCV folds", unit="fold")
    for fold in fold_iter:
        kf = jax.random.fold_in(k_folds, fold)
        train_mask = jax.random.uniform(kf, y.shape) < fraction
        test_mask = ~train_mask
        n_test = float(jnp.sum(test_mask))
        if n_test == 0:
            continue
        y_tr, d_tr = y * train_mask, d * train_mask
        if data_dependent:
            kf_init = jax.random.fold_in(k_init, fold)
            if init_option in RANDOM_INITS:
                ks = jax.random.split(kf_init, n_u_max)
                u0_b, a0_b = init_fold(y_tr, d_tr, ks)
            else:
                u0_b, a0_b = init_fold_det(y_tr, d_tr, kf_init)
        u_b, alpha_b, _ = solve_all_ranks(y_tr, d_tr, u0_b, a0_b)
        for i in range(n_u_max):
            if ref is not None:
                R = jnp.concatenate([jnp.asarray(ref), u_b[i]], axis=1)
            else:
                R = u_b[i]
            y_pred = R @ alpha_b[i]
            err = float(jnp.sum(((y - y_pred) * test_mask) ** 2)) / n_test
            total_press[i] += err
            if best_per_rank[i] is None or err < best_per_rank[i][0]:
                best_per_rank[i] = (err, np.asarray(u_b[i]),
                                    np.asarray(alpha_b[i]))

    list_press = total_press.tolist()
    best_i = int(np.argmin(total_press))
    best_n_u = best_i + 1
    _, u_full, alpha_full = best_per_rank[best_i]
    u_best = u_full[:, :best_n_u]
    alpha_best = np.concatenate(
        [alpha_full[:n_ct], alpha_full[n_ct:n_ct + best_n_u]], axis=0)
    return u_best, alpha_best, best_n_u, list_press


def evaluate_ic_batched(y, d, ref, ic: str, *, key=None, seed: int = 1,
                        iter1: int, iter2: int, tol: float,
                        n_u_max: int = 25, tol_relative: bool = False,
                        init_option: str = "uniform_"):
    """AIC/BIC sweep over n_u = 1..n_u_max with ONE solver compile +
    dispatch, for ALL five init options: the random inits (uniform_,
    beta, uniform) and the deterministic SVD/ICA inits (see
    _padded_init_batch for the per-init compile story).

    Returns (best_u, best_alpha, best_n_u, list_ic) like
    selection.sweep.evaluate_best_ic.
    """
    if ic not in ("AIC", "BIC"):
        raise ValueError("batched sweep supports AIC/BIC (CCC/BCV/minka "
                         "go through selection.sweep)")
    if key is None:
        key = jax.random.PRNGKey(seed)

    n_cpg, n_samples = y.shape
    n_ct = 0 if ref is None else ref.shape[1]
    u_b, alpha_b, costs, _ = batched_rank_sweep(
        y, d, ref, n_u_max=n_u_max, key=key, iter1=iter1, iter2=iter2,
        tol=tol, tol_relative=tol_relative, init_option=init_option)
    costs = np.asarray(costs, dtype=np.float64)

    fn = compute_bic if ic == "BIC" else compute_aic
    list_ic = [float(fn(costs[i], i + 1, n_cpg, n_ct, n_samples))
               for i in range(n_u_max)]
    # NaN-proof argmin (a non-finite criterion never wins)
    best_i = int(np.argmin(np.where(np.isfinite(list_ic), list_ic,
                                    np.inf)))
    best_n_u = best_i + 1

    u_best = np.asarray(u_b[best_i])[:, :best_n_u]
    alpha_full = np.asarray(alpha_b[best_i])
    # active rows: all known + first best_n_u unknown
    alpha_best = np.concatenate([alpha_full[:n_ct],
                                 alpha_full[n_ct:n_ct + best_n_u]], axis=0)
    return u_best, alpha_best, best_n_u, list_ic
