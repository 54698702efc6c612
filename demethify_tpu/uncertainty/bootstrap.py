"""Bootstrap confidence intervals, batched on device.

Reference: `bt_ci` (`demethify/bootstrap.py:10-93`): B row-resamples of
(Y, D, R) with replacement, a full re-init + re-solve per replicate, then
percentile CIs over replicates for the proportions (and the unknown
profiles in non-supervised modes).

Restructuring: replicates are an embarrassingly parallel batch axis.
Resampling is a per-replicate `jax.random.randint` gather; init + solve
are vmapped; replicates run in device-sized chunks (`batch_size`) so
B=2500 fills the device instead of looping serially (the reference's 55 s
fixture path). Percentiles use NumPy's default linear interpolation, same
as `np.percentile` in the reference.

Genome-scale form (``method="weights"``): gathered replicate copies cost
B x (2 n_s + n_ct) x n_cpg floats — prohibitive at megabase scale. A
with-replacement row resample is EXACTLY the row-MULTIPLICITY problem
(row i appears w_i ~ Multinomial times), and the solvers' cross-row
reductions all accept per-row weights (`partial_ref_solve(row_weights=)`):
the alpha Grams/cost weight the coverage by w, the Lipschitz norms use
the w-weighted ||R||^2, max(D) runs over surviving rows, and the
row-separable U update is untouched (duplicated rows share one
trajectory). Each replicate then costs ONE (n_cpg,) weight vector
instead of three gathered matrices, and all replicates share the
original Y/D in memory. Equivalence to the gathered solve is exact when
the gathered init re-uses per-original-row draws (tested); with the
standard per-replicate init the two modes differ only in which random
init a row's copies receive — the same init-RNG freedom that already
distinguishes this implementation from the reference. u rows absent
from a resample (w=0) still carry their alpha-conditional estimate, so
weighted u CIs are indexed by ORIGINAL row (resample mode's u CIs are
per resampled position, matching the reference's convention).

Deterministic inits (SVD/ICA) in weights mode use the SHARED-INIT form:
one init on the full data, shared by all replicates (see
_SHARED_INIT_WEIGHTABLE) — the only layout that avoids materializing B
resampled matrices for the per-replicate factorization at genome scale.

Deliberate divergence (documented): when `--purity` is active the reference
bootstrap scales by p/100 while the main path uses 1 - p/100
(`bootstrap.py:18` vs `demethify.py:77`) — i.e. it bootstraps a different
model than the point estimate. Here the bootstrap uses the SAME flipped
purity as the main path.

Fixed reference crash (documented divergence): `--confidence` without
`--ref` raises AttributeError in the reference (`bootstrap.py:63`,
`ref.shape` with ref=None) — unsupervised bootstrap CIs are unusable as
shipped. Here ``ref=None`` resamples (Y, D) rows and re-solves the
unsupervised NMF per replicate, in both resample and weights
(row-multiplicity, via `unsupervised_solve(row_weights=)`) layouts.
"""

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# init options whose weighted form is EXACT (same distribution as the
# gathered resample): data-independent draws, or 'uniform' whose WLS
# becomes a w-weighted WLS. SVD/ICA instead use the SHARED-INIT weighted
# form: the deterministic init is computed ONCE on the full data and
# every replicate solves its row-multiplicity problem from it. The
# reference re-inits on each resampled matrix (`bootstrap.py:30-36`), so
# shared-init CIs reflect solve-under-resampling variability only — the
# same class of freedom as the init-RNG divergence documented above
# (and the only tractable layout at genome scale, where materializing B
# resampled copies for the SVD is exactly what weights mode exists to
# avoid).
_WEIGHTABLE_INITS = ("uniform_", "beta", "uniform")
_SHARED_INIT_WEIGHTABLE = ("SVD", "ICA")


def resolve_method(method: str, init_option: str, n_elems: int) -> str:
    """Resolve "auto" to a concrete layout (shared with the CLI, which
    needs the answer up front to pick the data placement). Every init
    has a weights-mode layout (exact for the random/WLS options,
    shared-init for SVD/ICA), so auto switches purely on size."""
    if method != "auto":
        return method
    return "weights" if n_elems >= 2_000_000 else "resample"


# Budget for one replicate batch where the device reports no memory
# limit (CPU devices).
_HOST_BATCH_BUDGET = 2 << 30
# Share of a device's memory limit that one replicate batch may take: the
# input arrays and the compiled solver's own temporaries need the rest.
_DEVICE_BATCH_SHARE = 0.25


def _batch_budget_bytes(device) -> int:
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return _HOST_BATCH_BUDGET
    return int(limit * _DEVICE_BATCH_SHARE)


def _auto_batch_size(n_cpg, n_s, n_ct, n_u, method, budget_bytes,
                     itemsize=4):
    """Replicates per device dispatch, sized so the batch's per-replicate
    state fits the budget. Resample mode materializes gathered copies of
    (Y, D, R) plus solver carries; weights mode only the weight vector
    and the u carries."""
    if method == "weights":
        # weight vector + u/u_prev carries + the vmapped C-build's
        # per-member (n_cpg, n_s) residual temporary
        per_rep = itemsize * n_cpg * (2 + 6 * max(n_u, 1) + n_s)
    else:
        per_rep = itemsize * n_cpg * 2 * (2 * n_s + n_ct + 2 * n_u + 1)
    return int(max(1, min(256, budget_bytes // max(per_rep, 1))))


def _percentiles(arr: np.ndarray, level: float) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    a = 1.0 - level / 100.0
    lower = np.percentile(arr, 100 * (a / 2), axis=0)
    upper = np.percentile(arr, 100 * (1 - a / 2), axis=0)
    return lower, upper


def bootstrap_ci(y, d, ref, n_u: int, *,
                 level: float, n_bootstrap: int,
                 init_option: str = "uniform_",
                 n_iter1: int = 10000, n_iter2: int = 20,
                 tol: float = 1e-2,
                 purity=None,
                 key=None, seed: int = 1,
                 batch_size=None,
                 n_rows=None,
                 tol_relative: bool = False,
                 process_count: int = 1,
                 process_index: int = 0,
                 devices=None,
                 method: str = "auto",
                 progress: bool = False):
    """Returns (lower_props, upper_props, lower_u, upper_u); the u bounds
    are None in supervised mode (n_u == 0).

    ``ref=None`` runs the UNSUPERVISED bootstrap (the reference crashes
    here — see module docstring): replicates resample (Y, D) rows and
    re-solve the unsupervised NMF; proportions CIs are over the (n_u,
    n_s) alpha. ``progress`` shows a tqdm bar over replicates (chunk
    granularity), like the reference's `bootstrap.py:26`.

    ``method``: "resample" gathers replicate copies (the reference's
    data layout; u CIs per resampled row position), "weights" solves the
    equivalent row-multiplicity problem with zero data duplication
    (genome-scale; u CIs per original row — see module docstring),
    "auto" picks weights once the data is large enough for duplication
    to hurt (and the init has a weighted form — SVD/ICA do not).
    ``batch_size``: replicates per device dispatch; None sizes it to the
    device's memory (see _auto_batch_size).

    Multi-host scale-out (``process_count > 1``): each process solves a
    contiguous block of the B replicates on ITS devices (y/d/ref must be
    process-local full arrays, not row-sharded — the per-replicate row
    gather would otherwise be an all-to-all), then the per-replicate
    results are allgathered across processes before the percentile step.
    Replicate keys fold in the GLOBAL replicate index, so the CIs are
    bit-identical to a single-process run for any process count. The
    unknown-profile gather moves (B, n_cpg, n_u) between hosts — fine for
    panel-scale references; genome-scale bootstrap CIs of U should stay
    single-host or accept the transfer.

    Local multi-chip scale-out (``devices``, CLI --shard): the replicate
    batch axis shards across the given local devices with (y, d, ref)
    replicated — each chip solves its own replicates with zero
    communication (row-sharding would make every replicate's row gather
    an all-to-all instead). Results are identical to the single-device
    batch for any device count."""
    from demethify_tpu.ops.nnls import wls_intercept_batch
    from demethify_tpu.solvers.init import (
        init_partial,
        init_purity,
        init_unsupervised,
    )
    from demethify_tpu.solvers.partial_ref import partial_ref_solve
    from demethify_tpu.solvers.purity import purity_solve
    from demethify_tpu.solvers.unsupervised import unsupervised_solve

    if key is None:
        key = jax.random.PRNGKey(seed)

    y = jnp.asarray(y)
    d = jnp.asarray(d)
    unsupervised = ref is None
    if unsupervised and n_u == 0:
        raise ValueError("bootstrap_ci needs ref profiles (supervised) "
                         "or n_u > 0 (unsupervised)")
    ref = None if unsupervised else jnp.asarray(ref)
    if purity is not None:
        purity = jnp.asarray(purity, y.dtype)
    n_cpg = y.shape[0]
    # resample only real rows (rows beyond n_rows are zero-coverage
    # padding added for sharding divisibility)
    n_sample_rows = n_cpg if n_rows is None else int(n_rows)
    supervised = n_u == 0

    if method == "auto":
        # supervised replicates are init-free WLS solves, so weights
        # mode is always available there
        method = resolve_method(
            method, init_option if not supervised else "uniform_",
            n_cpg * y.shape[1])
    if method not in ("resample", "weights"):
        raise ValueError(f"unknown bootstrap method {method!r}")

    # SVD/ICA weights mode: the deterministic init is computed ONCE on
    # the full data and shared by every replicate (module docstring:
    # shared-init weighted form — documented divergence from per-
    # replicate re-init). The shared key only matters on the silent
    # uniform_ fallback (n_u > n_samples), where the init is random but
    # still replicate-shared.
    shared_init = None
    if (method == "weights" and not supervised
            and init_option in _SHARED_INIT_WEIGHTABLE):
        from demethify_tpu.solvers.init import (
            init_partial as _ip,
            init_purity as _ipur,
            init_unsupervised as _iu,
        )

        k_shared = jax.random.fold_in(key, 2 ** 31 - 1)
        if unsupervised:
            shared_init = _iu(k_shared, init_option, y, d, n_u)
        elif purity is not None:
            shared_init = _ipur(k_shared, init_option, y, d, ref, n_u,
                                purity)
        else:
            shared_init = _ip(k_shared, init_option, y, d, ref, n_u)
        shared_init = tuple(jnp.asarray(x) for x in shared_init)
    if batch_size is None:
        batch_size = _auto_batch_size(
            n_cpg, y.shape[1], 0 if unsupervised else ref.shape[1],
            n_u, method, _batch_budget_bytes(jax.local_devices()[0]))

    def one_replicate(k):
        k_idx, k_init = jax.random.split(k)
        # replicate size == number of REAL rows (n_cpg may be padded)
        idx = jax.random.randint(k_idx, (n_sample_rows,), 0,
                                 n_sample_rows)
        yb = y[idx]
        db = d[idx]
        if unsupervised:
            u0, a0 = init_unsupervised(k_init, init_option, yb, db, n_u)
            u, alpha, _ = unsupervised_solve(u0, a0, yb, db, n_u,
                                             n_iter1=n_iter1,
                                             n_iter2=n_iter2, tol=tol,
                                             tol_relative=tol_relative)
            return alpha, u
        refb = ref[idx]
        if supervised:
            props = wls_intercept_batch(db * yb, db, refb)
            return props, jnp.zeros((n_sample_rows, 0), y.dtype)
        if purity is not None:
            u0, a0 = init_purity(k_init, init_option, yb, db, refb, n_u,
                                 purity)
            u, alpha, _ = purity_solve(u0, a0, yb, db, refb, purity, n_u,
                                       n_iter1=n_iter1, n_iter2=n_iter2,
                                       tol=tol, tol_relative=tol_relative)
        else:
            u0, a0 = init_partial(k_init, init_option, yb, db, refb, n_u)
            u, alpha, _ = partial_ref_solve(u0, a0, yb, db, refb, n_u,
                                            n_iter1=n_iter1,
                                            n_iter2=n_iter2, tol=tol,
                                            tol_relative=tol_relative)
        return alpha, u

    def one_replicate_weighted(k):
        # identical resample draw; the multiplicity vector replaces the
        # gathered copies (module docstring: exact row-multiplicity form)
        k_idx, k_init = jax.random.split(k)
        idx = jax.random.randint(k_idx, (n_sample_rows,), 0,
                                 n_sample_rows)
        wvec = jnp.zeros((n_cpg,), y.dtype).at[idx].add(1.0)
        if unsupervised:
            # uniform_/beta/uniform unsupervised draws are
            # data-independent and SVD/ICA use the shared full-data
            # init, so the init needs no weighted form
            if shared_init is not None:
                u0, a0 = shared_init
            else:
                u0, a0 = init_unsupervised(k_init, init_option, y, d,
                                           n_u)
            u, alpha, _ = unsupervised_solve(u0, a0, y, d, n_u,
                                             n_iter1=n_iter1,
                                             n_iter2=n_iter2, tol=tol,
                                             tol_relative=tol_relative,
                                             row_weights=wvec)
            return alpha, u
        if supervised:
            props = wls_intercept_batch(d * y, wvec[:, None] * d, ref)
            return props, jnp.zeros((n_cpg, 0), y.dtype)
        if shared_init is not None:
            u0, a0 = shared_init
        elif purity is not None:
            u0, a0 = init_purity(k_init, init_option, y, d, ref, n_u,
                                 purity, row_weights=wvec)
        else:
            u0, a0 = init_partial(k_init, init_option, y, d, ref, n_u,
                                  row_weights=wvec)
        if purity is not None:
            u, alpha, _ = purity_solve(u0, a0, y, d, ref, purity, n_u,
                                       n_iter1=n_iter1, n_iter2=n_iter2,
                                       tol=tol,
                                       tol_relative=tol_relative,
                                       row_weights=wvec)
        else:
            u, alpha, _ = partial_ref_solve(u0, a0, y, d, ref, n_u,
                                            n_iter1=n_iter1,
                                            n_iter2=n_iter2, tol=tol,
                                            tol_relative=tol_relative,
                                            row_weights=wvec)
        return alpha, u

    replicate_fn = (one_replicate_weighted if method == "weights"
                    else one_replicate)
    batched = jax.jit(jax.vmap(replicate_fn))
    key_sharding = None
    n_dev = 1
    if devices is not None and len(devices) > 1:
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        n_dev = len(devices)
        mesh = Mesh(np.asarray(devices), ("replicate",))
        key_sharding = NamedSharding(mesh, P("replicate"))
        data_sharding = NamedSharding(mesh, P())
        y = jax.device_put(y, data_sharding)
        d = jax.device_put(d, data_sharding)
        if ref is not None:
            ref = jax.device_put(ref, data_sharding)
        if purity is not None:
            purity = jax.device_put(purity, data_sharding)

    # this process's contiguous block of global replicate indices; the
    # per-process count is padded so every process ships equal shapes to
    # the allgather, and the (deterministically-keyed) overhang past B is
    # trimmed after the gather
    per_proc = -(-n_bootstrap // process_count)
    start = process_index * per_proc

    pbar = None
    if progress:
        from demethify_tpu.utils import optional_import

        tqdm = optional_import("tqdm", "the progress bar")

        pbar = tqdm.tqdm(total=per_proc, desc="bootstrap replicates",
                         unit="rep")
    props_chunks = []
    u_chunks = []
    done = 0
    while done < per_proc:
        nb = min(batch_size, per_proc - done)
        # pad the chunk so the replicate axis divides the device count
        # (overhang keys are deterministic and trimmed below)
        nb_pad = -(-nb // n_dev) * n_dev
        keys = jnp.stack([jax.random.fold_in(key, start + done + i)
                          for i in range(nb_pad)])
        if key_sharding is not None:
            keys = jax.device_put(keys, key_sharding)
        props_b, u_b = batched(keys)
        props_chunks.append(np.asarray(props_b)[:nb])
        u_chunks.append(np.asarray(u_b)[:nb])
        done += nb
        if pbar is not None:
            pbar.update(nb)
    if pbar is not None:
        pbar.close()

    props_all = np.concatenate(props_chunks, axis=0)   # (B_local, p, n_s)
    u_all = np.concatenate(u_chunks, axis=0)       # (B_local, n_cpg, n_u)
    if process_count > 1:
        from jax.experimental import multihost_utils

        props_all = np.asarray(multihost_utils.process_allgather(
            props_all, tiled=True))[:n_bootstrap]
        if not supervised:
            u_all = np.asarray(multihost_utils.process_allgather(
                u_all, tiled=True))[:n_bootstrap]

    lo_p, hi_p = _percentiles(props_all, level)
    if supervised:
        return lo_p, hi_p, None, None
    lo_u, hi_u = _percentiles(u_all, level)
    return lo_p, hi_p, lo_u, hi_u
