"""Weighted (row-multiplicity) bootstrap: the with-replacement row
resample solved WITHOUT gathered copies must equal the materialized
resample exactly.

Equivalence argument (uncertainty/bootstrap.py module docstring): the U
update is row-separable given alpha, so duplicated rows share one
trajectory when they share one init; every cross-row reduction (alpha
Grams, cost, Lipschitz norms, max coverage) is the w-weighted reduction
over original rows. The tests below pin that argument numerically by
giving the gathered solve per-ORIGINAL-row init draws (u0_gathered =
u0[idx]): alpha trajectories, costs, iteration counts, and the sampled
rows' u values must then agree to float reassociation.
"""

import numpy as np
import jax
import jax.numpy as jnp

from demethify_tpu.ops.nnls import wls_intercept_batch
from demethify_tpu.solvers.partial_ref import partial_ref_solve
from demethify_tpu.solvers.purity import purity_solve
from demethify_tpu.uncertainty.bootstrap import bootstrap_ci


def _resample_idx(rng, n, drop_row=None):
    """Resample indices; optionally force-drop one row (exercises the
    max-coverage-row-dropped Lipschitz path)."""
    idx = rng.integers(0, n, size=n)
    if drop_row is not None:
        idx = np.where(idx == drop_row, (drop_row + 1) % n, idx)
    return idx


def _weights(idx, n):
    return np.bincount(idx, minlength=n).astype(np.float64)


class TestWeightedSolverEquivalence:
    def test_partial_ref_matches_gathered(self, small_problem):
        p = small_problem
        y, d, Rt = p["y"], p["d"], p["R_trunc"]
        n_cpg = y.shape[0]
        n_u = p["n_u"]
        rng = np.random.default_rng(5)
        # drop the max-coverage row so dmax differs from the full data
        drop = int(np.argmax(d.max(axis=1)))
        idx = _resample_idx(rng, n_cpg, drop_row=drop)
        w = _weights(idx, n_cpg)
        assert w[drop] == 0
        u0 = rng.uniform(size=(n_cpg, n_u))
        a0 = rng.dirichlet(np.ones(Rt.shape[1] + n_u), size=y.shape[1]).T

        want = partial_ref_solve(
            jnp.asarray(u0[idx]), jnp.asarray(a0), jnp.asarray(y[idx]),
            jnp.asarray(d[idx]), jnp.asarray(Rt[idx]), n_u,
            n_iter1=25, n_iter2=6, tol=1e-6, record_trace=True)
        got = partial_ref_solve(
            jnp.asarray(u0), jnp.asarray(a0), jnp.asarray(y),
            jnp.asarray(d), jnp.asarray(Rt), n_u,
            n_iter1=25, n_iter2=6, tol=1e-6, record_trace=True,
            row_weights=jnp.asarray(w))

        np.testing.assert_allclose(np.asarray(got[1]),
                                   np.asarray(want[1]), atol=1e-9)
        assert int(got[2]["n_iter"]) == int(want[2]["n_iter"])
        w_tr = np.asarray(want[2]["trace"])
        g_tr = np.asarray(got[2]["trace"])
        mask = ~np.isnan(w_tr)
        np.testing.assert_allclose(g_tr[mask], w_tr[mask], rtol=1e-9)
        # sampled rows' u trajectories coincide: u_gathered[i] = u[idx[i]]
        np.testing.assert_allclose(np.asarray(want[0]),
                                   np.asarray(got[0])[idx], atol=1e-9)

    def test_purity_matches_gathered(self, small_problem):
        p = small_problem
        y, d, Rt = p["y"], p["d"], p["R_trunc"]
        n_cpg, n_s = y.shape
        n_u = p["n_u"]
        rng = np.random.default_rng(6)
        idx = _resample_idx(rng, n_cpg)
        w = _weights(idx, n_cpg)
        purity = jnp.asarray(rng.uniform(0.3, 0.7, size=n_s))
        u0 = rng.uniform(size=(n_cpg, n_u))
        a0 = rng.dirichlet(np.ones(Rt.shape[1] + n_u), size=n_s).T

        want = purity_solve(
            jnp.asarray(u0[idx]), jnp.asarray(a0), jnp.asarray(y[idx]),
            jnp.asarray(d[idx]), jnp.asarray(Rt[idx]), purity, n_u,
            n_iter1=8, n_iter2=15, tol=1e-9)
        got = purity_solve(
            jnp.asarray(u0), jnp.asarray(a0), jnp.asarray(y),
            jnp.asarray(d), jnp.asarray(Rt), purity, n_u,
            n_iter1=8, n_iter2=15, tol=1e-9,
            row_weights=jnp.asarray(w))
        np.testing.assert_allclose(np.asarray(got[1]),
                                   np.asarray(want[1]), atol=1e-9)
        np.testing.assert_allclose(float(got[2]["cost"]),
                                   float(want[2]["cost"]), rtol=1e-9)
        np.testing.assert_allclose(np.asarray(want[0]),
                                   np.asarray(got[0])[idx], atol=1e-9)

    def test_supervised_wls_matches_gathered(self, small_problem):
        p = small_problem
        y, d, Rt = p["y"], p["d"], p["R_trunc"]
        n_cpg = y.shape[0]
        rng = np.random.default_rng(7)
        idx = _resample_idx(rng, n_cpg)
        w = _weights(idx, n_cpg)[:, None]
        want = wls_intercept_batch(jnp.asarray((d * y)[idx]),
                                   jnp.asarray(d[idx]),
                                   jnp.asarray(Rt[idx]))
        got = wls_intercept_batch(jnp.asarray(d * y),
                                  jnp.asarray(w * d), jnp.asarray(Rt))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-10)

    def test_weighted_wls_init_matches_gathered(self, small_problem):
        # the 'uniform' init's WLS on (y, w*d, [R|u]) == WLS on gathered
        # rows with the SAME per-original-row u columns
        p = small_problem
        y, d, Rt = p["y"], p["d"], p["R_trunc"]
        n_cpg = y.shape[0]
        n_u = p["n_u"]
        rng = np.random.default_rng(8)
        idx = _resample_idx(rng, n_cpg)
        w = _weights(idx, n_cpg)[:, None]
        u0 = rng.uniform(size=(n_cpg, n_u))
        R = np.hstack([Rt, u0])
        want = wls_intercept_batch(jnp.asarray(y[idx]),
                                   jnp.asarray(d[idx]),
                                   jnp.asarray(R[idx]))
        got = wls_intercept_batch(jnp.asarray(y), jnp.asarray(w * d),
                                  jnp.asarray(R))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-10)


class TestBootstrapCIWeights:
    def test_supervised_ci_identical_between_methods(self, small_problem):
        # supervised replicates are deterministic given the resample draw,
        # so the two layouts must produce the SAME intervals
        p = small_problem
        y, d, Rt = p["y"], p["d"], p["R_trunc"]
        kw = dict(level=90.0, n_bootstrap=12, key=jax.random.PRNGKey(3),
                  batch_size=6)
        lo_r, hi_r, _, _ = bootstrap_ci(y, d, Rt, 0, method="resample",
                                        **kw)
        lo_w, hi_w, _, _ = bootstrap_ci(y, d, Rt, 0, method="weights",
                                        **kw)
        np.testing.assert_allclose(lo_w, lo_r, atol=1e-9)
        np.testing.assert_allclose(hi_w, hi_r, atol=1e-9)

    def test_partial_ref_ci_weights_mode(self, small_problem):
        p = small_problem
        y, d, Rt = p["y"], p["d"], p["R_trunc"]
        n_u = p["n_u"]
        lo_p, hi_p, lo_u, hi_u = bootstrap_ci(
            y, d, Rt, n_u, level=90.0, n_bootstrap=8,
            n_iter1=20, n_iter2=5, tol=1e-6,
            key=jax.random.PRNGKey(4), batch_size=4, method="weights")
        pp = Rt.shape[1] + n_u
        assert lo_p.shape == (pp, y.shape[1])
        assert np.all(lo_p <= hi_p + 1e-12)
        # weighted u CIs are per ORIGINAL row
        assert lo_u.shape == (y.shape[0], n_u)
        assert np.all(np.isfinite(lo_u)) and np.all(np.isfinite(hi_u))

    def test_weights_mode_svd_shared_init(self, small_problem):
        """SVD-init weights mode (shared full-data init, per-replicate
        weighted solves) must produce CIs consistent with resample
        mode's distribution on the fixture: same shapes, valid ordering,
        and proportion-CI midpoints within the run-to-run spread (the
        init divergence is documented — shared init vs per-resample
        re-init — but both bootstrap the same converged optimum here)."""
        p = small_problem
        y, d, Rt, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
        kw = dict(level=90.0, n_bootstrap=16, init_option="SVD",
                  n_iter1=300, n_iter2=10, tol=1e-9,
                  key=jax.random.PRNGKey(7), batch_size=8)
        lo_w, hi_w, lo_uw, hi_uw = bootstrap_ci(
            y, d, Rt, n_u, method="weights", **kw)
        lo_r, hi_r, lo_ur, hi_ur = bootstrap_ci(
            y, d, Rt, n_u, method="resample", **kw)
        assert lo_w.shape == lo_r.shape
        assert np.all(lo_w <= hi_w + 1e-12)
        assert lo_uw.shape == (y.shape[0], n_u)
        # same underlying distribution: CI midpoints of the proportions
        # agree within the bootstrap spread
        mid_w = (np.asarray(lo_w) + np.asarray(hi_w)) / 2
        mid_r = (np.asarray(lo_r) + np.asarray(hi_r)) / 2
        width = np.maximum(np.asarray(hi_r) - np.asarray(lo_r), 0.02)
        assert np.all(np.abs(mid_w - mid_r) <= 2.0 * width + 0.05)

    def test_weights_mode_ica_shared_init_runs(self, small_problem):
        p = small_problem
        lo_p, hi_p, lo_u, hi_u = bootstrap_ci(
            p["y"], p["d"], p["R_trunc"], p["n_u"], level=90.0,
            n_bootstrap=4, init_option="ICA", n_iter1=50, n_iter2=5,
            tol=1e-7, key=jax.random.PRNGKey(9), batch_size=4,
            method="weights")
        assert np.all(lo_p <= hi_p + 1e-12)
        assert np.all(np.isfinite(lo_u)) and np.all(np.isfinite(hi_u))

    def test_auto_stays_resample_on_small_input(self, small_problem):
        # tiny fixture -> auto must keep the reference layout (u CIs per
        # resampled position: shape (n_rows, n_u) either way here, so
        # check via identical results to explicit resample)
        p = small_problem
        y, d, Rt = p["y"], p["d"], p["R_trunc"]
        kw = dict(level=90.0, n_bootstrap=4, n_iter1=5, n_iter2=3,
                  tol=1e-6, key=jax.random.PRNGKey(5), batch_size=2)
        auto = bootstrap_ci(y, d, Rt, p["n_u"], method="auto", **kw)
        res = bootstrap_ci(y, d, Rt, p["n_u"], method="resample", **kw)
        for a, r in zip(auto[:2], res[:2]):
            np.testing.assert_allclose(a, r, atol=0)


class TestWeightedBootstrapSharded:
    def test_row_sharded_matches_local(self, small_problem):
        # the weighted layout has no per-replicate row gather, so it
        # runs directly on cpg-row-sharded arrays; results must match
        # the local run (Gram psums reassociate -> tight tolerance)
        from demethify_tpu.parallel.mesh import make_mesh, shard_dataset

        p = small_problem
        y = np.asarray(p["y"])
        d = np.asarray(p["d"])
        Rt = np.asarray(p["R_trunc"])
        n_u = p["n_u"]
        kw = dict(level=90.0, n_bootstrap=6, n_iter1=10, n_iter2=4,
                  tol=1e-6, key=jax.random.PRNGKey(7), batch_size=3,
                  method="weights")
        local = bootstrap_ci(jnp.asarray(y), jnp.asarray(d),
                             jnp.asarray(Rt), n_u, **kw)
        mesh = make_mesh(jax.devices())
        y_s, d_s, Rt_s = shard_dataset(mesh, y, d, Rt)
        # padded rows (zero coverage) are excluded from the resample
        sharded = bootstrap_ci(y_s, d_s, Rt_s, n_u, n_rows=y.shape[0],
                               **kw)
        for a, b in zip(local[:2], sharded[:2]):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       atol=1e-9)
        # u CIs: compare the real (unpadded) rows
        np.testing.assert_allclose(np.asarray(sharded[2])[:y.shape[0]],
                                   np.asarray(local[2]), atol=1e-9)


def test_bootstrap_weights_svd_sharded_matches_local(small_problem):
    # SVD shared-init weights mode on row-sharded data: the vmapped
    # weighted solve on the row-sharded arrays must reproduce the local
    # CIs
    from jax.sharding import NamedSharding, PartitionSpec as P

    from demethify_tpu.parallel.mesh import CPG_AXIS, make_mesh

    p = small_problem
    y, d, Rt = p["y"], p["d"], p["R_trunc"]
    n_u = p["n_u"]
    kw = dict(level=90.0, n_bootstrap=4, n_iter1=6, n_iter2=4,
              tol=1e-6, key=jax.random.PRNGKey(13), batch_size=4,
              method="weights", init_option="SVD")
    local = bootstrap_ci(y, d, Rt, n_u, **kw)
    mesh = make_mesh(jax.devices()[:4], replicate=1)
    sh = NamedSharding(mesh, P(CPG_AXIS, None))
    y_s = jax.device_put(jnp.asarray(y), sh)
    d_s = jax.device_put(jnp.asarray(d), sh)
    Rt_s = jax.device_put(jnp.asarray(Rt), sh)
    sharded = bootstrap_ci(y_s, d_s, Rt_s, n_u, **kw)
    for a, b in zip(local, sharded):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=1e-6)


def test_supervised_weights_allows_any_init(small_problem):
    # supervised replicates never use the init, so weights mode must not
    # reject SVD/ICA there (the validation is init-gated only for the
    # iterative modes)
    p = small_problem
    lo, hi, _, _ = bootstrap_ci(p["y"], p["d"], p["R_trunc"], 0,
                                level=90.0, n_bootstrap=4,
                                init_option="SVD", method="weights",
                                key=jax.random.PRNGKey(12),
                                batch_size=4)
    assert np.all(np.isfinite(lo)) and np.all(np.isfinite(hi))


class TestUnsupervisedBootstrap:
    """--confidence without --ref: the reference crashes
    (`demethify/bootstrap.py:63`, ref.shape with ref=None); here the
    unsupervised mode resamples (Y, D) rows in both layouts."""

    def test_unsupervised_solve_matches_gathered(self, small_problem):
        from demethify_tpu.solvers.unsupervised import unsupervised_solve

        p = small_problem
        y, d = p["y"], p["d"]
        n_cpg, n_s = y.shape
        n_u = 3
        rng = np.random.default_rng(11)
        drop = int(np.argmax(d.max(axis=1)))
        idx = _resample_idx(rng, n_cpg, drop_row=drop)
        w = _weights(idx, n_cpg)
        assert w[drop] == 0
        u0 = rng.uniform(size=(n_cpg, n_u))
        a0 = rng.dirichlet(np.ones(n_u), size=n_s).T

        want = unsupervised_solve(
            jnp.asarray(u0[idx]), jnp.asarray(a0), jnp.asarray(y[idx]),
            jnp.asarray(d[idx]), n_u, n_iter1=20, n_iter2=6, tol=1e-6,
            record_trace=True)
        got = unsupervised_solve(
            jnp.asarray(u0), jnp.asarray(a0), jnp.asarray(y),
            jnp.asarray(d), n_u, n_iter1=20, n_iter2=6, tol=1e-6,
            record_trace=True, row_weights=jnp.asarray(w))

        np.testing.assert_allclose(np.asarray(got[1]),
                                   np.asarray(want[1]), atol=1e-9)
        assert int(got[2]["n_iter"]) == int(want[2]["n_iter"])
        w_tr = np.asarray(want[2]["trace"])
        g_tr = np.asarray(got[2]["trace"])
        mask = ~np.isnan(w_tr)
        np.testing.assert_allclose(g_tr[mask], w_tr[mask], rtol=1e-9)
        np.testing.assert_allclose(np.asarray(want[0]),
                                   np.asarray(got[0])[idx], atol=1e-9)

    def test_unsupervised_ci_both_methods(self, small_problem):
        p = small_problem
        y, d = p["y"], p["d"]
        n_u = 2
        kw = dict(level=90.0, n_bootstrap=6, n_iter1=10, n_iter2=4,
                  tol=1e-6, key=jax.random.PRNGKey(9), batch_size=3)
        for method in ("resample", "weights"):
            lo_p, hi_p, lo_u, hi_u = bootstrap_ci(
                y, d, None, n_u, method=method, **kw)
            assert lo_p.shape == (n_u, y.shape[1])
            assert np.all(lo_p <= hi_p + 1e-12)
            assert lo_u.shape == (y.shape[0], n_u)
            assert np.all(np.isfinite(lo_u))
            assert np.all(np.isfinite(hi_u))

    def test_unsupervised_rejects_n_u_zero(self, small_problem):
        import pytest

        p = small_problem
        with pytest.raises(ValueError, match="unsupervised"):
            bootstrap_ci(p["y"], p["d"], None, 0, level=90.0,
                         n_bootstrap=2)
