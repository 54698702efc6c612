"""Unit tests for the kernel layer against NumPy/SciPy oracles."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.optimize import nnls as scipy_nnls

from tests import oracle
from demethify_tpu.ops.simplex import project_columns_to_simplex
from demethify_tpu.ops.cost import weighted_cost, weighted_cost_gram
from demethify_tpu.ops.gram import sample_grams, site_curvature, u_constant_term
from demethify_tpu.ops import fista
from demethify_tpu.ops import frank_wolfe as fw
from demethify_tpu.ops.nnls import nnls, wls_intercept, wls_intercept_batch


class TestSimplex:
    def test_matches_oracle(self, rng):
        v = rng.normal(size=(7, 20)) * 3
        got = np.asarray(project_columns_to_simplex(jnp.asarray(v)))
        want = oracle.proj_simplex_cols(v)
        np.testing.assert_allclose(got, want, atol=1e-12)

    def test_feasible(self, rng):
        v = rng.normal(size=(13, 50)) * 10
        w = np.asarray(project_columns_to_simplex(jnp.asarray(v)))
        assert (w >= 0).all()
        np.testing.assert_allclose(w.sum(axis=0), 1.0, atol=1e-10)

    def test_already_on_simplex_is_fixed_point(self, rng):
        v = rng.dirichlet(np.ones(5), size=8).T
        w = np.asarray(project_columns_to_simplex(jnp.asarray(v)))
        np.testing.assert_allclose(w, v, atol=1e-12)

    def test_single_entry(self):
        v = np.array([[3.0, -2.0]])
        w = np.asarray(project_columns_to_simplex(jnp.asarray(v)))
        np.testing.assert_allclose(w, [[1.0, 1.0]])


class TestCost:
    def test_direct(self, small_problem):
        p = small_problem
        R = np.hstack([p["R_trunc"], p["u_true"]])
        got = float(weighted_cost(p["y"], R, p["alpha"], p["d"]))
        want = oracle.cost_w(p["y"], R, p["alpha"], p["d"])
        assert got == pytest.approx(want, rel=1e-12)

    def test_gram_identity(self, small_problem):
        p = small_problem
        R = np.hstack([p["R_trunc"], p["u_true"]])
        G, b, ydy = sample_grams(jnp.asarray(R), jnp.asarray(p["d"]),
                                 jnp.asarray(p["y"]))
        got = float(weighted_cost_gram(G, b, ydy, jnp.asarray(p["alpha"])))
        want = oracle.cost_w(p["y"], R, p["alpha"], p["d"])
        assert got == pytest.approx(want, rel=1e-9)

    def test_bfloat16_storage_accurate_at_scale(self):
        # bf16 STORAGE must not contaminate the cost: all arithmetic
        # runs in float32 (ops/cost.py), so the large-n cost agrees with
        # a float64 oracle on the SAME quantized values to ~1e-3 rel —
        # the residual-in-bf16 form this replaced erred at ~1e-2.
        rng = np.random.default_rng(7)
        n, n_s, p = 400_000, 4, 6
        R16 = jnp.asarray(rng.uniform(size=(n, p)), jnp.bfloat16)
        a16 = jnp.asarray(rng.dirichlet(np.ones(p), size=n_s).T,
                          jnp.bfloat16)
        y16 = jnp.asarray(rng.uniform(size=(n, n_s)), jnp.bfloat16)
        d16 = jnp.asarray(rng.poisson(50, size=(n, n_s)) + 1.0,
                          jnp.bfloat16)
        got = float(weighted_cost(y16, R16, a16, d16))
        y64, R64, a64, d64 = (np.asarray(x, np.float64)
                              for x in (y16, R16, a16, d16))
        want = float(np.sum(d64 * (y64 - R64 @ a64) ** 2))
        assert got == pytest.approx(want, rel=1e-3)


class TestFista:
    def test_u_gram_matches_oracle(self, small_problem):
        p = small_problem
        y, d, Rt, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
        alpha = p["alpha"]
        rng = np.random.default_rng(1)
        u = rng.uniform(size=(y.shape[0], n_u))
        dmax2 = d.max() ** 2
        l_w = np.linalg.norm(alpha[-n_u:]) ** 2 * dmax2

        want_u, want_up, want_a, want_l = oracle.fista_u(
            u.copy(), alpha, 8, 1.0, l_w, l_w, u.copy(), y, Rt, n_u, d)

        C = u_constant_term(jnp.asarray(y), jnp.asarray(d),
                            jnp.asarray(Rt), jnp.asarray(alpha[:-n_u]),
                            jnp.asarray(alpha[-n_u:]))
        M = site_curvature(jnp.asarray(d), jnp.asarray(alpha[-n_u:]))
        got_u, got_up, got_a, got_l = fista.fista_u_gram(
            jnp.asarray(u), jnp.asarray(u), jnp.ones(()), l_w, l_w, C, M, 8)

        np.testing.assert_allclose(np.asarray(got_u), want_u, atol=1e-9)
        np.testing.assert_allclose(np.asarray(got_up), want_up, atol=1e-9)
        assert float(got_a) == pytest.approx(want_a)

    def test_u_direct_matches_gram(self, small_problem):
        p = small_problem
        y, d, Rt, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
        alpha = p["alpha"]
        rng = np.random.default_rng(2)
        u = jnp.asarray(rng.uniform(size=(y.shape[0], n_u)))
        dmax2 = d.max() ** 2
        l_w = np.linalg.norm(alpha[-n_u:]) ** 2 * dmax2

        C = u_constant_term(jnp.asarray(y), jnp.asarray(d), jnp.asarray(Rt),
                            jnp.asarray(alpha[:-n_u]),
                            jnp.asarray(alpha[-n_u:]))
        M = site_curvature(jnp.asarray(d), jnp.asarray(alpha[-n_u:]))
        g = fista.fista_u_gram(u, u, jnp.ones(()), l_w, l_w, C, M, 5)
        ddir = fista.fista_u_direct(u, u, jnp.ones(()), l_w, l_w,
                                    jnp.asarray(y), jnp.asarray(d),
                                    jnp.asarray(Rt),
                                    jnp.asarray(alpha[:-n_u]),
                                    jnp.asarray(alpha[-n_u:]), 5)
        np.testing.assert_allclose(np.asarray(g[0]), np.asarray(ddir[0]),
                                   atol=1e-9)

    def test_alpha_gram_matches_oracle(self, small_problem):
        p = small_problem
        y, d, Rt, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
        R = np.hstack([Rt, p["u_true"]])
        alpha = p["alpha"]
        dmax2 = d.max() ** 2
        l_h = np.linalg.norm(R) ** 2 * dmax2

        want_a, want_ap, want_t, _ = oracle.fista_alpha(
            8, alpha.copy(), 1.0, l_h, l_h, alpha.copy(), R, d, y)

        G, b, _ = sample_grams(jnp.asarray(R), jnp.asarray(d),
                               jnp.asarray(y))
        got_a, got_ap, got_t, _ = fista.fista_alpha_gram(
            jnp.asarray(alpha), jnp.asarray(alpha), jnp.ones(()),
            l_h, l_h, G, b, 8)

        np.testing.assert_allclose(np.asarray(got_a), want_a, atol=1e-9)
        np.testing.assert_allclose(np.asarray(got_ap), want_ap, atol=1e-9)
        assert float(got_t) == pytest.approx(want_t)


class TestFrankWolfe:
    @staticmethod
    def _problem(p):
        y, d, Rt, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
        rng = np.random.default_rng(3)
        u = rng.uniform(size=(y.shape[0], n_u))
        purity = rng.uniform(0.3, 0.9, size=y.shape[1])
        a1 = rng.dirichlet(np.ones(Rt.shape[1]), size=y.shape[1]).T * purity
        a2 = rng.dirichlet(np.ones(n_u), size=y.shape[1]).T * (1 - purity)
        G, b, _ = sample_grams(jnp.asarray(np.hstack([Rt, u])),
                               jnp.asarray(d), jnp.asarray(y))
        return y, d, Rt, u, purity, a1, a2, G, b

    def test_gram_matches_oracle(self, small_problem):
        y, d, Rt, u, purity, a1, a2, G, b = self._problem(small_problem)
        want1, want2 = oracle.frank_wolfe(Rt, u, y, a1, a2, purity, 30, d)
        got1, got2 = fw.frank_wolfe_gram(jnp.asarray(a1), jnp.asarray(a2),
                                         G, b, jnp.asarray(purity), 30)
        np.testing.assert_allclose(np.asarray(got1), want1, atol=1e-9)
        np.testing.assert_allclose(np.asarray(got2), want2, atol=1e-9)

    def test_recorded_vertices_rebuild_the_result(self, small_problem):
        """The oracle's recorded vertices are the ones it stepped to: with
        step 2/(k+2) the start drops out and step k's vertex carries weight
        2(k+1)/(K(K+1)). chip_smoke's recording loop picks the same ones."""
        import chip_smoke

        y, d, Rt, u, purity, a1, a2, G, b = self._problem(small_problem)
        K, (p1, n_s) = 30, a1.shape
        vertices = []
        want1, _ = oracle.frank_wolfe(Rt, u, y, a1, a2, purity, K, d,
                                      vertices)
        idx = np.stack([v for v, _ in vertices])
        assert idx.shape == (K, n_s)
        assert np.all(np.stack([m for _, m in vertices]) >= 0)
        rebuilt = np.zeros_like(a1)
        for k in range(K):
            rebuilt[idx[k], np.arange(n_s)] += 2 * (k + 1) / (K * (K + 1))
        np.testing.assert_allclose(rebuilt * purity, want1, atol=1e-12)

        _, got = chip_smoke._fw_vertices(
            jnp.asarray(np.vstack([a1, a2])), G, b, jnp.asarray(purity), K,
            p1)
        np.testing.assert_array_equal(np.asarray(got), idx)


class TestNNLS:
    def test_nnls_matches_scipy(self, rng):
        for trial in range(5):
            A = rng.normal(size=(60, 8))
            y = rng.normal(size=(60,))
            want, _ = scipy_nnls(A, y)
            got = np.asarray(nnls(jnp.asarray(A), jnp.asarray(y)))
            np.testing.assert_allclose(got, want, atol=1e-7)

    def test_wls_intercept_matches_sklearn(self, rng):
        from sklearn.linear_model import LinearRegression
        X = rng.uniform(size=(80, 5))
        yv = rng.uniform(size=(80,))
        w = rng.poisson(40, size=80).astype(float) + 1.0

        reg = LinearRegression(fit_intercept=True, positive=True).fit(
            X, yv, w)
        want = reg.coef_ / max(reg.coef_.sum(), 1e-10)
        got = np.asarray(wls_intercept(jnp.asarray(yv), jnp.asarray(w),
                                       jnp.asarray(X)))
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_batch(self, rng):
        X = rng.uniform(size=(50, 4))
        Y = rng.uniform(size=(50, 3))
        W = rng.poisson(30, size=(50, 3)).astype(float) + 1.0
        got = np.asarray(wls_intercept_batch(jnp.asarray(Y), jnp.asarray(W),
                                             jnp.asarray(X)))
        for s in range(3):
            want = np.asarray(wls_intercept(jnp.asarray(Y[:, s]),
                                            jnp.asarray(W[:, s]),
                                            jnp.asarray(X)))
            np.testing.assert_allclose(got[:, s], want, atol=1e-10)
