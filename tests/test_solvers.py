"""Solver-level parity: full solves vs the NumPy oracle (same init)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests import oracle
from demethify_tpu.solvers.partial_ref import partial_ref_solve
from demethify_tpu.solvers.unsupervised import unsupervised_solve
from demethify_tpu.solvers.purity import purity_solve
from demethify_tpu.solvers.api import (
    deconvolve,
    partial_reference_deconv,
    supervised_deconv,
    unsupervised_deconv,
)


def _init(rng, n_cpg, p, n_u, n_s):
    u0 = rng.uniform(size=(n_cpg, n_u))
    a0 = rng.dirichlet(np.ones(p), size=n_s).T
    return u0, a0


class TestPartialRef:
    @pytest.mark.parametrize("use_gram", [True, False])
    def test_matches_oracle(self, small_problem, use_gram):
        p = small_problem
        y, d, Rt, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
        rng = np.random.default_rng(7)
        u0, a0 = _init(rng, y.shape[0], Rt.shape[1] + n_u, n_u, y.shape[1])

        R0 = np.hstack([Rt, u0])
        want_u, want_a = oracle.partial_ref_solve(
            u0.copy(), R0, a0.copy(), y, d, Rt, n_u, 40, 10, 1e-6)

        got_u, got_a, info = partial_ref_solve(
            jnp.asarray(u0), jnp.asarray(a0), jnp.asarray(y), jnp.asarray(d),
            jnp.asarray(Rt), n_u, n_iter1=40, n_iter2=10, tol=1e-6,
            use_gram_u=use_gram)

        np.testing.assert_allclose(np.asarray(got_u), want_u, atol=1e-7)
        np.testing.assert_allclose(np.asarray(got_a), want_a, atol=1e-7)

    def test_termination_matches(self, small_problem):
        p = small_problem
        y, d, Rt, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
        rng = np.random.default_rng(8)
        u0, a0 = _init(rng, y.shape[0], Rt.shape[1] + n_u, n_u, y.shape[1])
        # loose tol so it terminates early via the cost-delta test
        got_u, got_a, info = partial_ref_solve(
            jnp.asarray(u0), jnp.asarray(a0), jnp.asarray(y), jnp.asarray(d),
            jnp.asarray(Rt), n_u, n_iter1=500, n_iter2=10, tol=1.0)
        want_u, want_a = oracle.partial_ref_solve(
            u0.copy(), np.hstack([Rt, u0]), a0.copy(), y, d, Rt, n_u,
            500, 10, 1.0)
        assert int(info["n_iter"]) < 500
        np.testing.assert_allclose(np.asarray(got_u), want_u, atol=1e-7)
        np.testing.assert_allclose(np.asarray(got_a), want_a, atol=1e-7)

    def test_cost_decreases(self, small_problem):
        p = small_problem
        y, d, Rt, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
        rng = np.random.default_rng(9)
        u0, a0 = _init(rng, y.shape[0], Rt.shape[1] + n_u, n_u, y.shape[1])
        _, _, info = partial_ref_solve(
            jnp.asarray(u0), jnp.asarray(a0), jnp.asarray(y), jnp.asarray(d),
            jnp.asarray(Rt), n_u, n_iter1=30, n_iter2=10, tol=1e-8,
            record_trace=True)
        tr = np.asarray(info["trace"])
        tr = tr[~np.isnan(tr)]
        assert len(tr) > 3
        # FISTA is not strictly monotone; overall trend must decrease
        assert tr[-1] < tr[0]

    def test_simplex_feasibility(self, small_problem):
        p = small_problem
        y, d, Rt, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
        rng = np.random.default_rng(10)
        u0, a0 = _init(rng, y.shape[0], Rt.shape[1] + n_u, n_u, y.shape[1])
        got_u, got_a, _ = partial_ref_solve(
            jnp.asarray(u0), jnp.asarray(a0), jnp.asarray(y), jnp.asarray(d),
            jnp.asarray(Rt), n_u, n_iter1=20, n_iter2=5, tol=1e-8)
        got_u, got_a = np.asarray(got_u), np.asarray(got_a)
        assert (got_u >= 0).all() and (got_u <= 1).all()
        assert (got_a >= -1e-12).all()
        np.testing.assert_allclose(got_a.sum(axis=0), 1.0, atol=1e-8)


class TestUnsupervised:
    @pytest.mark.parametrize("use_gram", [True, False])
    def test_matches_oracle(self, small_problem, use_gram):
        p = small_problem
        y, d = p["y"], p["d"]
        n_u = 3
        rng = np.random.default_rng(11)
        u0 = rng.uniform(size=(y.shape[0], n_u))
        a0 = rng.dirichlet(np.ones(n_u), size=y.shape[1]).T

        want_u, want_a = oracle.unsupervised_solve(
            u0.copy(), a0.copy(), y, d, n_u, 30, 8, 1e-6)
        got_u, got_a, _ = unsupervised_solve(
            jnp.asarray(u0), jnp.asarray(a0), jnp.asarray(y), jnp.asarray(d),
            n_u, n_iter1=30, n_iter2=8, tol=1e-6, use_gram_u=use_gram)
        np.testing.assert_allclose(np.asarray(got_u), want_u, atol=1e-7)
        np.testing.assert_allclose(np.asarray(got_a), want_a, atol=1e-7)


class TestPurity:
    def test_runs_and_respects_purity_split(self, small_problem):
        p = small_problem
        y, d, Rt, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
        n_s = y.shape[1]
        rng = np.random.default_rng(12)
        purity = rng.uniform(0.2, 0.8, size=n_s)
        u0 = rng.uniform(size=(y.shape[0], n_u))
        a1 = rng.dirichlet(np.ones(Rt.shape[1]), size=n_s).T * purity
        a2 = rng.dirichlet(np.ones(n_u), size=n_s).T * (1 - purity)
        a0 = np.vstack([a1, a2])

        got_u, got_a, info = purity_solve(
            jnp.asarray(u0), jnp.asarray(a0), jnp.asarray(y), jnp.asarray(d),
            jnp.asarray(Rt), jnp.asarray(purity), n_u,
            n_iter1=10, n_iter2=50, tol=1e-8)
        got_a = np.asarray(got_a)
        # FW keeps each block's mass at its simplex scale
        np.testing.assert_allclose(got_a[:-n_u].sum(axis=0), purity,
                                   atol=1e-8)
        np.testing.assert_allclose(got_a[-n_u:].sum(axis=0), 1 - purity,
                                   atol=1e-8)

    def test_matches_oracle_one_outer(self, small_problem):
        """One outer iteration against a hand-rolled oracle iteration."""
        p = small_problem
        y, d, Rt, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
        n_s = y.shape[1]
        rng = np.random.default_rng(13)
        purity = rng.uniform(0.2, 0.8, size=n_s)
        u0 = rng.uniform(size=(y.shape[0], n_u))
        a1 = rng.dirichlet(np.ones(Rt.shape[1]), size=n_s).T * purity
        a2 = rng.dirichlet(np.ones(n_u), size=n_s).T * (1 - purity)
        a0 = np.vstack([a1, a2])

        # oracle: one outer iteration of mdwbssmf_deconv_p semantics
        dmax2 = d.max() ** 2
        l_w = np.linalg.norm(a2) ** 2 * dmax2
        wu, _, _, _ = oracle.fista_u(
            u0.copy(), a0, 20, 1.0, l_w, l_w, u0.copy(), y, Rt, n_u, d)
        wa1, wa2 = oracle.frank_wolfe(Rt, wu, y, a1, a2, purity, 20, d)

        got_u, got_a, _ = purity_solve(
            jnp.asarray(u0), jnp.asarray(a0), jnp.asarray(y), jnp.asarray(d),
            jnp.asarray(Rt), jnp.asarray(purity), n_u,
            n_iter1=1, n_iter2=20, tol=1e-12)
        np.testing.assert_allclose(np.asarray(got_u), wu, atol=1e-8)
        np.testing.assert_allclose(np.asarray(got_a), np.vstack([wa1, wa2]),
                                   atol=1e-8)


class TestAPI:
    def test_supervised(self, small_problem):
        p = small_problem
        R = np.hstack([p["R_trunc"], p["u_true"]])
        res = supervised_deconv(jnp.asarray(p["y"]), jnp.asarray(p["d"]),
                                jnp.asarray(R))
        props = np.asarray(res.proportions)
        assert props.shape == (R.shape[1], p["y"].shape[1])
        np.testing.assert_allclose(props.sum(axis=0), 1.0, atol=1e-6)
        # recovers the generating proportions reasonably well
        rmse = np.sqrt(np.mean((props - p["alpha"]) ** 2))
        assert rmse < 0.05

    def test_restarts_pick_best(self, small_problem):
        p = small_problem
        res1 = partial_reference_deconv(
            jnp.asarray(p["y"]), jnp.asarray(p["d"]),
            jnp.asarray(p["R_trunc"]), p["n_u"], n_restarts=1,
            n_iter1=20, n_iter2=5, seed=0)
        res4 = partial_reference_deconv(
            jnp.asarray(p["y"]), jnp.asarray(p["d"]),
            jnp.asarray(p["R_trunc"]), p["n_u"], n_restarts=4,
            n_iter1=20, n_iter2=5, seed=0)
        assert res4.cost <= res1.cost + 1e-6

    def test_dispatch(self, small_problem):
        p = small_problem
        y, d = jnp.asarray(p["y"]), jnp.asarray(p["d"])
        R = jnp.asarray(np.hstack([p["R_trunc"], p["u_true"]]))
        assert deconvolve(y, d, R).u is None
        r = deconvolve(y, d, jnp.asarray(p["R_trunc"]), n_u=1,
                       n_iter1=5, n_iter2=3)
        assert r.u is not None and r.u.shape[1] == 1
        r = deconvolve(y, d, n_u=2, n_iter1=5, n_iter2=3)
        assert r.proportions.shape[0] == 2


class TestReviewRegressions:
    """Regressions for the code-review findings."""

    def test_nan_restart_never_wins(self):
        import jax.numpy as jnp
        from demethify_tpu.solvers.api import _select_best
        u_b = jnp.zeros((3, 4, 1))
        a_b = jnp.zeros((3, 2, 2))
        info = {"cost": jnp.asarray([1.0, jnp.nan, 0.5]),
                "n_iter": jnp.asarray([5, 5, 5]),
                "trace": jnp.zeros((3, 0))}
        _, _, best = _select_best(u_b, a_b, info)
        assert float(best["cost"]) == 0.5

    def test_svd_fallback_counts_as_random(self):
        from demethify_tpu.solvers.api import _is_deterministic
        assert _is_deterministic("SVD", 2, 10, None)
        assert not _is_deterministic("SVD", 12, 10, None)  # fallback
        assert not _is_deterministic("uniform_", 1, 10, None)
        assert _is_deterministic("uniform_", 1, 10, ("u", "a"))


class TestBfloat16Storage:
    """bfloat16 storage with float32 accumulation must stay close to the
    float32 solve — README's mixed-precision claim."""

    def _solve_pair(self, small_problem, solver, extra=()):
        p = small_problem
        rng = np.random.default_rng(11)
        u0, a0 = _init(rng, p["y"].shape[0], p["R_trunc"].shape[1]
                       + p["n_u"], p["n_u"], p["y"].shape[1])
        args32 = [jnp.asarray(x, jnp.float32) for x in
                  (u0, a0, p["y"], p["d"], p["R_trunc"])]
        u32, a32, _ = solver(*args32, *extra, p["n_u"],
                             n_iter1=30, n_iter2=5, tol=0.0)
        args16 = [args32[0], args32[1],
                  jnp.asarray(p["y"], jnp.bfloat16),
                  jnp.asarray(p["d"], jnp.bfloat16), args32[4]]
        u16, a16, _ = solver(*args16, *extra, p["n_u"],
                             n_iter1=30, n_iter2=5, tol=0.0)
        return np.asarray(a32), np.asarray(a16, dtype=np.float32)

    def test_xla_path(self, small_problem):
        a32, a16 = self._solve_pair(small_problem, partial_ref_solve)
        assert np.abs(a32 - a16).max() < 0.05
        np.testing.assert_allclose(a16.sum(axis=0), 1.0, atol=1e-3)
