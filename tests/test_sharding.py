"""Multi-device sharding tests on the 8-virtual-CPU mesh: sharded solves
must agree with single-device solves and actually distribute the data."""

import numpy as np
import jax
import pytest
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from demethify_tpu.parallel.mesh import (
    CPG_AXIS,
    REPLICATE_AXIS,
    cpg_sharding,
    factor_devices,
    make_mesh,
    pad_to_multiple,
    shard_dataset,
)
from demethify_tpu.ops.gram import sample_grams
from demethify_tpu.ops.nnls import wls_intercept_batch
from demethify_tpu.solvers.partial_ref import partial_ref_solve
from demethify_tpu.solvers.purity import purity_solve
from demethify_tpu.solvers.unsupervised import unsupervised_solve


def _problem(n_cpg=256, n_s=4, n_ct=3, n_u=1, seed=0):
    rng = np.random.default_rng(seed)
    Rt = rng.uniform(size=(n_cpg, n_ct))
    alpha = rng.dirichlet(np.ones(n_ct + n_u), size=n_s).T
    ut = rng.uniform(size=(n_cpg, n_u))
    y = np.clip(np.hstack([Rt, ut]) @ alpha
                + 0.01 * rng.normal(size=(n_cpg, n_s)), 0, 1)
    d = (rng.poisson(50, size=(n_cpg, n_s)) + 1).astype(np.float64)
    u0 = rng.uniform(size=(n_cpg, n_u))
    a0 = rng.dirichlet(np.ones(n_ct + n_u), size=n_s).T
    return y, d, Rt, u0, a0


def test_factor_devices():
    assert factor_devices(8) == (2, 4)
    assert factor_devices(8, replicate=4) == (4, 2)
    assert factor_devices(1) == (1, 1)


def test_pad_to_multiple():
    x = np.ones((10, 3))
    p, n = pad_to_multiple(x, 4)
    assert p.shape == (12, 3) and n == 10
    assert (p[10:] == 0).all()


def test_sharded_grams_match_local():
    mesh = make_mesh(jax.devices())
    y, d, Rt, u0, _ = _problem()
    R = np.hstack([Rt, u0])
    y_s, d_s, R_s = shard_dataset(mesh, y, d, R)
    G_l, b_l, ydy_l = sample_grams(jnp.asarray(R), jnp.asarray(d),
                                   jnp.asarray(y))
    G_s, b_s, ydy_s = jax.jit(sample_grams)(R_s, d_s, y_s)
    np.testing.assert_allclose(np.asarray(G_s), np.asarray(G_l), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(b_s), np.asarray(b_l), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(ydy_s), np.asarray(ydy_l),
                               rtol=1e-10)


def test_sharded_solve_matches_single_device():
    mesh = make_mesh(jax.devices())
    y, d, Rt, u0, a0 = _problem()
    n_u = u0.shape[1]

    u_ref, a_ref, info_ref = partial_ref_solve(
        jnp.asarray(u0), jnp.asarray(a0), jnp.asarray(y), jnp.asarray(d),
        jnp.asarray(Rt), n_u, n_iter1=15, n_iter2=5, tol=1e-9)

    y_s, d_s, Rt_s = shard_dataset(mesh, y, d, Rt)
    u0_s = jax.device_put(u0, cpg_sharding(mesh))
    a0_s = jax.device_put(a0, NamedSharding(mesh, P()))
    u_sh, a_sh, info_sh = partial_ref_solve(
        u0_s, a0_s, y_s, d_s, Rt_s, n_u, n_iter1=15, n_iter2=5, tol=1e-9)

    np.testing.assert_allclose(np.asarray(u_sh), np.asarray(u_ref),
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(a_sh), np.asarray(a_ref),
                               atol=1e-9)
    np.testing.assert_allclose(float(info_sh["cost"]),
                               float(info_ref["cost"]), rtol=1e-9)
    # the factor output really lives distributed across devices
    assert len(u_sh.sharding.device_set) > 1


def test_sharded_supervised_matches():
    mesh = make_mesh(jax.devices())
    y, d, Rt, _, _ = _problem(n_cpg=200)
    want = np.asarray(wls_intercept_batch(jnp.asarray(d * y),
                                          jnp.asarray(d), jnp.asarray(Rt)))
    y_s, d_s, Rt_s = shard_dataset(mesh, y, d, Rt)
    got = np.asarray(jax.jit(wls_intercept_batch)(d_s * y_s, d_s, Rt_s))
    np.testing.assert_allclose(got, want, atol=1e-9)


def _shard_inputs(mesh, y, d, Rt, u0, a0):
    out = shard_dataset(mesh, y, d, Rt)
    u0_s = jax.device_put(u0, cpg_sharding(mesh))
    a0_s = jax.device_put(a0, NamedSharding(mesh, P()))
    return (*out, u0_s, a0_s)


def test_sharded_unsupervised_matches_local():
    mesh = make_mesh(jax.devices())
    y, d, _, u0, a0 = _problem(n_ct=0, n_u=4)
    n_u = 4
    u_ref, a_ref, info_ref = unsupervised_solve(
        jnp.asarray(u0), jnp.asarray(a0), jnp.asarray(y), jnp.asarray(d),
        n_u, n_iter1=12, n_iter2=5, tol=1e-9)
    y_s, d_s, _, u0_s, a0_s = _shard_inputs(mesh, y, d, None, u0, a0)
    u_sh, a_sh, info_sh = unsupervised_solve(
        u0_s, a0_s, y_s, d_s, n_u, n_iter1=12, n_iter2=5, tol=1e-9)
    np.testing.assert_allclose(np.asarray(u_sh), np.asarray(u_ref),
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(a_sh), np.asarray(a_ref),
                               atol=1e-9)
    np.testing.assert_allclose(float(info_sh["cost"]),
                               float(info_ref["cost"]), rtol=1e-9)


def test_sharded_purity_matches_local():
    mesh = make_mesh(jax.devices())
    y, d, Rt, u0, a0 = _problem()
    n_u = u0.shape[1]
    purity = np.full(y.shape[1], 0.35)
    u_ref, a_ref, info_ref = purity_solve(
        jnp.asarray(u0), jnp.asarray(a0), jnp.asarray(y), jnp.asarray(d),
        jnp.asarray(Rt), jnp.asarray(purity), n_u,
        n_iter1=8, n_iter2=12, tol=1e-9)
    y_s, d_s, Rt_s, u0_s, a0_s = _shard_inputs(mesh, y, d, Rt, u0, a0)
    u_sh, a_sh, info_sh = purity_solve(
        u0_s, a0_s, y_s, d_s, Rt_s, jnp.asarray(purity), n_u,
        n_iter1=8, n_iter2=12, tol=1e-9)
    np.testing.assert_allclose(np.asarray(u_sh), np.asarray(u_ref),
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(a_sh), np.asarray(a_ref),
                               atol=1e-9)


def test_bootstrap_replicate_sharded_matches_local():
    # CLI --shard routes bootstrap onto replicate-axis device
    # parallelism (data replicated); CIs must equal the single-device
    # batch exactly (identical per-replicate keys)
    from demethify_tpu.uncertainty.bootstrap import bootstrap_ci

    y, d, Rt, _, _ = _problem(n_cpg=96)
    kwargs = dict(level=90, n_bootstrap=5, n_iter1=8, n_iter2=4,
                  tol=1e-9, key=jax.random.PRNGKey(5))
    want = bootstrap_ci(y, d, Rt, 1, **kwargs)
    got = bootstrap_ci(y, d, Rt, 1, devices=jax.devices(), **kwargs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   atol=1e-12)
    # supervised mode too (n_u = 0 path)
    want0 = bootstrap_ci(y, d, Rt, 0, **kwargs)
    got0 = bootstrap_ci(y, d, Rt, 0, devices=jax.devices(), **kwargs)
    np.testing.assert_allclose(np.asarray(got0[0]), np.asarray(want0[0]),
                               atol=1e-12)


def test_dryrun_entrypoints():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    ge.dryrun_multichip(len(jax.devices()))


def _solver(mode, y, d, Rt, n_u, **kw):
    """One mode's XLA solver as f(u0, a0) -> (u, alpha, info)."""
    if mode == "partial":
        return lambda u0, a0: partial_ref_solve(u0, a0, y, d, Rt, n_u, **kw)
    if mode == "purity":
        purity = jnp.full((y.shape[1],), 0.35, y.dtype)
        return lambda u0, a0: purity_solve(u0, a0, y, d, Rt, purity, n_u,
                                           **kw)
    return lambda u0, a0: unsupervised_solve(u0, a0, y, d, n_u, **kw)


_MODES = {"partial": dict(n_ct=3, n_u=1, n_iter2=5),
          "purity": dict(n_ct=3, n_u=1, n_iter2=10),
          "unsupervised": dict(n_ct=0, n_u=2, n_iter2=5)}


class TestShardedRestarts:
    """Restarts are a vmap of the one XLA solver per mode; on row-sharded
    inputs the vmapped solve must reproduce the single-device batch, with
    the factors left distributed."""

    @pytest.mark.parametrize("mode", sorted(_MODES))
    def test_vmapped_restarts_match_local(self, mode):
        cfg = _MODES[mode]
        n_u = cfg["n_u"]
        y, d, Rt, _, _ = _problem(n_ct=max(cfg["n_ct"], 1), n_u=n_u)
        if cfg["n_ct"] == 0:
            Rt = None
        n_cpg, n_s = y.shape
        p_full = cfg["n_ct"] + n_u
        rng = np.random.default_rng(21)
        u0_b = rng.uniform(size=(3, n_cpg, n_u))
        a0_b = np.stack([rng.dirichlet(np.ones(p_full), size=n_s).T
                         for _ in range(3)])
        if mode == "purity":
            a0_b[:, :-n_u] *= 0.65 / a0_b[:, :-n_u].sum(axis=1,
                                                        keepdims=True)
            a0_b[:, -n_u:] = 0.35
        kw = dict(n_iter1=8, n_iter2=cfg["n_iter2"], tol=1e-9,
                  record_trace=True)
        local = [None if x is None else jnp.asarray(x) for x in (y, d, Rt)]
        want = jax.vmap(_solver(mode, *local, n_u, **kw))(
            jnp.asarray(u0_b), jnp.asarray(a0_b))

        mesh = make_mesh(jax.devices())
        y_s, d_s, Rt_s = shard_dataset(mesh, y, d, Rt)
        u0_s = jax.device_put(u0_b, NamedSharding(
            mesh, P(None, CPG_AXIS, None)))
        a0_s = jax.device_put(a0_b, NamedSharding(mesh, P()))
        got = jax.vmap(_solver(mode, y_s, d_s, Rt_s, n_u, **kw))(u0_s,
                                                                 a0_s)
        np.testing.assert_allclose(np.asarray(got[0]),
                                   np.asarray(want[0]), atol=1e-8)
        np.testing.assert_allclose(np.asarray(got[1]),
                                   np.asarray(want[1]), atol=1e-8)
        np.testing.assert_allclose(np.asarray(got[2]["trace"]),
                                   np.asarray(want[2]["trace"]),
                                   rtol=1e-8)
        assert len(got[0].sharding.device_set) > 1

    @pytest.mark.parametrize("mode", sorted(_MODES))
    def test_api_restarts_on_sharded_inputs(self, mode):
        # the public restart API on row-sharded inputs picks a finite
        # best member and keeps it row-sharded
        from demethify_tpu.solvers.api import deconvolve

        cfg = _MODES[mode]
        n_u = cfg["n_u"]
        y, d, Rt, _, _ = _problem(n_u=n_u)
        mesh = make_mesh(jax.devices())
        y_s, d_s, Rt_s = shard_dataset(mesh, y, d, Rt)
        purity = np.full(y.shape[1], 0.35) if mode == "purity" else None
        res = deconvolve(y_s, d_s, None if cfg["n_ct"] == 0 else Rt_s,
                         n_u=n_u, purity=purity, n_restarts=3, n_iter1=6,
                         n_iter2=cfg["n_iter2"], tol=1e-9, seed=2)
        assert np.isfinite(res.cost)
        assert res.u.shape == (y.shape[0], n_u)
        assert len(res.u.sharding.device_set) > 1
        np.testing.assert_allclose(
            np.asarray(res.proportions).sum(axis=0), 1.0, atol=1e-9)
