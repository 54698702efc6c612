"""Test config: CPU backend with 8 virtual devices (the standard JAX trick
for testing mesh/sharding code on one host), float64 enabled so
numerical-parity oracles are meaningful."""

import os
import types

# The CLI enables jax's persistent compile cache; under the suite that
# means the pytest process (in-process cli_main runs) AND concurrently
# spawned multi-process CLI runs would share one directory — concurrent
# entries have crashed the cache read. Disable it for tests (empty = off,
# see utils.enable_compile_cache); tiny CPU HLOs recompile in seconds.
os.environ["DEMETHIFY_COMPILE_CACHE"] = ""

import jax  # noqa: E402

# config.update pins the backend even where the environment pre-sets
# jax_platforms
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def small_problem(rng):
    """A tiny random weighted-NMF problem in the reference's data model."""
    n_cpg, n_s, n_ct, n_u = 120, 6, 4, 2
    R_trunc = rng.uniform(size=(n_cpg, n_ct))
    u_true = rng.uniform(size=(n_cpg, n_u))
    alpha = rng.dirichlet(np.ones(n_ct + n_u), size=n_s).T
    d = rng.poisson(50, size=(n_cpg, n_s)).astype(np.float64) + 1.0
    y = np.clip(np.hstack([R_trunc, u_true]) @ alpha
                + 0.01 * rng.normal(size=(n_cpg, n_s)), 0, 1)
    return dict(y=y, d=d, R_trunc=R_trunc, n_u=n_u, alpha=alpha,
                u_true=u_true)


COHORT_SITES = 2000
COHORT_KNOWN = 5


@pytest.fixture(scope="session")
def cohort(tmp_path_factory):
    """The seeded synthetic cohort (demethify_tpu.simulate.write_cohort) at
    test size: 2,000 sites x 10 samples, 5 known cell types + 1 hidden
    unknown. ``truth`` is the simulate.Cohort it was written from."""
    from demethify_tpu.simulate import make_cohort, write_cohort

    truth = make_cohort(COHORT_SITES, n_samples=10, n_known=COHORT_KNOWN,
                        n_unknown=1, seed=0)
    paths = write_cohort(str(tmp_path_factory.mktemp("cohort")), truth,
                         n_known=COHORT_KNOWN)
    return types.SimpleNamespace(samples=paths["samples"], ref=paths["ref"],
                                 truth=truth, n_sites=COHORT_SITES)
