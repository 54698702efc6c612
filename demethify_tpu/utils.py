"""Observability utilities: the reference only writes total wall time to
log.log (`demethify/demethify.py:229-233`); here cost trajectories,
device profiling, throughput counters, and NaN debugging are first-class
(SURVEY.md §5).
"""

import contextlib
import importlib
import os
import time
from typing import Optional

import numpy as np


# <checkout>/.jax_cache: a fixed path, because the path is part of the
# cache key — a directory that moves never hits.
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable_compile_cache():
    """Persistent XLA compile cache: in ``JAX_COMPILATION_CACHE_DIR`` when
    that is set, else in ``DEFAULT_COMPILE_CACHE``. Returns the directory,
    or None when disabled.

    ``DEMETHIFY_COMPILE_CACHE=""`` disables the cache. Concurrent writers
    of one directory can poison entries (a corrupted entry crashes jax's
    cache read on every later hit), so the test suite, whose multi-process
    tests spawn concurrent CLI runs, turns it off."""
    import jax

    if os.environ.get("DEMETHIFY_COMPILE_CACHE") == "":
        return None
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or \
        DEFAULT_COMPILE_CACHE
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def optional_import(module: str, feature: str):
    """Import a package that only ``feature`` needs, failing with a clear
    message when it is not installed (the plain CLI path needs none)."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"{feature} needs the optional package '{module}', which is "
            f"not installed (pip install 'demethify-tpu[extras]')") from e


def enable_nan_debugging():
    """The functional-purity analog of a race detector for this framework:
    every jitted computation checks for NaNs and raises at the op that
    produced them (`jax_debug_nans`)."""
    import jax

    jax.config.update("jax_debug_nans", True)


@contextlib.contextmanager
def device_profile(outdir: Optional[str]):
    """JAX profiler trace around a block; view with TensorBoard or xprof.
    No-op when outdir is None."""
    if not outdir:
        yield
        return
    import jax

    os.makedirs(outdir, exist_ok=True)
    with jax.profiler.trace(outdir):
        yield


class SolveStats:
    """Throughput accounting for a solver run, written to log.log."""

    def __init__(self, n_cpg: int, n_samples: int):
        self.n_cpg = n_cpg
        self.n_samples = n_samples
        self._t0 = time.time()
        self.elapsed = None
        self.outer_iters = 0

    def finish(self, outer_iters: int):
        self.elapsed = time.time() - self._t0
        self.outer_iters = int(outer_iters)
        return self

    @property
    def site_iters_per_s(self) -> float:
        if not self.elapsed:
            return 0.0
        return self.n_cpg * max(self.outer_iters, 1) / self.elapsed

    def summary(self) -> str:
        return (f"solver: {self.outer_iters} outer iterations in "
                f"{self.elapsed:.3f}s = "
                f"{self.site_iters_per_s/1e6:.1f}M site-iters/s "
                f"(wall time incl. compilation; see bench.py for warm "
                f"device throughput)")


def write_cost_trace(outdir: str, trace, name: str = "cost_trajectory.csv"):
    """Persist a solver's cost trajectory (NaN-padded trace from
    record_trace=True) for convergence inspection/parity checking."""
    tr = np.asarray(trace, dtype=np.float64)
    tr = tr[~np.isnan(tr)]
    path = os.path.join(outdir, name)
    with open(path, "w") as f:
        f.write("iteration,cost\n")
        for i, c in enumerate(tr):
            f.write(f"{i},{c}\n")
    return path


def termination_resolution_warning(tol: float, cost_scale: float,
                                   compute_dtype) -> Optional[str]:
    """Detect an unresolvable absolute termination test BEFORE the solve.

    The solvers stop on ``|cf - cf_prev| < tol`` (reference semantics,
    `demethify/deconvolution.py:218-221`). At megabase scale the cost
    magnitude grows with n_cpg, and once ``tol`` falls below the floating
    point resolution of the cost (one ulp at ``cost_scale``) the test
    can only fire on an exact bitwise cost plateau: the run silently
    degrades to a (near-)fixed n_iter1-iteration run. Returns a user-facing
    warning in that case, else None. ``cost_scale`` should be an upper
    estimate of the initial cost — sum(D * Y^2) (the cost at alpha = 0)
    works and needs no init."""
    import jax.numpy as jnp

    if cost_scale <= 0.0 or tol <= 0.0:
        return None
    eps = float(jnp.finfo(jnp.dtype(compute_dtype)).eps)
    floor = cost_scale * eps
    if tol >= floor:
        return None
    return (f"Warning: --termination {tol:g} is below the "
            f"{jnp.dtype(compute_dtype).name} resolution of the cost "
            f"(~{floor:.3g} at cost magnitude {cost_scale:.3g}); the "
            f"|delta cost| test can only fire on an exact cost plateau "
            f"and the run will likely iterate to the n_iter1 cap. "
            f"Pass --reltol to interpret "
            f"--termination as a fraction of the initial cost, or "
            f"--dtype float64.")
