"""Benchmark: partial-reference solver throughput on one GPU.

Workload: 1M CpG sites x 10 samples, 5 known cell types + 1 unknown —
megabase-scale version of the reference's fixture workload
(`test/output_partial_ref`, 10000/20 iterations). Fixed 1000 outer x 20
inner iterations (tol=0, so both implementations do identical work).

Baseline: the reference implementation's dataflow (NumPy, same update
math — the reference's Numba kernels delegate these matmuls to BLAS, so
NumPy wall-clock is representative of the reference on this machine's CPU),
timed on a subset of iterations and scaled.

Prints the device (platform, device kind, count, and the card's name and
power limit from nvidia-smi), then ONE JSON line:
  metric     = CpG-site-iterations/s on the device in the solver loop
  value      = n_cpg * n_outer / t_device   (median of REPS runs)
  vs_baseline= CPU-reference-seconds / device-seconds  (same workload)
  rep_seconds= every run, for the spread
Exits non-zero, before any timing, unless JAX's device is a GPU.
"""

import json
import subprocess
import sys
import time

import numpy as np

N_CPG = 1_000_000
N_S = 10
N_CT = 5
N_U = 1
N_OUTER = 1000
N_INNER = 20
BASELINE_OUTER = 3  # numpy iterations actually timed, scaled to N_OUTER
REPS = 5


def make_problem(dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    Rt = rng.uniform(size=(N_CPG, N_CT)).astype(dtype)
    at = rng.dirichlet(np.ones(N_CT + N_U), size=N_S).T.astype(dtype)
    ut = rng.uniform(size=(N_CPG, N_U)).astype(dtype)
    y = np.clip(np.hstack([Rt, ut]) @ at
                + 0.01 * rng.normal(size=(N_CPG, N_S)), 0, 1).astype(dtype)
    d = (rng.poisson(50, size=(N_CPG, N_S)) + 1).astype(dtype)
    u0 = rng.uniform(size=(N_CPG, N_U)).astype(dtype)
    a0 = rng.dirichlet(np.ones(N_CT + N_U), size=N_S).T.astype(dtype)
    return y, d, Rt, u0, a0


def numpy_reference_seconds(y, d, Rt, u0, a0):
    """Reference-dataflow BCD (mdwbssmf_deconv semantics), BASELINE_OUTER
    outer iterations, scaled to N_OUTER."""
    from tests.oracle import partial_ref_solve as oracle_solve

    R0 = np.hstack([Rt, u0])
    t = time.perf_counter()
    oracle_solve(u0.copy(), R0, a0.copy(), y, d, Rt, N_U,
                 BASELINE_OUTER, N_INNER, 0.0)
    return (time.perf_counter() - t) * (N_OUTER / BASELINE_OUTER)


def device_seconds(y, d, Rt, u0, a0):
    """Returns (median_seconds, all_rep_seconds)."""
    import jax

    from demethify_tpu.solvers.partial_ref import partial_ref_solve

    args = [jax.device_put(x) for x in (u0, a0, y, d, Rt)]
    jax.block_until_ready(args)

    def run():
        return jax.block_until_ready(partial_ref_solve(
            *args, N_U, n_iter1=N_OUTER, n_iter2=N_INNER, tol=0.0))

    run()  # compile + warm
    times = []
    for _ in range(REPS):
        t = time.perf_counter()
        run()
        times.append(time.perf_counter() - t)
    return float(np.median(times)), times


def gpu_or_exit():
    """The device, after printing what it is; exits unless it is a GPU."""
    import jax

    dev = jax.devices()[0]
    print(f"device: platform {dev.platform}, kind {dev.device_kind}, "
          f"count {len(jax.devices())}", flush=True)
    if dev.platform != "gpu":
        sys.stderr.write("bench: needs a GPU\n")
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    return dev


def main():
    from demethify_tpu.utils import enable_compile_cache

    dev = gpu_or_exit()
    enable_compile_cache()
    y, d, Rt, u0, a0 = make_problem()
    t_cpu = numpy_reference_seconds(y, d, Rt, u0, a0)
    t_dev, reps = device_seconds(y, d, Rt, u0, a0)
    print(json.dumps({
        "metric": "CpG-site-iterations/s (partial-ref solver loop, "
                  "1M sites x 10 samples, 1000x20 iters)",
        "value": N_CPG * N_OUTER / t_dev,
        "unit": "site-iters/s",
        "vs_baseline": t_cpu / t_dev,
        "rep_seconds": reps,
        "device": {"platform": dev.platform, "kind": dev.device_kind},
    }))


if __name__ == "__main__":
    main()
