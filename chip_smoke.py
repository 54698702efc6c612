"""Proof that the deconvolution CLI runs end to end on one NVIDIA GPU.

    python chip_smoke.py                 # every phase, one card
    python chip_smoke.py --four-cards    # only the row-sharded 4-card run
                                         # and its one-card comparison

Phases, all in this one process (a JAX process reserves most of the card):

  device  the card's name and power limit, device kind, JAX version;
  cohort  a seeded 1M-site x 10-sample cohort (5 known cell types + 1
          hidden unknown, coverage Poisson(50)+1) written as bedmethyl
          files under .smoke/ (simulate.write_cohort);
  kernel  the Triton-route alpha-FISTA / Frank-Wolfe kernels against the
          jnp loops at the solver's shapes, both timed, then the whole
          1M-site partial-reference and purity solves with the kernels
          and without;
  cli     cli.main in-process on the cohort for six invocations, each
          checked for parseable outputs, constraints and recovery of the
          simulated truth, and the partial-reference run once more, to
          see whether it repeats;
  oracle  each iterative mode for 20 outer iterations in f32 on the card
          against tests/oracle.py in float64 on the host, on three
          slices of the cohort, at the pinned precision (checked) and at
          XLA's default (logged); for purity also the vertex choices of
          the last Frank-Wolfe loop, f32 against float64;
  ugram   one outer iteration's C/M build, U FISTA and Gram pass against
          its byte bound, at full f32 precision and at XLA's default.

``--four-cards`` runs ``cli.main --shard`` on 4 cards (partial reference,
4M sites = 1M rows per card, 200 x 20 iterations at tol 0) and the same
problem on one card, and compares proportions and cost.

Times are host-clock medians around block_until_ready. The last line of
standard output is {"ok": true, "device": {...}}; any failure raises, so
the script exits non-zero and prints no such line. It also exits non-zero
before any work when JAX finds no GPU.
"""

import argparse
import contextlib
import csv
import filecmp
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")

N_SITES = 1_000_000
FOUR_CARD_SITES = 4_000_000
ORACLE_SITES = 20_000
N_SAMPLES = 10
N_KNOWN = 5
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet

# Recovery of the simulated truth, RMSE of the proportions. Supervised
# mode fits the 5 known types while the data holds a sixth: its bound is
# against the known rows renormalized (the intercept absorbs the sixth's
# mean). A purity run pins the unknown's share and is as tight. With a
# free unknown the model is identified only by the [0, 1] box on U: the
# unknown can absorb a zero-sum mix of known profiles, so the proportions
# bound is loose there, and every iterative run is also held to the
# noise-free mixture profiles @ truth, which its fit [R U] alpha must
# approach more closely than the observed fractions do.
PROPS_RMSE = {"ref": 0.01, "purity": 0.01, "partial": 0.1, "restart": 0.1,
              "confidence": 0.1}
# the Triton kernels against the jnp loops, f32 on the card: the sums run
# in another order (per-column reductions vs XLA's dots), nothing else
KERNEL_ALPHA_TOL = 1e-5
KERNEL_FW_COST_RTOL = 1e-5
FEASIBILITY_TOL = 1e-5
# f32 on the card against the float64 oracle after 20 outer iterations,
# max |proportion diff| and relative cost diff: rounding (f32 vs f64) and
# reduction order differ, and the BCD carries them through 20 x 20
# coupled steps. Each limit sits 1.8-2.8x above the largest of 16
# readings (8 slices, run twice on an H100 80GB HBM3); for partial and
# unsupervised it sits below what slices 0-2 read with TF32 contractions
# (Precision.DEFAULT), which the pinned precision is there to exclude.
# Purity reads larger: a Frank-Wolfe loop ends on a zigzag between
# near-tied vertices whose last steps weigh ~2/500, rounding flips some
# of them (at f64 margins of 3e-8 to 5e-7 of max |b|), and the difference
# moves the solution along a near-flat direction of the model (U absorbs
# a zero-sum mix of known profiles: max |U diff| reaches 0.009). So its
# whole-run limits are loose, and its alpha step is held instead to the
# last loop rerun in f32 from the oracle's own inputs, compared on the
# cost that loop minimizes (largest reading 1.8e-7, limit 5x that).
ORACLE_SLICES = 3
ORACLE_PROPS_TOL = {"partial": 6e-5, "unsupervised": 1.2e-4,
                    "purity": 1e-2}
ORACLE_COST_RTOL = {"partial": 1e-5, "unsupervised": 2e-5, "purity": 3e-4}
FW_LOOP_COST_RTOL = 1e-6
# --shard on 4 cards against one card after 200 outer iterations: the
# cross-card sums add in another order
FOUR_CARD_PROPS_TOL = 1e-3
FOUR_CARD_COST_RTOL = 1e-5


def log(*parts):
    print(*parts, flush=True)


def _timed(fn, *args, reps):
    """Median seconds per call over ``reps`` calls, each to completion."""
    import jax

    out = None
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def _alternate(label, fns, args, reps, unit=1e6, unit_name="us"):
    """Time ``fns`` ({"jnp": f, "kernel": g}) in the order jnp, kernel,
    kernel, jnp, each compiled first; logs and returns the medians."""
    import jax

    def fmt(ts):
        return "[" + ", ".join(f"{t * unit:.4g}" for t in ts) + "]"

    for fn in fns.values():
        jax.block_until_ready(fn(*args))
    got = {name: [] for name in fns}
    for name in ("jnp", "kernel", "kernel", "jnp"):
        got[name].append(_timed(fns[name], *args, reps=reps)[0])
    log(f"  {label}: jnp {fmt(got['jnp'])} {unit_name}, kernel "
        f"{fmt(got['kernel'])} {unit_name}, jnp/kernel "
        f"{np.median(got['jnp']) / np.median(got['kernel']):.2f}")
    return got


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------

def gpu_or_exit():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.stderr.write(f"chip_smoke: needs a GPU, JAX found "
                         f"'{dev.platform}'\n")
        sys.exit(2)
    return dev


def phase_device(dev):
    import jax

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"nvidia-smi: {smi}")
    log(f"jax {jax.__version__}, device_kind {dev.device_kind}, "
        f"{len(jax.devices())} device(s), "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")


def _peak_gib(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 2**30


# ---------------------------------------------------------------------------
# cohort
# ---------------------------------------------------------------------------

def phase_cohort(n_sites, outdir, seed=0):
    """Generate and write the cohort; returns (paths, truth)."""
    import concurrent.futures
    import multiprocessing

    from demethify_tpu.simulate import make_cohort, write_cohort

    t0 = time.perf_counter()
    truth = make_cohort(n_sites, n_samples=N_SAMPLES, n_known=N_KNOWN,
                        n_unknown=1, seed=seed)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    workers = min(N_SAMPLES + 1, os.cpu_count() or 1)
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        paths = write_cohort(outdir, truth, N_KNOWN, executor=ex)
    t_write = time.perf_counter() - t0
    log(f"cohort: {n_sites} sites x {N_SAMPLES} samples, {N_KNOWN} known "
        f"+ 1 unknown: generated in {t_gen:.2f} s, written in "
        f"{t_write:.2f} s ({workers} writers)")
    return paths, truth


def _load(paths, n_rows=None):
    """(y, d, R) of the cohort as float32 host arrays, first ``n_rows``."""
    from demethify_tpu.io.readers import load_dataset

    ds = load_dataset(paths["samples"], ref=paths["ref"], bedmethyl=True,
                      dtype=np.float32)
    rows = slice(None, n_rows)
    return ds.meth_f[rows], ds.counts[rows], ds.ref[rows]


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------

def _gram_problem(p, n_s, members, seed, n_rows=4096):
    """Per-sample Grams of a random weighted problem, and ``members``
    feasible alpha starts (members, p, n_s)."""
    import jax.numpy as jnp

    from demethify_tpu.ops.gram import sample_grams

    rng = np.random.default_rng(seed)
    R = rng.uniform(size=(n_rows, p))
    d = rng.poisson(50, size=(n_rows, n_s)) + 1.0
    y = np.clip(R @ rng.dirichlet(np.ones(p), size=n_s).T
                + 0.05 * rng.normal(size=(n_rows, n_s)), 0, 1)
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    G, b, ydy = sample_grams(f32(R), f32(d), f32(y))
    l_h = f32(np.sum(R * R) * d.max() ** 2)
    alphas = f32(np.stack([rng.dirichlet(np.ones(p), size=n_s).T
                           for _ in range(members)]))
    purity = f32(rng.uniform(0.3, 0.9, size=n_s))
    return G, b, ydy, l_h, alphas, purity


def _fista_fns(G, b, l_h, steps, interpret):
    import jax
    import jax.numpy as jnp

    from demethify_tpu.ops import pallas_small
    from demethify_tpu.ops.fista import fista_alpha_gram

    one = jnp.ones((), jnp.float32)

    def xla(a):
        return fista_alpha_gram(a, a, one, l_h, l_h, G, b, steps)[0]

    def kern(a):
        return pallas_small.fista_alpha(a, a, one, l_h, l_h, G, b, steps,
                                        interpret=interpret)[0]

    return {"jnp": jax.jit(jax.vmap(xla)), "kernel": jax.jit(jax.vmap(kern))}


def _fw_fns(G, b, purity, steps, p1, interpret):
    import jax
    import jax.numpy as jnp

    from demethify_tpu.ops import pallas_small
    from demethify_tpu.ops.frank_wolfe import frank_wolfe_gram

    def split(a):
        a1 = a[:p1] / jnp.sum(a[:p1], axis=0) * purity
        a2 = a[p1:] / jnp.sum(a[p1:], axis=0) * (1.0 - purity)
        return a1, a2

    def xla(a):
        return jnp.concatenate(frank_wolfe_gram(*split(a), G, b, purity,
                                                steps))

    def kern(a):
        return jnp.concatenate(pallas_small.frank_wolfe(
            *split(a), G, b, purity, steps, interpret=interpret))

    return {"jnp": jax.jit(jax.vmap(xla)), "kernel": jax.jit(jax.vmap(kern))}


def phase_kernel_loops(interpret=False, reps=50):
    """Kernel vs jnp loop: agreement, then timing, at the solver's
    shapes (p, n_s, steps, members)."""
    import jax.numpy as jnp

    from demethify_tpu.ops.cost import weighted_cost_gram

    log("kernel: alpha FISTA (p, n_s, steps, members)")
    for p, n_s, steps, members in [(6, 10, 20, 1), (6, 10, 20, 16),
                                   (29, 64, 20, 1)]:
        G, b, _, l_h, alphas, _ = _gram_problem(p, n_s, members, seed=p)
        fns = _fista_fns(G, b, l_h, steps, interpret)
        err = float(jnp.max(jnp.abs(fns["jnp"](alphas)
                                    - fns["kernel"](alphas))))
        label = f"({p}, {n_s}, {steps}, {members})"
        log(f"  {label}: max |alpha diff| {err:.3g} "
            f"(tol {KERNEL_ALPHA_TOL:g})")
        assert err <= KERNEL_ALPHA_TOL, (label, err)
        _alternate(label, fns, (alphas,), reps)

    log("kernel: Frank-Wolfe (p, n_s, steps, members)")
    for p, n_s, steps, members in [(6, 10, 500, 1), (6, 10, 500, 8)]:
        G, b, ydy, _, alphas, purity = _gram_problem(p, n_s, members,
                                                     seed=100 + members)
        fns = _fw_fns(G, b, purity, steps, p - 1, interpret)
        a_x, a_k = fns["jnp"](alphas), fns["kernel"](alphas)
        cost = [np.asarray([weighted_cost_gram(G, b, ydy, a) for a in aa])
                for aa in (a_x, a_k)]
        rel = float(np.max(np.abs(cost[0] - cost[1]) / np.abs(cost[0])))
        known = jnp.sum(a_k[:, :p - 1], axis=1)
        feas = max(float(jnp.max(jnp.abs(known - purity))),
                   float(jnp.max(jnp.abs(a_k[:, -1] - (1 - purity)))),
                   float(-jnp.min(a_k)))
        label = f"({p}, {n_s}, {steps}, {members})"
        log(f"  {label}: cost rel diff {rel:.3g} (tol "
            f"{KERNEL_FW_COST_RTOL:g}), feasibility error {feas:.3g} (tol "
            f"{FEASIBILITY_TOL:g})")
        assert rel <= KERNEL_FW_COST_RTOL, (label, rel)
        assert feas <= FEASIBILITY_TOL, (label, feas)
        _alternate(label, fns, (alphas,), max(reps // 5, 5))


@contextlib.contextmanager
def _loops_in_jnp():
    """Trace the solvers with the jnp loops in place of the kernels (the
    choice is made while tracing, so caches are cleared on both sides)."""
    import jax

    from demethify_tpu.ops import pallas_small

    original = pallas_small.use_kernel
    pallas_small.use_kernel = lambda platform, p, dtype: False
    jax.clear_caches()
    try:
        yield
    finally:
        pallas_small.use_kernel = original
        jax.clear_caches()


def _compile(fn, args, kernel):
    """AOT-compile ``fn(*args)`` with the loop kernels on or off, and check
    that the Triton call is in the program exactly when asked for."""
    import jax

    ctx = contextlib.nullcontext() if kernel else _loops_in_jnp()
    with ctx:
        compiled = jax.jit(fn).lower(*args).compile()
    # the Pallas call's target (XLA's own Triton fusions are named
    # otherwise)
    has_kernel = "__gpu$xla.gpu.triton" in compiled.as_text()
    assert has_kernel == kernel, ("Pallas call in the program", has_kernel)
    return lambda: compiled(*args)


def phase_kernel_solves(paths, reps=3):
    """The whole 1M-site partial-reference (1000 x 20) and purity
    (100 x 500) solves, tol 0, with the loop kernels and without."""
    import jax
    import jax.numpy as jnp

    from demethify_tpu.solvers.init import init_partial, init_purity
    from demethify_tpu.solvers.partial_ref import partial_ref_solve
    from demethify_tpu.solvers.purity import purity_solve

    y, d, R = (jnp.asarray(x) for x in _load(paths))
    key = jax.random.PRNGKey(0)
    purity = jnp.full((y.shape[1],), 0.7, jnp.float32)
    u0, a0 = init_partial(key, "uniform_", y, d, R, 1)
    pu0, pa0 = init_purity(key, "uniform_", y, d, R, 1, purity)
    cases = {
        "partial-ref 1000x20": (
            lambda u, a, y, d, R: partial_ref_solve(
                u, a, y, d, R, 1, n_iter1=1000, n_iter2=20, tol=0.0),
            (u0, a0, y, d, R)),
        "purity 100x500": (
            lambda u, a, y, d, R, q: purity_solve(
                u, a, y, d, R, q, 1, n_iter1=100, n_iter2=500, tol=0.0),
            (pu0, pa0, y, d, R, purity)),
    }
    log(f"kernel: whole solves at {y.shape[0]} sites, tol 0 (s per solve)")
    for label, (fn, args) in cases.items():
        fns = {"jnp": _compile(fn, args, kernel=False),
               "kernel": _compile(fn, args, kernel=True)}
        outs = {name: jax.block_until_ready(f()) for name, f in fns.items()}
        _alternate(label, fns, (), reps, unit=1.0, unit_name="s")
        diff = float(jnp.max(jnp.abs(outs["jnp"][1] - outs["kernel"][1])))
        log(f"  {label}: max |alpha diff| jnp vs kernel {diff:.3g}, cost "
            f"{float(outs['jnp'][2]['cost']):.9g} / "
            f"{float(outs['kernel'][2]['cost']):.9g}")


# ---------------------------------------------------------------------------
# cli
# ---------------------------------------------------------------------------

def _read_csv(path):
    """(header, row labels, cells) of a CSV the CLI wrote."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], [r[1:] for r in rows[1:]]


def _read_props(outdir):
    header, labels, cells = _read_csv(
        os.path.join(outdir, "celltypes_proportions.csv"))
    return header, labels, np.asarray(cells, np.float64)


def _read_profile(outdir):
    with open(os.path.join(outdir, "methylation_profile_estimate.csv")) as f:
        f.readline()
        return np.loadtxt(f, delimiter=",", ndmin=2)


def _n_iter(outdir):
    with open(os.path.join(outdir, "log.log")) as f:
        text = f.read()
    if " outer iterations" not in text:
        return 0
    return int(text.split(" outer iterations")[0].rsplit(" ", 1)[-1])


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _cli(argv, outdir):
    from demethify_tpu.cli import main as cli_main

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli_main(argv + ["--outdir", outdir, "--noprint"])
    wall = time.perf_counter() - t0
    assert rc == 0, (argv, rc)
    return wall


def _check_simplex(props, label):
    err = max(float(np.max(np.abs(props.sum(axis=0) - 1.0))),
              float(-props.min()))
    assert err <= FEASIBILITY_TOL, (label, "simplex", err)
    return err


def phase_cli(paths, truth, dev, outroot):
    samples = paths["samples"]
    base = ["--methfreq", *samples, "--bedmethyl"]
    ref = ["--ref", paths["ref"]]
    props_true = truth.proportions
    known_true = props_true[:-1] / props_true[:-1].sum(axis=0)
    mixture_true = truth.profiles @ props_true
    noise = _rmse(truth.fractions, mixture_true)
    unknown_true = props_true[-1]
    n_sites = truth.coverage.shape[0]
    R = truth.profiles[:, :N_KNOWN]
    purities = [repr(100.0 * float(u)) for u in unknown_true]
    runs = {
        "ref": ref,
        "partial": ref + ["--nbunknown", "1", "--iterations", "1000", "20"],
        "unsupervised": ["--nbunknown", "6", "--iterations", "1000", "20"],
        "purity": ref + ["--nbunknown", "1", "--purity", *purities],
        "restart": ref + ["--nbunknown", "1", "--iterations", "1000", "20",
                          "--restart", "4"],
        "confidence": ref + ["--nbunknown", "1", "--iterations", "1000",
                             "20", "--confidence", "95", "16",
                             "--cimethod", "weights"],
    }
    log(f"cli: cli.main in-process on {n_sites} sites; RMSE against the "
        f"simulated truth (observed fractions vs mixture: {noise:.4g})")
    for name, extra in runs.items():
        n_known = 0 if name == "unsupervised" else N_KNOWN
        outdir = os.path.join(outroot, name)
        wall = _cli(base + extra, outdir)
        header, labels, props = _read_props(outdir)
        assert header[1:] == [os.path.basename(s) for s in samples], header
        assert np.all(np.isfinite(props)), name
        feas = _check_simplex(props, name)
        checks = []
        if name in PROPS_RMSE:
            want = known_true if name == "ref" else props_true
            checks.append(("proportions", _rmse(props, want),
                           PROPS_RMSE[name]))
        if name != "ref":
            u = _read_profile(outdir)
            assert u.shape == (n_sites, props.shape[0] - n_known), u.shape
            assert np.all((u >= 0) & (u <= 1)), name
            fit = u @ props[n_known:]
            if n_known:
                fit = fit + R @ props[:n_known]
            checks.append(("mixture", _rmse(fit, mixture_true), noise))
        if name == "purity":
            # the unknown row is pinned at the purity the user gave
            pin = float(np.max(np.abs(props[-1] - unknown_true)))
            assert pin <= FEASIBILITY_TOL, ("purity pin", pin)
        if name == "confidence":
            _, _, cells = _read_csv(os.path.join(
                outdir, "confidence_interval_celltypes_proportions.csv"))
            lo_hi = np.asarray([[c.strip("()").split(", ") for c in row]
                                for row in cells], np.float64)
            assert lo_hi.shape == props.shape + (2,), lo_hi.shape
            assert np.all(lo_hi[..., 0] <= lo_hi[..., 1]), "CI order"
            assert np.all((lo_hi >= -FEASIBILITY_TOL)
                          & (lo_hi <= 1 + FEASIBILITY_TOL)), "CI range"
        log(f"  {name}: {wall:.2f} s wall (compile included), n_iter "
            f"{_n_iter(outdir)}, rows {labels[0]}..{labels[-1]}, simplex "
            f"error {feas:.2g}, "
            + ", ".join(f"{what} RMSE {got:.4g} (bound {bound:.4g})"
                        for what, got, bound in checks)
            + f", peak {_peak_gib(dev):.2f} GiB")
        for what, got, bound in checks:
            assert got <= bound, (name, what, got, bound)

    # The partial run once more in this process. Its stopping rule
    # |cf - cf_prev| < tol (1e-2) reads an f32 cost of ~2e6, whose spacing
    # is 0.25, so it stops only when the cost repeats exactly: n_iter
    # follows the last bit of every sum.
    first = os.path.join(outroot, "partial")
    again = os.path.join(outroot, "partial_again")
    wall = _cli(base + runs["partial"], again)
    same = all(filecmp.cmp(os.path.join(first, f), os.path.join(again, f),
                           shallow=False)
               for f in ("celltypes_proportions.csv",
                         "methylation_profile_estimate.csv"))
    log(f"  partial again: {wall:.2f} s wall, n_iter {_n_iter(again)} "
        f"(first run {_n_iter(first)}), output files "
        f"{'identical' if same else 'differ'}")


# ---------------------------------------------------------------------------
# oracle
# ---------------------------------------------------------------------------

MODES = ("partial", "unsupervised", "purity")
FW_STEPS = 500


def _inits(key, y, d, R, purity):
    """Each mode's (u0, alpha0) from the CLI's default init, on the
    device."""
    from demethify_tpu.solvers.init import (
        init_partial,
        init_purity,
        init_unsupervised,
    )

    return {"partial": init_partial(key, "uniform_", y, d, R, 1),
            "unsupervised": init_unsupervised(key, "uniform_", y, d, 6),
            "purity": init_purity(key, "uniform_", y, d, R, 1, purity)}


def _device_solve(mode, init, y, d, R, purity, n_iter1):
    """(u, alpha) of ``mode`` after ``n_iter1`` outer iterations at tol 0,
    f32 on the device, as float64 host arrays."""
    from demethify_tpu.solvers.partial_ref import partial_ref_solve
    from demethify_tpu.solvers.purity import purity_solve
    from demethify_tpu.solvers.unsupervised import unsupervised_solve

    u0, a0 = init
    if mode == "partial":
        out = partial_ref_solve(u0, a0, y, d, R, 1, n_iter1=n_iter1,
                                n_iter2=20, tol=0.0)
    elif mode == "unsupervised":
        out = unsupervised_solve(u0, a0, y, d, 6, n_iter1=n_iter1,
                                 n_iter2=20, tol=0.0)
    else:
        out = purity_solve(u0, a0, y, d, R, purity, 1, n_iter1=n_iter1,
                           n_iter2=FW_STEPS, tol=0.0)
    return [np.asarray(x, np.float64) for x in out[:2]]


def _submit_oracle(ex, mode, init, y, d, R, purity, n_iter1):
    """Submit tests/oracle.py's float64 run of ``mode`` from ``init``;
    the purity run also returns its last Frank-Wolfe loop."""
    from tests import oracle

    u0, a0 = (np.asarray(x, np.float64) for x in init)
    if mode == "partial":
        return ex.submit(oracle.partial_ref_solve, u0, np.hstack([R, u0]),
                         a0, y, d, R, 1, n_iter1, 20, 0.0)
    if mode == "unsupervised":
        return ex.submit(oracle.unsupervised_solve, u0, a0, y, d, 6,
                         n_iter1, 20, 0.0)
    return ex.submit(oracle.purity_solve, u0, a0, y, d, R, purity, 1,
                     n_iter1, FW_STEPS, 0.0, True)


def _fw_vertices(alpha, G, b, purity, steps, p1):
    """frank_wolfe_gram's loop, also returning each step's known-block
    vertex (steps, n_s)."""
    import jax
    import jax.numpy as jnp

    from demethify_tpu.ops.frank_wolfe import _lmo_columns
    from demethify_tpu.ops.gram import HIGHEST

    def body(alpha, k):
        grad = jnp.einsum("spq,qs->ps", G, alpha, precision=HIGHEST) - b
        s = jnp.concatenate([_lmo_columns(grad[:p1], purity),
                             _lmo_columns(grad[p1:], 1.0 - purity)])
        gamma = 2.0 / (k.astype(alpha.dtype) + 2.0)
        return ((1.0 - gamma) * alpha + gamma * s,
                jnp.argmin(grad[:p1], axis=0))

    return jax.lax.scan(body, alpha, jnp.arange(steps))


def _last_loop(last, u, want_alpha, y, d, R, purity):
    """The oracle's last Frank-Wolfe loop run again in f32 on the device
    from the oracle's own inputs (its U and starting alpha), by the
    solver's own loop (the kernel on a GPU) and by a loop that records
    its vertices. Returns the (step, sample) pairs whose known-block
    vertex differs from the oracle's; at the first such step of each
    sample, the float64 gradient margin (second-smallest minus smallest
    entry) relative to the sample's max |b|; and the solver loop's
    distance from the oracle's loop, in alpha and in the cost both
    minimize (float64, the oracle's U)."""
    import jax
    import jax.numpy as jnp

    from demethify_tpu.ops.gram import sample_grams
    from demethify_tpu.ops.pallas_small import fw_loop

    from tests import oracle

    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    R_full = np.hstack([R, u])
    G, b, _ = sample_grams(f32(R_full), f32(d), f32(y))
    a_in, pj = f32(last["alpha_in"]), f32(purity)
    p1 = a_in.shape[0] - 1
    alpha, idx = jax.jit(_fw_vertices, static_argnums=(4, 5))(
        a_in, G, b, pj, FW_STEPS, p1)
    solver = np.asarray(jnp.concatenate(jax.jit(fw_loop, static_argnums=5)(
        a_in[:p1], a_in[p1:], G, b, pj, FW_STEPS)), np.float64)
    want_idx = np.stack([v for v, _ in last["vertices"]])
    margin = np.stack([m for _, m in last["vertices"]])
    steps, samples = np.nonzero(np.asarray(idx) != want_idx)
    first = {}
    for k, s in zip(steps.tolist(), samples.tolist()):
        first.setdefault(s, k)
    b_max = np.max(np.abs(R.T @ (d * y)), axis=0)
    cost_o = oracle.cost_w(y, R_full, want_alpha, d)
    return {"flips": list(zip(steps.tolist(), samples.tolist())),
            "margin": max((margin[k, s] / b_max[s] for s, k in first.items()),
                          default=0.0),
            "loop_props": float(np.max(np.abs(solver - want_alpha))),
            "loop_cost": abs(oracle.cost_w(y, R_full, solver, d) - cost_o)
            / cost_o,
            "vs_recorder": float(np.max(np.abs(solver - np.asarray(alpha))))}


def oracle_readings(paths, truth, n_slices, n_rows=ORACLE_SITES,
                    n_iter1=20):
    """Each iterative mode for ``n_iter1`` outer iterations, f32 on the
    device at the pinned precision and at XLA's DEFAULT, against
    tests/oracle.py in float64 on the host (a process pool, while the
    device works), from the same init, on ``n_slices`` disjoint
    ``n_rows``-site slices of the cohort. Logs and returns the readings:
    max |proportion diff|, cost relative diff, max |U diff|, and for
    purity the last Frank-Wolfe loop's vertex flips (``_last_loop``)."""
    import concurrent.futures
    import multiprocessing

    import jax
    import jax.numpy as jnp

    from tests import oracle

    y_all, d_all, R_all = _load(paths, n_rows * n_slices)
    purity = 1.0 - truth.proportions[-1]
    pj = jnp.asarray(purity, jnp.float32)
    log(f"oracle: {n_iter1} outer iterations on {n_slices} slices of "
        f"{n_rows} sites, f32 on the device vs the float64 oracle from the "
        f"same init")
    slices, futures = [], {}
    workers = min(n_slices * len(MODES), os.cpu_count() or 1)
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        for i in range(n_slices):
            rows = slice(i * n_rows, (i + 1) * n_rows)
            data = tuple(jnp.asarray(x[rows]) for x in (y_all, d_all, R_all))
            data64 = tuple(x[rows].astype(np.float64)
                           for x in (y_all, d_all, R_all))
            inits = _inits(jax.random.PRNGKey(5 + i), *data, pj)
            for mode in MODES:
                futures[i, mode] = _submit_oracle(ex, mode, inits[mode],
                                                  *data64, purity, n_iter1)
            slices.append((data, data64, inits))
        got = {}
        for name, precision in (("pinned", None),
                                ("DEFAULT", jax.lax.Precision.DEFAULT)):
            ctx = (contextlib.nullcontext() if precision is None
                   else _contraction_precision(precision))
            with ctx:
                for i, (data, _, inits) in enumerate(slices):
                    for mode in MODES:
                        got[name, i, mode] = _device_solve(
                            mode, inits[mode], *data, pj, n_iter1)
        want = {key: f.result() for key, f in futures.items()}

    readings = []
    for (name, i, mode), (u, alpha) in got.items():
        y, d, R = slices[i][1]
        u_o, a_o = want[i, mode][:2]
        full = (lambda v: v) if mode == "unsupervised" else (
            lambda v: np.hstack([R, v]))
        cost_o = oracle.cost_w(y, full(u_o), a_o, d)
        r = {"precision": name, "slice": i, "mode": mode,
             "props": float(np.max(np.abs(alpha - a_o))),
             "cost": abs(oracle.cost_w(y, full(u), alpha, d) - cost_o)
             / cost_o,
             "u": float(np.max(np.abs(u - u_o)))}
        if mode == "purity" and name == "pinned":
            r.update(_last_loop(want[i, mode][2], u_o, a_o, y, d, R,
                                purity))
        readings.append(r)
        log(f"  {name} slice {i} {mode}: max |proportion diff| "
            f"{r['props']:.3g}, cost rel diff {r['cost']:.3g}, max |U diff| "
            f"{r['u']:.3g}")
        if "flips" in r:
            shown = ", ".join(f"{k}:{s}" for k, s in r["flips"][:12]) \
                or "none"
            log(f"    last Frank-Wolfe loop in f32 from the oracle's inputs: "
                f"{len(r['flips'])} of {FW_STEPS} x {len(purity)} vertex "
                f"choices differ (step:sample {shown}"
                f"{' ...' if len(r['flips']) > 12 else ''}); float64 margin "
                f"at each sample's first <= {r['margin']:.3g} of max |b|; "
                f"the solver's loop ends {r['loop_props']:.3g} from the "
                f"oracle's in alpha, {r['loop_cost']:.3g} relative in cost, "
                f"{r['vs_recorder']:.3g} from the recording loop")
    return readings


def _within(r):
    ok = (r["props"] <= ORACLE_PROPS_TOL[r["mode"]]
          and r["cost"] <= ORACLE_COST_RTOL[r["mode"]])
    return ok and r.get("loop_cost", 0.0) <= FW_LOOP_COST_RTOL


def phase_oracle(paths, truth, n_slices=ORACLE_SLICES):
    """oracle_readings, held to the limits at the pinned precision; the
    DEFAULT readings are logged against the same limits."""
    readings = oracle_readings(paths, truth, n_slices)
    failed = [r for r in readings
              if r["precision"] == "pinned" and not _within(r)]
    log(f"  limits: max |proportion diff| {ORACLE_PROPS_TOL}, cost rel diff "
        f"{ORACLE_COST_RTOL}, last Frank-Wolfe loop cost rel diff "
        f"{FW_LOOP_COST_RTOL:g}; pinned precision within them: "
        f"{not failed}")
    for mode in MODES:
        default = [_within(r) for r in readings
                   if r["precision"] == "DEFAULT" and r["mode"] == mode]
        log(f"  DEFAULT precision {mode}: within the limits on "
            f"{sum(default)} of {len(default)} slices")
    assert not failed, failed


# ---------------------------------------------------------------------------
# ugram
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _contraction_precision(precision):
    """Trace the contractions at ``precision``: they are pinned to
    ``ops.gram.HIGHEST``, which each module binds at import, so every
    loaded module of the package that holds it is patched."""
    import jax

    import demethify_tpu.solvers.api  # noqa: F401  (loads every solver)
    from demethify_tpu.ops import gram

    pinned = gram.HIGHEST
    modules = [m for name, m in list(sys.modules.items())
               if name.startswith("demethify_tpu.")
               and getattr(m, "HIGHEST", None) is pinned]
    for m in modules:
        m.HIGHEST = precision
    jax.clear_caches()
    try:
        yield
    finally:
        for m in modules:
            m.HIGHEST = pinned
        jax.clear_caches()


def ugram_bytes(n_cpg, n_s, n_ct, n_u, itemsize=4):
    """Bytes that steps 1-3 of one outer iteration must move: as one
    pass (read Y, D, Rt, U; write U), and as the three passes XLA runs
    (1: read Y, D, Rt, write C, M; 2: read C, M, U, U_prev, write both
    U; 3: read Y, D, Rt, U)."""
    one_pass = n_cpg * (2 * n_s + n_ct + 2 * n_u)
    step1 = n_cpg * (2 * n_s + n_ct + n_u + n_u * n_u)
    step2 = n_cpg * (n_u + n_u * n_u + 4 * n_u)
    step3 = n_cpg * (2 * n_s + n_ct + n_u)
    return one_pass * itemsize, (step1 + step2 + step3) * itemsize


def phase_ugram(n_cpg=N_SITES, n_s=N_SAMPLES, n_ct=N_KNOWN, n_u=1,
                reps=50):
    """Steps 1-3 of partial_ref.py's outer iteration (C/M build, 20-step
    U FISTA, Gram pass) on device data, timed against their byte bound."""
    import jax
    import jax.numpy as jnp

    from demethify_tpu.ops import fista
    from demethify_tpu.ops.gram import (
        sample_grams,
        sample_grams_incremental,
        site_curvature,
        u_constant_term,
    )

    k = jax.random.split(jax.random.PRNGKey(3), 4)
    y = jax.random.uniform(k[0], (n_cpg, n_s), jnp.float32)
    d = jnp.floor(jax.random.uniform(k[1], (n_cpg, n_s), jnp.float32,
                                     1.0, 100.0))
    Rt = jax.random.uniform(k[2], (n_cpg, n_ct), jnp.float32)
    u = jax.random.uniform(k[3], (n_cpg, n_u), jnp.float32)
    alpha = jnp.full((n_ct + n_u, n_s), 1.0 / (n_ct + n_u), jnp.float32)
    G_tt, b_t, _ = sample_grams(Rt, d, y)
    one = jnp.ones((), jnp.float32)
    l_w = jnp.asarray(n_s * 1e4, jnp.float32)

    def step(u, y, d, Rt, alpha, G_tt, b_t):
        C = u_constant_term(y, d, Rt, alpha[:n_ct], alpha[n_ct:])
        M = site_curvature(d, alpha[n_ct:])
        u, _, _, _ = fista.fista_u_gram(u, u, one, l_w, l_w, C, M, 20)
        return u, sample_grams_incremental(G_tt, b_t, Rt, u, d, y)

    args = (u, y, d, Rt, alpha, G_tt, b_t)
    one_pass, three_pass = ugram_bytes(n_cpg, n_s, n_ct, n_u)
    log(f"ugram: C/M + 20-step U FISTA + Gram pass at {n_cpg} x {n_s}, "
        f"n_ct={n_ct}, n_u={n_u}")
    log(f"  byte bound at {HBM_BYTES_PER_S / 1e12:g} TB/s: one pass "
        f"{one_pass / 1e6:.1f} MB = {one_pass / HBM_BYTES_PER_S * 1e6:.1f} "
        f"us; as three passes {three_pass / 1e6:.1f} MB = "
        f"{three_pass / HBM_BYTES_PER_S * 1e6:.1f} us")
    for name, precision in (("HIGHEST", jax.lax.Precision.HIGHEST),
                            ("DEFAULT", jax.lax.Precision.DEFAULT)):
        with _contraction_precision(precision):
            fn = jax.jit(step).lower(*args).compile()
        jax.block_until_ready(fn(*args))
        times = [_timed(fn, *args, reps=reps)[0] for _ in range(3)]
        t = float(np.median(times))
        log(f"  precision {name}: {[f'{x * 1e6:.1f}' for x in times]} us "
            f"(median {t * 1e6:.1f} us = {one_pass / t / 1e9:.0f} GB/s "
            f"one-pass-equivalent, {one_pass / HBM_BYTES_PER_S / t:.2f} "
            f"of the one-pass bound)")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def _host_cost(data, outdir):
    """sum(d (y - [Rt U] alpha)^2) in float64 from the CLI's output
    files; ``data`` is the cohort's (y, d, Rt)."""
    y, d, R = data
    _, _, props = _read_props(outdir)
    u = _read_profile(outdir)
    resid = y - np.hstack([R, u]) @ props
    return float(np.sum(d * resid * resid))


def phase_four_cards(paths, dev, outroot):
    import jax

    devices = jax.devices()
    assert len(devices) >= 4, f"--four-cards needs 4 devices, found " \
                              f"{len(devices)}"
    argv = ["--methfreq", *paths["samples"], "--bedmethyl", "--ref",
            paths["ref"], "--nbunknown", "1", "--iterations", "200", "20",
            "--termination", "0"]
    log(f"four-cards: partial reference, 200 x 20 at tol 0, "
        f"{len(devices)} cards with --shard vs one card")
    data = tuple(x.astype(np.float64) for x in _load(paths))
    props, costs = {}, {}
    for name in ("shard", "one", "one", "shard"):
        outdir = os.path.join(outroot, f"four_{name}")
        wall = _cli(argv + (["--shard"] if name == "shard" else []), outdir)
        props[name] = _read_props(outdir)[2]
        costs[name] = _host_cost(data, outdir)
        log(f"  {name}: {wall:.2f} s wall (the first run of each compiles), "
            f"cost {costs[name]:.9g}")
    dp = float(np.max(np.abs(props["shard"] - props["one"])))
    dc = abs(costs["shard"] - costs["one"]) / costs["one"]
    log(f"  max |proportion diff| {dp:.3g} (tol {FOUR_CARD_PROPS_TOL:g}), "
        f"cost rel diff {dc:.3g} (tol {FOUR_CARD_COST_RTOL:g}): the "
        f"cross-card sums add in another order")
    assert dp <= FOUR_CARD_PROPS_TOL, dp
    assert dc <= FOUR_CARD_COST_RTOL, dc


# ---------------------------------------------------------------------------

def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-card row-sharded CLI path and "
                             "its one-card comparison")
    args = parser.parse_args(argv)

    dev = gpu_or_exit()
    import jax

    from demethify_tpu.utils import enable_compile_cache

    enable_compile_cache()
    phase_device(dev)
    if args.four_cards:
        paths, _ = phase_cohort(FOUR_CARD_SITES, os.path.join(WORK, "4m"))
        phase_four_cards(paths, dev, os.path.join(WORK, "out"))
    else:
        paths, truth = phase_cohort(N_SITES, os.path.join(WORK, "1m"))
        phase_kernel_loops()
        phase_kernel_solves(paths)
        phase_cli(paths, truth, dev, os.path.join(WORK, "out"))
        phase_oracle(paths, truth)
        phase_ugram()
    log(f"peak device memory {_peak_gib(dev):.2f} GiB")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
