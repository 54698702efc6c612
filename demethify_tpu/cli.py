"""Command-line interface, flag-compatible with the reference
(`demethify/demethify.py:24-239`), running the jitted JAX solvers.

Reproduced quirks/conventions:
- `nargs=1` flags arrive as 1-lists (`--nbunknown`, `--restart`, `--seed`,
  `--termination` default-vs-list) and are unwrapped like the reference
  (`demethify.py:55-67,99-100`);
- iteration defaults switch on purity: (100, 500) with, (10000, 20) without
  (`demethify.py:60-64`);
- CLI purity p% becomes `1 - p/100` (`demethify.py:77`); the "is it really a
  percentage?" warning is kept, and the out-of-bounds check is the one the
  reference *intended* (its `&`-combined check at `demethify.py:73` can
  never fire);
- `--ic NAME [n_restarts]` with default 5 restarts (`demethify.py:84-89`);
- `--confidence LEVEL B` runs before the point estimate (`demethify.py:151`).

Deliberate fixes (documented divergences): the reference re-seeds every
restart with the same seed (making `--restart` a no-op) and crashes on
`--seed N` + `--confidence` (list + int TypeError, `bootstrap.py:27`); here
seeds fold per restart/replicate.

Extras: `--dtype {float32,bfloat16,float64}` (default float32) and
`--platform` to pin the JAX backend.

The plain run imports no pandas, matplotlib, orbax or tqdm: `--plot`,
`--savestate`/`--initstate` and progress bars load theirs on demand.
"""

import argparse
import os
import sys
from time import time

import numpy as np

LOGO = r"""
    ____                      __  __    _ ____        __
   / __ \___  ____ ___  ___  / /_/ /_  (_) __/_  __  / /_____  __  __
  / / / / _ \/ __ `__ \/ _ \/ __/ __ \/ / /_/ / / / / __/ __ \/ / / /
 / /_/ /  __/ / / / / /  __/ /_/ / / / / __/ /_/ / / /_/ /_/ / /_/ /
/_____/\___/_/ /_/ /_/\___/\__/_/ /_/_/_/  \__, /  \__/ .___/\__,_/
                                          /____/     /_/
"""


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="demethify-tpu",
        description="DeMethify-TPU - Partial reference-based Methylation "
                    "Deconvolution on JAX accelerators")
    parser.add_argument('--methfreq', nargs='+', type=str, required=True,
                        help='Methylation frequency file path (values '
                             'between 0 and 1)')
    parser.add_argument('--ref', nargs='?', type=str,
                        help='Methylation reference matrix file path')
    parser.add_argument('--iterations', nargs=2, type=int,
                        help='Numbers of iterations for outer and inner '
                             'loops (default without purity = 10000, 20, '
                             'with purity = 100, 500)')
    parser.add_argument('--nbunknown', nargs=1, type=int,
                        help='Number of unknown cell types to estimate')
    parser.add_argument('--purity', nargs='+', type=float,
                        help='The purities of the samples in percent '
                             '[0,100], if known')
    parser.add_argument('--termination', nargs=1, type=float, default=1e-2,
                        help='Termination condition for cost function '
                             '(default = 1e-2)')
    parser.add_argument('--init', nargs='?', default='uniform_',
                        help='Initialisation option, the default is '
                             'uniform_, and the options are: uniform, '
                             'uniform_, beta, SVD, ICA.')
    parser.add_argument('--outdir', nargs='?', required=True,
                        help='Output directory')
    parser.add_argument('--fillna', action='store_true',
                        help='Replace every NA by 0 in the given data')
    parser.add_argument('--ic', nargs='+',
                        help='Select number of unknown cell types by '
                             'minimising a criterion (AIC, BIC, CCC, BCV, '
                             'minka)')
    parser.add_argument('--confidence', nargs=2, type=int,
                        help='Outputs bootstrap confidence intervals, takes '
                             'confidence level and bootstrap iteration '
                             'numbers as input.')
    parser.add_argument('--plot', action='store_true',
                        help='Plot cell type proportions estimates for each '
                             'sample, eventually with confidence intervals.')
    parser.add_argument('--restart', nargs=1, type=int,
                        help='Number of random restarts among which to '
                             'select the one with the lowest cost')
    parser.add_argument('--seed', nargs=1, type=int, default=1,
                        help='Set a seed integer number for random number '
                             'generation for reproducibility.')
    parser.add_argument('--noprint', action='store_true',
                        help="Doesn't show the logo.")
    parser.add_argument('--bedmethyl', action='store_true',
                        help='Flag to indicate that the input will be '
                             'bedmethyl files, modkit style')
    # extras beyond the reference's flags
    parser.add_argument('--dtype', choices=['float32', 'bfloat16',
                                            'float64'],
                        default='float32', help='Compute dtype on device')
    parser.add_argument('--platform', type=str, default=None,
                        help='Pin the JAX backend (e.g. cpu, cuda)')
    parser.add_argument('--icmax', nargs=1, type=int, default=[25],
                        help='Upper end of the --ic sweep range '
                             '(reference hardcodes 25)')
    parser.add_argument('--reltol', action='store_true',
                        help='Interpret --termination as a fraction of the '
                             'initial cost (recommended for megabase-scale '
                             'float32 runs, where an absolute 1e-2 is below '
                             'accumulation noise)')
    parser.add_argument('--cimethod', choices=['auto', 'resample',
                                               'weights'],
                        default='auto',
                        help='Bootstrap layout: "resample" gathers '
                             'replicate copies of (Y, D, R); "weights" '
                             'solves the equivalent row-multiplicity '
                             'problem with zero data duplication '
                             '(genome-scale CIs; SVD/ICA inits are '
                             'computed once on the full data and shared '
                             'across replicates); "auto" switches to '
                             'weights on large inputs')
    parser.add_argument('--trace', action='store_true',
                        help='Record and write the solver cost trajectory '
                             'to <outdir>/cost_trajectory.csv')
    parser.add_argument('--profile', type=str, default=None,
                        help='Write a JAX device profile trace to this '
                             'directory (view with xprof/TensorBoard)')
    parser.add_argument('--debugnans', action='store_true',
                        help='Raise at the first op producing NaN '
                             '(jax_debug_nans)')
    parser.add_argument('--shard', action='store_true',
                        help='Row-shard the CpG axis across all local '
                             'devices; Gram reductions run as cross-device '
                             'sums')
    parser.add_argument('--savestate', type=str, default=None,
                        help='Save the converged factor state (U, alpha, '
                             'cost) as an orbax checkpoint at this path '
                             '(sharding-preserving; see checkpoint.py)')
    parser.add_argument('--initstate', type=str, default=None,
                        help='Warm-start the solver from a --savestate '
                             'checkpoint instead of --init (resume / '
                             'refine a previous run)')
    parser.add_argument('--multihost', nargs=3, default=None,
                        metavar=('COORD', 'NPROC', 'PID'),
                        help='Join a multi-host run: coordinator '
                             'address (host:port), total process count, '
                             'this process id. Every process must run '
                             'the same command; CpG rows are sharded '
                             'globally (Gram reductions are cross-device '
                             'sums), proportions are written by '
                             'process 0, unknown profiles as per-host '
                             'part files.')
    return parser


def _check_optional_packages(args):
    """Fail before any work when a requested feature's package is
    missing."""
    from demethify_tpu.utils import optional_import

    if args.plot:
        optional_import("pandas", "--plot")
        optional_import("matplotlib", "--plot")
    if args.savestate or args.initstate:
        optional_import("orbax.checkpoint", "--savestate/--initstate")


def main(argv=None):
    args = build_parser().parse_args(argv)
    _check_optional_packages(args)

    if args.platform:
        import jax
        jax.config.update('jax_platforms', args.platform)
    if args.dtype == 'float64':
        import jax
        jax.config.update('jax_enable_x64', True)

    import jax

    if args.initstate and (args.ic or
                           (args.ref and not args.nbunknown)):
        sys.stderr.write(
            "Error: --initstate warm-starts the iterative solvers; it "
            "cannot be used with --ic or the reference-based "
            "(no --nbunknown) mode.\n")
        sys.exit(1)

    proc_id = 0
    n_procs = 1
    if args.multihost:
        from demethify_tpu.parallel.distributed import initialize
        coord, n_procs, proc_id = (args.multihost[0],
                                   int(args.multihost[1]),
                                   int(args.multihost[2]))
        initialize(coordinator_address=coord, num_processes=n_procs,
                   process_id=proc_id)

    import jax.numpy as jnp

    from demethify_tpu.utils import (
        SolveStats,
        device_profile,
        enable_compile_cache,
        enable_nan_debugging,
        write_cost_trace,
    )

    enable_compile_cache()
    if args.debugnans:
        enable_nan_debugging()

    from demethify_tpu.io.readers import load_dataset
    from demethify_tpu.io.writers import (
        write_ci_profile,
        write_ci_proportions,
        write_log,
        write_profile_estimate,
        write_proportions,
    )
    from demethify_tpu.selection.sweep import evaluate_best_ic
    from demethify_tpu.solvers.api import (
        partial_reference_deconv,
        purity_deconv,
        supervised_deconv,
        unsupervised_deconv,
    )
    from demethify_tpu.uncertainty.bootstrap import bootstrap_ci

    # ------------------------------------------------------------------
    # argument normalization (reference demethify.py:51-100)
    # ------------------------------------------------------------------
    restart = 1 if args.restart is None else args.restart[0]

    if not args.iterations:
        args.iterations = [100, 500] if args.purity else [10000, 20]

    termination = (args.termination[0] if isinstance(args.termination, list)
                   else args.termination)

    purity = None
    if args.purity:
        purity_arr = np.array(args.purity, dtype=np.float64)
        if np.any((purity_arr < 0) | (purity_arr > 100)):
            sys.stderr.write("Error: Invalid value for purity, not within "
                             "[0,100] bounds.")
            sys.exit(1)
        if np.any((purity_arr >= 0) & (purity_arr <= 1)):
            print("Purity is between 0 and 1, are you sure that it's a "
                  "percentage?")
        purity = 1.0 - (purity_arr / 100.0)
        if len(purity) != len(args.methfreq):
            sys.stderr.write(
                f"Error: --purity needs one value per sample "
                f"({len(args.methfreq)} samples, {len(purity)} purity "
                f"values given).\n")
            sys.exit(1)

    nb_r = 5
    ic_name = None
    if args.ic:
        if args.nbunknown:
            sys.stderr.write("Error: --ic cannot be used with "
                             "--nbunknown.\n")
            sys.exit(1)
        if len(args.ic) > 1:
            nb_r = int(args.ic[1])
        ic_name = args.ic[0]

    seed = args.seed[0] if isinstance(args.seed, list) else args.seed

    if not args.noprint:
        print(LOGO)

    outdir = os.path.join(os.getcwd(), args.outdir)
    if not os.path.exists(outdir):
        print(f'Creating directory {outdir} to store results')
        os.makedirs(outdir, exist_ok=True)

    n_u = 0 if args.nbunknown is None else args.nbunknown[0]

    # ------------------------------------------------------------------
    # data loading (reference demethify.py:102-146)
    # ------------------------------------------------------------------
    np_dtype = {'float32': np.float32, 'bfloat16': np.float32,
                'float64': np.float64}[args.dtype]
    ds = load_dataset(args.methfreq, ref=args.ref,
                      bedmethyl=args.bedmethyl, fillna=args.fillna,
                      dtype=np_dtype)
    n_cpg_orig = ds.meth_f.shape[0]
    if not args.reltol:
        from demethify_tpu.utils import termination_resolution_warning
        cost_scale = float(np.einsum("is,is,is->", ds.counts, ds.meth_f,
                                     ds.meth_f, dtype=np.float64))
        msg = termination_resolution_warning(termination, cost_scale,
                                             np_dtype)
        if msg:
            print(msg)
    dev_dtype = jnp.bfloat16 if args.dtype == 'bfloat16' else None
    if args.multihost:
        from demethify_tpu.parallel.distributed import shard_dataset_global
        _, y, d, ref_mat = shard_dataset_global(
            ds.meth_f.astype(np_dtype), ds.counts.astype(np_dtype),
            None if ds.ref is None else ds.ref.astype(np_dtype))
        if dev_dtype is not None:
            y = y.astype(dev_dtype)
            d = d.astype(dev_dtype)
            ref_mat = None if ref_mat is None else ref_mat.astype(dev_dtype)
    elif args.shard and len(jax.devices()) > 1:
        from demethify_tpu.parallel.mesh import make_mesh, shard_dataset
        mesh = make_mesh(jax.devices(), replicate=1)
        y, d, ref_mat = shard_dataset(
            mesh,
            ds.meth_f.astype(np_dtype), ds.counts.astype(np_dtype),
            None if ds.ref is None else ds.ref.astype(np_dtype))
        if dev_dtype is not None:
            y = y.astype(dev_dtype)
            d = d.astype(dev_dtype)
            ref_mat = None if ref_mat is None else \
                ref_mat.astype(dev_dtype)
    else:
        y = jnp.asarray(ds.meth_f, dtype=dev_dtype)
        d = jnp.asarray(ds.counts, dtype=dev_dtype)
        ref_mat = None if ds.ref is None else jnp.asarray(ds.ref,
                                                          dtype=dev_dtype)
    header = list(ds.header)

    time_start = time()
    key = jax.random.PRNGKey(seed)

    def _write_profile(u_arr, unknown_header):
        """Unknown-profile CSV; in --multihost mode each process writes
        only its addressable CpG row block (no global gather)."""
        if args.multihost and not getattr(u_arr, "is_fully_addressable",
                                          True):
            from demethify_tpu.parallel.distributed import (
                addressable_row_block,
            )
            blk, start = addressable_row_block(u_arr)
            stop = min(start + blk.shape[0], n_cpg_orig)
            if stop > start:
                write_profile_estimate(outdir, blk[:stop - start],
                                       unknown_header,
                                       suffix=f".part{proc_id:04d}",
                                       row_offset=start)
        elif proc_id == 0:
            # fully-addressable factors (e.g. the multihost IC sweep's
            # locally-recomputed winner) are identical on every process;
            # one writer suffices
            write_profile_estimate(outdir,
                                   np.asarray(u_arr)[:n_cpg_orig],
                                   unknown_header)

    # ------------------------------------------------------------------
    # bootstrap CIs first, like the reference (demethify.py:151-152)
    # ------------------------------------------------------------------
    ci_bounds = None
    if args.confidence:
        if ref_mat is None and n_u == 0:
            sys.stderr.write("Error: --confidence without --ref needs "
                             "--nbunknown (unsupervised bootstrap).\n")
            sys.exit(1)
        level, n_boot = args.confidence
        from demethify_tpu.uncertainty.bootstrap import resolve_method
        # supervised replicates are init-free WLS solves, so weights
        # mode is available regardless of --init (mirrors bootstrap_ci)
        ci_method = resolve_method(
            args.cimethod, args.init if n_u > 0 else "uniform_",
            int(np.prod(ds.meth_f.shape)))
        bt_devices = None
        if (args.shard and not args.multihost
                and ci_method == "weights" and ref_mat is not None):
            # the weighted (row-multiplicity) layout has no per-replicate
            # row gather, so it runs directly on the row-sharded arrays:
            # per-device memory stays 1/n_devices of the data and the Gram
            # reductions are cross-device sums (genome-scale sharded CIs)
            y_bt, d_bt, ref_bt = y, d, ref_mat
        elif (args.shard and args.multihost
                and ci_method == "weights" and ref_mat is not None):
            # 2-D scale-out (--multihost --shard): replicates partition
            # across PROCESSES (the network carries only the tiny
            # per-replicate results) while each process row-shards
            # (Y, D, R) over its
            # LOCAL devices (which sum the weighted Gram partials) — so
            # genome-scale bootstrap CIs compose with multihost
            # (per-device memory is 1/local_device_count of the data,
            # never host-full-per-device)
            from demethify_tpu.parallel.mesh import (
                make_mesh,
                shard_dataset,
            )
            lmesh = make_mesh(jax.local_devices(), replicate=1)
            y_bt, d_bt, ref_bt = shard_dataset(
                lmesh, ds.meth_f.astype(np_dtype),
                ds.counts.astype(np_dtype), ds.ref.astype(np_dtype))
            if dev_dtype is not None:
                y_bt = y_bt.astype(dev_dtype)
                d_bt = d_bt.astype(dev_dtype)
                ref_bt = ref_bt.astype(dev_dtype)
        elif args.multihost or args.shard:
            # resample mode runs on host-full arrays — row-sharded
            # inputs would turn every replicate's row gather into an
            # all-to-all. --multihost partitions replicates across
            # processes; --shard batch-parallels them across the local
            # devices (data replicated, zero comms per replicate).
            y_bt = jnp.asarray(ds.meth_f.astype(np_dtype),
                               dtype=dev_dtype)
            d_bt = jnp.asarray(ds.counts.astype(np_dtype),
                               dtype=dev_dtype)
            ref_bt = None if ds.ref is None else jnp.asarray(
                ds.ref.astype(np_dtype), dtype=dev_dtype)
            if args.shard and not args.multihost:
                bt_devices = jax.devices()
        else:
            y_bt, d_bt, ref_bt = y, d, ref_mat
        lo_p, hi_p, lo_u, hi_u = bootstrap_ci(
            y_bt, d_bt, ref_bt, n_u, level=level, n_bootstrap=n_boot,
            init_option=args.init, n_iter1=args.iterations[0],
            n_iter2=args.iterations[1], tol=termination,
            purity=purity, key=jax.random.fold_in(key, 987654321),
            n_rows=n_cpg_orig, tol_relative=args.reltol,
            process_count=n_procs, process_index=proc_id,
            devices=bt_devices, method=ci_method,
            progress=sys.stdout.isatty() and proc_id == 0)
        unknown_header = [f"unknown_cell_{i+1}" for i in range(n_u)]
        ci_bounds = (lo_p, hi_p, header + unknown_header)
        if proc_id == 0:
            write_ci_proportions(outdir, lo_p, hi_p,
                                 header + unknown_header, ds.sample_names)
            if n_u > 0:
                write_ci_profile(outdir, lo_u[:n_cpg_orig],
                                 hi_u[:n_cpg_orig], unknown_header)

    # ------------------------------------------------------------------
    # point estimate (reference demethify.py:154-217)
    # ------------------------------------------------------------------
    init_provided = None
    if args.initstate:
        from demethify_tpu.checkpoint import load_factors
        state = load_factors(args.initstate, as_numpy=True)
        u0 = np.asarray(state["u"]).astype(y.dtype)
        a0 = np.asarray(state["alpha"]).astype(y.dtype)
        if u0.shape[0] < y.shape[0]:      # row-padded device arrays
            u0 = np.pad(u0, ((0, y.shape[0] - u0.shape[0]), (0, 0)))
        if u0.shape[0] != y.shape[0]:
            sys.stderr.write(
                f"Error: --initstate factor rows ({u0.shape[0]}) do not "
                f"match the input CpG rows ({y.shape[0]}).\n")
            sys.exit(1)
        if args.multihost or (args.shard and len(jax.devices()) > 1):
            # Restore ONTO the run's mesh: U row-sharded like y, alpha
            # replicated. Multi-controller JAX requires global arrays —
            # process-local single-device factors would fail inside the
            # jitted solve over the global mesh.
            from jax.sharding import NamedSharding, PartitionSpec as P
            u0 = jax.device_put(u0, y.sharding)
            a0 = jax.device_put(a0, NamedSharding(y.sharding.mesh, P()))
        else:
            u0 = jnp.asarray(u0)
            a0 = jnp.asarray(a0)
        init_provided = (u0, a0)

    list_ic = None
    ic_n_u = None
    res = None
    stats = SolveStats(y.shape[0], y.shape[1])
    profile_ctx = device_profile(args.profile)
    profile_ctx.__enter__()
    if ic_name:
        if args.multihost and args.shard:
            # 2-D sweep (--multihost --shard): candidate ranks partition
            # across PROCESSES while each process solves its ranks on
            # its LOCAL row-sharded mesh (GSPMD inserts the Gram psums
            # across local devices) — genome-scale model selection
            # composes with multihost. Row padding for shard divisibility
            # perturbs the AIC/BIC n_cpg term by < n_local_devices rows
            # (same as the single-process --shard sweep).
            from demethify_tpu.parallel.mesh import (
                make_mesh,
                shard_dataset,
            )
            lmesh = make_mesh(jax.local_devices(), replicate=1)
            y_ic, d_ic, ref_ic = shard_dataset(
                lmesh, ds.meth_f.astype(np_dtype),
                ds.counts.astype(np_dtype),
                None if ds.ref is None else ds.ref.astype(np_dtype))
            if dev_dtype is not None:
                y_ic = y_ic.astype(dev_dtype)
                d_ic = d_ic.astype(dev_dtype)
                ref_ic = (None if ref_ic is None
                          else ref_ic.astype(dev_dtype))
        elif args.multihost:
            # rank-partitioned sweep on host-full arrays (criteria
            # allgathered; the winner is recomputed identically on
            # every process — see selection/sweep.py)
            y_ic = jnp.asarray(ds.meth_f.astype(np_dtype),
                               dtype=dev_dtype)
            d_ic = jnp.asarray(ds.counts.astype(np_dtype),
                               dtype=dev_dtype)
            ref_ic = None if ds.ref is None else jnp.asarray(
                ds.ref.astype(np_dtype), dtype=dev_dtype)
        else:
            y_ic, d_ic, ref_ic = y, d, ref_mat
        u_best, proportions, ic_n_u, list_ic = evaluate_best_ic(
            y_ic, d_ic, ref_ic, args.init, ic_name, key=key,
            iter1=args.iterations[0], iter2=args.iterations[1],
            tol=termination, tol_relative=args.reltol,
            n_restarts=nb_r, n_u_max=args.icmax[0],
            process_count=n_procs, process_index=proc_id,
            progress=sys.stdout.isatty() and proc_id == 0)
        unknown_header = [f"unknown_cell_{i+1}" for i in range(ic_n_u)]
        header += unknown_header
        _write_profile(u_best, unknown_header)
    elif ref_mat is None:
        res = unsupervised_deconv(y, d, n_u, init=args.init, key=key,
                                  n_restarts=restart,
                                  n_iter1=args.iterations[0],
                                  n_iter2=args.iterations[1],
                                  tol=termination,
                                  tol_relative=args.reltol,
                                  record_trace=args.trace,
                                  init_provided=init_provided)
        proportions = res.proportions
        unknown_header = [f"unknown_cell_{i+1}" for i in range(n_u)]
        header = unknown_header
        _write_profile(res.u, unknown_header)
    elif n_u > 0 and y.shape[1] >= 1:
        if purity is not None:
            res = purity_deconv(y, d, ref_mat, n_u, purity,
                                init=args.init, key=key,
                                n_restarts=restart,
                                n_iter1=args.iterations[0],
                                n_iter2=args.iterations[1],
                                tol=termination,
                                tol_relative=args.reltol,
                                record_trace=args.trace,
                                init_provided=init_provided)
        else:
            res = partial_reference_deconv(y, d, ref_mat, n_u,
                                           init=args.init, key=key,
                                           n_restarts=restart,
                                           n_iter1=args.iterations[0],
                                           n_iter2=args.iterations[1],
                                           tol=termination,
                                           tol_relative=args.reltol,
                                           record_trace=args.trace,
                                           init_provided=init_provided)
        proportions = res.proportions
        unknown_header = [f"unknown_cell_{i+1}" for i in range(n_u)]
        header += unknown_header
        _write_profile(res.u, unknown_header)
    elif n_u == 0 and y.shape[1] >= 1:
        res = supervised_deconv(y, d, ref_mat)
        proportions = res.proportions
    else:
        sys.exit(f'Invalid number of unknown value! : "{n_u}" ')

    profile_ctx.__exit__(None, None, None)
    if args.savestate and res is not None:
        from demethify_tpu.checkpoint import save_factors
        state = {"alpha": res.proportions, "cost": res.cost}
        if res.u is not None:
            state["u"] = res.u
        save_factors(args.savestate, **state)
    time_tot = time() - time_start
    if res is not None:
        stats.finish(res.n_iter)
    if args.trace and res is not None and res.trace is not None \
            and res.trace.size and proc_id == 0:
        trace_arr = res.trace
        if args.multihost:
            from demethify_tpu.parallel.distributed import (
                replicated_to_host,
            )
            trace_arr = replicated_to_host(trace_arr)
        write_cost_trace(outdir, trace_arr)

    # ------------------------------------------------------------------
    # outputs (reference demethify.py:221-239)
    # ------------------------------------------------------------------
    if args.multihost:
        from demethify_tpu.parallel.distributed import replicated_to_host
        props_np = replicated_to_host(proportions).astype(np.float64)
    else:
        props_np = np.asarray(proportions, dtype=np.float64)
    if proc_id != 0:
        # non-zero hosts wrote their profile part files above; the
        # replicated small outputs are process 0's job
        return 0
    write_proportions(outdir, props_np, header, ds.sample_names)

    print("All demethified! Results in " + outdir)
    write_log(outdir, time_tot, ic_name, ic_n_u)
    if res is not None and stats.elapsed:
        with open(os.path.join(outdir, 'log.log'), 'a') as f:
            f.write('\n' + stats.summary() + '\n')

    if args.plot:
        _plot(outdir, props_np, header, ds.sample_names, ci_bounds, list_ic)

    return 0


def _plot(outdir, props, header, sample_names, ci_bounds, list_ic):
    import pandas as pd

    from demethify_tpu.plotting import plot_proportions

    props_df = pd.DataFrame(props, index=header, columns=sample_names)
    ci_df = pd.DataFrame()
    if ci_bounds is not None:
        lo, hi, ci_header = ci_bounds
        ci_df = pd.DataFrame(
            {name: [(float(lo[k, j]), float(hi[k, j]))
                    for k in range(lo.shape[0])]
             for j, name in enumerate(sample_names)}, index=ci_header)
    plot_proportions(props_df, ci_df, outdir, list_ic)


if __name__ == "__main__":
    sys.exit(main())
