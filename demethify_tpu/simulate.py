"""In-silico bulk-methylation mixture simulator (seeded fixture generator).

Reference: `test/gen_bedmethyl.py:5-89` and the maintained notebook version
(`test/gen_data.ipynb` cell 5). Generative model: Dirichlet cell-type
proportions, Poisson read coverage, Beta-perturbed reference profiles,
Binomial methylated counts; writes modkit-style sample BEDs plus ground
truth `proportions_sim.csv` / `meth_profile_sim.csv`.

The reference script has two latent bugs fixed here: `unknown_portion` is a
free variable inside `gen_param_u` (`gen_bedmethyl.py:20`) — it's an
explicit argument now — and the missing `import pandas`. RNG is an explicit
`numpy.random.Generator` (host-side data generation; no device involved).

`write_cohort` is the seeded synthetic cohort with no input panel (random
reference profiles, a hidden unknown component); it needs only NumPy, and
the tests and `chip_smoke.py` build their fixtures with it.
"""

import argparse
import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np


def _perturb_reference(R_full: np.ndarray, rng: np.random.Generator,
                       disp: float, eps: float) -> np.ndarray:
    """Beta-jitter the reference profiles (per-site biological noise)."""
    R = R_full + ((R_full == 0) * eps) - ((R_full == 1) * eps)
    return rng.beta(disp * R, disp * (1 - R))


def gen_param_u(R_full: np.ndarray, read_depth: float, trunc: int,
                unknown_portion: np.ndarray, nb_samples: int,
                rng: Optional[np.random.Generator] = None,
                disp: float = 1.0):
    """Mixture with an unknown component: the first `trunc` cell types are
    'known', the rest collapse into one unknown profile with per-sample
    mass `unknown_portion` (shape (1, nb_samples)).

    Returns (meth_counts, coverage, proportions_truth, unknown_profile).
    """
    rng = rng or np.random.default_rng()
    nb_cpg, nb_celltypes = R_full.shape
    unknown_portion = np.reshape(np.asarray(unknown_portion),
                                 (1, nb_samples))

    alpha_known = rng.dirichlet(np.ones(trunc), nb_samples).T
    alpha_unknown = rng.dirichlet(np.ones(nb_celltypes - trunc), 1).T
    alpha_sim = np.concatenate([alpha_known * (1 - unknown_portion),
                                alpha_unknown * unknown_portion])

    d_x = rng.poisson(read_depth, (nb_cpg, nb_samples))
    R_jit = _perturb_reference(R_full, rng, disp, 1e-10)
    beta_sim = R_jit @ alpha_sim
    x = rng.binomial(d_x, np.clip(beta_sim, 0.0, 1.0))
    m_u = R_jit[:, trunc:] @ alpha_unknown

    truth = np.concatenate([alpha_known * (1 - unknown_portion),
                            unknown_portion])
    return x, d_x, truth, m_u


def gen_param(R_full: np.ndarray, read_depth: float, nb_samples: int,
              rng: Optional[np.random.Generator] = None,
              disp: float = 1.0):
    """Fully known mixture. Returns (meth_counts, coverage, proportions)."""
    rng = rng or np.random.default_rng()
    nb_cpg, nb_celltypes = R_full.shape

    alpha_sim = rng.dirichlet(np.ones(nb_celltypes), nb_samples).T
    d_x = rng.poisson(read_depth, (nb_cpg, nb_samples))
    R_jit = _perturb_reference(R_full, rng, disp, 1e-16)
    beta_sim = R_jit @ alpha_sim
    x = rng.binomial(d_x, np.clip(beta_sim, 0.0, 1.0))
    return x, d_x, alpha_sim


def generate_dataset(ref_bed: str, outdir: str, *,
                     nb_samples: int = 10,
                     read_depth: float = 50,
                     nb_known: int = 5,
                     select_cell_types: Optional[Sequence[str]] = None,
                     unknown_portion: Optional[Sequence[float]] = None,
                     subsample: Optional[int] = None,
                     seed: int = 0,
                     disp: float = 1.0,
                     random_known: bool = False) -> dict:
    """Write modkit-style sample BEDs + truth CSVs, like the reference
    notebook's fixture generation (gen_data.ipynb cells 5-8).

    Known cell-type selection mirrors the reference's three modes
    (`gen_bedmethyl.py:56-61`): explicit names (``select_cell_types``),
    the first ``nb_known`` columns (default), or ``random_known`` —
    a seeded draw of ``nb_known`` cell types without replacement."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    ref = pd.read_csv(ref_bed, sep="\t").dropna()
    if subsample:
        ref = ref.sample(n=subsample, random_state=seed)
    pos, df = ref.iloc[:, :3], ref.iloc[:, 3:]

    if select_cell_types:
        known = list(select_cell_types)
    elif random_known:
        known = list(rng.choice(df.columns, nb_known, replace=False))
    else:
        known = list(df.columns)[:nb_known]
    df = df[known + [c for c in df.columns if c not in known]]

    os.makedirs(outdir, exist_ok=True)

    if unknown_portion is not None:
        meth_counts, counts, truth, meth_u = gen_param_u(
            df.values.astype(np.float64), read_depth, len(known),
            np.asarray(unknown_portion, np.float64), nb_samples, rng, disp)
        index_name = known + ["unknown_cell_1"]
        meth_u_df = pd.DataFrame(meth_u, columns=["unknown_cell_1"])
        meth_u_df.to_csv(os.path.join(outdir, "meth_profile_sim.csv"),
                         sep="\t", index=False)
    else:
        meth_counts, counts, truth = gen_param(
            df.values.astype(np.float64), read_depth, nb_samples, rng, disp)
        index_name = list(df.columns)

    truth_df = pd.DataFrame(truth)
    truth_df.index = index_name
    truth_df.columns = [f"sample{i+1}" for i in range(nb_samples)]
    truth_df.to_csv(os.path.join(outdir, "proportions_sim.csv"),
                    sep="\t", index=True)

    sample_paths: List[str] = []
    for i in range(nb_samples):
        sample = pos.copy()
        sample["valid_coverage"] = counts[:, i:i + 1]
        sample["count_modified"] = meth_counts[:, i:i + 1]
        with np.errstate(divide="ignore", invalid="ignore"):
            sample["percent_modified"] = (
                sample["count_modified"] / sample["valid_coverage"]) * 100
        path = os.path.join(outdir, f"sample{i+1}.bed")
        sample.to_csv(path, sep="\t", index=False)
        sample_paths.append(path)

    ref_out = pd.concat([pos.reset_index(drop=True),
                         df[known].reset_index(drop=True)], axis=1)
    ref_path = os.path.join(outdir, "ref_matrix.bed")
    ref_out.to_csv(ref_path, sep="\t", index=False)

    return {"samples": sample_paths, "ref": ref_path,
            "proportions": os.path.join(outdir, "proportions_sim.csv")}


class Cohort(NamedTuple):
    """A simulated cohort: ``profiles`` (n_cpg, n_known + n_unknown) with
    the known panel first, ``proportions`` (n_known + n_unknown, n_s),
    ``coverage`` and ``methylated`` read counts (n_cpg, n_s)."""

    profiles: np.ndarray
    proportions: np.ndarray
    coverage: np.ndarray
    methylated: np.ndarray

    @property
    def fractions(self) -> np.ndarray:
        """Observed methylation fractions, as the readers return them."""
        return self.methylated / self.coverage


def make_cohort(n_cpg: int, n_samples: int = 10, n_known: int = 5,
                n_unknown: int = 1, depth: float = 50,
                seed: int = 0) -> Cohort:
    """Uniform(0, 1) cell-type profiles, Dirichlet(1) proportions per
    sample over known and hidden unknown types, coverage Poisson(depth) + 1
    and Binomial methylated counts of the mixed profile."""
    rng = np.random.default_rng(seed)
    p = n_known + n_unknown
    profiles = rng.uniform(size=(n_cpg, p))
    proportions = rng.dirichlet(np.ones(p), size=n_samples).T
    coverage = rng.poisson(depth, size=(n_cpg, n_samples)) + 1
    methylated = rng.binomial(coverage,
                              np.clip(profiles @ proportions, 0.0, 1.0))
    return Cohort(profiles, proportions, coverage, methylated)


def _write_table(path: str, header: Sequence[str], columns) -> None:
    """Tab-separated table; floats in %.10g, one f-string per row (an
    order of magnitude faster than np.savetxt at 1M rows)."""
    fmt = "\t".join("{:.10g}" if np.asarray(c).dtype.kind == "f" else "{}"
                    for c in columns)
    with open(path, "w") as f:
        f.write("\t".join(header) + "\n")
        f.writelines(fmt.format(*row) + "\n"
                     for row in zip(*(np.asarray(c).tolist()
                                      for c in columns)))


def _site_columns(n_cpg: int):
    return [np.full(n_cpg, "chr1"), np.arange(n_cpg), np.arange(1, n_cpg + 1)]


def write_sample_bed(path: str, coverage: np.ndarray,
                     methylated: np.ndarray) -> str:
    """One sample as a modkit-style bedmethyl file."""
    _write_table(path, ["chrom", "start", "end", "valid_coverage",
                        "count_modified", "percent_modified"],
                 _site_columns(coverage.shape[0])
                 + [coverage, methylated, 100.0 * methylated / coverage])
    return path


def write_reference_bed(path: str, profiles: np.ndarray) -> str:
    """Reference panel: chrom, start, end, one column per cell type."""
    n_cpg, n_ct = profiles.shape
    _write_table(path, ["chrom", "start", "end"]
                 + [f"celltype_{k + 1}" for k in range(n_ct)],
                 _site_columns(n_cpg) + [profiles[:, k] for k in range(n_ct)])
    return path


def write_cohort(outdir: str, cohort: Cohort, n_known: int,
                 executor=None) -> dict:
    """Write ``sample{i}.bed`` (modkit bedmethyl columns) per sample, the
    known panel as ``ref_matrix.bed`` and the truth as ``truth.npz``.
    Files are written through ``executor.submit`` when one is given
    (a process pool writes them in parallel). Returns the paths
    ({"samples", "ref", "truth"})."""
    os.makedirs(outdir, exist_ok=True)
    n_s = cohort.coverage.shape[1]
    sample_paths = [os.path.join(outdir, f"sample{i + 1}.bed")
                    for i in range(n_s)]
    ref_path = os.path.join(outdir, "ref_matrix.bed")
    jobs = [(write_sample_bed, path, cohort.coverage[:, i],
             cohort.methylated[:, i]) for i, path in enumerate(sample_paths)]
    jobs.append((write_reference_bed, ref_path,
                 cohort.profiles[:, :n_known]))
    if executor is None:
        for fn, *args in jobs:
            fn(*args)
    else:
        for future in [executor.submit(*job) for job in jobs]:
            future.result()
    truth_path = os.path.join(outdir, "truth.npz")
    np.savez(truth_path, proportions=cohort.proportions,
             profiles=cohort.profiles, n_known=n_known)
    return {"samples": sample_paths, "ref": ref_path, "truth": truth_path}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Generate an in-silico bulk methylation mixture "
                    "dataset from a reference BED.")
    parser.add_argument('--ref', required=True,
                        help='Reference BED (chrom start end celltypes...)')
    parser.add_argument('--outdir', required=True)
    parser.add_argument('--samples', type=int, default=10)
    parser.add_argument('--depth', type=float, default=50)
    parser.add_argument('--known', type=int, default=5)
    parser.add_argument('--unknown', nargs='+', type=float, default=None,
                        help='Per-sample unknown portions (enables the '
                             'unknown-component model)')
    parser.add_argument('--subsample', type=int, default=None)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--select', nargs='+', default=None,
                        help='Known cell types by name (reference '
                             'gen_u="select" mode)')
    parser.add_argument('--randomknown', action='store_true',
                        help='Pick the known cell types at random '
                             '(reference gen_u="random" mode)')
    args = parser.parse_args(argv)
    generate_dataset(args.ref, args.outdir, nb_samples=args.samples,
                     read_depth=args.depth, nb_known=args.known,
                     select_cell_types=args.select,
                     unknown_portion=args.unknown,
                     subsample=args.subsample, seed=args.seed,
                     random_known=args.randomknown)
    return 0


if __name__ == "__main__":
    main()
