"""Output writers matching the reference's CSV/log formats byte for byte
(`demethify/demethify.py:204-233`, `bootstrap.py:49-90`).

The reference writes through pandas' ``DataFrame.to_csv``; these writers
produce the same bytes with the ``csv`` module: float cells as the
shortest round-trip ``repr`` (what pandas prints for float64), NaN as the
empty string, and QUOTE_MINIMAL quoting, so the "(lo, hi)" CI cells are
double-quoted for their embedded comma."""

import csv
import math
import os
from typing import List, Optional, Sequence

import numpy as np


def _cell(x: float) -> str:
    return "" if math.isnan(x) else repr(x)


def _write_rows(path: str, header: Sequence[str], rows) -> str:
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow(header)
        out.writerows(rows)
    return path


def _float_rows(values: np.ndarray, index: Optional[Sequence] = None):
    """Rows of formatted cells, optionally led by an index label."""
    rows = np.asarray(values, np.float64).tolist()
    if index is None:
        return ([_cell(x) for x in row] for row in rows)
    return ([label] + [_cell(x) for x in row]
            for label, row in zip(index, rows))


def write_proportions(outdir: str, proportions: np.ndarray,
                      header: List[str], sample_names: List[str]) -> str:
    """`celltypes_proportions.csv`: index name "Cell types", one column per
    sample file basename. Returns the path."""
    path = os.path.join(outdir, "celltypes_proportions.csv")
    return _write_rows(path, ["Cell types"] + list(sample_names),
                       _float_rows(proportions, header))


def write_profile_estimate(outdir: str, u: np.ndarray,
                           unknown_header: List[str],
                           suffix: str = "",
                           row_offset: int = 0) -> str:
    """``suffix``/``row_offset`` support the multi-host path: each host
    writes only its own CpG row block as
    ``methylation_profile_estimate<suffix>.csv`` with a global row index,
    so no host ever gathers the genome-scale factor."""
    path = os.path.join(outdir,
                        f"methylation_profile_estimate{suffix}.csv")
    if suffix:
        index = range(row_offset, row_offset + np.shape(u)[0])
        return _write_rows(path, ["row"] + list(unknown_header),
                           _float_rows(u, index))
    return _write_rows(path, unknown_header, _float_rows(u))


def write_log(outdir: str, total_time: float,
              ic_name: Optional[str] = None,
              ic_n_u: Optional[int] = None) -> str:
    path = os.path.join(outdir, "log.log")
    with open(path, "w+") as f:
        f.write("Total execution time = " + str(total_time) + " s" + "\n")
        if ic_name:
            f.write("Number of unknowns that minimises " + ic_name + " : "
                    + str(ic_n_u))
    return path


def _ci_cells(lower: np.ndarray, upper: np.ndarray):
    """(rows, cols) grid of "(lo, hi)" cells, as str(tuple) prints them."""
    lo = np.asarray(lower, np.float64).tolist()
    hi = np.asarray(upper, np.float64).tolist()
    return [[f"({a!r}, {b!r})" for a, b in zip(rl, rh)]
            for rl, rh in zip(lo, hi)]


def write_ci_proportions(outdir: str, lower: np.ndarray, upper: np.ndarray,
                         cell_types: Sequence[str],
                         sample_names: Sequence[str]) -> str:
    """`confidence_interval_celltypes_proportions.csv`: cells are
    "(lo, hi)" tuples, index name "Cell Type" (reference
    `bootstrap.py:60-70`). lower/upper: (p, n_s). Returns the path."""
    path = os.path.join(outdir,
                        "confidence_interval_celltypes_proportions.csv")
    rows = ([name] + cells
            for name, cells in zip(cell_types, _ci_cells(lower, upper)))
    return _write_rows(path, ["Cell Type"] + list(sample_names), rows)


def write_ci_profile(outdir: str, lower: np.ndarray, upper: np.ndarray,
                     unknown_header: Sequence[str]) -> str:
    """`confidence_interval_methylation_estimate.csv` (reference
    `bootstrap.py:80-89`). lower/upper: (n_cpg, n_u). Returns the path."""
    path = os.path.join(outdir,
                        "confidence_interval_methylation_estimate.csv")
    return _write_rows(path, unknown_header, _ci_cells(lower, upper))
