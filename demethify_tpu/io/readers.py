"""Host-side input readers: bedmethyl (modkit-style) and CSV.

Column conventions follow the reference exactly
(`demethify/demethify.py:102-143`):

- bedmethyl (`--bedmethyl`): TSV with header; reference matrix = columns
  3+ of the ref BED; per-sample `percent_modified / 100` and
  `valid_coverage` stacked into (n_cpg, n_s) matrices.
- CSV: values are read raw (already in [0, 1], NO /100); a single-column
  sample file gets `valid_coverage = 1`.
- `--fillna` replaces NA with 0 in every input.

Parsing goes through io/fastbed.py (native parser, Python fallback).
Output dtype is configurable (float32 for the device, float64 for CPU
parity work). Readers return plain NumPy; the solvers' jit boundary
devices them.
"""

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from demethify_tpu.io import fastbed


@dataclass
class Dataset:
    meth_f: np.ndarray                 # (n_cpg, n_s) methylation fractions
    counts: np.ndarray                 # (n_cpg, n_s) coverage weights
    ref: Optional[np.ndarray] = None   # (n_cpg, n_ct) reference profiles
    header: List[str] = field(default_factory=list)  # cell-type names
    sample_names: List[str] = field(default_factory=list)


def _nan_to_zero(vals, fillna: bool):
    return np.nan_to_num(vals, nan=0.0) if fillna else vals


def read_reference_bed(path: str, fillna: bool = False,
                       dtype=np.float64):
    """Reference matrix = columns 3+ of the reference BED."""
    header = fastbed.read_header(path, "\t")[3:]
    vals = fastbed.parse_columns(path, header, "\t")
    return _nan_to_zero(vals, fillna).astype(dtype), header


def read_reference_csv(path: str, fillna: bool = False,
                       dtype=np.float64):
    """Reference matrix = every column of the reference CSV."""
    header = fastbed.read_header(path, ",")
    vals = fastbed.parse_columns(path, header, ",")
    return _nan_to_zero(vals, fillna).astype(dtype), header


def _check_equal_rows(meth, paths):
    lens = {len(m) for m in meth}
    if len(lens) > 1:
        detail = ", ".join(f"{p.split('/')[-1]}:{len(m)}"
                           for p, m in zip(paths, meth))
        raise ValueError(
            f"Sample files have different CpG row counts ({detail}) — "
            f"intersect them first (demethify-tpu-intersect).")


def read_bedmethyl_samples(paths: List[str], fillna: bool = False,
                           dtype=np.float64):
    meth, counts = [], []
    for bed in paths:
        vals = _nan_to_zero(fastbed.parse_columns(
            bed, ["percent_modified", "valid_coverage"], "\t"), fillna)
        meth.append(vals[:, 0] / 100.0)
        counts.append(vals[:, 1])
    _check_equal_rows(meth, paths)
    return (np.column_stack(meth).astype(dtype),
            np.column_stack(counts).astype(dtype))


def read_csv_samples(paths: List[str], fillna: bool = False,
                     dtype=np.float64):
    """A single-column sample CSV gets ``valid_coverage = 1``."""
    meth, counts = [], []
    for csv in paths:
        if len(fastbed.read_header(csv, ",")) == 1:
            vals = _nan_to_zero(fastbed.parse_columns(
                csv, ["percent_modified"], ","), fillna)
            meth.append(vals[:, 0])
            counts.append(np.ones(vals.shape[0]))
        else:
            vals = _nan_to_zero(fastbed.parse_columns(
                csv, ["percent_modified", "valid_coverage"], ","), fillna)
            meth.append(vals[:, 0])
            counts.append(vals[:, 1])
    _check_equal_rows(meth, paths)
    return (np.column_stack(meth).astype(dtype),
            np.column_stack(counts).astype(dtype))


def load_dataset(methfreq: List[str], ref: Optional[str] = None,
                 bedmethyl: bool = False, fillna: bool = False,
                 dtype=np.float64) -> Dataset:
    header: List[str] = []
    ref_mat = None
    if bedmethyl:
        if ref:
            ref_mat, header = read_reference_bed(ref, fillna, dtype)
        meth_f, counts = read_bedmethyl_samples(methfreq, fillna, dtype)
    else:
        if ref:
            ref_mat, header = read_reference_csv(ref, fillna, dtype)
        meth_f, counts = read_csv_samples(methfreq, fillna, dtype)
    if ref_mat is not None and ref_mat.shape[0] != meth_f.shape[0]:
        raise ValueError(
            f"Row mismatch: reference has {ref_mat.shape[0]} CpG rows but "
            f"samples have {meth_f.shape[0]} — intersect the BED files "
            f"first (demethify-tpu-intersect).")
    sample_names = [p.split("/")[-1] for p in methfreq]
    return Dataset(meth_f=meth_f, counts=counts, ref=ref_mat,
                   header=header, sample_names=sample_names)
