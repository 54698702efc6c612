"""Readers/writers: column conventions, fillna, output formats, utils."""

import os

import numpy as np
import pandas as pd
import pytest

from demethify_tpu.io.readers import (
    load_dataset,
    read_csv_samples,
)
from demethify_tpu.io.writers import (
    write_ci_profile,
    write_ci_proportions,
    write_log,
    write_profile_estimate,
    write_proportions,
)
from demethify_tpu.utils import SolveStats, write_cost_trace


class TestCSVReaders:
    def test_single_column_gets_unit_coverage(self, tmp_path):
        p = tmp_path / "s.csv"
        p.write_text("percent_modified\n0.5\n0.25\n0.75\n")
        meth, counts = read_csv_samples([str(p)])
        np.testing.assert_allclose(meth[:, 0], [0.5, 0.25, 0.75])
        np.testing.assert_allclose(counts[:, 0], 1.0)

    def test_csv_values_not_rescaled(self, tmp_path):
        # CSV convention: raw values (no /100), reference demethify.py:140
        p = tmp_path / "s.csv"
        p.write_text("percent_modified,valid_coverage\n0.9,30\n0.1,50\n")
        meth, counts = read_csv_samples([str(p)])
        np.testing.assert_allclose(meth[:, 0], [0.9, 0.1])
        np.testing.assert_allclose(counts[:, 0], [30, 50])

    def test_fillna(self, tmp_path):
        p = tmp_path / "s.csv"
        p.write_text("percent_modified,valid_coverage\n0.5,\nNA,20\n")
        meth, counts = read_csv_samples([str(p)], fillna=True)
        np.testing.assert_allclose(meth[:, 0], [0.5, 0.0])
        np.testing.assert_allclose(counts[:, 0], [0.0, 20.0])

    def test_bedmethyl_rescales_percent(self, tmp_path):
        p = tmp_path / "s.bed"
        p.write_text("chrom\tstart\tend\tvalid_coverage\tcount_modified\t"
                     "percent_modified\nchr1\t0\t1\t40\t20\t50.0\n")
        ds = load_dataset([str(p)], bedmethyl=True)
        np.testing.assert_allclose(ds.meth_f[:, 0], [0.5])
        np.testing.assert_allclose(ds.counts[:, 0], [40])
        assert ds.sample_names == ["s.bed"]


class TestWriters:
    def test_proportions_format(self, tmp_path):
        props = np.array([[0.6, 0.3], [0.4, 0.7]])
        returned = write_proportions(str(tmp_path), props, ["A", "B"],
                                     ["s1.bed", "s2.bed"])
        assert returned == os.path.join(tmp_path,
                                        "celltypes_proportions.csv")
        df = pd.read_csv(returned, index_col=0)
        assert df.index.name == "Cell types"
        assert list(df.columns) == ["s1.bed", "s2.bed"]
        np.testing.assert_allclose(df.values, props)

    def test_ci_tuple_cells(self, tmp_path):
        lo = np.array([[0.1, 0.2]])
        hi = np.array([[0.3, 0.4]])
        path = write_ci_proportions(str(tmp_path), lo, hi, ["A"],
                                    ["s1", "s2"])
        back = pd.read_csv(path, index_col=0)
        assert back.index.name == "Cell Type"
        lo0, hi0 = eval(back.iloc[0, 0])
        assert (lo0, hi0) == (0.1, 0.3)

    def test_log_format(self, tmp_path):
        path = write_log(str(tmp_path), 1.234, "AIC", 7)
        text = open(path).read()
        assert text.startswith("Total execution time = 1.234 s")
        assert "Number of unknowns that minimises AIC : 7" in text


# values whose text forms differ most between float printers: exponents,
# negative zero, the shortest round-trip digits, denormals, NaN
_AWKWARD = np.array([[0.1 + 0.2, 1e-05, 0.0001, 1.0, -0.0],
                     [1e16, 123456789.123, 5e-324, np.nan, 1e22],
                     [0.3333333333333333, 2.5e-10, 7.0, 1e-17, 0.5]])


class TestWritersMatchPandas:
    """The writers replaced pandas' to_csv; a run's files must be the
    bytes the pandas writers produced."""

    def _pandas_bytes(self, pd, tmp_path, write):
        path = tmp_path / "pandas.csv"
        write(pd, str(path))
        return path.read_bytes()

    def test_proportions(self, tmp_path):
        pd_ = pytest.importorskip("pandas")

        def legacy(pd, path):
            df = pd.DataFrame(_AWKWARD)
            df.index = ["A", "B,x", "unknown_cell_1"]
            df.columns = ["s1.bed", "s 2.bed", "s3", "s4", "s5"]
            df.index.name = "Cell types"
            df.to_csv(path, index=True)

        got = write_proportions(str(tmp_path), _AWKWARD,
                                ["A", "B,x", "unknown_cell_1"],
                                ["s1.bed", "s 2.bed", "s3", "s4", "s5"])
        assert open(got, "rb").read() == self._pandas_bytes(
            pd_, tmp_path, legacy)

    @pytest.mark.parametrize("suffix", ["", ".part0001"])
    def test_profile_estimate(self, tmp_path, suffix):
        pd_ = pytest.importorskip("pandas")
        u = _AWKWARD.T                       # (5 rows, 3 unknowns)
        header = ["unknown_cell_1", "unknown_cell_2", "unknown_cell_3"]

        def legacy(pd, path):
            df = pd.DataFrame(u)
            if suffix:
                df.index = np.arange(40, 45)
                df.to_csv(path, index=True, index_label="row",
                          header=header)
            else:
                df.to_csv(path, index=False, header=header)

        got = write_profile_estimate(str(tmp_path), u, header,
                                     suffix=suffix, row_offset=40)
        assert open(got, "rb").read() == self._pandas_bytes(
            pd_, tmp_path, legacy)

    def test_ci_files(self, tmp_path):
        pd_ = pytest.importorskip("pandas")
        lo = np.nan_to_num(_AWKWARD)
        hi = lo + 0.125

        def legacy(pd, path):
            data = {name: [(float(lo[k, j]), float(hi[k, j]))
                           for k in range(lo.shape[0])]
                    for j, name in enumerate(["a", "b", "c", "d", "e"])}
            df = pd.DataFrame(data, index=["x", "y", "z"])
            df.index.name = "Cell Type"
            df.to_csv(path, index=True)

        got = write_ci_proportions(str(tmp_path), lo, hi, ["x", "y", "z"],
                                   ["a", "b", "c", "d", "e"])
        assert open(got, "rb").read() == self._pandas_bytes(
            pd_, tmp_path, legacy)
        # the profile CI file reads back as the same (lo, hi) cells
        path = write_ci_profile(str(tmp_path), lo.T, hi.T, ["u1", "u2",
                                                            "u3"])
        back = pd_.read_csv(path)
        assert list(back.columns) == ["u1", "u2", "u3"]
        assert eval(back.iloc[3, 1]) == (float(lo[1, 3]), float(hi[1, 3]))


class TestUtils:
    def test_cost_trace_drops_nan_padding(self, tmp_path):
        trace = np.array([5.0, 4.0, 3.5, np.nan, np.nan])
        path = write_cost_trace(str(tmp_path), trace)
        df = pd.read_csv(path)
        assert len(df) == 3
        np.testing.assert_allclose(df["cost"], [5.0, 4.0, 3.5])

    def test_solve_stats(self):
        st = SolveStats(1000, 4)
        st.finish(10)
        assert st.outer_iters == 10
        assert st.site_iters_per_s > 0
        assert "site-iters/s" in st.summary()
