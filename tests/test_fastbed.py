"""Native fastbed parser vs pandas and vs its Python fallback, on the
generated cohort and edge cases."""

import numpy as np
import pandas as pd
import pytest

from demethify_tpu.io import fastbed
from demethify_tpu.io.readers import load_dataset

pytestmark = pytest.mark.skipif(not fastbed.available(),
                                reason="no native toolchain")


class TestFastbed:
    def test_matches_pandas_on_fixture(self, cohort):
        path = cohort.samples[0]
        got = fastbed.parse_columns(
            path, ["percent_modified", "valid_coverage"], "\t")
        df = pd.read_csv(path, sep="\t")
        np.testing.assert_allclose(
            got, df[["percent_modified", "valid_coverage"]].values,
            rtol=1e-12)

    def test_na_handling(self, tmp_path):
        p = tmp_path / "x.tsv"
        p.write_text("a\tb\tc\n1\tNA\t3\n4\t\t6\nnan\t8\t.\n")
        got = fastbed.parse_columns(str(p), ["a", "b", "c"], "\t")
        assert got.shape == (3, 3)
        assert np.isnan(got[0, 1]) and np.isnan(got[1, 1])
        assert np.isnan(got[2, 0]) and np.isnan(got[2, 2])
        assert got[0, 0] == 1 and got[2, 1] == 8

    def test_csv_delim(self, tmp_path):
        p = tmp_path / "x.csv"
        p.write_text("percent_modified,valid_coverage\n0.5,10\n0.25,20\n")
        got = fastbed.parse_columns(
            str(p), ["valid_coverage", "percent_modified"], ",")
        np.testing.assert_allclose(got, [[10, 0.5], [20, 0.25]])

    def test_no_trailing_newline(self, tmp_path):
        p = tmp_path / "x.tsv"
        p.write_text("a\tb\n1\t2\n3\t4")
        got = fastbed.parse_columns(str(p), ["b"], "\t")
        np.testing.assert_allclose(got, [[2], [4]])

    def test_missing_column_raises(self, tmp_path):
        p = tmp_path / "x.tsv"
        p.write_text("a\tb\n1\t2\n")
        with pytest.raises(KeyError):
            fastbed.parse_columns(str(p), ["zzz"], "\t")

    def test_dataset_identical_with_and_without_native(self, cohort,
                                                       monkeypatch):
        samples = cohort.samples[:2]
        ds_native = load_dataset(samples, ref=cohort.ref, bedmethyl=True)
        monkeypatch.setattr(fastbed, "available", lambda: False)
        ds_python = load_dataset(samples, ref=cohort.ref, bedmethyl=True)
        np.testing.assert_allclose(ds_native.meth_f, ds_python.meth_f,
                                   rtol=1e-12)
        np.testing.assert_allclose(ds_native.counts, ds_python.counts)
        np.testing.assert_allclose(ds_native.ref, ds_python.ref)
        assert ds_native.header == ds_python.header

    def test_python_fallback_na_handling(self, tmp_path, monkeypatch):
        # the fallback keeps the native missing-value rules
        p = tmp_path / "x.tsv"
        p.write_text("a\tb\tc\n1\tNA\t3\n4\t\t6\nnan\t8\t.\n")
        native = fastbed.parse_columns(str(p), ["a", "b", "c"], "\t")
        monkeypatch.setattr(fastbed, "available", lambda: False)
        python = fastbed.parse_columns(str(p), ["a", "b", "c"], "\t")
        np.testing.assert_array_equal(python, native)
