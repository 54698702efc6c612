"""End-to-end CLI runs on the seeded synthetic cohort (conftest `cohort`:
2,000 sites x 10 samples, 5 known cell types + 1 hidden unknown), checked
against tests/oracle.py run from the same init and against the simulated
truth (accuracy criterion per SURVEY.md §6)."""

import os

import jax
import numpy as np
import pandas as pd
import pytest

from demethify_tpu.cli import main as cli_main
from demethify_tpu.io.readers import load_dataset
from tests import oracle


def _run(cohort, outdir, *extra):
    argv = ["--methfreq", *cohort.samples, "--bedmethyl",
            "--outdir", str(outdir), "--noprint", "--dtype", "float64",
            *extra]
    assert cli_main(argv) == 0


def _read_props(path):
    return pd.read_csv(path, index_col=0)


def _n_iter(outdir):
    with open(os.path.join(outdir, "log.log")) as f:
        log = f.read()
    return int(log.split(" outer iterations")[0].rsplit(" ", 1)[-1])


@pytest.fixture(scope="module")
def data(cohort):
    return load_dataset(cohort.samples, ref=cohort.ref, bedmethyl=True)


def _unknown_truth(cohort):
    return cohort.truth.proportions[-1]


class TestReferenceBased:
    def test_matches_golden(self, cohort, data, tmp_path):
        # the reference's sklearn/scipy WLS (tests/oracle.py) per sample
        _run(cohort, tmp_path, "--ref", cohort.ref)
        got = _read_props(tmp_path / "celltypes_proportions.csv")
        assert list(got.index) == [f"celltype_{k}" for k in range(1, 6)]
        assert list(got.columns) == [f"sample{i}.bed" for i in range(1, 11)]
        want = np.stack([oracle.wls_intercept(
            data.counts[:, s] * data.meth_f[:, s], data.counts[:, s],
            data.ref) for s in range(10)], axis=1)
        np.testing.assert_allclose(got.values, want, atol=2e-6)

    def test_recovers_simulation(self, cohort, data, tmp_path):
        _run(cohort, tmp_path, "--ref", cohort.ref)
        got = _read_props(tmp_path / "celltypes_proportions.csv")
        # known rows renormalized by (1 - unknown portion)
        known = cohort.truth.proportions[:-1]
        known = known / known.sum(axis=0, keepdims=True)
        rmse = np.sqrt(np.mean((got.values - known) ** 2))
        want = np.stack([oracle.wls_intercept(
            data.counts[:, s] * data.meth_f[:, s], data.counts[:, s],
            data.ref) for s in range(10)], axis=1)
        # at least as accurate as the reference's own procedure
        assert rmse <= np.sqrt(np.mean((want - known) ** 2)) + 1e-6


class TestPartialRef:
    def test_fixture_run(self, cohort, data, tmp_path):
        from demethify_tpu.solvers.init import init_partial

        _run(cohort, tmp_path, "--ref", cohort.ref, "--nbunknown", "1",
             "--seed", "3")
        got = _read_props(tmp_path / "celltypes_proportions.csv")
        assert list(got.index)[-1] == "unknown_cell_1"
        # the unknown-portion estimate tracks the simulated truth
        unknown_rmse = np.sqrt(np.mean(
            (got.values[-1] - _unknown_truth(cohort)) ** 2))
        assert unknown_rmse < 0.1
        # trajectory parity with the oracle from the CLI's own init
        u0, a0 = init_partial(jax.random.PRNGKey(3), "uniform_",
                              data.meth_f, data.counts, data.ref, 1)
        u0 = np.asarray(u0)
        _, want = oracle.partial_ref_solve(
            u0, np.hstack([data.ref, u0]), np.asarray(a0), data.meth_f,
            data.counts, data.ref, 1, _n_iter(tmp_path), 20, 0.0)
        np.testing.assert_allclose(got.values, want, atol=1e-7)
        prof = pd.read_csv(tmp_path / "methylation_profile_estimate.csv")
        assert prof.shape == (cohort.n_sites, 1)
        assert ((prof.values >= 0) & (prof.values <= 1)).all()


class TestUnsupervised:
    def test_fixture_run(self, cohort, tmp_path):
        _run(cohort, tmp_path, "--nbunknown", "4")
        got = _read_props(tmp_path / "celltypes_proportions.csv")
        assert got.shape == (4, 10)
        np.testing.assert_allclose(got.values.sum(axis=0), 1.0, atol=1e-6)
        prof = pd.read_csv(tmp_path / "methylation_profile_estimate.csv")
        assert prof.shape == (cohort.n_sites, 4)


class TestPurity:
    def test_fixture_run(self, cohort, tmp_path):
        # CLI purity p% = tumor (unknown) fraction; after the reference's
        # flip (demethify.py:77) the FW constraint pins the unknown block's
        # mass at p/100 exactly
        unknown = _unknown_truth(cohort)
        purities = [repr(100 * float(u)) for u in unknown]
        _run(cohort, tmp_path, "--ref", cohort.ref, "--nbunknown", "1",
             "--purity", *purities, "--iterations", "50", "100")
        got = _read_props(tmp_path / "celltypes_proportions.csv")
        np.testing.assert_allclose(got.values[-1], unknown, atol=1e-8)


class TestBootstrapCI:
    def test_ci_outputs(self, cohort, tmp_path):
        _run(cohort, tmp_path, "--ref", cohort.ref, "--confidence", "95",
             "24")
        ci = pd.read_csv(
            tmp_path / "confidence_interval_celltypes_proportions.csv",
            index_col=0)
        assert ci.shape == (5, 10)
        lo, hi = eval(ci.iloc[0, 0])
        assert 0 <= lo <= hi <= 1

    def test_ci_partial(self, cohort, tmp_path):
        _run(cohort, tmp_path, "--ref", cohort.ref, "--nbunknown", "1",
             "--confidence", "90", "8", "--iterations", "200", "10")
        ci_prof = pd.read_csv(
            tmp_path / "confidence_interval_methylation_estimate.csv")
        assert ci_prof.shape == (cohort.n_sites, 1)

    def test_ci_svd_weights_mode(self, cohort, tmp_path):
        # genome-scale CI layout with a deterministic init: shared
        # full-data SVD init + per-replicate weighted solves
        _run(cohort, tmp_path, "--ref", cohort.ref, "--nbunknown", "1",
             "--init", "SVD", "--cimethod", "weights",
             "--confidence", "90", "8", "--iterations", "200", "10")
        ci = pd.read_csv(
            tmp_path / "confidence_interval_celltypes_proportions.csv",
            index_col=0)
        assert ci.shape == (6, 10)
        lo, hi = eval(ci.iloc[0, 0])
        assert 0 <= lo <= hi <= 1
        ci_prof = pd.read_csv(
            tmp_path / "confidence_interval_methylation_estimate.csv")
        assert ci_prof.shape == (cohort.n_sites, 1)

    def test_ci_unsupervised(self, cohort, tmp_path):
        # the reference crashes on --confidence without --ref
        # (bootstrap.py:63, ref.shape with ref=None); fixed here
        _run(cohort, tmp_path, "--nbunknown", "2",
             "--confidence", "90", "6", "--iterations", "100", "8")
        ci = pd.read_csv(
            tmp_path / "confidence_interval_celltypes_proportions.csv",
            index_col=0)
        assert ci.shape == (2, 10)
        assert list(ci.index) == ["unknown_cell_1", "unknown_cell_2"]
        lo, hi = eval(ci.iloc[0, 0])
        assert 0 <= lo <= hi <= 1
        ci_prof = pd.read_csv(
            tmp_path / "confidence_interval_methylation_estimate.csv")
        assert ci_prof.shape == (cohort.n_sites, 2)


class TestModelSelection:
    def test_aic_sweep(self, cohort, tmp_path):
        _run(cohort, tmp_path, "--ref", cohort.ref, "--ic", "AIC",
             "--icmax", "3", "--iterations", "300", "10")
        log = (tmp_path / "log.log").read_text()
        assert "Number of unknowns that minimises AIC" in log
        prof = pd.read_csv(tmp_path / "methylation_profile_estimate.csv")
        assert prof.shape[0] == cohort.n_sites


class TestGoldenCostParity:
    """Factor-level comparison is meaningless for non-identifiable modes;
    compare achieved COST against the oracle run from the same init."""

    def test_unsupervised_cost_at_least_matches_golden(self, cohort, data,
                                                       tmp_path):
        from demethify_tpu.solvers.init import init_unsupervised

        _run(cohort, tmp_path, "--nbunknown", "4", "--seed", "5")
        prof = pd.read_csv(tmp_path / "methylation_profile_estimate.csv")
        props = _read_props(tmp_path / "celltypes_proportions.csv")
        recon = prof.values @ props.values
        ours = oracle.cost_w(data.meth_f, prof.values, props.values,
                             data.counts)
        u0, a0 = init_unsupervised(jax.random.PRNGKey(5), "uniform_",
                                   data.meth_f, data.counts, 4)
        u_o, a_o = oracle.unsupervised_solve(
            np.asarray(u0), np.asarray(a0), data.meth_f, data.counts, 4,
            _n_iter(tmp_path), 20, 0.0)
        want = oracle.cost_w(data.meth_f, u_o, a_o, data.counts)
        assert ours == pytest.approx(want, rel=1e-8)
        # accuracy vs SIMULATION truth: the fit must denoise — its
        # reconstruction sits closer to the noise-free simulated mixture
        # than the raw data does
        truth = cohort.truth
        y_clean = truth.profiles @ truth.proportions
        rmse_fit = float(np.sqrt(np.mean((recon - y_clean) ** 2)))
        rmse_raw = float(np.sqrt(np.mean((data.meth_f - y_clean) ** 2)))
        assert rmse_fit < rmse_raw

    def test_purity_matches_golden_constraint(self, cohort, data, tmp_path):
        # purity = 100*(1 - unknown_truth): the unknown row is pinned at
        # 1 - truth, and the whole alpha follows the oracle's FW run from
        # the CLI's own init
        from demethify_tpu.solvers.init import init_purity

        truth = _unknown_truth(cohort)
        purities = [repr(100 * (1 - float(u))) for u in truth]
        _run(cohort, tmp_path, "--ref", cohort.ref, "--nbunknown", "1",
             "--purity", *purities, "--iterations", "100", "100")
        got = _read_props(tmp_path / "celltypes_proportions.csv")
        np.testing.assert_allclose(got.values[-1], 1 - truth, atol=1e-8)
        flipped = 1.0 - np.array([float(p) for p in purities]) / 100.0
        u0, a0 = init_purity(jax.random.PRNGKey(1), "uniform_",
                             data.meth_f, data.counts, data.ref, 1,
                             flipped)
        _, want = oracle.purity_solve(
            np.asarray(u0), np.asarray(a0), data.meth_f, data.counts,
            data.ref, flipped, 1, _n_iter(tmp_path), 100, 0.0)
        np.testing.assert_allclose(got.values, want, atol=1e-7)


class TestDeterminism:
    def test_same_seed_same_output(self, cohort, tmp_path):
        a, b = tmp_path / "a", tmp_path / "b"
        for out in (a, b):
            _run(cohort, out, "--ref", cohort.ref, "--nbunknown", "1",
                 "--seed", "11", "--iterations", "50", "10")
        pa = _read_props(a / "celltypes_proportions.csv")
        pb = _read_props(b / "celltypes_proportions.csv")
        np.testing.assert_array_equal(pa.values, pb.values)

    def test_purity_length_mismatch_rejected(self, cohort, tmp_path):
        with pytest.raises(SystemExit):
            _run(cohort, tmp_path, "--ref", cohort.ref, "--nbunknown", "1",
                 "--purity", "60", "70")  # 10 samples, 2 purity values


class TestRemainingCLIPaths:
    def test_minka_via_cli(self, cohort, tmp_path):
        _run(cohort, tmp_path, "--ref", cohort.ref, "--ic", "minka",
             "--iterations", "100", "10")
        log = (tmp_path / "log.log").read_text()
        assert "minka" in log

    def test_bcv_via_cli(self, cohort, tmp_path):
        _run(cohort, tmp_path, "--ref", cohort.ref, "--ic", "BCV", "3",
             "--icmax", "2", "--iterations", "50", "5")
        log = (tmp_path / "log.log").read_text()
        assert "BCV" in log

    def test_svd_init_via_cli(self, cohort, tmp_path):
        _run(cohort, tmp_path, "--ref", cohort.ref, "--nbunknown", "1",
             "--init", "SVD", "--iterations", "100", "10")
        got = _read_props(tmp_path / "celltypes_proportions.csv")
        np.testing.assert_allclose(got.values.sum(axis=0), 1.0, atol=1e-8)

    def test_ica_init_via_cli(self, cohort, tmp_path):
        _run(cohort, tmp_path, "--ref", cohort.ref, "--nbunknown", "1",
             "--init", "ICA", "--iterations", "50", "5")
        got = _read_props(tmp_path / "celltypes_proportions.csv")
        np.testing.assert_allclose(got.values.sum(axis=0), 1.0, atol=1e-8)

    def test_purity_with_confidence(self, cohort, tmp_path):
        unknown = _unknown_truth(cohort)
        purities = [repr(100 * float(u)) for u in unknown]
        _run(cohort, tmp_path, "--ref", cohort.ref, "--nbunknown", "1",
             "--purity", *purities, "--confidence", "90", "6",
             "--iterations", "20", "30")
        ci = pd.read_csv(
            tmp_path / "confidence_interval_celltypes_proportions.csv",
            index_col=0)
        assert ci.shape == (6, 10)
        # the purity constraint pins the unknown mass, so its CI is
        # (nearly) degenerate at p/100
        lo, hi = eval(ci.iloc[-1, 0])
        assert abs(lo - unknown[0]) < 0.05 and abs(hi - unknown[0]) < 0.05

    def test_restart_via_cli(self, cohort, tmp_path):
        _run(cohort, tmp_path, "--ref", cohort.ref, "--nbunknown", "1",
             "--restart", "4", "--iterations", "50", "10")
        got = _read_props(tmp_path / "celltypes_proportions.csv")
        assert got.shape == (6, 10)


class TestSaveInitState:
    def test_warm_start_resumes(self, cohort, tmp_path):
        # the saved run converges far below the resumed run's tolerance,
        # so its state is (near) stationary for the resumed run
        ck = str(tmp_path / "state")
        _run(cohort, tmp_path / "a", "--ref", cohort.ref, "--nbunknown",
             "1", "--iterations", "3000", "8", "--termination", "1e-6",
             "--savestate", ck)
        _run(cohort, tmp_path / "b", "--ref", cohort.ref, "--nbunknown",
             "1", "--iterations", "150", "8", "--initstate", ck)
        a = _read_props(tmp_path / "a" / "celltypes_proportions.csv")
        b = _read_props(tmp_path / "b" / "celltypes_proportions.csv")
        np.testing.assert_allclose(a.values, b.values, atol=1e-4)
        # warm start must converge (almost) immediately
        assert _n_iter(tmp_path / "b") <= 2

    def test_initstate_rejected_for_supervised_and_ic(self, cohort,
                                                      tmp_path):
        ck = str(tmp_path / "state")
        with pytest.raises(SystemExit):
            _run(cohort, tmp_path / "c", "--ref", cohort.ref,
                 "--initstate", ck)

    def test_warm_start_onto_sharded_mesh(self, cohort, tmp_path):
        # save unsharded, restore onto the 8-device cpg mesh (--shard):
        # the CLI must place the factors with the run's global sharding
        ck = str(tmp_path / "state")
        _run(cohort, tmp_path / "a", "--ref", cohort.ref, "--nbunknown",
             "1", "--iterations", "3000", "8", "--termination", "1e-6",
             "--savestate", ck)
        _run(cohort, tmp_path / "b", "--ref", cohort.ref, "--nbunknown",
             "1", "--iterations", "150", "8", "--shard", "--initstate", ck)
        a = _read_props(tmp_path / "a" / "celltypes_proportions.csv")
        b = _read_props(tmp_path / "b" / "celltypes_proportions.csv")
        np.testing.assert_allclose(a.values, b.values, atol=1e-4)

    def test_bare_savestate_flag_errors(self, cohort, tmp_path):
        # a forgotten path must be a parse error, not a silent no-op
        with pytest.raises(SystemExit):
            _run(cohort, tmp_path, "--ref", cohort.ref, "--nbunknown", "1",
                 "--iterations", "5", "2", "--savestate")


class TestBfloat16CLI:
    def test_partial_ref_bf16(self, cohort, tmp_path):
        args = ["--ref", cohort.ref, "--nbunknown", "1", "--iterations",
                "120", "8"]
        _run(cohort, tmp_path / "f64", *args)
        argv = ["--methfreq", *cohort.samples, "--bedmethyl",
                "--outdir", str(tmp_path / "bf16"), "--noprint",
                "--dtype", "bfloat16", *args]
        assert cli_main(argv) == 0
        got = _read_props(tmp_path / "bf16" / "celltypes_proportions.csv")
        want = _read_props(tmp_path / "f64" / "celltypes_proportions.csv")
        # bf16 storage, f32 accumulation: statistical agreement with the
        # float64 run from the same init
        rmse = float(np.sqrt(((got.values - want.values) ** 2).mean()))
        assert rmse < 0.12
        sums = got.values.sum(axis=0)
        np.testing.assert_allclose(sums, 1.0, atol=5e-2)


class TestTraceCLI:
    def test_trace_writes_trajectory(self, cohort, tmp_path):
        _run(cohort, tmp_path, "--ref", cohort.ref, "--nbunknown", "1",
             "--iterations", "60", "5", "--trace")
        tr = pd.read_csv(tmp_path / "cost_trajectory.csv")
        assert list(tr.columns) == ["iteration", "cost"]
        assert len(tr) >= 2
        # termination is on |delta cost|; trajectory must be finite
        assert np.isfinite(tr["cost"]).all()
