"""Multi-host helpers: row-block ownership, global array assembly."""

import os

import numpy as np
import jax

from demethify_tpu.parallel.distributed import host_row_block, initialize
from demethify_tpu.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_host_row_block_partitions_exactly():
    n_rows, n_hosts = 103, 4
    blocks = [host_row_block(n_rows, n_hosts, h) for h in range(n_hosts)]
    # contiguous, disjoint, covering
    assert blocks[0][0] == 0
    assert blocks[-1][1] == n_rows
    for (s0, e0), (s1, e1) in zip(blocks, blocks[1:]):
        assert e0 == s1
    sizes = [e - s for s, e in blocks]
    assert max(sizes) - min(sizes) <= 1


def test_initialize_single_process_noop():
    initialize()  # must not raise or attempt a network rendezvous
    initialize(num_processes=1)


def test_make_mesh_replicate_override():
    mesh = make_mesh(jax.devices(), replicate=1)
    assert mesh.shape["replicate"] == 1
    assert mesh.shape["cpg"] == len(jax.devices())


class TestMultiProcessE2E:
    """REAL multi-process runs: two OS processes join one jax.distributed
    runtime over CPU (gloo collectives) and run the full CLI with
    globally row-sharded CpG arrays — the closest single-machine
    approximation of a multi-host run."""

    def _run_cli(self, cohort, extra, env):
        import sys
        cmd = [sys.executable, "-m", "demethify_tpu",
               "--methfreq", *cohort.samples, "--ref", cohort.ref,
               "--bedmethyl", "--noprint", "--platform", "cpu",
               "--dtype", "float64", "--nbunknown", "1",
               "--iterations", "40", "5", "--seed", "3"] + extra
        return cmd

    def test_two_process_purity_matches_single(self, cohort, tmp_path):
        import os
        import socket
        import subprocess

        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
        env.pop("JAX_PLATFORMS", None)
        purity = ["--purity"] + [str(50 + 4 * i) for i in range(10)] + \
                 ["--iterations", "10", "20"]

        out1 = tmp_path / "single"
        cmd = self._run_cli(cohort, ["--outdir", str(out1)], env)
        # replace the partial-ref iteration schedule with the purity one
        i = cmd.index("--iterations")
        cmd = cmd[:i] + purity + cmd[i + 3:]
        subprocess.run(cmd, check=True, env=env, cwd=REPO,
                       timeout=300)

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        out2 = tmp_path / "multi"
        procs = []
        for pid in (0, 1):
            cmd = self._run_cli(cohort, ["--outdir", str(out2), "--multihost",
                                 f"localhost:{port}", "2", str(pid)], env)
            i = cmd.index("--iterations")
            cmd = cmd[:i] + purity + cmd[i + 3:]
            procs.append(subprocess.Popen(cmd, env=env, cwd=REPO))
        for pr in procs:
            assert pr.wait(timeout=300) == 0

        import pandas as pd
        got = pd.read_csv(out2 / "celltypes_proportions.csv", index_col=0)
        want = pd.read_csv(out1 / "celltypes_proportions.csv", index_col=0)
        np.testing.assert_allclose(got.values, want.values, atol=1e-8)

    def _two_proc_vs_single(self, cohort, tmp_path, extra,
                            drop_nbunknown=False):
        import os
        import socket
        import subprocess

        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
        env.pop("JAX_PLATFORMS", None)

        def build(args):
            cmd = self._run_cli(cohort, args, env)
            if drop_nbunknown:
                i = cmd.index("--nbunknown")
                del cmd[i:i + 2]
            return cmd

        out1 = tmp_path / "single"
        subprocess.run(build(["--outdir", str(out1)] + extra),
                       check=True, env=env, cwd=REPO,
                       timeout=600)

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        out2 = tmp_path / "multi"
        procs = [subprocess.Popen(
            build(["--outdir", str(out2), "--multihost",
                   f"localhost:{port}", "2", str(pid)] + extra),
            env=env, cwd=REPO) for pid in (0, 1)]
        for pr in procs:
            assert pr.wait(timeout=600) == 0
        return out1, out2

    def test_two_process_bootstrap_matches_single(self, cohort, tmp_path):
        import pandas as pd
        out1, out2 = self._two_proc_vs_single(
            cohort, tmp_path, ["--confidence", "90", "7"])
        # CI cells are "(lo, hi)" strings — exact match required: both
        # paths run the replicates on host-full arrays with keys folding
        # the GLOBAL replicate index
        for fname in ["confidence_interval_celltypes_proportions.csv",
                      "confidence_interval_methylation_estimate.csv"]:
            got = pd.read_csv(out2 / fname, index_col=0)
            want = pd.read_csv(out1 / fname, index_col=0)
            assert got.equals(want), fname
        # the point estimate itself runs on the row-sharded mesh in the
        # 2-process run — equal up to psum reassociation
        got = pd.read_csv(out2 / "celltypes_proportions.csv", index_col=0)
        want = pd.read_csv(out1 / "celltypes_proportions.csv",
                           index_col=0)
        np.testing.assert_allclose(got.values, want.values, atol=1e-8)

    def test_two_process_ic_sweep_matches_single(self, cohort, tmp_path):
        import pandas as pd
        out1, out2 = self._two_proc_vs_single(
            cohort, tmp_path, ["--ic", "AIC", "--icmax", "3",
                       "--init", "beta", "--iterations", "30", "5"],
            drop_nbunknown=True)
        got = pd.read_csv(out2 / "celltypes_proportions.csv", index_col=0)
        want = pd.read_csv(out1 / "celltypes_proportions.csv",
                           index_col=0)
        assert list(got.index) == list(want.index)  # same chosen rank
        np.testing.assert_allclose(got.values, want.values, atol=1e-8)

    def test_two_process_cli_matches_single(self, cohort, tmp_path):
        import os
        import socket
        import subprocess

        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
        env.pop("JAX_PLATFORMS", None)

        out1 = tmp_path / "single"
        subprocess.run(self._run_cli(cohort, ["--outdir", str(out1)], env),
                       check=True, env=env, cwd=REPO, timeout=300)

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        out2 = tmp_path / "multi"
        procs = [subprocess.Popen(
            self._run_cli(cohort, ["--outdir", str(out2), "--multihost",
                           f"localhost:{port}", "2", str(pid)], env),
            env=env, cwd=REPO) for pid in (0, 1)]
        for pr in procs:
            assert pr.wait(timeout=300) == 0

        import pandas as pd
        got = pd.read_csv(out2 / "celltypes_proportions.csv", index_col=0)
        want = pd.read_csv(out1 / "celltypes_proportions.csv", index_col=0)
        np.testing.assert_allclose(got.values, want.values, atol=1e-8)

        # per-host unknown-profile part files cover all rows exactly once
        part0 = pd.read_csv(out2 / "methylation_profile_estimate.part0000.csv")
        part1 = pd.read_csv(out2 / "methylation_profile_estimate.part0001.csv")
        rows = np.concatenate([part0["row"].values, part1["row"].values])
        assert sorted(rows.tolist()) == list(range(cohort.n_sites))
        full = pd.read_csv(out1 / "methylation_profile_estimate.csv")
        stacked = np.concatenate([part0.iloc[:, 1:].values,
                                  part1.iloc[:, 1:].values])[np.argsort(rows)]
        np.testing.assert_allclose(stacked, full.values, atol=1e-8)


class TestTwoDimensionalScaleOut:
    """2-D composition (--multihost --shard): ranks/replicates partition
    across processes while each process row-shards over its LOCAL mesh.
    With 1 local device per process (this CPU harness) the local shard
    is the identity, so outputs must be bit-identical to single-process;
    the multi-device row-sharding itself is covered by
    tests/test_sharding.py."""

    def test_two_process_2d_ic_sweep_matches_single(self, cohort,
                                                    tmp_path):
        import pandas as pd
        helper = TestMultiProcessE2E()
        out1, out2 = helper._two_proc_vs_single(
            cohort, tmp_path, ["--ic", "AIC", "--icmax", "3",
                       "--init", "beta", "--iterations", "30", "5",
                       "--shard"],
            drop_nbunknown=True)
        got = pd.read_csv(out2 / "celltypes_proportions.csv", index_col=0)
        want = pd.read_csv(out1 / "celltypes_proportions.csv",
                           index_col=0)
        assert list(got.index) == list(want.index)  # same chosen rank
        np.testing.assert_allclose(got.values, want.values, atol=1e-8)

    def test_two_process_2d_bootstrap_matches_single(self, cohort,
                                                       tmp_path):
        import ast
        import pandas as pd
        helper = TestMultiProcessE2E()
        out1, out2 = helper._two_proc_vs_single(
            cohort, tmp_path, ["--confidence", "90", "7",
                       "--cimethod", "weights", "--shard"])

        def bounds(path):
            df = pd.read_csv(path, index_col=0)
            return np.array([[ast.literal_eval(c) for c in row]
                             for row in df.values])

        # replicate draws fold the GLOBAL index, so the intervals agree
        # to reduction-reassociation precision (the local-mesh data
        # placement compiles a differently-annotated executable than the
        # single-process plain-array one — not bitwise, ~1e-13)
        for fname in ["confidence_interval_celltypes_proportions.csv",
                      "confidence_interval_methylation_estimate.csv"]:
            np.testing.assert_allclose(bounds(out2 / fname),
                                       bounds(out1 / fname),
                                       rtol=1e-10, atol=1e-12,
                                       err_msg=fname)
