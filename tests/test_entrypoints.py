"""The compile-cache location, the plain CLI's imports, and chip_smoke.py's
refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from demethify_tpu import utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTIONAL_PACKAGES = ("pandas", "orbax", "matplotlib", "tqdm", "seaborn")


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", DEMETHIFY_COMPILE_CACHE="")
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


class TestCompileCache:
    @pytest.fixture(autouse=True)
    def _restore_config(self):
        saved = (jax.config.jax_compilation_cache_dir,
                 jax.config.jax_persistent_cache_min_compile_time_secs)
        yield
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          saved[1])

    @pytest.mark.parametrize("env_dir", [True, False])
    def test_location(self, monkeypatch, tmp_path, env_dir):
        monkeypatch.delenv("DEMETHIFY_COMPILE_CACHE", raising=False)
        if env_dir:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            want = str(tmp_path)
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(REPO, ".jax_cache")
        assert utils.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want

    def test_empty_override_disables(self, monkeypatch):
        monkeypatch.setenv("DEMETHIFY_COMPILE_CACHE", "")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/nonexistent")
        before = jax.config.jax_compilation_cache_dir
        assert utils.enable_compile_cache() is None
        assert jax.config.jax_compilation_cache_dir == before


def test_plain_cli_run_imports_no_optional_package(cohort, tmp_path):
    # a fresh interpreter: the test process itself has pandas loaded
    argv = ["--platform", "cpu", "--methfreq", *cohort.samples,
            "--bedmethyl", "--ref", cohort.ref, "--nbunknown", "1",
            "--iterations", "3", "5", "--outdir", str(tmp_path / "out"),
            "--noprint"]
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['demethify_tpu'] + {argv!r}\n"
        "try:\n"
        "    runpy.run_module('demethify_tpu', run_name='__main__',\n"
        "                     alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "import json\n"
        f"print(json.dumps(sorted(m for m in {OPTIONAL_PACKAGES!r}\n"
        "                         if m in sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert (tmp_path / "out" / "celltypes_proportions.csv").exists()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_a_cpu(tmp_path, alone):
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        # a directory holding the script and nothing else of the repo
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd = str(tmp_path)
    out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert not os.path.exists(os.path.join(cwd, ".smoke"))
