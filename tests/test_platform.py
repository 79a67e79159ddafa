"""Device selection and the compile cache (hydra_tpu/platform.py, --device).

The tests run with JAX_PLATFORMS=cpu (conftest). Whether a process without
that setting refuses to start on a machine with no GPU is checked in
subprocesses, so this process's backend is never touched.
"""

import os
import subprocess
import sys

import pytest

from hydra_tpu import platform
from hydra_tpu.options import parse_args
from tests.conftest import REPO

_BASE = ["--mpibayes", "bayesMPI", "--bfile", "x", "--pheno", "x.phen"]


@pytest.mark.parametrize("choice", ["cpu", "gpu"])
def test_device_flag_choices(choice):
    assert parse_args(_BASE + ["--device", choice]).device == choice


@pytest.mark.parametrize("choice", ["metal", "rocm", "cuda"])
def test_device_flag_rejects_other_platforms(choice, capsys):
    with pytest.raises(SystemExit):
        parse_args(_BASE + ["--device", choice])


def test_device_defaults_to_gpu_unless_env_says_cpu(monkeypatch):
    assert parse_args(_BASE).device == ""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert platform.requested_device("") == "cpu"
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    assert platform.requested_device("") == "gpu"
    monkeypatch.delenv("JAX_PLATFORMS")
    assert platform.requested_device("") == "gpu"
    # an explicit flag wins over the environment
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert platform.requested_device("gpu") == "gpu"
    with pytest.raises(ValueError):
        platform.requested_device("rocm")


def _probe(code, env_extra=None, drop=("JAX_PLATFORMS",)):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["PYTHONPATH"] = REPO
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)


_CACHE_PROBE = ("import jax\n"
                "from hydra_tpu import platform\n"
                "platform.select_platform(%r)\n"
                "print('CACHE', jax.config.jax_compilation_cache_dir)\n")


@pytest.mark.parametrize("env_dir", [None, "/some/cache"],
                         ids=["fixed_path", "env_var"])
def test_gpu_compile_cache_env_or_fixed_checkout_path(env_dir):
    """A GPU run caches in $JAX_COMPILATION_CACHE_DIR, else .jax_cache/ in
    the checkout; selecting the platform starts no backend."""
    extra = {"JAX_COMPILATION_CACHE_DIR": env_dir} if env_dir else {}
    drop = ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR")
    r = _probe(_CACHE_PROBE % "gpu", env_extra=extra, drop=drop)
    assert r.returncode == 0, r.stderr
    want = env_dir or os.path.join(REPO, ".jax_cache")
    assert f"CACHE {want}" in r.stdout
    assert platform.CACHE_DIR == os.path.join(REPO, ".jax_cache")


def test_cpu_runs_keep_no_cache_unless_asked():
    r = _probe(_CACHE_PROBE % "cpu",
               drop=("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR"))
    assert r.returncode == 0, r.stderr
    assert "CACHE None" in r.stdout


def test_fixed_cache_dir_is_git_ignored():
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_no_gpu_is_an_error_not_a_cpu_fallback():
    """Without a GPU and without asking for the CPU, configure() refuses;
    the same process asking for the CPU gets it."""
    r = _probe("from hydra_tpu import platform\n"
               "try:\n"
               "    platform.configure()\n"
               "    print('RAN_ON', __import__('jax').devices()[0].platform)\n"
               "except platform.NoDeviceError as e:\n"
               "    print('REFUSED', e)\n")
    assert r.returncode == 0, r.stderr
    assert "REFUSED" in r.stdout and "--device cpu" in r.stdout
    assert "RAN_ON" not in r.stdout


def test_env_cpu_is_honoured():
    r = _probe("from hydra_tpu import platform\n"
               "print('RAN_ON', platform.configure())\n",
               env_extra={"JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    assert "RAN_ON cpu" in r.stdout


def test_cli_without_gpu_exits_with_clear_error(tmp_path):
    r = _probe("import sys\n"
               "from hydra_tpu.cli import main\n"
               "sys.exit(main(['--mpibayes', 'bayesMPI', '--bfile', 'x', "
               "'--pheno', 'x.phen', '--mcmc-out-dir', %r]))\n"
               % str(tmp_path / "o"))
    assert r.returncode == 2
    assert "FATAL" in r.stderr and "no GPU found" in r.stderr


def test_host_only_converter_needs_no_device(tmp_path):
    """--bed-to-sparse uses no device, so it runs where no GPU is found
    and the CPU was not asked for."""
    from tests.conftest import make_synthetic_bed

    base, _ = make_synthetic_bed(tmp_path, 12, 30, seed=4)
    r = _probe("import sys\n"
               "from hydra_tpu.cli import main\n"
               "sys.exit(main(['--bed-to-sparse', '--bfile', %r]))\n" % base)
    assert r.returncode == 0, r.stderr
    assert os.path.exists(base + ".si1")
