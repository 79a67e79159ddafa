"""True multi-process execution: K separate jax.distributed processes.

The reference is an MPI program (main.cpp:20 MPI_Init; mpi_utils.hpp:8-67);
its rebuild equivalent is jax.distributed over a localhost coordinator
(parallel/distributed.py init_distributed, driven by the env vars
scripts/run_multiprocess.py exports). These tests run the UNMODIFIED CLI as
2 (and 4) real processes on CPU and require:

  * per-host data loading: each process reads only its own marker shards'
    .bed rows (runner.dataset_from_options; data.cpp:671-739 analogue);
  * primary-only writers (outputs.writers.NullWriter on secondaries);
  * --det-sync 1: topology-invariant reductions (parallel/mesh.det_psum) so
    the SAME 8-shard mesh run as 1x8, 2x4 and 4x2 process layouts produces
    BITWISE-identical .csv/.bet/.cpn/.eps outputs;
  * kill-one-process -> --restart resumes bitwise (the multi-process
    version of test/scripts/srun_restart.sh:140-200).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from run_multiprocess import free_port, launch, wait_all  # noqa: E402

CHAIN = dict(chain=36, thin=3, save=12, seed=42)
OUT_FILES = ("ref.csv", "ref.bet", "ref.cpn", "ref.acu", "ref.eps.0",
             "ref.mus.0", "ref.mrk.0", "ref.xbet", "ref.xcpn", "ref.rng.0")


def _cli_args(base, outdir, chain=None, extra=()):
    c = dict(CHAIN)
    if chain:
        c.update(chain)
    return ["--mpibayes", "bayesMPI", "--bfile", base,
            "--pheno", base + ".phen",
            "--mcmc-out-dir", outdir, "--mcmc-out-name", "ref",
            "--chain-length", str(c["chain"]), "--thin", str(c["thin"]),
            "--save", str(c["save"]), "--seed", str(c["seed"]),
            "--S", "0.01,0.1", "--det-sync", "1"] + list(extra)


@pytest.fixture(scope="module")
def mp_data(tmp_path_factory):
    from tests.conftest import make_synthetic_bed

    tmp = tmp_path_factory.mktemp("mpdata")
    base, _ = make_synthetic_bed(tmp, 96, 120, seed=9, missing_rate=0.03)
    rs = np.random.RandomState(5)
    with open(base + ".phen", "w") as fh:
        for i in range(120):
            fh.write(f"per{i} per{i} {rs.randn():.5f}\n")
    return base


def _run_single(base, outdir, chain=None, extra=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env.pop("HYDRA_COORDINATOR", None)
    r = subprocess.run(
        [sys.executable, "-m", "hydra_tpu.cli"]
        + _cli_args(base, outdir, chain, extra),
        env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]


def _run_multi(base, outdir, nprocs, dpp, chain=None, extra=(), log_dir=None):
    procs = launch(nprocs, dpp, _cli_args(base, outdir, chain, extra),
                   stdout_dir=log_dir)
    codes = wait_all(procs, timeout=900)
    assert codes == [0] * nprocs, f"exit codes {codes} (logs: {log_dir})"


def _assert_identical(dir_a, dir_b, files=OUT_FILES):
    for f in files:
        pa, pb = os.path.join(dir_a, f), os.path.join(dir_b, f)
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read(), f"{f} differs"


@pytest.mark.slow
def test_two_process_bitwise_match(mp_data, tmp_path):
    sp = str(tmp_path / "sp")
    mp = str(tmp_path / "mp")
    logs = str(tmp_path / "logs")
    os.makedirs(logs)
    _run_single(mp_data, sp)
    _run_multi(mp_data, mp, 2, 4, log_dir=logs)
    _assert_identical(sp, mp)
    # per-host read: each process loaded only its shards' rows
    loads = []
    for p in range(2):
        txt = open(os.path.join(logs, f"proc{p}.log")).read()
        for line in txt.splitlines():
            if "seconds to load" in line:
                loads.append(int(line.split("load")[1].split()[0]))
    assert len(loads) == 2 and all(b < 96 * 30 for b in loads), loads


@pytest.mark.slow
def test_four_process_bitwise_match(mp_data, tmp_path):
    sp = str(tmp_path / "sp")
    mp = str(tmp_path / "mp")
    _run_single(mp_data, sp)
    _run_multi(mp_data, mp, 4, 2)
    _assert_identical(sp, mp)


@pytest.mark.slow
def test_kill_one_process_then_restart_bitwise(mp_data, tmp_path):
    """SIGKILL a secondary mid-chain; --restart across 2 processes resumes
    and every post-restart record matches the uninterrupted run bitwise."""
    full = str(tmp_path / "full")
    kil = str(tmp_path / "killed")
    logs = str(tmp_path / "logs")
    os.makedirs(logs)
    chain = dict(chain=60, thin=2, save=10)
    _run_multi(mp_data, full, 2, 4, chain=chain)

    # same-seed run, SIGKILL proc 1 once the csv shows iteration >= 20
    procs = launch(2, 4, _cli_args(mp_data, kil, chain), stdout_dir=logs)
    csv = os.path.join(kil, "ref.csv")
    deadline = time.time() + 600
    killed = False
    while time.time() < deadline:
        if all(p.poll() is not None for p in procs):
            break
        if os.path.exists(csv):
            try:
                rows = open(csv).read().strip().split("\n")
            except OSError:
                rows = []
            if rows and rows[-1] and int(rows[-1].split(",")[0]) >= 20:
                procs[1].kill()
                killed = True
                break
        time.sleep(0.05)
    assert killed, "chain finished before the kill window"
    wait_all(procs, timeout=120)  # gang-kills the hung primary

    # restart across 2 processes from the last save
    _run_multi(mp_data, kil, 2, 4, chain=chain, extra=("--restart",),
               log_dir=logs)

    # every post-restart record must match the uninterrupted run bitwise
    from hydra_tpu import postproc
    full_bet = {it: v.tobytes() for it, v in
                postproc._read_records(os.path.join(full, "ref.bet"),
                                       np.float64)}
    rs_bet = list(postproc._read_records(os.path.join(kil, "ref_rs.bet"),
                                         np.float64))
    assert len(rs_bet) > 0
    for it, v in rs_bet:
        assert v.tobytes() == full_bet[it], f"bet record {it} differs"
    full_rows = {r.split(",")[0]: r for r in
                 open(os.path.join(full, "ref.csv")).read().splitlines() if r}
    rs_rows = [r for r in
               open(os.path.join(kil, "ref_rs.csv")).read().splitlines() if r]
    assert len(rs_rows) > 0
    for r in rs_rows:
        assert r == full_rows[r.split(",")[0]], "csv row differs"


def test_det_sync_single_process_valid_chain(mp_data, tmp_path):
    """--det-sync changes reduction order only: same chain as psum within
    float tolerance on the 8-device single-process mesh (fast tier)."""
    a = str(tmp_path / "a")
    b = str(tmp_path / "b")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    for out, det in ((a, "1"), (b, "0")):
        r = subprocess.run(
            [sys.executable, "-m", "hydra_tpu.cli", "--mpibayes", "bayesMPI",
             "--bfile", mp_data, "--pheno", mp_data + ".phen",
             "--mcmc-out-dir", out, "--mcmc-out-name", "ref",
             "--chain-length", "12", "--thin", "3", "--save", "6",
             "--seed", "7", "--S", "0.01,0.1", "--det-sync", det],
            env=env, capture_output=True, text=True, timeout=900)
        assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    from hydra_tpu import postproc
    ra = list(postproc._read_records(os.path.join(a, "ref.bet"), np.float64))
    rb = list(postproc._read_records(os.path.join(b, "ref.bet"), np.float64))
    for (ia, va), (ib, vb) in zip(ra, rb):
        assert ia == ib
        np.testing.assert_allclose(va, vb, atol=1e-5)


@pytest.fixture(scope="module")
def mp_bw_data(tmp_path_factory):
    """Survival data: phenotype = log event times, .fail indicators."""
    from tests.conftest import make_synthetic_bed

    tmp = tmp_path_factory.mktemp("mpbw")
    base, geno = make_synthetic_bed(tmp, 64, 100, seed=11)
    rs = np.random.RandomState(3)
    log_t = 3.0 + rs.gumbel(0, 0.3, 100)
    fail = (rs.random(100) < 0.8).astype(int)
    with open(base + ".phen", "w") as fh:
        for i in range(100):
            fh.write(f"per{i} per{i} {log_t[i]:.5f}\n")
    with open(base + ".fail", "w") as fh:
        for i in range(100):
            fh.write(f"{fail[i]}\n")
    return base


@pytest.mark.slow
def test_bayesw_two_process_bitwise_match(mp_bw_data, tmp_path):
    sp = str(tmp_path / "sp")
    mp = str(tmp_path / "mp")
    args = ["--mpibayes", "bayesWMPI", "--bfile", mp_bw_data,
            "--pheno", mp_bw_data + ".phen", "--failure",
            mp_bw_data + ".fail", "--mcmc-out-dir", None,
            "--mcmc-out-name", "ref", "--chain-length", "24", "--thin", "3",
            "--save", "12", "--seed", "42", "--S", "0.01,0.1",
            "--sync-rate", "8", "--det-sync", "1"]

    def argv(outdir):
        a = list(args)
        a[a.index(None)] = outdir
        return a

    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-m", "hydra_tpu.cli"] + argv(sp),
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    procs = launch(2, 4, argv(mp))
    codes = wait_all(procs, timeout=900)
    assert codes == [0, 0], codes
    _assert_identical(sp, mp, files=("ref.csv", "ref.bet", "ref.cpn",
                                     "ref.eps.0", "ref.mus.0"))


@pytest.mark.slow
def test_mt_two_process_bitwise_match(mp_data, tmp_path):
    """Multi-trait (2 phenotypes incl. NaNs) 2x4 vs 1x8 bitwise parity."""
    # second phenotype with NAs
    ph2 = mp_data + ".phen2"
    rs = np.random.RandomState(13)
    with open(ph2, "w") as fh:
        for i in range(120):
            v = "NA" if rs.random() < 0.05 else f"{rs.randn():.5f}"
            fh.write(f"per{i} per{i} {v}\n")
    args = ["--mpibayes", "bayesMPI", "--bfile", mp_data,
            "--pheno", mp_data + ".phen," + ph2,
            "--mcmc-out-dir", None, "--mcmc-out-name", "ref",
            "--chain-length", "24", "--thin", "3", "--save", "12",
            "--seed", "42", "--S", "0.01,0.1", "--det-sync", "1"]

    def argv(outdir):
        a = list(args)
        a[a.index(None)] = outdir
        return a

    sp = str(tmp_path / "sp")
    mp = str(tmp_path / "mp")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-m", "hydra_tpu.cli"] + argv(sp),
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    procs = launch(2, 4, argv(mp))
    codes = wait_all(procs, timeout=900)
    assert codes == [0, 0], codes
    for t in (0, 1):
        _assert_identical(sp, mp, files=(f"ref.t{t}.csv", f"ref.t{t}.bet",
                                         f"ref.t{t}.cpn", f"ref.t{t}.eps.0"))


@pytest.mark.parametrize("device,dpp", [("gpu", 1), ("gpu", 2), ("cpu", 4)])
def test_launcher_gives_each_process_its_devices(monkeypatch, device, dpp):
    """GPU gangs: process p sees cards p*D..p*D+D-1 (CUDA_VISIBLE_DEVICES)
    and autotunes its own program; CPU gangs get D virtual devices each.
    Popen is faked: nothing is started."""
    import run_multiprocess

    seen = []

    class FakePopen:
        def __init__(self, cmd, env=None, **kw):
            seen.append((cmd, env))

    monkeypatch.setattr(run_multiprocess.subprocess, "Popen", FakePopen)
    monkeypatch.setenv("XLA_FLAGS", "--xla_dump_to=/nowhere")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    procs = launch(2, dpp, ["--mpibayes", "bayesMPI"], device=device,
                   port=12345)
    assert len(procs) == 2
    for pid, (cmd, env) in enumerate(seen):
        assert cmd[cmd.index("--device") + 1] == device
        assert env["HYDRA_PROC_ID"] == str(pid)
        assert env["HYDRA_NUM_PROCS"] == "2"
        assert env["HYDRA_COORDINATOR"] == "localhost:12345"
        assert env["XLA_FLAGS"].endswith("--xla_dump_to=/nowhere")
        if device == "gpu":
            assert env["CUDA_VISIBLE_DEVICES"] == ",".join(
                str(pid * dpp + d) for d in range(dpp))
            assert "--xla_gpu_shard_autotuning=false" in env["XLA_FLAGS"]
        else:
            assert "CUDA_VISIBLE_DEVICES" not in env
            assert (f"--xla_force_host_platform_device_count={dpp}"
                    in env["XLA_FLAGS"])


def test_launcher_numbers_cards_within_its_own_visible_set(monkeypatch):
    """A launcher that itself sees a subset of the host's cards hands its
    processes cards from that subset, in order."""
    import run_multiprocess

    seen = []

    class FakePopen:
        def __init__(self, cmd, env=None, **kw):
            seen.append(env["CUDA_VISIBLE_DEVICES"])

    monkeypatch.setattr(run_multiprocess.subprocess, "Popen", FakePopen)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5,6,7")
    launch(2, 2, ["--mpibayes", "bayesMPI"], device="gpu", port=12345)
    assert seen == ["4,5", "6,7"]
