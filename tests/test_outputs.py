"""End-to-end CLI run, output formats, and restart equivalence.

Mirrors the reference's srun_restart.sh scenario (test/scripts/): full chain
vs fail-at-k + --restart must produce consistent output.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import REPO, make_synthetic_bed


def _write_phen(base, n, seed=4, na_every=0):
    rs = np.random.RandomState(seed)
    with open(base + ".phen", "w") as fh:
        for i in range(n):
            if na_every and i % na_every == na_every - 1:
                fh.write(f"per{i} per{i} NA\n")
            else:
                fh.write(f"per{i} per{i} {rs.randn():.6f}\n")


def _run_cli(args, cwd=REPO):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-m", "hydra_tpu.cli"] + args,
                       capture_output=True, text=True, env=env, cwd=cwd,
                       timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"CLI failed:\n{r.stdout}\n{r.stderr}")
    return r


@pytest.fixture
def small_run(tmp_path):
    base, geno = make_synthetic_bed(tmp_path, 48, 120, seed=6)
    _write_phen(base, 120)
    return tmp_path, base


def test_cli_bayesrrm_outputs(small_run):
    tmp_path, base = small_run
    out = str(tmp_path / "out")
    _run_cli(["--mpibayes", "bayesMPI", "--bfile", base, "--pheno", base + ".phen",
              "--mcmc-out-dir", out, "--mcmc-out-name", "t1",
              "--chain-length", "12", "--thin", "2", "--save", "4",
              "--seed", "5", "--S", "0.001,0.01,0.1", "--n-devices", "2"])
    ob = os.path.join(out, "t1")
    # csv rows: it 0,2,4,6,8,10
    rows = open(ob + ".csv").read().strip().split("\n")
    assert len(rows) == 6
    tok = [t.strip() for t in rows[-1].split(",")]
    assert int(tok[0]) == 10
    assert int(tok[1]) == 1  # one group
    # bet: u32 header Mtot + 6 records of [u32 it][48 f64]
    raw = open(ob + ".bet", "rb").read()
    assert np.frombuffer(raw[:4], np.uint32)[0] == 48
    assert len(raw) == 4 + 6 * (4 + 48 * 8)
    # xbet: header + it + last state
    raw = open(ob + ".xbet", "rb").read()
    assert np.frombuffer(raw[:4], np.uint32)[0] == 48
    assert np.frombuffer(raw[4:8], np.uint32)[0] == 8  # last save iteration
    # eps dump
    raw = open(ob + ".eps.0", "rb").read()
    it, n = np.frombuffer(raw[:8], np.uint32)
    assert (it, n) == (8, 120)
    assert len(raw) == 8 + 120 * 8
    # cpn ints within [0, K)
    raw = open(ob + ".cpn", "rb").read()
    comps = np.frombuffer(raw[8: 8 + 48 * 4], np.int32)
    assert comps.min() >= 0 and comps.max() <= 3


def test_cli_restart(small_run):
    tmp_path, base = small_run
    out = str(tmp_path / "outr")
    common = ["--mpibayes", "bayesMPI", "--bfile", base, "--pheno", base + ".phen",
              "--mcmc-out-dir", out, "--thin", "2", "--save", "4",
              "--seed", "9", "--S", "0.001,0.01,0.1"]
    # truncated run to it 0..9 (last save at 8)
    _run_cli(common + ["--mcmc-out-name", "tr", "--chain-length", "10"])
    # restart continues from 9
    _run_cli(common + ["--mcmc-out-name", "tr", "--chain-length", "16", "--restart"])
    ob = os.path.join(out, "tr_rs")
    rows = open(ob + ".csv").read().strip().split("\n")
    its = [int(r.split(",")[0]) for r in rows]
    assert its == [10, 12, 14]  # resumed at 9, thinned rows at 10..14
    # original files untouched
    rows0 = open(os.path.join(out, "tr") + ".csv").read().strip().split("\n")
    assert [int(r.split(",")[0]) for r in rows0] == [0, 2, 4, 6, 8]


def test_cli_restart_bitwise_no_seed(tmp_path):
    """Restart must continue the SAVED RNG stream without re-passing --seed
    (the reference restores the boost state from .rng.<rank>,
    BayesRRm.cpp:1204): full chain == truncated + --restart, bitwise, with
    covariates exercised (.gam.0/.xiv.0 round trip)."""
    base, _ = make_synthetic_bed(tmp_path, 40, 100, seed=26)
    _write_phen(base, 100)
    rs = np.random.RandomState(27)
    with open(base + ".cov", "w") as fh:
        for i in range(100):
            fh.write(f"per{i} per{i} {rs.randn():.5f} {rs.randn():.5f}\n")
    out = str(tmp_path / "outb")
    common = ["--mpibayes", "bayesMPI", "--bfile", base, "--pheno", base + ".phen",
              "--covariates", base + ".cov", "--mcmc-out-dir", out,
              "--thin", "2", "--save", "4", "--S", "0.001,0.01,0.1",
              "--n-devices", "2"]
    _run_cli(common + ["--mcmc-out-name", "full", "--chain-length", "20",
                       "--seed", "31"])
    _run_cli(common + ["--mcmc-out-name", "cut", "--chain-length", "10",
                       "--seed", "31"])
    # NOTE: no --seed here — it must come from cut.rng.0
    _run_cli(common + ["--mcmc-out-name", "cut", "--chain-length", "20",
                       "--restart"])
    fb, rb = os.path.join(out, "full"), os.path.join(out, "cut_rs")
    full_rows = {int(r.split(",")[0]): r.strip()
                 for r in open(fb + ".csv").read().strip().split("\n")}
    rs_rows = {int(r.split(",")[0]): r.strip()
               for r in open(rb + ".csv").read().strip().split("\n")}
    assert sorted(rs_rows) == [10, 12, 14, 16, 18]
    for it, row in rs_rows.items():
        assert row == full_rows[it], f"csv row for it {it} differs"

    def _records(path, dtype, m=40):
        raw = open(path, "rb").read()
        rec, out_d = 4 + m * np.dtype(dtype).itemsize, {}
        for r in range((len(raw) - 4) // rec):
            chunk = raw[4 + r * rec: 4 + (r + 1) * rec]
            out_d[int(np.frombuffer(chunk[:4], np.uint32)[0])] = chunk[4:]
        return out_d

    full_bet, rs_bet = _records(fb + ".bet", np.float64), _records(rb + ".bet", np.float64)
    for it in rs_bet:
        assert rs_bet[it] == full_bet[it], f".bet record for it {it} differs"
    # .xiv.0 written and readable (covariate order dump)
    raw = open(rb + ".xiv.0", "rb").read()
    it, ncov = np.frombuffer(raw[:8], np.uint32)
    assert (it, ncov) == (16, 2)


def test_unknown_flag_rejected():
    from hydra_tpu.options import parse_args
    with pytest.raises(SystemExit, match="invalid option"):
        parse_args(["--mpibayes", "bayesMPI", "--no-such-flag", "1"])


def test_cli_na_phenotypes(tmp_path):
    """NA test equivalent of srun_NA_test.sh: run with NAs, outputs well-formed."""
    base, _ = make_synthetic_bed(tmp_path, 32, 90, seed=8)
    _write_phen(base, 90, na_every=9)
    out = str(tmp_path / "outna")
    _run_cli(["--mpibayes", "bayesMPI", "--bfile", base, "--pheno", base + ".phen",
              "--mcmc-out-dir", out, "--mcmc-out-name", "na",
              "--chain-length", "6", "--thin", "2", "--save", "4",
              "--seed", "3", "--S", "0.001,0.01,0.1"])
    raw = open(os.path.join(out, "na") + ".eps.0", "rb").read()
    it, n = np.frombuffer(raw[:8], np.uint32)
    assert n == 80  # 10 NAs dropped


def test_cli_groups_and_check_ram(tmp_path, capsys):
    base, _ = make_synthetic_bed(tmp_path, 30, 60, seed=10)
    _write_phen(base, 60)
    with open(str(tmp_path / "g.grp"), "w") as fh:
        fh.write("\n".join(str(i % 2) for i in range(30)))
    with open(str(tmp_path / "g.mS"), "w") as fh:
        fh.write("0.001,0.01,0.1;0.001,0.01,0.1")
    out = str(tmp_path / "outg")
    _run_cli(["--mpibayes", "bayesMPI", "--bfile", base, "--pheno", base + ".phen",
              "--groupIndexFile", str(tmp_path / "g.grp"),
              "--groupMixtureFile", str(tmp_path / "g.mS"),
              "--mcmc-out-dir", out, "--mcmc-out-name", "g",
              "--chain-length", "4", "--thin", "2", "--save", "2", "--seed", "2"])
    rows = open(os.path.join(out, "g") + ".csv").read().strip().split("\n")
    tok = [t.strip() for t in rows[0].split(",")]
    assert int(tok[1]) == 2  # two groups -> two sigmaG columns
    # check-RAM path
    r = _run_cli(["--check-RAM", "--bfile", base, "--check-RAM-tasks", "4"])
    assert "per-device memory estimate" in r.stdout
    assert "no device-memory check made" in r.stdout   # CPU: no limit known


def test_cli_bayesw(tmp_path):
    """BayesW end-to-end incl. restart (csv layout BayesW.cpp:1942-1961)."""
    rs = np.random.RandomState(14)
    base, geno = make_synthetic_bed(tmp_path, 24, 80, seed=14)
    with open(base + ".phen", "w") as fh:
        for i in range(80):
            fh.write(f"per{i} per{i} {4.0 + rs.randn() * 0.2:.6f}\n")
    with open(base + ".fail", "w") as fh:
        fh.write("\n".join("1" if rs.random() > 0.2 else "0" for _ in range(80)))
    out = str(tmp_path / "outw")
    common = ["--mpibayes", "bayesWMPI", "--bfile", base,
              "--pheno", base + ".phen", "--failure", base + ".fail",
              "--mcmc-out-dir", out, "--thin", "2", "--save", "4",
              "--seed", "21", "--S", "0.001,0.01,0.1", "--quad_points", "7"]
    _run_cli(common + ["--mcmc-out-name", "w", "--chain-length", "10"])
    ob = os.path.join(out, "w")
    rows = open(ob + ".csv").read().strip().split("\n")
    assert len(rows) == 5
    tok = [t.strip() for t in rows[-1].split(",")]
    assert int(tok[0]) == 8
    mu, sg_sum, alpha = float(tok[1]), float(tok[2]), float(tok[3])
    assert 3.0 < mu < 5.0 and alpha > 0
    # restart
    _run_cli(common + ["--mcmc-out-name", "w", "--chain-length", "14", "--restart"])
    rows = open(os.path.join(out, "w_rs") + ".csv").read().strip().split("\n")
    assert [int(r.split(",")[0]) for r in rows] == [10, 12]


def test_cli_bayesw_covariates_nas(tmp_path):
    """BayesW with covariates and NAs end-to-end incl. restart — the
    reference's srun_cov_nas.sh scenario (phen+fail+cov joint NA semantics,
    data.cpp:1681-1802; gamma via slice sampling on gamma_dens,
    BayesW.cpp:1366-1413). Checks the .gam text dump and that the restarted
    chain restores gamma from it."""
    rs = np.random.RandomState(33)
    n = 90
    base, geno = make_synthetic_bed(tmp_path, 20, n, seed=33)
    cov_effect = np.array([0.3])
    cov = rs.randn(n, 1)
    y = 4.0 + cov @ cov_effect + rs.randn(n) * 0.15
    with open(base + ".phen", "w") as fh:
        for i in range(n):
            v = "NA" if i % 17 == 16 else f"{y[i]:.6f}"
            fh.write(f"per{i} per{i} {v}\n")
    with open(base + ".fail", "w") as fh:
        fh.write("\n".join("1" if rs.random() > 0.2 else "0" for _ in range(n)))
    with open(base + ".cov", "w") as fh:
        for i in range(n):
            v = "NA" if i % 29 == 28 else f"{cov[i, 0]:.5f}"
            fh.write(f"per{i} per{i} {v}\n")
    out = str(tmp_path / "outwc")
    common = ["--mpibayes", "bayesWMPI", "--bfile", base,
              "--pheno", base + ".phen", "--failure", base + ".fail",
              "--covariates", base + ".cov",
              "--mcmc-out-dir", out, "--thin", "2", "--save", "4",
              "--S", "0.001,0.01,0.1", "--quad_points", "7"]
    _run_cli(common + ["--mcmc-out-name", "wc", "--chain-length", "10",
                       "--seed", "41"])
    ob = os.path.join(out, "wc")
    # NA drop: 90 - (5 phen NAs) - (3 cov NAs, one overlapping? compute)
    raw = open(ob + ".eps.0", "rb").read()
    _, n_kept = np.frombuffer(raw[:8], np.uint32)
    n_expected = sum(1 for i in range(n)
                     if i % 17 != 16 and i % 29 != 28)
    assert n_kept == n_expected
    # .gam text rows: "it, gamma..." per thin
    gam_rows = [r for r in open(ob + ".gam").read().strip().split("\n") if r]
    assert len(gam_rows) == 5
    g_last = float(gam_rows[-1].split(",")[1])
    assert np.isfinite(g_last)
    # restart without --seed: continues and keeps writing gamma
    _run_cli(common + ["--mcmc-out-name", "wc", "--chain-length", "14",
                       "--restart"])
    rb = os.path.join(out, "wc_rs")
    rows = open(rb + ".csv").read().strip().split("\n")
    assert [int(r.split(",")[0]) for r in rows] == [10, 12]
    gam_rs = [r for r in open(rb + ".gam").read().strip().split("\n") if r]
    assert [int(r.split(",")[0]) for r in gam_rs] == [10, 12]


@pytest.mark.slow
def test_bayesw_covariate_recovery():
    """Posterior gamma recovers a known covariate effect (library path)."""
    import jax
    from hydra_tpu.data.genotypes import Dataset, GenotypeData, make_default_groups
    from hydra_tpu.parallel.mesh import make_mesh
    from hydra_tpu.samplers.bayesw import BayesW, EULER_MASCHERONI
    from tests.test_bayesrrm import _pack

    rs = np.random.RandomState(55)
    m, n = 48, 500
    maf = rs.uniform(0.1, 0.5, m)
    geno = rs.binomial(1, maf[:, None], (m, n)) + rs.binomial(1, maf[:, None], (m, n))
    gd = GenotypeData.from_packed(_pack(geno), n, np.array([], dtype=np.int64))
    alpha_true, gamma_true = 10.0, 0.25
    cov = rs.randn(n, 1)
    w = np.log(rs.exponential(1.0, n)) + EULER_MASCHERONI
    y = 4.0 + cov[:, 0] * gamma_true + w / alpha_true
    groups, mS = make_default_groups(m, [0.001, 0.01, 0.1])
    ds = Dataset(geno=gd, y=y, groups=groups, num_groups=1, mS=mS,
                 fail=np.ones(n), X=cov)
    sampler = BayesW(ds, window=8, seed=77, mesh=make_mesh(2), quad_points=7)
    state = sampler.init_state()
    gs = []
    for it in range(150):
        state, _ = sampler.step(state, it)
        if it >= 75:
            gs.append(float(np.asarray(state.gamma)[0]))
    g_mean = np.mean(gs)
    assert abs(g_mean - gamma_true) < 0.08, g_mean
    assert 7.0 < float(state.alpha) < 14.0


def test_cli_multi_trait(tmp_path):
    base, _ = make_synthetic_bed(tmp_path, 20, 60, seed=15)
    rs = np.random.RandomState(15)
    for t in (1, 2):
        with open(base + f".phen{t}", "w") as fh:
            for i in range(60):
                v = "NA" if (t == 2 and i % 20 == 19) else f"{rs.randn():.5f}"
                fh.write(f"per{i} per{i} {v}\n")
    out = str(tmp_path / "outmt")
    _run_cli(["--mpibayes", "bayesMPI", "--bfile", base,
              "--pheno", f"{base}.phen1,{base}.phen2",
              "--mcmc-out-dir", out, "--mcmc-out-name", "mt",
              "--chain-length", "6", "--thin", "2", "--save", "4",
              "--seed", "4", "--S", "0.001,0.01,0.1"])
    for t in range(2):
        rows = open(os.path.join(out, f"mt.t{t}") + ".csv").read().strip().split("\n")
        assert len(rows) == 3
    # restart continues each trait from the last save
    _run_cli(["--mpibayes", "bayesMPI", "--bfile", base,
              "--pheno", f"{base}.phen1,{base}.phen2",
              "--mcmc-out-dir", out, "--mcmc-out-name", "mt",
              "--chain-length", "10", "--thin", "2", "--save", "4",
              "--seed", "4", "--S", "0.001,0.01,0.1", "--restart"])
    for t in range(2):
        rows = open(os.path.join(out, f"mt_rs.t{t}") + ".csv").read().strip().split("\n")
        assert [int(r.split(",")[0]) for r in rows] == [6, 8]


def test_cli_multi_trait_restart_bitwise(tmp_path):
    """mt restart, no --seed re-passed: full chain == truncated + --restart
    bitwise per trait (counter-based RNG + complete per-trait state
    restore; exercises the exact-mt default path end to end)."""
    base, _ = make_synthetic_bed(tmp_path, 24, 80, seed=33)
    rs = np.random.RandomState(34)
    for t in (1, 2):
        with open(base + f".phen{t}", "w") as fh:
            for i in range(80):
                fh.write(f"per{i} per{i} {rs.randn():.5f}\n")
    out = str(tmp_path / "outmtb")
    common = ["--mpibayes", "bayesMPI", "--bfile", base,
              "--pheno", f"{base}.phen1,{base}.phen2",
              "--mcmc-out-dir", out, "--thin", "2", "--save", "4",
              "--S", "0.001,0.01,0.1"]
    _run_cli(common + ["--mcmc-out-name", "full", "--chain-length", "16",
                       "--seed", "41"])
    _run_cli(common + ["--mcmc-out-name", "cut", "--chain-length", "8",
                       "--seed", "41"])
    _run_cli(common + ["--mcmc-out-name", "cut", "--chain-length", "16",
                       "--restart"])
    for t in range(2):
        fb = os.path.join(out, f"full.t{t}")
        rb = os.path.join(out, f"cut_rs.t{t}")
        full_rows = {int(r.split(",")[0]): r.strip()
                     for r in open(fb + ".csv").read().strip().split("\n")}
        rs_rows = {int(r.split(",")[0]): r.strip()
                   for r in open(rb + ".csv").read().strip().split("\n")}
        # cut chain's last save is it 4 -> restart resumes at 5; thinned
        # rows from 6 on must match the full chain bitwise
        assert sorted(rs_rows) == [6, 8, 10, 12, 14]
        for it, row in rs_rows.items():
            assert row == full_rows[it], f"trait {t} csv it {it} differs"


def test_cli_multi_trait_covariates_and_acu(tmp_path):
    """mt with --covariates: per-trait .gam.0 dumps and real .acu records
    (BayesRRm_mt.cpp:706-708; the reference's own mt covariate block is
    unfinished — see samplers/bayesrrm_mt.py)."""
    base, _ = make_synthetic_bed(tmp_path, 16, 48, seed=18)
    rs = np.random.RandomState(18)
    for t in (1, 2):
        with open(base + f".phen{t}", "w") as fh:
            for i in range(48):
                fh.write(f"per{i} per{i} {rs.randn():.5f}\n")
    with open(base + ".cov", "w") as fh:
        for i in range(48):
            fh.write(f"{rs.randn():.5f},{rs.randn():.5f}\n")
    out = str(tmp_path / "outmtc")
    _run_cli(["--mpibayes", "bayesMPI", "--bfile", base,
              "--pheno", f"{base}.phen1,{base}.phen2",
              "--covariates", base + ".cov",
              "--mcmc-out-dir", out, "--mcmc-out-name", "mtc",
              "--chain-length", "6", "--thin", "2", "--save", "4",
              "--seed", "4", "--S", "0.001,0.01,0.1"])
    for t in range(2):
        ob = os.path.join(out, f"mtc.t{t}")
        # .acu: same layout as .bet but f64 P(zero): header + 3 records
        raw = open(ob + ".acu", "rb").read()
        assert np.frombuffer(raw[:4], np.uint32)[0] == 16
        assert len(raw) == 4 + 3 * (4 + 16 * 8)
        vals = np.frombuffer(raw[-16 * 8:], np.float64)
        assert vals.min() >= 0.0 and vals.max() <= 1.0 and vals.std() > 0
        # .gam.0: [u32 it][u32 F][F f64]
        raw = open(ob + ".gam.0", "rb").read()
        it, f = np.frombuffer(raw[:8], np.uint32)
        assert (it, f) == (4, 2)
        g = np.frombuffer(raw[8:], np.float64)
        assert g.shape == (2,) and np.isfinite(g).all()


def test_bed_to_sparse_cli(tmp_path):
    base, _ = make_synthetic_bed(tmp_path, 25, 40, seed=12)
    _run_cli(["--bed-to-sparse", "--bfile", base])
    from hydra_tpu.io.sparse import read_sparse_files
    sp = read_sparse_files(base)
    assert (sp.n, sp.m) == (40, 25)


def test_cli_bayesw_w1_exact_flag(tmp_path):
    """--window 1 = exact sequential BayesW; the .rng.0 state records
    exact=true so restarts validate against the right schedule."""
    import json
    rs = np.random.RandomState(15)
    base, _ = make_synthetic_bed(tmp_path, 16, 60, seed=15)
    with open(base + ".phen", "w") as fh:
        for i in range(60):
            fh.write(f"per{i} per{i} {4.0 + rs.randn() * 0.2:.6f}\n")
    with open(base + ".fail", "w") as fh:
        fh.write("\n".join("1" if rs.random() > 0.2 else "0"
                           for _ in range(60)))
    out = str(tmp_path / "outw1")
    _run_cli(["--mpibayes", "bayesWMPI", "--bfile", base,
              "--pheno", base + ".phen", "--failure", base + ".fail",
              "--mcmc-out-dir", out, "--mcmc-out-name", "w1",
              "--chain-length", "4", "--thin", "2", "--save", "2",
              "--seed", "22", "--window", "1", "--quad_points", "7"])
    rng = json.load(open(os.path.join(out, "w1") + ".rng.0"))
    assert rng["window"] == 1 and rng["exact"] is True


def test_check_ram_sparse_simulation(tmp_path, synthetic_bed_factory):
    """--check-RAM with sparse files reads the REAL .sl* counts and packs
    nodes like the reference (checkRamUsage BayesRRm.cpp:2947-3084): max-node
    RAM equals the hand-computed (n1+n2+nm)*4 bytes over each task range."""
    import io as _io
    from contextlib import redirect_stdout

    from hydra_tpu.io import sparse as sparse_io
    from hydra_tpu.diag.ramcheck import check_ram_usage
    from hydra_tpu.options import parse_args

    base, geno = synthetic_bed_factory(40, 37, missing_rate=0.1)
    sp = str(tmp_path / "sp")
    sparse_io.write_sparse_files(base + ".bed", 37, 40, sp)
    opt = parse_args(["--check-RAM", "--sparse-dir", str(tmp_path),
                      "--sparse-basename", "sp", "--check-RAM-tasks", "5",
                      "--check-RAM-tasks-per-node", "2",
                      "--number-individuals", "37", "--number-markers", "40"])
    buf = _io.StringIO()
    with redirect_stdout(buf):
        res = check_ram_usage(opt)
    assert res["nranks"] == 5 and res["nodes"] == 3
    # hand-compute: task ranges from the same splitter over real counts
    n1 = np.fromfile(sp + ".sl1", np.uint64)
    n2 = np.fromfile(sp + ".sl2", np.uint64)
    nm = np.fromfile(sp + ".slm", np.uint64)
    from hydra_tpu.io.groups import assign_blocks_to_tasks
    st, ln = assign_blocks_to_tasks(0, None, None, 40, 5)
    per_task = [float((n1[s:s+l].sum() + n2[s:s+l].sum() + nm[s:s+l].sum())
                      * 4 * 1e-9)
                for s, l in zip(st.astype(int), ln.astype(int))]
    # nodes: [t0,t1], [t2,t3], [t4] (nfull = 5 + 3*(1-2) = 2)
    expect = [per_task[0] + per_task[1], per_task[2] + per_task[3],
              per_task[4]]
    np.testing.assert_allclose(res["node_gb"], expect, rtol=1e-12)
    # total indices conservation
    assert abs(sum(per_task) - res["max_gb"] - sum(r for r in res["node_gb"]
               if r != res["max_gb"])) < 1e-12
