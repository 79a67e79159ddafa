"""Postproc converter + compression tests."""

import io
import os
import subprocess
import sys

import numpy as np

from hydra_tpu import postproc
from hydra_tpu.utils.compression import compress_doubles, decompress_doubles


def _write_bet(path, m, records):
    with open(path, "wb") as fh:
        fh.write(np.asarray([m], np.uint32).tobytes())
        for it, vals in records:
            fh.write(np.asarray([it], np.uint32).tobytes())
            fh.write(np.asarray(vals, np.float64).tobytes())


def test_beta_convert_and_extract(tmp_path):
    m = 5
    recs = [(0, [0.0, 1.5, 0.0, -2.25, 0.0]), (5, [0.125, 0.0, 0.0, 0.0, 3.0])]
    p = str(tmp_path / "x.bet")
    _write_bet(p, m, recs)
    buf = io.StringIO()
    postproc.beta_convert(p, 1, out=buf)
    lines = buf.getvalue().strip().split("\n")
    assert len(lines) == 10
    assert "1.5" in lines[1]
    buf = io.StringIO()
    postproc.extract_nonzero(p, 0, 1, np.float64, out=buf)
    rows = [l.split() for l in buf.getvalue().strip().split("\n")]
    assert len(rows) == 4  # 2 + 2 nonzero
    assert rows[0][:2] == ["0", "1"]


def test_beta_check(tmp_path):
    recs = [(0, [1.0, 2.0]), (5, [3.0, 4.0])]
    a, b = str(tmp_path / "a.bet"), str(tmp_path / "b.bet")
    _write_bet(a, 2, recs)
    _write_bet(b, 2, recs)
    assert postproc.beta_check(a, b) == 0
    _write_bet(b, 2, [(0, [1.0, 2.0]), (5, [3.0, 4.5])])
    assert postproc.beta_check(a, b) == 1


def test_combine_csv(tmp_path):
    p1 = tmp_path / "a.csv"
    p2 = tmp_path / "b.csv"
    p1.write_text("0, 1.0\n5, 2.0\n10, 3.0\n")
    p2.write_text("10, 3.5\n15, 4.0\n")
    out = str(tmp_path / "c.csv")
    postproc.combine_csv(out, [str(p1), str(p2)])
    rows = open(out).read().strip().split("\n")
    assert [int(r.split(",")[0]) for r in rows] == [0, 5, 10, 15]
    assert rows[2] == "10, 3.0"  # first file wins for duplicates


def test_postproc_cli_runs_on_real_output(tmp_path):
    """Drive the module CLI on a real sampler .bet file."""
    from tests.conftest import REPO, make_synthetic_bed
    base, _ = make_synthetic_bed(tmp_path, 10, 40, seed=2)
    with open(base + ".phen", "w") as fh:
        rs = np.random.RandomState(0)
        for i in range(40):
            fh.write(f"per{i} per{i} {rs.randn():.5f}\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = str(tmp_path / "o")
    subprocess.run([sys.executable, "-m", "hydra_tpu.cli", "--mpibayes",
                    "bayesMPI", "--bfile", base, "--pheno", base + ".phen",
                    "--mcmc-out-dir", out, "--mcmc-out-name", "pp",
                    "--chain-length", "4", "--thin", "2", "--save", "2",
                    "--seed", "1", "--S", "0.01,0.1"],
                   check=True, env=env, capture_output=True, timeout=600)
    r = subprocess.run([sys.executable, "-m", "hydra_tpu.postproc",
                        "beta-convert", os.path.join(out, "pp.bet"), "1"],
                       check=True, env=env, capture_output=True, text=True)
    assert len(r.stdout.strip().split("\n")) == 20


def test_ess_iid_and_ar1():
    """ESS of iid draws ~ n; of AR(1) with phi=0.9 ~ n(1-phi)/(1+phi);
    split-R-hat near 1 for same-distribution chains, inflated for shifted."""
    rs = np.random.RandomState(7)
    n = 4000
    iid = [rs.randn(n), rs.randn(n)]
    rhat, ess = postproc._split_rhat_ess(iid)
    assert abs(rhat - 1.0) < 0.02
    assert 0.7 * 2 * n < ess <= 2 * n * np.log10(2 * n)
    phi = 0.9
    ar = np.empty(n)
    ar[0] = rs.randn()
    for i in range(1, n):
        ar[i] = phi * ar[i - 1] + np.sqrt(1 - phi * phi) * rs.randn()
    _, ess_ar = postproc._split_rhat_ess([ar])
    expected = n * (1 - phi) / (1 + phi)   # ~211
    assert 0.4 * expected < ess_ar < 2.5 * expected
    rhat_bad, _ = postproc._split_rhat_ess([rs.randn(n), rs.randn(n) + 3.0])
    assert rhat_bad > 1.5


def test_chain_stats_parses_both_layouts(tmp_path):
    """ess auto-detects the BayesRRm vs BayesW csv row layouts by writing
    rows through the writers themselves (BayesRRm.cpp:2742-2761 /
    BayesW.cpp:1942-1961)."""
    from hydra_tpu.outputs.writers import McmcWriter
    w = McmcWriter.__new__(McmcWriter)   # only the row formatters needed
    rs = np.random.RandomState(1)
    brr = tmp_path / "brr.csv"
    with open(brr, "w") as fh:
        for it in range(20):
            fh.write(w.csv_row_brr(it, np.abs(rs.randn(2)) + 0.3,
                                   1.0 + 0.1 * rs.rand(), 5 + it % 3,
                                   np.full((2, 3), 1 / 3)))
    bw = tmp_path / "bw.csv"
    with open(bw, "w") as fh:
        for it in range(20):
            fh.write(w.csv_row_bw(it, 0.1 * rs.randn(),
                                  np.abs(rs.randn(2)) + 0.3,
                                  10 + rs.rand(), 7, np.full((2, 3), 1 / 3)))
    sb = postproc.chain_stats([str(brr)], out=io.StringIO())
    assert set(sb) == {"sigmaG", "sigmaE", "h2", "m0"}
    assert 0 < sb["h2"]["mean"] < 1
    sw = postproc.chain_stats([str(bw)], out=io.StringIO())
    assert set(sw) == {"sigmaG", "alpha", "h2", "m0"}
    assert 10 < sw["alpha"]["mean"] < 11.1
    assert sw["m0"]["rhat"] == 1.0       # constant trace: trivially converged


def test_predict_matches_numpy(tmp_path):
    """predict == dense NumPy scoring with missing-to-mean imputation and
    the intercept from .mus.0."""
    from hydra_tpu.io import plink
    rs = np.random.RandomState(5)
    m, n = 30, 50
    geno = rs.binomial(2, 0.4, size=(m, n)).astype(np.int64)
    geno[rs.rand(m, n) < 0.05] = -1                   # missing
    geno[3, :] = 1                                    # zero-variance marker
    base = str(tmp_path / "score")
    plink.write_bed(base + ".bed", geno)
    with open(base + ".fam", "w") as fh:
        for i in range(n):
            fh.write(f"F{i} I{i} 0 0 1 -9\n")
    with open(base + ".bim", "w") as fh:
        for j in range(m):
            fh.write(f"1 snp{j} 0 {j + 1} A G\n")
    recs = [(0, rs.randn(m)), (2, rs.randn(m)), (4, rs.randn(m))]
    bet = str(tmp_path / "run.bet")
    _write_bet(bet, m, recs)
    mus = str(tmp_path / "run.mus.0")
    with open(mus, "wb") as fh:
        for it, mu in [(0, 1.5), (2, 0.5), (4, 1.0)]:
            fh.write(np.asarray([it], np.uint32).tobytes())
            fh.write(np.asarray([mu], np.float64).tobytes())
    out = str(tmp_path / "scores.txt")
    score = postproc.predict(bet, base, burnin=1, mus_path=mus,
                             out_path=out, block=7)
    # golden: dense NumPy with the same semantics
    beta = (recs[1][1] + recs[2][1]) / 2
    mask = (geno >= 0).astype(np.float64)
    g = np.where(geno >= 0, geno, 0).astype(np.float64)
    nobs = mask.sum(1)
    mave = (g * mask).sum(1) / nobs
    var = (mask * (g - mave[:, None]) ** 2).sum(1) / np.maximum(nobs - 1, 1)
    mstd = np.sqrt(var)
    want = np.full(n, 0.75)                           # mean mu after burnin
    for j in range(m):
        if mstd[j] > 0:
            want += beta[j] / mstd[j] * mask[j] * (g[j] - mave[j])
    np.testing.assert_allclose(score, want, rtol=1e-12)
    lines = open(out).read().strip().split("\n")
    assert len(lines) == n and lines[0].startswith("F0 I0 ")


def test_compression_roundtrip():
    x = np.random.RandomState(3).randn(1000)
    blob = compress_doubles(x)
    assert len(blob) < 8000
    y = decompress_doubles(blob, 1000)
    np.testing.assert_array_equal(x, y)
