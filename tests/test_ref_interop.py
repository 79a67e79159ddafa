"""Reference-binary format interop: the reference's OWN compiled postproc
tools read hydra_tpu chain output.

Until this suite existed, ".bet/.cpn/.eps are hydra-compatible" was certified
only by hydra_tpu's own readers. Here we g++-compile the reference's
standalone converters (no MPI dependency):

    postproc/beta_converter.cpp:17-60
    postproc/components_converter.cpp:17-60
    postproc/epsilon_converter.cpp:17-48
    postproc/extract_non_zero_betaAll.cpp:8-51
    postproc/extract_non_zero_cpnAll.cpp:7-51

run them on a real hydra_tpu chain's output files, and diff their stdout
against `hydra_tpu.postproc`'s equivalents — proving byte-layout parity with
actual reference code. (postproc/beta_checker.cpp is compiled but not
value-diffed: its seek math ignores the per-record u32 iteration prefix
[beta_checker.cpp:30], so it reads misaligned doubles even on the reference's
own files — a reference bug, not a format statement.)
"""

import io
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from hydra_tpu import postproc
from tests.conftest import REPO

REF = "/root/reference/postproc"

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or not os.path.isdir(REF),
    reason="g++ or reference postproc sources unavailable",
)

TOOLS = (
    "beta_converter",
    "components_converter",
    "epsilon_converter",
    "extract_non_zero_betaAll",
    "extract_non_zero_cpnAll",
    "beta_checker",
)

M, N = 12, 40
CHAIN, THIN = 6, 2  # -> 3 thinned records (its 1, 3, 5)
NREC = 3


@pytest.fixture(scope="module")
def ref_bins(tmp_path_factory):
    d = tmp_path_factory.mktemp("refbins")
    bins = {}
    for tool in TOOLS:
        exe = str(d / tool)
        r = subprocess.run(
            ["g++", "-O2", "-o", exe, os.path.join(REF, tool + ".cpp")],
            capture_output=True, text=True)
        if r.returncode != 0:
            pytest.skip(f"g++ failed on {tool}: {r.stderr[:500]}")
        bins[tool] = exe
    return bins


@pytest.fixture(scope="module")
def chain_out(tmp_path_factory):
    """Short BayesRRm chain on synthetic data; returns the output basename."""
    tmp = tmp_path_factory.mktemp("chain")
    from tests.conftest import make_synthetic_bed

    base, _ = make_synthetic_bed(tmp, M, N, seed=3, missing_rate=0.02)
    rs = np.random.RandomState(0)
    with open(base + ".phen", "w") as fh:
        for i in range(N):
            fh.write(f"per{i} per{i} {rs.randn():.5f}\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = str(tmp / "o")
    subprocess.run(
        [sys.executable, "-m", "hydra_tpu.cli", "--mpibayes", "bayesMPI",
         "--bfile", base, "--pheno", base + ".phen",
         "--mcmc-out-dir", out, "--mcmc-out-name", "interop",
         "--chain-length", str(CHAIN), "--thin", str(THIN), "--save",
         str(THIN), "--seed", "11", "--S", "0.01,0.1"],
        check=True, env=env, capture_output=True, timeout=600)
    return os.path.join(out, "interop")


def _run(exe, *args):
    r = subprocess.run([exe, *map(str, args)], capture_output=True, text=True,
                       check=True, timeout=120)
    return r.stdout


_DATA = re.compile(r"^\s*(\d+)/\s*(\d+) = (.+)$")


def _parse_slash_lines(text):
    rows = []
    for line in text.splitlines():
        mm = _DATA.match(line)
        if mm:
            rows.append((int(mm.group(1)), int(mm.group(2)), mm.group(3)))
    return rows


def test_beta_converter_exact_lines(ref_bins, chain_out):
    """Reference beta_converter stdout data lines == postproc.beta_convert,
    byte for byte (both print %5d/%7d = %20.12f)."""
    ref = _run(ref_bins["beta_converter"], chain_out + ".bet", NREC - 1)
    ref_lines = [l for l in ref.splitlines() if _DATA.match(l)]
    buf = io.StringIO()
    postproc.beta_convert(chain_out + ".bet", NREC - 1, out=buf)
    ours = buf.getvalue().splitlines()
    assert len(ref_lines) == NREC * M == len(ours)
    assert ref_lines == ours
    # header: the reference read our u32 marker count
    assert f"{M} markers were processed." in ref


def test_components_converter_framing(ref_bins, chain_out):
    """Reference components_converter walks our .cpn record framing.

    Its VALUE column is unusable on any input — components_converter.cpp:37
    declares `double cpn` but :52 prints it with %2d (UB: the double goes in
    an xmm register, %2d reads an integer register — it prints garbage even
    on reference-produced files). i32 value parity is instead proven by
    test_extract_non_zero_cpn_values (extract_non_zero_cpnAll.cpp declares
    `int cpn` correctly). Here we assert the parts that DO exercise the
    layout: the u32 marker header and the per-record u32 iteration numbers
    read from our file at the reference's computed offsets."""
    out = _run(ref_bins["components_converter"], chain_out + ".cpn", NREC - 1)
    assert f"{M} markers were processed." in out
    recs = list(postproc._read_records(chain_out + ".cpn", np.int32))
    assert len(recs) == NREC
    for rec, (it, _) in enumerate(recs):
        offset = 4 + rec * (4 + M * 4)
        assert f"read iteration number {it} (iter={rec}) at {offset}" in out
    assert len(_parse_slash_lines(out)) == NREC * M


def test_epsilon_converter_values(ref_bins, chain_out):
    """Reference epsilon_converter reads our .eps.0 ([u32 it][u32 N][f64xN])."""
    out = _run(ref_bins["epsilon_converter"], chain_out + ".eps.0")
    with open(chain_out + ".eps.0", "rb") as fh:
        it, n = np.frombuffer(fh.read(8), np.uint32)
        eps = np.frombuffer(fh.read(), np.float64, count=n)
    assert f"iteration {it} was last logged" in out
    assert f"{n} individuals were processed." in out
    rows = _parse_slash_lines(out)
    assert len(rows) == n
    for (rit, i, sval), want in zip(rows, eps):
        assert rit == it
        # %20.11f rounds to 11 decimals
        assert abs(float(sval) - want) < 5e-12


def test_extract_non_zero_beta_exact_lines(ref_bins, chain_out):
    """extract_non_zero_betaAll == postproc.extract_nonzero, byte for byte
    (both print %7d %7d %20.12f for |beta| > 1e-17)."""
    ref = _run(ref_bins["extract_non_zero_betaAll"], chain_out + ".bet",
               0, NREC - 1)
    ref_lines = [l for l in ref.splitlines()
                 if re.match(r"^\s*\d+\s+\d+\s+-?\d+\.\d+$", l)]
    buf = io.StringIO()
    postproc.extract_nonzero(chain_out + ".bet", 0, NREC - 1, np.float64,
                             out=buf)
    assert ref_lines == buf.getvalue().splitlines()
    assert len(ref_lines) > 0  # the chain set some betas


def test_extract_non_zero_cpn_values(ref_bins, chain_out):
    """extract_non_zero_cpnAll (cpn > 0 rows) vs postproc.extract_nonzero."""
    ref = _run(ref_bins["extract_non_zero_cpnAll"], chain_out + ".cpn",
               chain_out + ".bet", 0, NREC - 1)
    got = [tuple(map(int, l.split())) for l in ref.splitlines() if l.strip()]
    buf = io.StringIO()
    postproc.extract_nonzero(chain_out + ".cpn", 0, NREC - 1, np.int32,
                             out=buf)
    ours = [tuple(map(int, l.split())) for l in buf.getvalue().splitlines()]
    # ours lists all non-zero components; the reference lists cpn > 0 only
    # (identical here: components are never negative)
    assert got == [t for t in ours if t[2] > 0] == ours
    assert len(got) > 0


def test_restart_bet_accepted_by_reference(ref_bins, chain_out):
    """The reference converter also reads the last-state .xbet-style layout?
    No — .xbet is reference-internal. Instead: confirm beta_converter agrees
    with NumPy on every double in .bet (full-file readback)."""
    ref = _parse_slash_lines(
        _run(ref_bins["beta_converter"], chain_out + ".bet", NREC - 1))
    recs = list(postproc._read_records(chain_out + ".bet", np.float64))
    vals = np.array([float(s) for _, _, s in ref]).reshape(NREC, M)
    ours = np.stack([v for _, v in recs])
    np.testing.assert_allclose(vals, ours, atol=5e-13)
