"""IO layer tests: PLINK round-trip, NA semantics, sparse format, groups."""

import os

import numpy as np
import pytest

from hydra_tpu.io import plink, sparse as sparse_io
from hydra_tpu.io.pheno import (
    center_and_scale,
    read_failure_file,
    read_phen_cov_files,
    read_phen_fail_files,
    read_phenotype_file,
)
from hydra_tpu.io.groups import (
    assign_blocks_to_tasks,
    read_group_file,
    read_group_priors,
    read_ms_file,
)

# small hand-written files in the reference's formats
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def test_bed_roundtrip(synthetic_bed_factory):
    base, geno = synthetic_bed_factory(37, 53, missing_rate=0.05)
    packed = plink.read_bed(base + ".bed", 53, 37)
    g, mask = plink.decode_bed_numpy(packed, 53)
    expect_mask = (geno >= 0).astype(float)
    expect_geno = np.where(geno >= 0, geno, 0).astype(float)
    np.testing.assert_array_equal(mask, expect_mask)
    np.testing.assert_array_equal(g, expect_geno)


def test_fam_bim_readers(synthetic_bed_factory):
    base, _ = synthetic_bed_factory(10, 20)
    fam = plink.read_fam(base + ".fam")
    bim = plink.read_bim(base + ".bim")
    assert fam.n == 20
    assert bim.m == 10
    assert bim.snp_id[3] == "snp3"


def test_reference_fam_reader():
    """PLINK .fam layout (FID IID father mother sex phenotype); the same
    IID under two FIDs is two individuals (data.cpp:1455-1458 keys on
    both). The reference's only gtest counts a .fam's individuals
    (test/dataTest.cpp:4-10)."""
    fam = plink.read_fam(os.path.join(DATA, "small.fam"))
    assert fam.n == 6
    assert fam.fid == ["FAM1", "FAM1", "FAM1", "FAM2", "FAM2", "FAM3"]
    assert fam.pid == ["IND1", "IND2", "IND3", "IND1", "IND2", "IND7"]
    np.testing.assert_array_equal(fam.sex, [1, 2, 1, 2, 0, 1])


def test_phenotype_na_semantics(tmp_path):
    p = tmp_path / "t.phen"
    p.write_text("f0 i0 1.5\nf1 i1 NA\nf2 i2 -0.25\nf3 i3 NA\nf4 i4 3.0\n")
    ph = read_phenotype_file(str(p), expected_n=5)
    np.testing.assert_array_equal(ph.na_indices, [1, 3])
    np.testing.assert_allclose(ph.y, [1.5, -0.25, 3.0])
    assert ph.num_nas == 2


def test_phen_cov_na_union(tmp_path):
    (tmp_path / "t.phen").write_text("f0 i0 1.0\nf1 i1 2.0\nf2 i2 3.0\n")
    (tmp_path / "t.cov").write_text("f0 i0 0.1 0.2\nf1 i1 NA 0.3\nf2 i2 0.5 0.6\n")
    ph = read_phen_cov_files(str(tmp_path / "t.phen"), str(tmp_path / "t.cov"), 3)
    np.testing.assert_array_equal(ph.na_indices, [1])
    np.testing.assert_allclose(ph.y, [1.0, 3.0])
    np.testing.assert_allclose(ph.X, [[0.1, 0.2], [0.5, 0.6]])


def test_phen_fail(tmp_path):
    (tmp_path / "t.phen").write_text("f0 i0 1.0\nf1 i1 NA\nf2 i2 3.0\n")
    (tmp_path / "t.fail").write_text("1\n0\n0\n")
    ph = read_phen_fail_files(str(tmp_path / "t.phen"), str(tmp_path / "t.fail"), 3)
    np.testing.assert_allclose(ph.y, [1.0, 3.0])
    np.testing.assert_allclose(ph.fail, [1.0, 0.0])


def test_failure_file_reference_example():
    """.fail: one 0/1 event indicator per individual (data.cpp:1919-1937)."""
    fail = read_failure_file(os.path.join(DATA, "small.fail"))
    np.testing.assert_array_equal(fail, [1, 0, 0, 1, 1, 0, 1, 1])
    assert fail.dtype == np.float64


def test_center_and_scale():
    y = np.array([1.0, 2.0, 3.0, 4.0])
    z = center_and_scale(y)
    assert abs(z.mean()) < 1e-12
    np.testing.assert_allclose((z**2).sum(), len(y) - 1)


def test_ms_file_reference_example():
    """.mS: one comma-separated mixture grid per group, groups separated by
    ';'; the reader prepends the spike's 0.0 (data.cpp:1963-2009)."""
    mS = read_ms_file(os.path.join(DATA, "small.mS"))
    assert mS.shape == (2, 4)
    np.testing.assert_allclose(mS[0], [0.0, 0.001, 0.01, 0.1])
    np.testing.assert_allclose(mS[1], [0.0, 0.0001, 0.001, 0.01])


def test_group_file_reference_example():
    """.group: one group index per marker, any whitespace layout
    (data.cpp:1940-1959)."""
    g = read_group_file(os.path.join(DATA, "small.group"))
    np.testing.assert_array_equal(g, [0, 0, 1, 1, 2, 2, 0, 1, 1, 0])
    assert g.dtype == np.int32


def test_group_priors(tmp_path):
    p = tmp_path / "p.txt"
    p.write_text("0.001,0.001; 2.0,0.5")
    pr = read_group_priors(str(p))
    np.testing.assert_allclose(pr, [[0.001, 0.001], [2.0, 0.5]])


def test_ms_rejects_nonpositive(tmp_path):
    p = tmp_path / "bad.mS"
    p.write_text("0.0,0.01")
    with pytest.raises(ValueError):
        read_ms_file(str(p))


def test_block_assignment_even():
    s, l = assign_blocks_to_tasks(0, None, None, 10, 4)
    np.testing.assert_array_equal(l, [3, 3, 2, 2])
    np.testing.assert_array_equal(s, [0, 3, 6, 8])
    assert l.sum() == 10


def test_sparse_roundtrip(tmp_path, synthetic_bed_factory):
    base, geno = synthetic_bed_factory(23, 41, missing_rate=0.1)
    out = str(tmp_path / "sp")
    sparse_io.write_sparse_files(base + ".bed", 41, 23, out, block_size=7)
    sp = sparse_io.read_sparse_files(out)
    assert (sp.n, sp.m) == (41, 23)
    packed2 = sparse_io.sparse_to_packed_bed(sp)
    g2, m2 = plink.decode_bed_numpy(packed2, 41)
    g1, m1 = plink.decode_bed_numpy(plink.read_bed(base + ".bed", 41, 23), 41)
    np.testing.assert_array_equal(g1, g2)
    np.testing.assert_array_equal(m1, m2)


def test_sparse_slice_read(tmp_path, synthetic_bed_factory):
    base, _ = synthetic_bed_factory(23, 41)
    out = str(tmp_path / "sp")
    sparse_io.write_sparse_files(base + ".bed", 41, 23, out)
    sp = sparse_io.read_sparse_files(out, marker_start=5, marker_count=6)
    assert sp.m == 6
    packed_all = plink.read_bed(base + ".bed", 41, 23)
    g_all, _ = plink.decode_bed_numpy(packed_all, 41)
    packed_slice = sparse_io.sparse_to_packed_bed(sp)
    g_slice, _ = plink.decode_bed_numpy(packed_slice, 41)
    np.testing.assert_array_equal(g_slice, g_all[5:11])


def test_remove_individuals_packed(synthetic_bed_factory):
    base, geno = synthetic_bed_factory(11, 29, missing_rate=0.07)
    packed = plink.read_bed(base + ".bed", 29, 11)
    drop = np.array([0, 7, 28])
    packed2 = plink.remove_individuals_packed(packed, 29, drop)
    keep = np.setdiff1d(np.arange(29), drop)
    g2, m2 = plink.decode_bed_numpy(packed2, 26)
    g1, m1 = plink.decode_bed_numpy(packed, 29)
    np.testing.assert_array_equal(g2, g1[:, keep])
    np.testing.assert_array_equal(m2, m1[:, keep])


def test_sparse_writer_native_matches_python(tmp_path, synthetic_bed_factory, monkeypatch):
    """The native bed_counts+bed_sparse_fill converter path produces files
    byte-identical to the NumPy per-marker loop (write_sparse_files)."""
    from hydra_tpu import native
    if not native.available():
        import pytest
        pytest.skip("native toolchain unavailable")
    base, _ = synthetic_bed_factory(37, 53, missing_rate=0.07)
    a = str(tmp_path / "nat")
    b = str(tmp_path / "py")
    sparse_io.write_sparse_files(base + ".bed", 53, 37, a, block_size=11)
    monkeypatch.setattr(native, "available", lambda: False)
    sparse_io.write_sparse_files(base + ".bed", 53, 37, b, block_size=11)
    exts = [f".{k}{t}" for k in ("ss", "sl", "si") for t in ("1", "2", "m")]
    for ext in exts + [".dim"]:
        with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
            assert fa.read() == fb.read(), ext
