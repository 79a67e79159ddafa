"""Native C++ BED kernel parity tests (vs the NumPy golden path)."""

import numpy as np
import pytest

from hydra_tpu import native
from hydra_tpu.io import plink

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C++ toolchain available")


def _data(factory, m=33, n=77, missing=0.07):
    base, geno = factory(m, n, missing_rate=missing)
    packed = plink.read_bed(base + ".bed", n, m)
    return packed, geno


def test_counts(synthetic_bed_factory):
    packed, geno = _data(synthetic_bed_factory)
    n1, n2, nm = native.bed_counts(packed, 77)
    np.testing.assert_array_equal(n1, (geno == 1).sum(1))
    np.testing.assert_array_equal(n2, (geno == 2).sum(1))
    np.testing.assert_array_equal(nm, (geno == -1).sum(1))


def test_decode(synthetic_bed_factory):
    packed, geno = _data(synthetic_bed_factory)
    g, mk = native.bed_decode(packed)
    g_np, m_np = plink.decode_bed_numpy(packed, packed.shape[1] * 4)
    np.testing.assert_array_equal(g, g_np.astype(np.float32))
    np.testing.assert_array_equal(mk, m_np.astype(np.float32))


def test_remove_individuals(synthetic_bed_factory):
    packed, geno = _data(synthetic_bed_factory)
    drop = np.array([0, 5, 33, 76])
    out = native.bed_remove_individuals(packed, 77, drop)
    ref = plink.remove_individuals_packed(packed, 77, drop)
    g1, m1 = plink.decode_bed_numpy(out, 73)
    g2, m2 = plink.decode_bed_numpy(ref, 73)
    np.testing.assert_array_equal(g1, g2)
    np.testing.assert_array_equal(m1, m2)


def test_sparse_fill(synthetic_bed_factory):
    packed, geno = _data(synthetic_bed_factory, m=9, n=41)
    c1, c2, cm = native.bed_counts(packed, 41)
    s1 = np.concatenate([[0], np.cumsum(c1)[:-1]])
    s2 = np.concatenate([[0], np.cumsum(c2)[:-1]])
    sm = np.concatenate([[0], np.cumsum(cm)[:-1]])
    i1, i2, im = native.bed_sparse_fill(packed, 41, s1, s2, sm, c1, c2, cm)
    for j in range(9):
        np.testing.assert_array_equal(
            i1[s1[j]: s1[j] + c1[j]], np.nonzero(geno[j] == 1)[0])
        np.testing.assert_array_equal(
            i2[s2[j]: s2[j] + c2[j]], np.nonzero(geno[j] == 2)[0])
        np.testing.assert_array_equal(
            im[sm[j]: sm[j] + cm[j]], np.nonzero(geno[j] == -1)[0])


def test_bed_dot(synthetic_bed_factory):
    packed, geno = _data(synthetic_bed_factory, m=15, n=60)
    from hydra_tpu.data.genotypes import GenotypeData
    gd = GenotypeData.from_packed(packed, 60, np.array([], dtype=np.int64))
    rs = np.random.RandomState(1)
    eps = rs.randn(60)
    num = native.bed_dot(gd.packed, 60, eps, gd.mave, gd.mstd)
    g_np, m_np = plink.decode_bed_numpy(gd.packed, 60)
    xt = (g_np - gd.mave[:, None] * m_np) * gd.mstd[:, None]
    np.testing.assert_allclose(num, xt[:, :60] @ eps, rtol=1e-10)
