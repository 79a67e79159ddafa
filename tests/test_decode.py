"""On-device decode & window primitive tests against the NumPy golden path."""

import numpy as np
import jax.numpy as jnp

from hydra_tpu.data.genotypes import GenotypeData
from hydra_tpu.io import plink
from hydra_tpu.ops.decode import decode_planes, marker_counts, standardized_window, window_dot


def _packed_dataset(factory, m=17, n=37, missing_rate=0.06):
    base, geno = factory(m, n, missing_rate=missing_rate)
    packed = plink.read_bed(base + ".bed", n, m)
    return packed, geno


def test_decode_planes_matches_numpy(synthetic_bed_factory):
    packed, geno = _packed_dataset(synthetic_bed_factory)
    A, B = decode_planes(jnp.asarray(packed))
    g_np, m_np = plink.decode_bed_numpy(packed, packed.shape[1] * 4)
    np.testing.assert_array_equal(np.asarray(A), g_np)
    np.testing.assert_array_equal(np.asarray(B), m_np)


def test_window_dot(synthetic_bed_factory):
    packed, geno = _packed_dataset(synthetic_bed_factory, m=9, n=61)
    n_pad = packed.shape[1] * 4
    eps = np.random.RandomState(0).randn(n_pad)
    s1, s2 = window_dot(jnp.asarray(packed), jnp.asarray(eps, jnp.float32))
    g_np, m_np = plink.decode_bed_numpy(packed, n_pad)
    np.testing.assert_allclose(np.asarray(s1), g_np @ eps, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(s2), m_np @ eps, rtol=1e-5)


def test_marker_counts_and_stats(synthetic_bed_factory):
    base, geno = synthetic_bed_factory(21, 45, missing_rate=0.08)
    packed = plink.read_bed(base + ".bed", 45, 21)
    gd = GenotypeData.from_packed(packed, 45, np.array([], dtype=np.int64))
    # NumPy expectations
    n1 = (geno == 1).sum(axis=1)
    n2 = (geno == 2).sum(axis=1)
    nm = (geno == -1).sum(axis=1)
    np.testing.assert_array_equal(gd.n1, n1)
    np.testing.assert_array_equal(gd.n2, n2)
    np.testing.assert_array_equal(gd.nm, nm)
    mave = (n1 + 2.0 * n2) / (45.0 - nm)
    np.testing.assert_allclose(gd.mave, mave, rtol=1e-12)
    # mstd = sqrt((N-1)/sum (g - mave)^2 over non-missing) (BayesRRm.cpp:1502-1508)
    for j in range(21):
        obs = geno[j][geno[j] >= 0]
        ss = np.sum((obs - mave[j]) ** 2)
        np.testing.assert_allclose(gd.mstd[j], np.sqrt(44.0 / ss), rtol=1e-10)

    # device-side counts agree (on padded rows, padding adds to NM only)
    c1, c2, cm = marker_counts(jnp.asarray(gd.packed))
    np.testing.assert_array_equal(np.asarray(c1), n1)
    np.testing.assert_array_equal(np.asarray(c2), n2)
    np.testing.assert_array_equal(np.asarray(cm), nm + (gd.n_pad - 45))


def test_standardized_window(synthetic_bed_factory):
    base, geno = synthetic_bed_factory(7, 33, missing_rate=0.1)
    packed = plink.read_bed(base + ".bed", 33, 7)
    gd = GenotypeData.from_packed(packed, 33, np.array([], dtype=np.int64))
    Xt = standardized_window(
        jnp.asarray(gd.packed), jnp.asarray(gd.mave, jnp.float32),
        jnp.asarray(gd.mstd, jnp.float32),
    )
    Xt = np.asarray(Xt)
    assert Xt.shape == (7, gd.n_pad)
    # padding columns are exactly zero
    assert np.all(Xt[:, 33:] == 0.0)
    # each column standardized: sum over non-missing of x~^2 == N-1
    np.testing.assert_allclose((Xt**2).sum(axis=1), 32.0, rtol=1e-4)
    # missing entries decode to zero contribution
    miss = geno == -1
    np.testing.assert_allclose(Xt[:, :33][miss], 0.0, atol=1e-6)


def test_na_correction_pipeline(synthetic_bed_factory):
    base, geno = synthetic_bed_factory(5, 20, missing_rate=0.05)
    packed = plink.read_bed(base + ".bed", 20, 5)
    gd = GenotypeData.from_packed(packed, 20, np.array([3, 11]))
    assert gd.n == 18
    keep = np.setdiff1d(np.arange(20), [3, 11])
    g_exp = geno[:, keep]
    g_dec, m_dec = plink.decode_bed_numpy(gd.packed, 18)
    np.testing.assert_array_equal(g_dec, np.where(g_exp >= 0, g_exp, 0))


def test_pad_individuals_tile_friendly():
    """pad_individuals rounds up to the next multiple of IND_ALIGN (a
    128-byte packed width that splits over any power-of-two ind axis)."""
    from hydra_tpu.data.genotypes import IND_ALIGN, pad_individuals

    assert pad_individuals(5_000) == 5_120
    assert pad_individuals(50_000) == 50_176
    assert pad_individuals(300) == 512
    assert pad_individuals(512) == 512
    for n in (123, 5_000, 50_000, 458_000, 500_000, 458_783, 1_234_567):
        np_ = pad_individuals(n)
        assert np_ >= n and np_ % IND_ALIGN == 0
        assert np_ - n < IND_ALIGN, (n, np_)
