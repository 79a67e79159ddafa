"""Individual-dimension (N) sharding: 2-D (markers, inds) mesh equivalence.

The reference replicates the full epsilon vector on every rank
(BayesRRm.cpp:1528-1537), bounding N by node RAM. This rebuild adds an
"inds" mesh axis that shards epsilon, the covariates and the packed byte
columns, turning every N-length reduction into a partial dot + one psum
over that axis. These tests check that any (markers, inds) factorization
of the same device pool gives the same chain as the inds-replicated layout
(up to psum float ordering).
"""

import numpy as np
import pytest

from hydra_tpu.parallel.mesh import make_mesh, mesh_axes
from hydra_tpu.samplers.bayesrrm import BayesRRm

from tests.test_bayesrrm import simulate


def _run(sampler, n_iter=4):
    st = sampler.init_state()
    for it in range(n_iter):
        st, stats = sampler.step(st, it)
    return st, stats


@pytest.mark.parametrize("n_ind", [2, 4, 8])
def test_ind_sharding_matches_replicated(n_ind):
    """(8/n_ind markers x n_ind inds) vs (8/n_ind markers x 1): the marker
    layout is identical, so the chains differ only by psum ordering."""
    ds, _, _ = simulate(m=96, n=300, h2=0.5, seed=31)
    n_marker = 8 // n_ind
    ref = BayesRRm(ds, window=4, exact=True, seed=17,
                   mesh=make_mesh(n_marker), shuffle=False)
    two_d = BayesRRm(ds, window=4, exact=True, seed=17,
                     mesh=make_mesh(8, n_ind=n_ind), shuffle=False)
    assert mesh_axes(two_d.mesh) == (n_marker, n_ind, 1)
    st_ref, stats_ref = _run(ref)
    st_2d, stats_2d = _run(two_d)

    np.testing.assert_allclose(ref.beta_global(st_ref),
                               two_d.beta_global(st_2d), atol=2e-4)
    np.testing.assert_allclose(np.asarray(st_ref.eps),
                               np.asarray(st_2d.eps), atol=2e-4)
    np.testing.assert_allclose(float(st_ref.sigma_e), float(st_2d.sigma_e),
                               rtol=2e-3)
    assert float(np.asarray(stats_2d.cass).sum()) == ds.m


def test_pure_ind_sharding_exact_sequential():
    """(1 x 8): N fully sharded, markers on one shard — must reproduce the
    single-device exact sequential sweep."""
    ds, _, _ = simulate(m=64, n=300, h2=0.5, seed=33)
    s1 = BayesRRm(ds, window=8, exact=True, seed=5, mesh=make_mesh(1))
    s8 = BayesRRm(ds, window=8, exact=True, seed=5,
                  mesh=make_mesh(8, n_ind=8))
    st1, _ = _run(s1)
    st8, _ = _run(s8)
    np.testing.assert_allclose(s1.beta_global(st1), s8.beta_global(st8),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(st1.eps), np.asarray(st8.eps),
                               atol=2e-4)


def test_ind_sharding_with_covariates_and_fh():
    """Covariate ridge sweep (psum per column) and FH branches under a 2-D
    mesh."""
    ds, _, _ = simulate(m=48, n=256, h2=0.5, seed=35)
    rs = np.random.RandomState(7)
    ds.X = rs.randn(ds.n, 3)
    ref = BayesRRm(ds, window=4, fh=True, seed=19, mesh=make_mesh(2),
                   shuffle=False)
    two_d = BayesRRm(ds, window=4, fh=True, seed=19,
                     mesh=make_mesh(8, n_ind=4), shuffle=False)
    st_ref, _ = _run(ref, 3)
    st_2d, _ = _run(two_d, 3)
    np.testing.assert_allclose(np.asarray(st_ref.gamma),
                               np.asarray(st_2d.gamma), atol=2e-4)
    np.testing.assert_allclose(ref.beta_global(st_ref),
                               two_d.beta_global(st_2d), atol=2e-4)


def test_bayesw_ind_sharding_matches_replicated():
    """BayesW under a (2 markers x 4 inds) mesh vs (2 markers x 1): the
    N-length partial sums (vi level sums, slice-density sums) psum over the
    inds axis; the chains must agree up to psum float ordering."""
    from hydra_tpu.samplers.bayesw import BayesW
    from tests.test_bayesw import simulate_weibull

    ds, _, _, _ = simulate_weibull(m=48, n=300, seed=41)
    ref = BayesW(ds, window=4, seed=29, mesh=make_mesh(2), shuffle=False)
    two_d = BayesW(ds, window=4, seed=29, mesh=make_mesh(8, n_ind=4),
                   shuffle=False)
    st_ref, st_2d = ref.init_state(), two_d.init_state()
    for it in range(3):
        st_ref, _ = ref.step(st_ref, it)
        st_2d, _ = two_d.step(st_2d, it)
    np.testing.assert_allclose(float(st_ref.alpha), float(st_2d.alpha),
                               rtol=1e-3)
    np.testing.assert_allclose(ref.beta_global(st_ref),
                               two_d.beta_global(st_2d), atol=3e-4)
    np.testing.assert_allclose(np.asarray(st_ref.eps),
                               np.asarray(st_2d.eps), atol=3e-4)


def test_multitrait_ind_sharding_matches_replicated():
    """BayesRRm-mt: (2 markers x 4 inds) vs (2 markers), 2 traits with NaN
    masks — per-trait chains agree up to psum ordering."""
    from hydra_tpu.samplers.bayesrrm_mt import BayesRRmMT

    ds, _, _ = simulate(m=64, n=300, h2=0.5, seed=51)
    rs = np.random.RandomState(11)
    phenos = np.stack([ds.y, ds.y[::-1].copy()])
    phenos[0, rs.choice(ds.n, 20, replace=False)] = np.nan
    ref = BayesRRmMT(ds, phenos, window=4, seed=53, mesh=make_mesh(2),
                     shuffle=False)
    two_d = BayesRRmMT(ds, phenos, window=4, seed=53,
                       mesh=make_mesh(8, n_ind=4), shuffle=False)
    st_ref, st_2d = ref.init_state(), two_d.init_state()
    for it in range(3):
        st_ref, _ = ref.step(st_ref, it)
        st_2d, _ = two_d.step(st_2d, it)
    np.testing.assert_allclose(ref.beta_global(st_ref),
                               two_d.beta_global(st_2d), atol=3e-4)
    np.testing.assert_allclose(np.asarray(st_ref.eps),
                               np.asarray(st_2d.eps), atol=3e-4)
    np.testing.assert_allclose(np.asarray(st_ref.sigma_e),
                               np.asarray(st_2d.sigma_e), rtol=2e-3)
