"""Multi-host ("dcn") hierarchical marker sharding.

The reference's cross-node story is a flat MPI_Allreduce regardless of
topology (BayesRRm.cpp:2456); across hosts the residual all-reduce should
be decomposed — psum over "markers" within a host (NVLink) then chunked
psums over a "dcn" axis (parallel/mesh.py:hier_psum). These
tests validate, on the virtual 8-device CPU mesh, that a hierarchical
("dcn", "markers") factorization produces the same chain as the flat 1-D
marker mesh with the same total shard count (the slot layout and per-slot
RNG are shard-count-invariant, so results differ only by reduction
ordering).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from hydra_tpu.parallel.mesh import (
    DCN_AXIS, MARKER_AXIS, hier_psum, make_mesh, mesh_axes)
from hydra_tpu.samplers.bayesrrm import BayesRRm

from tests.test_bayesrrm import simulate


def _run(sampler, n_iter=4):
    st = sampler.init_state()
    for it in range(n_iter):
        st, stats = sampler.step(st, it)
    return st, stats


def test_mesh_axes_hierarchy():
    m = make_mesh(8, n_dcn=2)
    assert m.axis_names == (DCN_AXIS, MARKER_AXIS)
    assert mesh_axes(m) == (8, 1, 2)
    m3 = make_mesh(8, n_dcn=2, n_ind=2)
    assert m3.axis_names == (DCN_AXIS, MARKER_AXIS, "inds")
    assert mesh_axes(m3) == (4, 2, 2)


def test_hier_psum_matches_flat():
    """hier_psum over ("dcn","markers") == flat psum over a fused axis, for
    both chunk-divisible and non-divisible lengths."""
    mesh = make_mesh(8, n_dcn=2)

    def body(n):
        def f():
            dev = jax.lax.axis_index((DCN_AXIS, MARKER_AXIS))
            v = (jnp.arange(n, dtype=jnp.float32) + 1.0) * (dev + 1)
            return hier_psum(v, 2)
        return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(),
                                     out_specs=P()))()

    for n in (64, 30):  # 64 % 8 == 0 (chunked), 30 % 8 != 0 (fallback)
        got = np.asarray(body(n))
        ref = (np.arange(n, dtype=np.float32) + 1.0) * sum(range(1, 9))
        np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("exact", [False, True])
def test_dcn_matches_flat_marker_mesh(exact):
    """(dcn=2 x markers=4) vs flat 8-shard marker mesh: identical slot
    layout and per-slot RNG -> same chain up to reduction ordering."""
    ds, _, _ = simulate(m=96, n=300, h2=0.5, seed=61)
    flat = BayesRRm(ds, window=4, exact=exact, seed=23, mesh=make_mesh(8),
                    shuffle=False)
    hier = BayesRRm(ds, window=4, exact=exact, seed=23,
                    mesh=make_mesh(8, n_dcn=2), shuffle=False)
    st_f, stats_f = _run(flat)
    st_h, stats_h = _run(hier)
    np.testing.assert_allclose(flat.beta_global(st_f), hier.beta_global(st_h),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(st_f.eps), np.asarray(st_h.eps),
                               atol=2e-4)
    np.testing.assert_allclose(float(st_f.sigma_e), float(st_h.sigma_e),
                               rtol=2e-3)
    assert float(np.asarray(stats_h.cass).sum()) == ds.m


def test_dcn_with_ind_axis():
    """Full 3-D hierarchy (dcn=2, markers=2, inds=2) vs flat 4-shard mesh."""
    ds, _, _ = simulate(m=64, n=300, h2=0.5, seed=63)
    flat = BayesRRm(ds, window=4, exact=False, seed=27, mesh=make_mesh(4),
                    shuffle=False)
    hier = BayesRRm(ds, window=4, exact=False, seed=27,
                    mesh=make_mesh(8, n_dcn=2, n_ind=2), shuffle=False)
    st_f, _ = _run(hier, 3)
    st_flat, _ = _run(flat, 3)
    np.testing.assert_allclose(flat.beta_global(st_flat),
                               hier.beta_global(st_f), atol=2e-4)
    np.testing.assert_allclose(np.asarray(st_flat.eps),
                               np.asarray(st_f.eps), atol=2e-4)


def test_bayesw_dcn_matches_flat():
    from hydra_tpu.samplers.bayesw import BayesW
    from tests.test_bayesw import simulate_weibull

    ds, _, _, _ = simulate_weibull(m=48, n=300, seed=71)
    flat = BayesW(ds, window=4, seed=31, mesh=make_mesh(8), shuffle=False)
    hier = BayesW(ds, window=4, seed=31, mesh=make_mesh(8, n_dcn=2),
                  shuffle=False)
    st_f, st_h = flat.init_state(), hier.init_state()
    for it in range(3):
        st_f, _ = flat.step(st_f, it)
        st_h, _ = hier.step(st_h, it)
    np.testing.assert_allclose(float(st_f.alpha), float(st_h.alpha),
                               rtol=1e-3)
    np.testing.assert_allclose(flat.beta_global(st_f), hier.beta_global(st_h),
                               atol=3e-4)
    np.testing.assert_allclose(np.asarray(st_f.eps), np.asarray(st_h.eps),
                               atol=3e-4)


def test_multitrait_dcn_matches_flat():
    from hydra_tpu.samplers.bayesrrm_mt import BayesRRmMT

    ds, _, _ = simulate(m=64, n=300, h2=0.5, seed=73)
    rs = np.random.RandomState(13)
    phenos = np.stack([ds.y, ds.y[::-1].copy()])
    phenos[0, rs.choice(ds.n, 20, replace=False)] = np.nan
    flat = BayesRRmMT(ds, phenos, window=4, seed=57, mesh=make_mesh(8),
                      shuffle=False)
    hier = BayesRRmMT(ds, phenos, window=4, seed=57,
                      mesh=make_mesh(8, n_dcn=2), shuffle=False)
    st_f, st_h = flat.init_state(), hier.init_state()
    for it in range(3):
        st_f, _ = flat.step(st_f, it)
        st_h, _ = hier.step(st_h, it)
    np.testing.assert_allclose(flat.beta_global(st_f), hier.beta_global(st_h),
                               atol=3e-4)
    np.testing.assert_allclose(np.asarray(st_f.eps), np.asarray(st_h.eps),
                               atol=3e-4)
