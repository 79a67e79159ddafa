"""Multi-trait sampler tests: shapes, NaN masks, recovery, trait independence."""

import numpy as np
import pytest

from hydra_tpu.data.genotypes import Dataset, GenotypeData, make_default_groups
from hydra_tpu.parallel.mesh import make_mesh
from hydra_tpu.samplers.bayesrrm_mt import BayesRRmMT

from tests.test_bayesrrm import _pack


def simulate_mt(m=120, n=500, n_traits=3, h2=0.5, seed=3, na_frac=0.0):
    rs = np.random.RandomState(seed)
    maf = rs.uniform(0.1, 0.5, m)
    geno = rs.binomial(1, maf[:, None], (m, n)) + rs.binomial(1, maf[:, None], (m, n))
    keep = geno.std(axis=1) > 0
    geno = geno[keep]
    m = geno.shape[0]
    x = (geno - geno.mean(1, keepdims=True)) / geno.std(1, keepdims=True)
    betas = np.zeros((m, n_traits))
    phenos = np.zeros((n_traits, n))
    ncausal = m // 4
    for t in range(n_traits):
        causal = rs.choice(m, ncausal, replace=False)
        betas[causal, t] = rs.randn(ncausal) * np.sqrt(h2 / ncausal)
        phenos[t] = x.T @ betas[:, t] + rs.randn(n) * np.sqrt(1 - h2)
        if na_frac > 0:
            phenos[t, rs.random(n) < na_frac] = np.nan
    gd = GenotypeData.from_packed(_pack(geno), n, np.array([], dtype=np.int64))
    groups, mS = make_default_groups(m, [0.001, 0.01, 0.1])
    ds = Dataset(geno=gd, y=phenos[0], groups=groups, num_groups=1, mS=mS)
    return ds, phenos, betas


def test_mt_one_step():
    ds, phenos, betas = simulate_mt(m=48, n=200, n_traits=2)
    s = BayesRRmMT(ds, phenos, window=8, seed=5, mesh=make_mesh(4))
    st = s.init_state()
    st, stats = s.step(st, 0)
    assert st.eps.shape == (ds.geno.n_pad, 2)
    assert np.asarray(stats.cass).sum() == 48 * 2
    assert np.isfinite(np.asarray(st.beta)).all()


@pytest.mark.slow
def test_mt_recovery_and_na_masks():
    ds, phenos, betas = simulate_mt(m=96, n=500, n_traits=2, seed=11,
                                    na_frac=0.1)
    s = BayesRRmMT(ds, phenos, window=4, seed=13, mesh=make_mesh(2))
    st = s.init_state()
    h2s, bsum, cnt = [], 0.0, 0
    for it in range(200):
        st, stats = s.step(st, it)
        if it >= 100:
            sg = np.asarray(st.sigma_g).sum(axis=1)
            se = np.asarray(st.sigma_e)
            h2s.append(sg / (sg + se))
            bsum = bsum + s.beta_global(st)
            cnt += 1
    h2_mean = np.mean(h2s, axis=0)
    beta_mean = bsum / cnt
    for t in range(2):
        assert abs(h2_mean[t] - 0.5) < 0.25, (t, h2_mean)
        corr = np.corrcoef(beta_mean[:, t], betas[:, t])[0, 1]
        assert corr > 0.5, (t, corr)
    # masked entries of eps stay exactly zero
    eps = np.asarray(st.eps)[: ds.geno.n]
    mask = np.isfinite(phenos).T
    assert np.all(eps[~mask] == 0.0)


@pytest.mark.slow
def test_mt_matches_single_trait_when_duplicated():
    """Running the same phenotype as 2 traits: each trait's posterior matches
    a single-trait run distribution-wise."""
    ds, phenos, betas = simulate_mt(m=64, n=400, n_traits=1, seed=21)
    dup = np.vstack([phenos[0], phenos[0]])
    s = BayesRRmMT(ds, dup, window=4, seed=23, mesh=make_mesh(1))
    st = s.init_state()
    acc = 0.0
    for it in range(120):
        st, _ = s.step(st, it)
        if it >= 60:
            acc = acc + s.beta_global(st)
    bm = acc / 60
    # the two trait columns are distinct chains over the same posterior
    assert np.corrcoef(bm[:, 0], bm[:, 1])[0, 1] > 0.8


@pytest.mark.slow
@pytest.mark.parametrize("na_frac,n_dev", [(0.0, 1), (0.0, 4), (0.1, 1),
                                           (0.1, 2)])
def test_mt_exact_is_window_invariant(na_frac, n_dev):
    """Exact mt == per-marker sequential schedule for any window size.

    W=1 is literally one marker per shard between residual syncs; exact
    W>1 must reproduce it through the per-trait Gram correction (the mt
    analogue of test_exact_mode_is_exact_across_shards). na_frac>0 takes
    the per-trait masked-Gram path; n_dev>1 the packed-byte block ring.
    cross_sync=1 pins the strict per-step semantics on multi-shard meshes
    (the round-4 default is cross_sync=window; its semantics are pinned by
    test_mt_cross_sync_semantics instead)."""
    ds, phenos, _ = simulate_mt(m=96, n=320, n_traits=2, seed=3,
                                na_frac=na_frac)
    s1 = BayesRRmMT(ds, phenos, window=1, seed=13, mesh=make_mesh(n_dev),
                    shuffle=True, cross_sync=1)
    s4 = BayesRRmMT(ds, phenos, window=4, seed=13, mesh=make_mesh(n_dev),
                    shuffle=True, cross_sync=1)
    assert s4.cfg.exact and s4.cfg.full_pheno == (na_frac == 0.0)
    st1, st4 = s1.init_state(), s4.init_state()
    for it in range(3):
        st1, _ = s1.step(st1, it)
        st4, _ = s4.step(st4, it)
        np.testing.assert_allclose(
            s1.beta_global(st1), s4.beta_global(st4), atol=2e-4,
            err_msg=f"iteration {it}")
    np.testing.assert_allclose(np.asarray(st1.eps), np.asarray(st4.eps),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(st1.sigma_e),
                               np.asarray(st4.sigma_e), rtol=2e-3)


@pytest.mark.parametrize("na_frac", [0.0, 0.1])
def test_mt_cross_sync_semantics(na_frac):
    """Pin the batched cross-shard exchange for mt (round-4 exact default).

    (window=W, cross_sync=B) must equal (window=B): marker j sees all
    own-shard deltas t<j plus other shards' deltas up to the last exchange
    — exactly what the window-boundary residual psum of a width-B window
    produces. Covers both the trait-shared Gram (full phenotypes) and the
    per-trait masked Gram (na_frac>0)."""
    ds, phenos, _ = simulate_mt(m=64, n=320, n_traits=2, seed=3,
                                na_frac=na_frac)
    s_b = BayesRRmMT(ds, phenos, window=8, seed=13, mesh=make_mesh(2),
                     shuffle=True, cross_sync=4)
    s_ref = BayesRRmMT(ds, phenos, window=4, seed=13, mesh=make_mesh(2),
                       shuffle=True)
    assert s_b.cfg.exact and s_b.cfg.cross_sync == 4
    assert s_b.cfg.full_pheno == (na_frac == 0.0)
    st_b, st_r = s_b.init_state(), s_ref.init_state()
    for it in range(3):
        st_b, _ = s_b.step(st_b, it)
        st_r, _ = s_ref.step(st_r, it)
        np.testing.assert_allclose(
            s_b.beta_global(st_b), s_ref.beta_global(st_r), atol=2e-4,
            err_msg=f"na_frac={na_frac} iteration {it}")
    np.testing.assert_allclose(np.asarray(st_b.eps), np.asarray(st_r.eps),
                               atol=2e-4)


def test_mt_exact_missing_genotypes_window_invariant():
    """Missing genotypes force the plane (non-integer) Gram; exact mt must
    still be window-invariant."""
    from tests.test_bayesrrm import simulate as simulate_1t

    ds, phenos, _ = simulate_mt(m=64, n=256, n_traits=2, seed=7)
    # repack with 5% missing entries (reuses the single-trait helper's
    # packing; stats recomputed by from_packed)
    rs = np.random.RandomState(9)
    from hydra_tpu.io.plink import decode_bed_numpy
    g, _ = decode_bed_numpy(ds.geno.packed, ds.geno.n)
    g = g.astype(np.int64)
    g[rs.random(g.shape) < 0.05] = -1
    gd = GenotypeData.from_packed(_pack(g), ds.geno.n,
                                  np.array([], dtype=np.int64))
    assert int(np.asarray(gd.nm).sum()) > 0
    import dataclasses
    ds = dataclasses.replace(ds, geno=gd)
    s1 = BayesRRmMT(ds, phenos, window=1, seed=5, mesh=make_mesh(2),
                    cross_sync=1)
    s4 = BayesRRmMT(ds, phenos, window=4, seed=5, mesh=make_mesh(2),
                    cross_sync=1)
    assert s4.cfg.exact and not s4.cfg.complete
    st1, st4 = s1.init_state(), s4.init_state()
    for it in range(3):
        st1, _ = s1.step(st1, it)
        st4, _ = s4.step(st4, it)
    np.testing.assert_allclose(s1.beta_global(st1), s4.beta_global(st4),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(st1.eps), np.asarray(st4.eps),
                               atol=2e-4)


def test_mt_matches_numpy_golden_model():
    """JAX mt sampler vs the independent sequential NumPy golden model
    (testing/reference_bayesrrm_mt.py): same posterior per trait under NaN
    masks and covariates (VERDICT r2 missing #1, mt leg)."""
    import dataclasses

    from hydra_tpu.io.plink import decode_bed_numpy
    from hydra_tpu.testing import reference_bayesrrm_mt as mtref

    ds, phenos, betas = simulate_mt(m=96, n=400, n_traits=2, seed=43,
                                    na_frac=0.08)
    rs = np.random.RandomState(43)
    X = rs.randn(400, 2)
    g_true = np.array([[1.0, -0.7], [-1.2, 0.5]])
    phenos = phenos + (X @ g_true).T
    ds = dataclasses.replace(ds, X=X)
    m, n, T = ds.geno.m, ds.geno.n, 2

    # independent data prep: decode, per-trait center/scale, masked stats
    g, miss = decode_bed_numpy(ds.geno.packed, n)
    tm = np.isfinite(phenos).astype(np.float64).T          # (N, T)
    nonas = tm.sum(axis=0)
    y = np.where(tm.T > 0, phenos, 0.0)
    y = (y - y.sum(1) [:, None] / nonas[:, None]) * tm.T
    y *= np.sqrt((nonas - 1) / (y * y).sum(1))[:, None]
    mave = np.zeros((m, T))
    mstd = np.zeros((m, T))
    for t in range(T):
        mt = miss * tm[:, t][None, :]
        cnt = mt.sum(1)
        mave[:, t] = (g * mt).sum(1) / cnt
        var = (mt * (g - mave[:, t][:, None]) ** 2).sum(1)
        mstd[:, t] = np.sqrt((cnt - 1) / var)

    rng = np.random.RandomState(99)
    st = dict(eps=(y * tm.T).T, beta=np.zeros((m, T)), mu=np.zeros(T),
              sigma_g=np.full((T, 1), 0.5),
              sigma_e=(y ** 2).sum(1) / nonas * 0.5,
              est_pi=np.tile(np.array([0.5, 0.5 * 0.001 / 0.111,
                                       0.5 * 0.01 / 0.111,
                                       0.5 * 0.1 / 0.111]), (T, 1, 1)),
              gamma=np.zeros((2, T)))
    h2_np, bsum, gsum, cnt_it = [], 0.0, 0.0, 0
    for it in range(200):
        out = mtref.sweep(g, miss, tm, st['eps'], st['beta'], mave, mstd,
                          ds.groups, ds.mS, st['sigma_g'], st['sigma_e'],
                          st['mu'], st['est_pi'], rng, x_cov=X,
                          gamma=st['gamma'])
        st = {k: out[k] for k in ('eps', 'beta', 'mu', 'sigma_g', 'sigma_e',
                                  'est_pi', 'gamma')}
        if it >= 100:
            sg = out['sigma_g'].sum(axis=1)
            h2_np.append(sg / (sg + out['sigma_e']))
            bsum = bsum + out['beta']
            gsum = gsum + out['gamma']
            cnt_it += 1
    h2_np = np.mean(h2_np, axis=0)
    beta_np = bsum / cnt_it
    gamma_np = gsum / cnt_it

    s = BayesRRmMT(ds, phenos, window=8, seed=55, mesh=make_mesh(4))
    st2 = s.init_state()
    h2s, bacc, gacc = [], 0.0, 0.0
    for it in range(200):
        st2, _ = s.step(st2, it)
        if it >= 100:
            sg = np.asarray(st2.sigma_g).sum(axis=1)
            h2s.append(sg / (sg + np.asarray(st2.sigma_e)))
            bacc = bacc + s.beta_global(st2)
            gacc = gacc + np.asarray(st2.gamma)
    h2_jax = np.mean(h2s, axis=0)
    beta_jax = bacc / 100
    gamma_jax = gacc / 100
    for t in range(T):
        assert abs(h2_jax[t] - h2_np[t]) < 0.12, (t, h2_jax, h2_np)
        assert np.corrcoef(beta_np[:, t], beta_jax[:, t])[0, 1] > 0.9, t
    np.testing.assert_allclose(gamma_jax, gamma_np, atol=0.05)


def test_mt_covariate_recovery():
    """Per-trait fixed effects: known gamma recovered per trait under masks
    (the completed generalization of BayesRRm.cpp:2648-2681; the reference's
    own mt covariate block is unfinished — see sampler docstring)."""
    import dataclasses

    ds, phenos, betas = simulate_mt(m=32, n=400, n_traits=2, seed=31,
                                    na_frac=0.05)
    rs = np.random.RandomState(31)
    X = rs.randn(400, 2)
    g_true = np.array([[1.5, -0.8], [-2.0, 0.6]])   # (F, T)
    phen2 = phenos + (X @ g_true).T                  # add per-trait effects
    ds = dataclasses.replace(ds, X=X)
    s = BayesRRmMT(ds, phen2, window=8, seed=33, mesh=make_mesh(2))
    assert s.cfg.n_cov == 2
    st = s.init_state()
    acc = np.zeros((2, 2))
    for it in range(80):
        st, _ = s.step(st, it)
        if it >= 40:
            acc += np.asarray(st.gamma)
    gm = acc / 40
    # phenotypes are centered/scaled per trait: gamma is recovered up to the
    # per-trait scale factor
    for t in range(2):
        yt = phen2[t]
        m = np.isfinite(yt)
        sd = np.sqrt((np.nan_to_num(yt - yt[m].mean()) ** 2)[m].sum()
                     / (m.sum() - 1))
        np.testing.assert_allclose(gm[:, t], g_true[:, t] / sd, atol=0.12)
    # masked entries of eps still exactly zero after the covariate sweep
    eps = np.asarray(st.eps)[: ds.geno.n]
    mask = np.isfinite(phen2).T
    assert np.all(eps[~mask] == 0.0)
    # acum populated (P(zero) in [0, 1], not the init value everywhere)
    ac = np.asarray(st.acum)
    assert ac.min() >= 0.0 and ac.max() <= 1.0 and ac.std() > 0


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "stale"])
def test_mt_schedule_auto_is_marker_and_block_is_honoured(exact):
    ds, phenos, _ = simulate_mt(m=64, n=200, n_traits=2, seed=4)
    auto = BayesRRmMT(ds, phenos, window=16, exact=exact, seed=1,
                      mesh=make_mesh(1))
    assert auto.cfg.schedule == "marker"
    blk = BayesRRmMT(ds, phenos, window=16, exact=exact, seed=1,
                     mesh=make_mesh(1), schedule="block")
    assert blk.cfg.schedule == "block"
    st, stats = blk.step(blk.init_state(), 0)
    assert np.isfinite(np.asarray(st.eps)).all()
    assert float(np.asarray(stats.cass).sum()) == 64 * 2


@pytest.mark.parametrize("cross_sync,na_frac", [(1, 0.0), (1, 0.1), (4, 0.0)])
def test_mt_exact_step_f32_products_use_highest(cross_sync, na_frac):
    """The multi-trait exact sweep on a multi-shard mesh (trait-shared and
    per-trait Gram blocks) has no f32 product below HIGHEST precision."""
    import jax
    import jax.numpy as jnp

    from tests.test_bayesrrm import f32_dots_below_highest

    ds, phenos, _ = simulate_mt(m=64, n=200, n_traits=2, seed=3,
                                na_frac=na_frac)
    s = BayesRRmMT(ds, phenos, window=8, seed=13, mesh=make_mesh(4),
                   shuffle=True, cross_sync=cross_sync)
    jaxpr = jax.make_jaxpr(s.raw_step)(jnp.uint32(13), jnp.int32(0),
                                       s.init_state())
    assert f32_dots_below_highest(jaxpr) == []
