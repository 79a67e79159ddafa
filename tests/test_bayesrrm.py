"""BayesRRm sampler tests: posterior recovery on simulated data, groups,
sharding equivalence, FH smoke.

Mirrors the reference's validation strategy (SURVEY §4): golden-run style
checks on simulated data with known h2, plus the sharded-vs-single-device
equivalence the reference could never test without a cluster.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from hydra_tpu.data.genotypes import GenotypeData, Dataset, make_default_groups
from hydra_tpu.io.plink import write_bed, read_bed
from hydra_tpu.samplers.bayesrrm import BayesRRm
from hydra_tpu.parallel.mesh import make_mesh


def simulate(m=200, n=500, h2=0.5, frac_causal=0.2, seed=3, num_groups=1,
             missing_frac=0.0):
    """Simulated dataset with the reference example's mixture grid.

    The grid must cover the per-marker variance fraction (h2/ncausal); the
    bundled example uses {0.001, 0.01, 0.1} (example/normal.mS) for the same
    reason — the CLI default {1e-4..1e-2} is meant for ~1e5+ marker panels.
    """
    rs = np.random.RandomState(seed)
    maf = rs.uniform(0.05, 0.5, m)
    geno = rs.binomial(1, maf[:, None], (m, n)) + rs.binomial(1, maf[:, None], (m, n))
    std = geno.std(axis=1)
    keep = std > 0
    geno = geno[keep]
    m = geno.shape[0]
    x = (geno - geno.mean(axis=1, keepdims=True)) / geno.std(axis=1, keepdims=True)
    ncausal = max(1, int(m * frac_causal))
    causal = rs.choice(m, ncausal, replace=False)
    beta = np.zeros(m)
    beta[causal] = rs.randn(ncausal) * np.sqrt(h2 / ncausal)
    g = x.T @ beta
    e = rs.randn(n) * np.sqrt(1 - h2)
    y = g + e
    if missing_frac > 0.0:
        # mark AFTER building y from the complete x: missing entries only
        # change the marker stats/mask path, not the phenotype
        geno = np.where(rs.random_sample(geno.shape) < missing_frac,
                        -1, geno)
    packed_geno = GenotypeData.from_packed(
        _pack(geno), n, np.array([], dtype=np.int64))
    groups, mS = make_default_groups(m, [0.001, 0.01, 0.1])
    if num_groups > 1:
        groups = (np.arange(m) % num_groups).astype(np.int32)
        mS = np.tile(mS, (num_groups, 1))
    ds = Dataset(geno=packed_geno, y=y, groups=groups, num_groups=num_groups, mS=mS)
    return ds, beta, h2


def _pack(geno):
    from hydra_tpu.io.plink import bed_bytes_per_marker, MISSING_CODE
    m, n = geno.shape
    code = np.select([geno == 0, geno == 1, geno == 2, geno < 0],
                     [0b11, 0b10, 0b00, MISSING_CODE])
    nbytes = bed_bytes_per_marker(n)
    padded = np.full((m, nbytes * 4), MISSING_CODE, dtype=np.uint8)
    padded[:, :n] = code
    return (padded[:, 0::4] | (padded[:, 1::4] << 2)
            | (padded[:, 2::4] << 4) | (padded[:, 3::4] << 6)).astype(np.uint8)


def _run_chain(sampler, n_iter, burn=None):
    burn = n_iter // 2 if burn is None else burn
    state = sampler.init_state()
    h2_samples, beta_sum, nsamp = [], 0.0, 0
    for it in range(n_iter):
        state, stats = sampler.step(state, it)
        if it >= burn:
            sg = float(np.sum(np.asarray(state.sigma_g)))
            se = float(state.sigma_e)
            h2_samples.append(sg / (sg + se))
            beta_sum = beta_sum + sampler.beta_global(state)
            nsamp += 1
    return np.mean(h2_samples), beta_sum / nsamp, state


@pytest.mark.slow
def test_h2_recovery_single_device():
    ds, beta_true, h2 = simulate(m=200, n=500, h2=0.5)
    mesh = make_mesh(1)
    sampler = BayesRRm(ds, window=1, exact=True, seed=11, mesh=mesh)
    h2_est, beta_mean, _ = _run_chain(sampler, 300)
    assert abs(h2_est - 0.5) < 0.15, f"h2 estimate {h2_est} too far from 0.5"
    corr = np.corrcoef(beta_mean, beta_true)[0, 1]
    assert corr > 0.55, f"posterior-mean beta poorly correlated: {corr}"


@pytest.mark.slow
def test_h2_recovery_windowed_matches_sequential():
    """Stale-window relaxation must not move the posterior.

    Tolerances calibrated by the full sweep in BIAS_SWEEP.md (M=10K x
    N=5K, 1000 iters): h2-mean shift vs exact was <= 0.008 for W <= 256
    and 0.014 at W=1024 (posterior sd ~0.024). On this short small-m
    chain the MCMC noise itself is ~0.02, so 0.05 gives ~2 combined sd.
    """
    ds, beta_true, h2 = simulate(m=192, n=400, h2=0.5, seed=5)
    mesh = make_mesh(1)
    h2_w1, bm1, _ = _run_chain(BayesRRm(ds, window=1, seed=7, mesh=mesh), 250)
    h2_w32, bm32, _ = _run_chain(BayesRRm(ds, window=32, seed=7, mesh=mesh), 250)
    h2_w96, bm96, _ = _run_chain(BayesRRm(ds, window=96, seed=7, mesh=mesh), 250)
    assert abs(h2_w1 - h2_w32) < 0.05, (h2_w1, h2_w32)
    assert abs(h2_w1 - h2_w96) < 0.05, (h2_w1, h2_w96)
    assert np.corrcoef(bm1, bm32)[0, 1] > 0.9
    assert np.corrcoef(bm1, bm96)[0, 1] > 0.9


@pytest.mark.slow
def test_sharded_equivalence():
    """8-shard CPU mesh vs single device: identical per-marker RNG + aligned
    windows => numerically near-identical sweep (psum order differences only).

    This is the test the reference lacks entirely (SURVEY §4: multi-node
    correctness only on live SLURM clusters).
    """
    ds, _, _ = simulate(m=160, n=300, h2=0.5, seed=9)
    s1 = BayesRRm(ds, window=1, exact=True, seed=13, mesh=make_mesh(1),
                  shuffle=False)
    s8 = BayesRRm(ds, window=1, exact=True, seed=13, mesh=make_mesh(8),
                  shuffle=False)
    st1, st8 = s1.init_state(), s8.init_state()
    for it in range(3):
        st1, _ = s1.step(st1, it)
        st8, _ = s8.step(st8, it)
    # With window=1 and no shuffle, shard d processes its markers in order but
    # windows interleave across shards; epsilon therefore differs from the
    # single-device sequential sweep within an iteration. Full-sweep windows
    # give exactly one sync in both: compare that configuration bitwise-ish.
    sF1 = BayesRRm(ds, window=s1.m_loc, exact=False, seed=13, mesh=make_mesh(1),
                   shuffle=False)
    m_loc8 = BayesRRm(ds, window=1, seed=13, mesh=make_mesh(8), shuffle=False).m_loc
    sF8 = BayesRRm(ds, window=m_loc8, exact=False, seed=13, mesh=make_mesh(8),
                   shuffle=False)
    stF1, stF8 = sF1.init_state(), sF8.init_state()
    for it in range(5):
        stF1, _ = sF1.step(stF1, it)
        stF8, _ = sF8.step(stF8, it)
    b1 = sF1.beta_global(stF1)
    b8 = sF8.beta_global(stF8)
    np.testing.assert_allclose(b1, b8, atol=2e-4)
    np.testing.assert_allclose(float(stF1.sigma_e), float(stF8.sigma_e), rtol=2e-3)


@pytest.mark.slow
def test_exact_mode_is_exact_across_shards():
    """Sharded exact mode == per-marker dense sync, any window size.

    With window=1 every marker step ends in an N-length psum — literally the
    reference's sync-rate=1 multi-rank schedule (one marker per rank between
    residual syncs, BayesRRm.cpp:2044-2060). Exact mode with window W>1 must
    reproduce that schedule through the cross-shard Gram blocks: the window
    is a batching choice, not a semantics choice. Shard-local-only Gram
    correction (round-1 behavior) fails this test.

    cross_sync=1 selects strict per-step semantics (the round-4 default is
    cross_sync=window: one cross-shard exchange per window, BIAS_SWEEP-
    quantified — see test_cross_sync_semantics)."""
    ds, _, _ = simulate(m=160, n=300, h2=0.5, seed=9)
    s_w1 = BayesRRm(ds, window=1, exact=True, seed=13, mesh=make_mesh(8),
                    shuffle=True, cross_sync=1)
    s_w4 = BayesRRm(ds, window=4, exact=True, seed=13, mesh=make_mesh(8),
                    shuffle=True, cross_sync=1)
    st1, st4 = s_w1.init_state(), s_w4.init_state()
    for it in range(4):
        st1, _ = s_w1.step(st1, it)
        st4, _ = s_w4.step(st4, it)
        np.testing.assert_allclose(
            s_w1.beta_global(st1), s_w4.beta_global(st4), atol=2e-4,
            err_msg=f"iteration {it}")
    np.testing.assert_allclose(float(st1.sigma_e), float(st4.sigma_e),
                               rtol=2e-3)
    np.testing.assert_allclose(np.asarray(st1.eps), np.asarray(st4.eps),
                               atol=2e-4)


def test_exact_across_shards_with_missing_data():
    """Missing genotypes disable the packed-byte integer-Gram ring; the
    general plane-shipping ring must still reproduce the per-marker dense
    sync schedule (window is a batching choice, not a semantics choice)."""
    ds, _, _ = simulate(m=96, n=300, h2=0.5, seed=11, missing_frac=0.05)
    assert int(np.asarray(ds.geno.nm).sum()) > 0
    s_w1 = BayesRRm(ds, window=1, exact=True, seed=13, mesh=make_mesh(4),
                    shuffle=True, cross_sync=1)
    assert not s_w1.cfg.complete
    s_w4 = BayesRRm(ds, window=4, exact=True, seed=13, mesh=make_mesh(4),
                    shuffle=True, cross_sync=1)
    st1, st4 = s_w1.init_state(), s_w4.init_state()
    for it in range(3):
        st1, _ = s_w1.step(st1, it)
        st4, _ = s_w4.step(st4, it)
        np.testing.assert_allclose(
            s_w1.beta_global(st1), s_w4.beta_global(st4), atol=2e-4,
            err_msg=f"iteration {it}")
    np.testing.assert_allclose(np.asarray(st1.eps), np.asarray(st4.eps),
                               atol=2e-4)


def test_cross_sync_semantics():
    """Pin the batched cross-shard exchange (round-4 exact default).

    Exact-mode semantics depend only on the effective exchange interval
    B = min(cross_sync, window), not on the window width: with
    (window=W, cross_sync=B) marker j sees ALL own-shard deltas t<j (the
    in-window recurrence is sequential) and other shards' deltas up to the
    last exchange t < B*floor(j/B) — exactly what (window=B) produces via
    its window-boundary residual psum. The two configurations must
    therefore yield the same chain. This is the multi-shard generalization
    of the W=1==W=N invariance (which is the cross_sync=1 special case).
    Ref: the reference's own relaxation knob is --sync-rate
    (BayesRRm.cpp:2044-2060), which freezes eps even on-rank — ours is
    strictly fresher at equal B."""
    ds, _, _ = simulate(m=128, n=300, h2=0.5, seed=9)
    for b in (2, 8):
        s_b = BayesRRm(ds, window=8, exact=True, seed=13, mesh=make_mesh(4),
                       shuffle=True, cross_sync=b)
        s_ref = BayesRRm(ds, window=b, exact=True, seed=13, mesh=make_mesh(4),
                         shuffle=True)
        assert s_b.cfg.cross_sync == b and s_ref.cfg.cross_sync == b
        st_b, st_r = s_b.init_state(), s_ref.init_state()
        for it in range(3):
            st_b, _ = s_b.step(st_b, it)
            st_r, _ = s_ref.step(st_r, it)
            np.testing.assert_allclose(
                s_b.beta_global(st_b), s_ref.beta_global(st_r), atol=2e-4,
                err_msg=f"B={b} iteration {it}")
        np.testing.assert_array_equal(np.asarray(st_b.components),
                                      np.asarray(st_r.components))
        np.testing.assert_allclose(np.asarray(st_b.eps),
                                   np.asarray(st_r.eps), atol=2e-4)


def test_cross_sync_semantics_missing_data():
    """Same invariance through the general (plane-shipping) Gram ring."""
    ds, _, _ = simulate(m=64, n=300, h2=0.5, seed=11, missing_frac=0.05)
    s_b = BayesRRm(ds, window=8, exact=True, seed=13, mesh=make_mesh(2),
                   shuffle=True, cross_sync=4)
    assert not s_b.cfg.complete
    s_ref = BayesRRm(ds, window=4, exact=True, seed=13, mesh=make_mesh(2),
                     shuffle=True)
    st_b, st_r = s_b.init_state(), s_ref.init_state()
    for it in range(3):
        st_b, _ = s_b.step(st_b, it)
        st_r, _ = s_ref.step(st_r, it)
    np.testing.assert_allclose(s_b.beta_global(st_b), s_ref.beta_global(st_r),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(st_b.eps), np.asarray(st_r.eps),
                               atol=2e-4)


def test_cross_sync_collective_structure():
    """Pin the COMM structure of exact mode on D>1, not just its numerics.

    The round-4 default (cross_sync=window) must lower with ZERO all_gather
    ops — other shards' deltas ride the window-boundary residual psum, so a
    multi-shard exact sweep has the same collective profile as stale mode
    (M/W psums). cross_sync<window variants carry the batched (or per-step)
    all_gather inside the window scan. Regression guard for the round-3
    structure VERDICT flagged: W sequential scalar all_gathers per window
    (~130-320 us/window of pure ICI latency, dwarfing ~90 us compute)."""
    import re

    ds, _, _ = simulate(m=128, n=300, h2=0.5, seed=9)
    counts = {}
    for cs in (0, 1, 4):
        s = BayesRRm(ds, window=8, exact=True, seed=13, mesh=make_mesh(4),
                     shuffle=True, cross_sync=cs)
        st = s.init_state()
        txt = s._step.lower(jnp.uint32(13), jnp.int32(0), st,
                            *s._consts).as_text()
        counts[cs] = len(re.findall(r"all_gather", txt))
    assert counts[0] == 0, f"default exact must have no all_gather: {counts}"
    assert counts[1] > 0 and counts[4] > 0, counts


@pytest.mark.slow
def test_groups_recovery():
    ds, beta_true, _ = simulate(m=200, n=400, h2=0.5, seed=21, num_groups=2)
    sampler = BayesRRm(ds, window=8, seed=23, mesh=make_mesh(2))
    h2_est, _, state = _run_chain(sampler, 200)
    assert state.sigma_g.shape == (2,)
    assert abs(h2_est - 0.5) < 0.2


@pytest.mark.slow
def test_fh_recovers_sparse_signal():
    """Horseshoe should recover few large effects and shrink the rest
    (BayesFH semantics, BayesRRm.cpp:1125-1163 + FH branches)."""
    ds, beta_true, _ = simulate(m=120, n=600, h2=0.5, frac_causal=0.05,
                                seed=47)
    sampler = BayesRRm(ds, window=4, fh=True, seed=49, mesh=make_mesh(2))
    state = sampler.init_state()
    bsum, cnt = 0.0, 0
    for it in range(200):
        state, stats = sampler.step(state, it)
        if it >= 100:
            bsum = bsum + sampler.beta_global(state)
            cnt += 1
    beta_mean = bsum / cnt
    corr = np.corrcoef(beta_mean, beta_true)[0, 1]
    assert corr > 0.6, corr
    # shrinkage: null markers should have much smaller posterior means
    causal = np.abs(beta_true) > 0
    mean_null = np.abs(beta_mean[~causal]).mean()
    mean_causal = np.abs(beta_mean[causal]).mean()
    assert mean_causal > 3 * mean_null, (mean_causal, mean_null)


@pytest.mark.slow
def test_fh_smoke():
    ds, beta_true, _ = simulate(m=96, n=300, h2=0.5, seed=31)
    sampler = BayesRRm(ds, window=4, fh=True, seed=33, mesh=make_mesh(1))
    state = sampler.init_state()
    for it in range(30):
        state, stats = sampler.step(state, it)
    assert np.isfinite(float(state.tau))
    assert np.isfinite(float(state.sigma_e))
    assert np.all(np.isfinite(np.asarray(state.beta)))
    assert float(state.sigma_e) > 0


@pytest.mark.slow
def test_matches_numpy_golden_model():
    """JAX sampler vs independent sequential NumPy Gibbs: same posterior."""
    from hydra_tpu.io.plink import decode_bed_numpy
    from hydra_tpu.io.pheno import center_and_scale
    from hydra_tpu.testing.reference_bayesrrm import sweep

    ds, beta_true, _ = simulate(m=128, n=300, h2=0.5, seed=17)
    y = center_and_scale(ds.y)
    g, mask = decode_bed_numpy(ds.geno.packed, ds.geno.n_pad)
    xt = ((g - ds.geno.mave[:, None] * mask) * ds.geno.mstd[:, None])[:, :300]

    rng = np.random.RandomState(99)
    st = dict(eps=y.copy(), beta=np.zeros(128), mu=0.0,
              sigma_g=np.array([0.5]), sigma_e=float(y @ y / 300 * 0.5),
              est_pi=np.array([[0.5, 0.5 * 0.001 / 0.111, 0.5 * 0.01 / 0.111,
                                0.5 * 0.1 / 0.111]]))
    h2_np, bsum, cnt = [], 0.0, 0
    for it in range(200):
        out = sweep(xt, st['eps'], st['beta'], ds.groups, ds.mS, st['sigma_g'],
                    st['sigma_e'], st['mu'], st['est_pi'], rng)
        st = dict(eps=out['eps'], beta=out['beta'], mu=out['mu'],
                  sigma_g=out['sigma_g'], sigma_e=out['sigma_e'],
                  est_pi=out['est_pi'])
        if it >= 100:
            sg = out['sigma_g'].sum()
            h2_np.append(sg / (sg + out['sigma_e']))
            bsum = bsum + out['beta']
            cnt += 1
    h2_np = np.mean(h2_np)
    beta_np = bsum / cnt

    sampler = BayesRRm(ds, window=16, seed=55, mesh=make_mesh(4))
    h2_jax, beta_jax, _ = _run_chain(sampler, 200, burn=100)
    assert abs(h2_jax - h2_np) < 0.1, (h2_jax, h2_np)
    assert np.corrcoef(beta_np, beta_jax)[0, 1] > 0.9


def test_one_step_runs_and_shapes():
    ds, _, _ = simulate(m=64, n=200, h2=0.5, seed=41)
    sampler = BayesRRm(ds, window=4, seed=43, mesh=make_mesh(4))
    state = sampler.init_state()
    state, stats = sampler.step(state, 0)
    assert state.beta.shape == (sampler.cfg.m_glob,)
    assert np.asarray(stats.cass).sum() == 64  # all real markers assigned
    b = sampler.beta_global(state)
    assert b.shape == (64,)
    assert np.isfinite(b).all()


def test_f64_mode_parity():
    """--dtype float64: state stays f64 through fused sweeps and the chain
    tracks the f32 one closely at matched seed (VERDICT r1 item 10; the
    full N=500K audit lives in F32_AUDIT.md)."""
    import jax
    ds, _, _ = simulate(m=64, n=300, h2=0.5, seed=21)
    try:
        jax.config.update("jax_enable_x64", True)
        s64 = BayesRRm(ds, window=8, seed=31, mesh=make_mesh(2),
                       dtype="float64")
        st = s64.init_state()
        st, _ = s64.run_steps(st, 1, 10)
        assert st.sigma_e.dtype == jnp.float64
        assert st.eps.dtype == jnp.float64
        h2_64 = float(np.sum(np.asarray(st.sigma_g))
                      / (np.sum(np.asarray(st.sigma_g)) + float(st.sigma_e)))
    finally:
        jax.config.update("jax_enable_x64", False)
    s32 = BayesRRm(ds, window=8, seed=31, mesh=make_mesh(2))
    st32 = s32.init_state()
    st32, _ = s32.run_steps(st32, 1, 10)
    h2_32 = float(np.sum(np.asarray(st32.sigma_g))
                  / (np.sum(np.asarray(st32.sigma_g)) + float(st32.sigma_e)))
    # different rounding, same seed: early-chain h2 should still be close
    assert abs(h2_64 - h2_32) < 0.15, (h2_64, h2_32)


@pytest.mark.slow
def test_fh_matches_numpy_golden_model():
    """JAX BayesFH vs the independent NumPy golden model
    (testing/reference_bayesfh.py): same posterior on beta/sigmaE/tau scale
    (VERDICT r2 missing #1)."""
    from hydra_tpu.io.plink import decode_bed_numpy
    from hydra_tpu.io.pheno import center_and_scale
    from hydra_tpu.testing import reference_bayesfh as fhref

    ds, beta_true, _ = simulate(m=96, n=500, h2=0.5, frac_causal=0.05,
                                seed=61)
    m = ds.m
    y = center_and_scale(ds.y)
    g, mask = decode_bed_numpy(ds.geno.packed, ds.geno.n_pad)
    xt = ((g - ds.geno.mave[:, None] * mask) * ds.geno.mstd[:, None])[:, :500]

    rng = np.random.RandomState(71)
    fh = fhref.init_fh(rng, 1, m)
    st = dict(eps=y.copy(), beta=np.zeros(m), mu=0.0,
              sigma_e=float(y @ y / 500 * 0.5),
              est_pi=np.array([[0.5, 0.5 * 0.001 / 0.111, 0.5 * 0.01 / 0.111,
                                0.5 * 0.1 / 0.111]]), fh=fh)
    nit = 200
    bsum, se_l, tau_l, cnt = 0.0, [], [], 0
    for it in range(nit):
        out = fhref.sweep(xt, st["eps"], st["beta"], ds.groups,
                          st["est_pi"], st["sigma_e"], st["mu"], st["fh"],
                          rng)
        st = {k: out[k] for k in
              ("eps", "beta", "mu", "sigma_e", "est_pi", "fh")}
        if it >= nit // 2:
            bsum = bsum + out["beta"]
            se_l.append(out["sigma_e"])
            tau_l.append(out["fh"]["tau"])
            cnt += 1
    b_np, se_np = bsum / cnt, np.mean(se_l)

    sampler = BayesRRm(ds, window=8, fh=True, seed=77, mesh=make_mesh(2))
    state = sampler.init_state()
    bsum, se_l, cnt = 0.0, [], 0
    for it in range(nit):
        state, _ = sampler.step(state, it)
        if it >= nit // 2:
            bsum = bsum + sampler.beta_global(state)
            se_l.append(float(state.sigma_e))
            cnt += 1
    b_jax, se_jax = bsum / cnt, np.mean(se_l)

    assert np.corrcoef(b_np, b_jax)[0, 1] > 0.9, np.corrcoef(b_np, b_jax)[0, 1]
    assert abs(se_jax - se_np) / se_np < 0.15, (se_jax, se_np)
    # both recover the sparse truth
    assert np.corrcoef(b_np, beta_true)[0, 1] > 0.6
    assert np.corrcoef(b_jax, beta_true)[0, 1] > 0.6


# ---- marker-processing schedule (BayesRRmConfig.schedule) ----

@pytest.mark.parametrize("exact", [True, False], ids=["exact", "stale"])
def test_block_schedule_auto_stays_marker_for_exact(exact):
    """--schedule auto resolves to the reference's per-sweep marker shuffle
    on every backend, exact or stale."""
    ds, _, _ = simulate(m=128, n=300, h2=0.5, seed=5)
    s = BayesRRm(ds, window=32, exact=exact, seed=7, mesh=make_mesh(1),
                 schedule="auto")
    assert s.cfg.schedule == "marker"
    np.testing.assert_array_equal(s.slot_to_marker[:128], np.arange(128))


def test_block_schedule_differs_from_marker_but_recovers():
    """The two schedules are different (valid) chains over the same
    posterior: the block chain permutes the slot layout once, still covers
    every marker, moves and keeps finite state."""
    ds, _, _ = simulate(m=192, n=400, h2=0.5, seed=5)
    sb = BayesRRm(ds, window=32, exact=False, seed=7, mesh=make_mesh(1),
                  schedule="block")
    assert sb.cfg.schedule == "block"
    assert not np.array_equal(sb.slot_to_marker, np.arange(192))
    assert set(sb.slot_to_marker.tolist()) >= set(range(192))
    st = sb.init_state()
    for it in range(3):
        st, _ = sb.step(st, it)
    assert np.isfinite(np.asarray(st.eps)).all()
    assert float(np.asarray(st.sigma_g).sum()) > 0


def test_block_schedule_exact_is_honored_and_matches_window_path(capsys):
    """Explicit exact + block: honoured (with a note that window-width
    invariance is waived) and deterministic for a fixed seed."""
    ds, _, _ = simulate(m=128, n=300, h2=0.5, seed=5)
    runs = []
    for _ in range(2):
        s = BayesRRm(ds, window=32, exact=True, seed=7, mesh=make_mesh(1),
                     schedule="block")
        assert s.cfg.schedule == "block"
        st = s.init_state()
        for it in range(3):
            st, _ = s.step(st, it)
        runs.append(np.asarray(s.beta_global(st)))
    assert "window-width invariance" in capsys.readouterr().out
    np.testing.assert_array_equal(runs[0], runs[1])
    assert np.isfinite(runs[0]).all()


def f32_dots_below_highest(closed_jaxpr) -> list:
    """Every dot_general of the jaxpr (sub-jaxprs included) that takes a
    float32 operand without precision=HIGHEST; on the GPU such a product
    may run in TF32. bf16 products (the exact integer-plane Gram) pass."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                prec = eqn.params.get("precision")
                precs = prec if isinstance(prec, tuple) else (prec, prec)
                if (any(v.aval.dtype == jnp.float32 for v in eqn.invars)
                        and not all(p == jax.lax.Precision.HIGHEST
                                    for p in precs)):
                    found.append(str(eqn)[:200])
            for val in eqn.params.values():
                for sub in val if isinstance(val, (tuple, list)) else (val,):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(closed_jaxpr.jaxpr)
    return found


@pytest.mark.parametrize("cross_sync,missing", [
    (0, 0.0), (1, 0.0), (4, 0.0), (1, 0.05)])
def test_exact_step_f32_products_use_highest(cross_sync, missing):
    """The exact sweep on a multi-shard mesh (the per-step, batched and
    per-window cross-shard exchanges; complete and missing genotypes) has
    no f32 product below HIGHEST precision."""
    ds, _, _ = simulate(m=64, n=200, h2=0.5, seed=9, missing_frac=missing)
    s = BayesRRm(ds, window=8, exact=True, seed=13, mesh=make_mesh(4),
                 shuffle=True, cross_sync=cross_sync)
    jaxpr = jax.make_jaxpr(s.raw_step)(jnp.uint32(13), jnp.int32(0),
                                       s.init_state())
    assert f32_dots_below_highest(jaxpr) == []


@pytest.mark.parametrize("num_groups,lead", [(1, ()), (3, ()), (4, (2,))])
def test_group_sum_matches_segment_sum(num_groups, lead):
    """The fused per-group reduction behind beta_sqn equals segment_sum
    (over the last axis, with leading trait axes)."""
    from hydra_tpu.samplers.bayesrrm import group_sum

    rs = np.random.RandomState(num_groups)
    groups = jnp.asarray(rs.randint(0, num_groups, 257), jnp.int32)
    v = jnp.asarray(rs.randn(*lead, 257), jnp.float32)
    got = np.asarray(group_sum(v, groups, num_groups))
    want = np.stack([np.asarray(jax.ops.segment_sum(
        row, groups, num_segments=num_groups))
        for row in np.asarray(v).reshape(-1, 257)]).reshape(
            lead + (num_groups,))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
