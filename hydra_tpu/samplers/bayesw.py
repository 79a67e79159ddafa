"""BayesW — Weibull survival-model Gibbs sampler in JAX.

Behavioral rebuild of BayesW::runMpiGibbs_bW (src/BayesW.cpp:905-2151):
age-at-onset (log-time) phenotype y, failure indicators, Weibull shape alpha,
spike + Gaussian-mixture marker effects whose marginal likelihoods are
computed by adaptive Gauss-Hermite quadrature (BayesW.cpp:174-726).

Structure follows hydra_tpu.samplers.bayesrrm: marker sharding over the
"markers" mesh axis, stale-residual windows, psum residual sync. Windows use
the reference's own relaxation semantics (epsilon and vi frozen between syncs,
BayesW.cpp:1659-1850); window=1 is the reference's sequential sync-rate=1.

ARS (src/BayesW_arms.cpp) is replaced by vectorized slice sampling
(hydra_tpu.utils.slice_sampler) for the four log-concave conditionals; the
marker-effect draws batch across the whole window.

Numerical note: all the survival densities contain differences of O(sum vi)
~ O(N) terms. They are evaluated in the mathematically identical "expm1 form"
    vi_sum' - E(s)(vi_0' + vi_1' f1 + vi_2' f2)
      = -vi_0' expm1(th0 s) - vi_1' expm1(th1 s) - vi_2' expm1(th2 s)
which avoids the large-term cancellation and keeps float32 accurate
(the reference computes the raw form in float64, BayesW.cpp:161-169).

Partial sums over genotype classes (vi_1, vi_2, vi_sum; partial_sum
BayesW.cpp:49-65) become fused decode + reductions over the packed bytes
(ops/window.level_sums); removing a marker's own
effect from vi (the tmp_vi recompute at BayesW.cpp:1499-1516) is done in
closed form by the per-class factors e^{alpha*beta*(g-mave)/sd}, exactly
matching the reference's factorization in beta_dens (:152-154).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hydra_tpu.data.genotypes import Dataset, shard_layout
from hydra_tpu.ops.window import level_sums, window_axpy
from hydra_tpu.parallel.mesh import (
    IND_AXIS, det_psum, hier_psum, make_mesh, marker_axes, mesh_axes)
from hydra_tpu.samplers.bayesrrm import group_sum, resolve_schedule
from hydra_tpu.utils import dist
from hydra_tpu.utils.slice_sampler import (slice_noise, slice_sample,
                                           slice_sample_noise)

# fixed slice-sampling budgets for the per-marker beta draws
N_EXPAND, N_SHRINK = 10, 24

EULER_MASCHERONI = 0.577215664901532  # EuMasc, BayesW.cpp:42
SQRT_PI = 1.77245385090552

# priors (BayesW.hpp:85-89)
ALPHA_0 = 0.01
KAPPA_0 = 0.01
SIGMA_MU = 100.0
ALPHA_SIGMA = 1.0
BETA_SIGMA = 0.0001

_S_MU, _S_ALPHA, _S_MARKER, _S_SIGMAG, _S_PI, _S_PERM, _S_COV, _S_COVPERM = (
    0, 1, 2, 3, 4, 5, 6, 7)


def gh_table(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Hermite nodes and *adjusted* weights w~ = w exp(x^2).

    The reference hard-codes these for n in {3..25} (BayesW.cpp:174-712);
    numpy's hermgauss reproduces them (verified in tests to the printed
    precision of the reference's constants).
    """
    x, w = np.polynomial.hermite.hermgauss(n)
    return x, w * np.exp(x * x)


@dataclass(frozen=True)
class BayesWConfig:
    n_real: int
    n_pad: int
    m_tot: int
    m_loc: int
    n_dev: int
    window: int
    k: int                    # mixtures incl. zero component
    num_groups: int
    n_cov: int
    n_ind: int = 1            # individual-axis shards (2-D mesh)
    n_dcn: int = 1            # multi-slice hierarchy (see parallel/mesh.py)
    quad_n: int = 25
    shuffle: bool = True
    schedule: str = "marker"  # marker | block (see BayesRRmConfig.schedule;
                              # BayesW windows are stale by construction, so
                              # block applies to every windowed bw run)
    det_sync: bool = False    # topology-invariant reductions (--det-sync)

    @property
    def n_windows(self) -> int:
        return self.m_loc // self.window

    @property
    def m_glob(self) -> int:
        return self.m_loc * self.n_dev


class BayesWState(NamedTuple):
    eps: jax.Array        # (n_pad,) residual y - mu - X beta (raw scale)
    beta: jax.Array       # (m_glob,)
    components: jax.Array
    mu: jax.Array
    alpha: jax.Array      # Weibull shape
    sigma_g: jax.Array    # (G,)
    pi_l: jax.Array       # (G, K)
    gamma: jax.Array      # (F,)


class BayesWStats(NamedTuple):
    m0: jax.Array
    cass: jax.Array
    beta_sqn: jax.Array


def _local_iteration(cfg: BayesWConfig, gh_x, gh_w, seed, it,
                     state: BayesWState,
                     packed, groups, mave, msd, valid, sum_fail,
                     cva_nz, mtot_grp, ind_mask, fail,
                     x_cov, sum_fail_fix):
    f32 = jnp.float32
    km1 = cfg.k - 1
    W = cfg.window
    Q = cfg.quad_n
    ma = marker_axes(cfg.n_dcn)
    dev = jax.lax.axis_index(ma)
    # --det-sync: topology-invariant all-reduce (see bayesrrm / mesh.det_psum)
    if cfg.det_sync:
        def ma_sum(v):
            return det_psum(v, ma, cfg.n_dev)

        def hpsum(v, n_dcn):
            return det_psum(v, ma, cfg.n_dev)
    else:
        def ma_sum(v):
            return jax.lax.psum(v, ma)
        hpsum = hier_psum

    # N-sharding (see bayesrrm._local_iteration): partial N-length sums are
    # combined with one psum over IND_AXIS; identity when n_ind == 1. The
    # slice-sampler densities close over psummed scalars or do their own
    # psum_i, so every inds replica runs an identical fixed-budget chain.
    if cfg.n_ind > 1:
        def psum_i(x):
            return jax.lax.psum(x, IND_AXIS)
    else:
        def psum_i(x):
            return x

    base_key = jax.random.key(seed)
    it_key = jax.random.fold_in(base_key, it)

    def site(s):
        return jax.random.fold_in(it_key, s)

    eps = state.eps
    beta = state.beta
    comps = state.components
    alpha = state.alpha
    sigma_g = state.sigma_g
    pi_l = state.pi_l
    d_events = psum_i(jnp.sum(fail))

    # ---- 1. mu via slice sampling (mu_dens BayesW.cpp:77-88) ----
    # f_rel(x) = -alpha d x - w0 * expm1(-alpha (x - mu)) - x^2/(2 sigma_mu)
    # with w0 = sum exp(alpha*eps - EuMasc) (current residual scale)
    w0 = psum_i(jnp.sum(jnp.exp(alpha * eps - EULER_MASCHERONI) * ind_mask))
    mu_old = state.mu

    def mu_logf(x):
        return (-alpha * d_events * x
                - w0 * jnp.expm1(-alpha * (x - mu_old))
                - x * x / (2.0 * SIGMA_MU))

    # Scale-aware bracket: the location parameter of the extreme-value
    # likelihood has Fisher information ~ alpha^2 * N, so the conditional's
    # sd is ~ 1/(alpha sqrt(N)). The stepping-out budget covers the tails;
    # width only tunes efficiency, never the stationary law (Neal 2003).
    dN_total = f32(cfg.n_real)
    mu_width = jnp.maximum(2.0 / (alpha * jnp.sqrt(dN_total)), 1e-3)
    mu = slice_sample(mu_logf, mu_old, site(_S_MU), width=mu_width)
    eps = eps + (mu_old - mu) * ind_mask

    # ---- 1a. fixed effects (gamma_dens BayesW.cpp:119-129) ----
    gamma = state.gamma
    if cfg.n_cov > 0:
        xi = jax.random.permutation(site(_S_COVPERM), cfg.n_cov)
        # per-covariate information scale: I(gamma_j) ~ alpha^2 sum_i x_ij^2
        # (the reference's fixed +-0.075 hull, BayesW.cpp:1389, assumes
        # standardized covariates; this adapts to the actual column norms)
        col_sq = psum_i(jnp.sum(x_cov * x_cov * ind_mask[:, None], axis=0))

        def cov_step(carry, i):
            eps, gamma = carry
            j = xi[i]
            col = x_cov[:, j]
            g_old = gamma[j]
            # residual with this covariate's effect restored
            w = jnp.exp(alpha * (eps + col * g_old) - EULER_MASCHERONI) * ind_mask

            def g_logf(x):
                return (-alpha * x * sum_fail_fix[j]
                        - psum_i(jnp.sum(w * jnp.expm1(-alpha * col * x)))
                        - x * x / (2.0 * SIGMA_MU))

            g_width = jnp.maximum(
                2.0 / (alpha * jnp.sqrt(jnp.maximum(col_sq[j], 1.0))), 1e-3)
            g_new = slice_sample(g_logf, g_old,
                                 jax.random.fold_in(site(_S_COV), i),
                                 width=g_width)
            eps = eps + (g_old - g_new) * col * ind_mask
            return (eps, gamma.at[j].set(g_new)), None

        (eps, gamma), _ = jax.lax.scan(cov_step, (eps, gamma),
                                       jnp.arange(cfg.n_cov))

    # ---- 2. Weibull shape alpha (alpha_dens BayesW.cpp:132-142) ----
    # f_rel(x) = (a0+d-1)(log x - log a) + (x-a) C - sum vi_i expm1(eps_i (x-a))
    vi_cur = jnp.exp(alpha * eps - EULER_MASCHERONI) * ind_mask
    c_lin = psum_i(jnp.sum(eps * fail)) - KAPPA_0

    def alpha_logf(x):
        dx = x - alpha
        return ((ALPHA_0 + d_events - 1.0)
                * (jnp.log(jnp.maximum(x, 1e-30)) - jnp.log(alpha))
                + dx * c_lin
                - psum_i(jnp.sum(vi_cur * jnp.expm1(eps * dx))))

    # shape-parameter MLE has sd ~ 0.78 alpha / sqrt(n_events)
    # (Weibull Fisher info); bracket at ~2 sd
    alpha_width = jnp.maximum(
        1.6 * alpha / jnp.sqrt(jnp.maximum(d_events, 4.0)), 1e-3)
    alpha = slice_sample(alpha_logf, alpha, site(_S_ALPHA),
                         width=alpha_width, lower=jnp.float32(1e-6))

    # ---- 3. vi (BayesW.cpp:1452-1455) ----
    vi = jnp.exp(alpha * eps - EULER_MASCHERONI) * ind_mask

    # ---- marker order + per-marker keys ----
    if cfg.schedule == "block" and cfg.shuffle:
        # window-BLOCK shuffle (see bayesrrm.py), expanded to the composite
        # marker order
        wperm = jax.random.permutation(
            jax.random.fold_in(site(_S_PERM), dev), cfg.n_windows)
        perm = (wperm[:, None] * W
                + jnp.arange(W, dtype=wperm.dtype)).reshape(-1)
    elif cfg.shuffle:
        perm = jax.random.permutation(
            jax.random.fold_in(site(_S_PERM), dev), cfg.m_loc)
    else:
        perm = jnp.arange(cfg.m_loc)
    off = dev * cfg.m_loc
    marker_site = site(_S_MARKER)

    sum_sigma_g = jnp.sum(sigma_g)    # safe-limit scale (BayesW.cpp:1562)
    log_pi = jnp.log(jnp.maximum(pi_l, 1e-30))

    def window_body(w, carry):
        eps, vi, beta, comps, cass = carry
        idx = jax.lax.dynamic_slice(perm, (w * W,), (W,))
        pk = jnp.take(packed, idx, axis=0)
        mave_w = jnp.take(mave, idx)
        sd_w = jnp.take(msd, idx)
        act_w = jnp.take(valid, idx) > 0
        act_w = act_w & (sd_w > 0)
        sf_w = jnp.take(sum_fail, idx)
        grp_w = jnp.take(groups, idx)
        bold_w = jnp.take(beta, idx)
        keys_w = jax.vmap(lambda i: jax.random.fold_in(marker_site, i))(off + idx)
        u_w = jax.vmap(lambda k: jax.random.uniform(k, (), f32))(keys_w)
        bkeys_w = jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys_w)

        inv_sd = jnp.where(act_w, 1.0 / jnp.maximum(sd_w, 1e-30), 0.0)

        s1, s2, b_vi = (psum_i(s) for s in level_sums(pk, vi))
        s_all = psum_i(jnp.sum(vi))
        sm = s_all - b_vi                       # missing-genotype individuals
        s0 = s_all - s1 - s2 - sm

        # remove each marker's own current effect in closed form
        # (tmp_vi recompute, BayesW.cpp:1499-1516)
        ab = alpha * bold_w
        e0 = jnp.exp(ab * (0.0 - mave_w) * inv_sd)
        e1 = jnp.exp(ab * (1.0 - mave_w) * inv_sd)
        e2 = jnp.exp(ab * (2.0 - mave_w) * inv_sd)
        vi1 = s1 * e1
        vi2 = s2 * e2
        vsum = s0 * e0 + vi1 + vi2 + sm
        vi0 = vsum - vi1 - vi2

        # adaptive G-H marginal likelihoods (BayesW.cpp:716-726)
        exp_sum = (vi1 * (1.0 - 2.0 * mave_w) + 4.0 * (1.0 - mave_w) * vi2
                   + vsum * mave_w * mave_w) * inv_sd * inv_sd
        cva_w = cva_nz[grp_w]                                   # (W, km1)
        sig_w = sigma_g[grp_w]                                  # (W,)
        sqrt2ck = jnp.sqrt(2.0 * cva_w * sig_w[:, None])        # (W, km1)
        sigma_ad = 1.0 / jnp.sqrt(
            1.0 + alpha * alpha * sig_w[:, None] * cva_w * exp_sum[:, None])

        # theta coefficients of the expm1 form
        th0 = alpha * mave_w * inv_sd                            # (W,)
        th1 = alpha * (mave_w - 1.0) * inv_sd
        th2 = alpha * (mave_w - 2.0) * inv_sd

        s_nodes = sigma_ad[:, :, None] * gh_x[None, None, :]     # (W, km1, Q)
        sq = s_nodes * sqrt2ck[:, :, None]
        temp = (-alpha * sq * sf_w[:, None, None]
                - vi0[:, None, None] * jnp.expm1(th0[:, None, None] * sq)
                - vi1[:, None, None] * jnp.expm1(th1[:, None, None] * sq)
                - vi2[:, None, None] * jnp.expm1(th2[:, None, None] * sq)
                - s_nodes * s_nodes)
        # the adaptive substitution's Jacobian sigma_ad multiplies the
        # integral (reference returns sigma*temp, BayesW.cpp:711) — without
        # it every non-zero marginal likelihood is inflated by 1/sigma_ad
        # (5-50x), spike escapes avalanche and sigmaG runs away on weakly
        # identified data (validated against exact numerical integration)
        integral = sigma_ad * jnp.sum(
            gh_w[None, None, :] * jnp.exp(temp), axis=-1)
        ml = jnp.concatenate(
            [jnp.exp(log_pi[grp_w][:, :1]) * SQRT_PI,
             jnp.exp(log_pi[grp_w][:, 1:]) * integral], axis=1)   # (W, K)

        probs = ml / jnp.sum(ml, axis=1, keepdims=True)
        cum = jnp.cumsum(probs, axis=1)
        comp = jnp.minimum(
            jnp.sum((u_w[:, None] > cum).astype(jnp.int32), axis=1), km1)
        comp = jnp.where(act_w, comp, 0)

        # ---- beta draw via slice sampling on beta_dens (BayesW.cpp:145-156)
        ksel = jnp.maximum(comp - 1, 0)
        ck = jnp.take_along_axis(cva_w, ksel[:, None], axis=1)[:, 0]
        safe_limit = 2.0 * jnp.sqrt(sum_sigma_g * ck)
        two_ck_sg = 2.0 * ck * jnp.maximum(sig_w, 1e-30)

        def beta_logf(x):
            return (-alpha * x * sf_w
                    - vi0 * jnp.expm1(th0 * x)
                    - vi1 * jnp.expm1(th1 * x)
                    - vi2 * jnp.expm1(th2 * x)
                    - x * x / two_ck_sg)

        draw_mask = (comp > 0) & act_w
        # PER-MARKER slice schedules, keyed by global slot id (bkeys_w):
        # the beta draw stream is independent of window width and device
        # count, and each window's joint draw is conditionally independent
        # given eps — like the reference's sequential rand() stream
        # (BayesW_arms.cpp:913-917), minus the sequential coupling.
        le_w, ub_w, uu_w = jax.vmap(
            lambda k: slice_noise(k, (), N_SHRINK))(bkeys_w)
        bnew = slice_sample_noise(beta_logf, bold_w, le_w, ub_w,
                                  jnp.transpose(uu_w),
                                  width=jnp.maximum(safe_limit / 5.0, 1e-3),
                                  lower=bold_w - safe_limit,
                                  upper=bold_w + safe_limit,
                                  n_expand=N_EXPAND, n_shrink=N_SHRINK,
                                  mask=draw_mask)
        bnew_w = jnp.where(draw_mask, bnew, 0.0)

        dbeta = bold_w - bnew_w
        d_eps = hpsum(window_axpy(pk, dbeta, mave_w, inv_sd), cfg.n_dcn)
        eps = eps + d_eps
        vi = jnp.exp(alpha * eps - EULER_MASCHERONI) * ind_mask  # :1832-1834

        flat = grp_w * cfg.k + comp
        cass = cass + jax.ops.segment_sum(
            act_w.astype(f32), flat, num_segments=cfg.num_groups * cfg.k
        ).reshape(cfg.num_groups, cfg.k)
        beta = beta.at[idx].set(bnew_w)
        comps = comps.at[idx].set(comp)
        return eps, vi, beta, comps, cass

    cass0 = jax.lax.pcast(
        jnp.zeros((cfg.num_groups, cfg.k), f32), ma, to="varying")
    eps, vi, beta, comps, cass = jax.lax.fori_loop(
        0, cfg.n_windows, window_body, (eps, vi, beta, comps, cass0))

    cass = ma_sum(cass)
    beta_sqn = ma_sum(group_sum(beta * beta, groups, cfg.num_groups))

    # ---- hypers (BayesW.cpp:1885-1905) ----
    m0 = mtot_grp.astype(f32) - cass[:, 0]
    keys = jax.random.split(site(_S_SIGMAG), cfg.num_groups)
    sigma_g = jax.vmap(
        lambda k, m, b: dist.inv_gamma_rng(
            k, ALPHA_SIGMA + 0.5 * m, BETA_SIGMA + 0.5 * m * b)
    )(keys, m0, beta_sqn)
    sigma_g = jnp.where(mtot_grp == 0, 0.0, sigma_g)
    pi_l = dist.dirichlet_rng(site(_S_PI), cass + 1.0)

    new_state = BayesWState(eps=eps, beta=beta, components=comps, mu=mu,
                            alpha=alpha, sigma_g=sigma_g, pi_l=pi_l,
                            gamma=gamma)
    return new_state, BayesWStats(m0=m0, cass=cass, beta_sqn=beta_sqn)


class BayesW:
    """Driver for the Weibull sampler (role of BayesW::runMpiGibbs_bW)."""

    def __init__(self, dataset: Dataset, *, window: int = 1,
                 shuffle: bool = True, seed: int = 0, quad_points: int = 25,
                 mesh: Optional[Mesh] = None, n_devices: int = 0,
                 n_ind: int = 1, n_dcn: int = 1,
                 schedule: str = "auto", det_sync: bool = False):
        if dataset.fail is None:
            raise ValueError("BayesW requires failure indicators (--failure)")
        self.ds = dataset
        self.mesh = mesh if mesh is not None else make_mesh(
            n_devices, n_ind=n_ind, n_dcn=n_dcn)
        n_dev, n_ind, n_dcn = mesh_axes(self.mesh)
        self.seed = seed

        geno = dataset.geno
        starts, lengths, m_loc = shard_layout(geno.m_global, n_dev, window,
                                              dataset.blocks)
        self.shard_starts, self.shard_lengths, self.m_loc = starts, lengths, m_loc
        self._n_procs = jax.process_count()
        if self._n_procs > 1 and n_ind > 1:
            raise NotImplementedError(
                "--ind-shards with multi-process execution is not supported")

        K = dataset.mS.shape[1]
        if geno.n_pad % (4 * n_ind):
            raise ValueError(
                f"individual padding {geno.n_pad} not divisible by "
                f"4*n_ind={4 * n_ind}; use a power-of-two inds axis <= 128")
        schedule = resolve_schedule(schedule, exact=False)
        self.cfg = BayesWConfig(
            n_real=geno.n, n_pad=geno.n_pad, m_tot=geno.m_global, m_loc=m_loc,
            n_dev=n_dev, n_ind=n_ind, n_dcn=n_dcn, window=window, k=K,
            num_groups=dataset.num_groups,
            n_cov=0 if dataset.X is None else dataset.X.shape[1],
            quad_n=quad_points, shuffle=shuffle, schedule=schedule,
            det_sync=det_sync)
        cfg = self.cfg

        gh_x, gh_w = gh_table(cfg.quad_n)
        self._gh = (jnp.asarray(gh_x, jnp.float32), jnp.asarray(gh_w, jnp.float32))

        # sum_failure per marker: (sum_{g=1} f + 2 sum_{g=2} f - mave*sum f)/sd
        # (BayesW.cpp:1222-1229), computed BLOCKWISE over markers — a dense
        # (M, N) host decode is tens of GB at bench scale (the mt sampler's
        # masked stats use the same pattern)
        from hydra_tpu.io.plink import decode_bed_numpy
        f = dataset.fail
        fsum = f.sum()
        s1f = np.zeros(geno.m)
        s2f = np.zeros(geno.m)
        blk = max(1, (1 << 27) // max(geno.n, 1))
        for s0 in range(0, geno.m, blk):
            e0 = min(geno.m, s0 + blk)
            g_np, mask_np = decode_bed_numpy(geno.packed[s0:e0], geno.n)
            s1f[s0:e0] = ((g_np == 1.0) & (mask_np == 1.0)) @ f
            s2f[s0:e0] = (g_np == 2.0) @ f
        with np.errstate(divide="ignore", invalid="ignore"):
            sum_fail = (s1f + 2.0 * s2f - geno.mave * fsum) / geno.msd
        sum_fail[~np.isfinite(sum_fail)] = 0.0

        m_glob = cfg.m_glob
        nb = geno.packed.shape[1]
        # multi-process: compact local packed buffer, global-shape metadata
        # (see bayesrrm.py — remote metadata slots keep fill values)
        if self._n_procs > 1:
            from hydra_tpu.parallel.distributed import local_marker_shards
            local_d = local_marker_shards(self.mesh)
            if local_d != list(range(min(local_d), max(local_d) + 1)):
                raise NotImplementedError("non-contiguous local marker shards")
            slot_base = min(local_d) * m_loc
            packed_g = np.full((len(local_d) * m_loc, nb), 0b01010101,
                               dtype=np.uint8)
        else:
            local_d = list(range(n_dev))
            slot_base = 0
            packed_g = np.full((m_glob, nb), 0b01010101, dtype=np.uint8)
        groups_g = np.zeros(m_glob, dtype=np.int32)
        mave_g = np.zeros(m_glob, dtype=np.float32)
        msd_g = np.zeros(m_glob, dtype=np.float32)
        valid_g = np.zeros(m_glob, dtype=np.float32)
        sfail_g = np.zeros(m_glob, dtype=np.float32)
        slot_to_marker = np.full(m_glob, -1, dtype=np.int64)
        for d in range(n_dev):
            s, l = int(starts[d]), int(lengths[d])
            sl = slice(d * m_loc, d * m_loc + l)
            if d in local_d:
                ls = s - geno.marker_offset
                loc = slice(sl.start - slot_base, sl.stop - slot_base)
                packed_g[loc] = geno.packed[ls: ls + l]
                mave_g[sl] = geno.mave[ls: ls + l]
                msd_g[sl] = geno.msd[ls: ls + l]
                sfail_g[sl] = sum_fail[ls: ls + l]
            groups_g[sl] = dataset.groups[s: s + l]
            valid_g[sl] = 1.0
            slot_to_marker[d * m_loc: d * m_loc + l] = np.arange(s, s + l)
        if cfg.schedule == "block":
            # one-time decorrelating marker -> slot permutation (see
            # bayesrrm.py: fixed window blocks must be random marker sets;
            # every process draws ALL shard permutations in order)
            rs = np.random.RandomState((seed ^ 0x5EED1) & 0x7FFFFFFF)
            for d in range(n_dev):
                sl = slice(d * m_loc, (d + 1) * m_loc)
                p = rs.permutation(m_loc)
                if d in local_d:
                    loc = slice(sl.start - slot_base, sl.stop - slot_base)
                    packed_g[loc] = packed_g[loc][p]
                groups_g[sl] = groups_g[sl][p]
                mave_g[sl] = mave_g[sl][p]
                msd_g[sl] = msd_g[sl][p]
                valid_g[sl] = valid_g[sl][p]
                sfail_g[sl] = sfail_g[sl][p]
                slot_to_marker[sl] = slot_to_marker[sl][p]
        self.slot_to_marker = slot_to_marker

        max_ = marker_axes(cfg.n_dcn)
        shard_m = NamedSharding(self.mesh, P(max_))
        rep = NamedSharding(self.mesh, P())
        if cfg.n_ind > 1:
            shard_m2 = NamedSharding(self.mesh, P(max_, IND_AXIS))
            shard_i = NamedSharding(self.mesh, P(IND_AXIS))
            shard_i2 = NamedSharding(self.mesh, P(IND_AXIS, None))
        else:
            shard_m2 = NamedSharding(self.mesh, P(max_, None))
            shard_i = shard_i2 = rep
        self._shard_i = shard_i
        from hydra_tpu.parallel.distributed import put_global
        put = put_global if self._n_procs > 1 else jax.device_put
        self._put = put
        # device bytes are H-PACKED (ops/decode.py): minimal on-device decode
        from hydra_tpu.ops.decode import hpack_bytes
        packed_h = hpack_bytes(packed_g)
        if self._n_procs > 1:
            def _pk_cb(idx, _pk=packed_h):
                r0, r1, _ = idx[0].indices(m_glob)
                return _pk[r0 - slot_base: r1 - slot_base, idx[1]]

            self.packed = jax.make_array_from_callback(
                (m_glob, nb), shard_m2, _pk_cb)
        else:
            self.packed = put(packed_h, shard_m2)
        # non-zero mixture values only (cVa in bW stores km1 columns,
        # BayesW.cpp:781-786)
        mtot_grp = np.bincount(dataset.groups, minlength=dataset.num_groups)
        ind_mask = np.zeros(geno.n_pad, dtype=np.float32)
        ind_mask[: geno.n] = 1.0
        fail_pad = np.zeros(geno.n_pad, dtype=np.float32)
        fail_pad[: geno.n] = dataset.fail
        if dataset.X is not None:
            xpad = np.zeros((geno.n_pad, dataset.X.shape[1]), dtype=np.float32)
            xpad[: geno.n] = dataset.X
            sff = np.asarray(dataset.X.T @ dataset.fail,
                             np.float32)          # BayesW.cpp:1236-1239
        else:
            xpad = np.zeros((geno.n_pad, 0), np.float32)
            sff = np.zeros((0,), np.float32)
        # one batched pytree device_put for the small constants
        consts = put(
            dict(groups=groups_g, mave=mave_g, msd=msd_g, valid=valid_g,
                 sum_fail=sfail_g,
                 cva_nz=np.asarray(dataset.mS[:, 1:], np.float32),
                 mtot_grp=np.asarray(mtot_grp, np.int32),
                 ind_mask=ind_mask, fail=fail_pad, x_cov=xpad,
                 sum_fail_fix=sff),
            dict(groups=shard_m, mave=shard_m, msd=shard_m, valid=shard_m,
                 sum_fail=shard_m, cva_nz=rep, mtot_grp=rep,
                 ind_mask=shard_i, fail=shard_i, x_cov=shard_i2,
                 sum_fail_fix=rep))
        self.groups = consts["groups"]
        self.mave = consts["mave"]
        self.msd = consts["msd"]
        self.valid = consts["valid"]
        self.sum_fail = consts["sum_fail"]
        self.cva_nz = consts["cva_nz"]
        self.mtot_grp = consts["mtot_grp"]
        self.ind_mask = consts["ind_mask"]
        self.fail = consts["fail"]
        self.x_cov = consts["x_cov"]
        self.sum_fail_fix = consts["sum_fail_fix"]

        self._rep = rep
        self._shard_m = shard_m
        self._multi = {}
        self._step = self._build_step()

    # ------------------------------------------------------------------
    def init_state(self) -> BayesWState:
        """BayesW::init (BayesW.cpp:728-853)."""
        cfg = self.cfg
        y = self.ds.y
        mu = float(y.mean())
        denominator = 6.0 * np.sum((y - mu) ** 2) / (len(y) - 1)
        alpha = float(np.pi / np.sqrt(denominator))
        sigma_g = np.full(cfg.num_groups,
                          np.pi**2 / (6.0 * alpha**2) / cfg.num_groups)
        mtot = cfg.m_tot
        km1 = cfg.k - 1
        pi_l = np.full((cfg.num_groups, cfg.k), 1.0 / mtot)
        pi_l[:, 0] = 0.99
        pi_l[:, 1] = 1.0 - pi_l[:, 0] - (km1 - 1) / mtot

        eps = np.zeros(cfg.n_pad, dtype=np.float32)
        eps[: cfg.n_real] = y - mu

        # one batched pytree device_put (see constructor note)
        return self._put(
            BayesWState(
                eps=eps,
                beta=np.zeros(cfg.m_glob, np.float32),
                components=np.zeros(cfg.m_glob, np.int32),
                mu=np.float32(mu),
                alpha=np.float32(alpha),
                sigma_g=np.asarray(sigma_g, np.float32),
                pi_l=np.asarray(pi_l, np.float32),
                gamma=np.zeros(max(cfg.n_cov, 0), np.float32)),
            BayesWState(
                eps=self._shard_i, beta=self._shard_m,
                components=self._shard_m, mu=self._rep, alpha=self._rep,
                sigma_g=self._rep, pi_l=self._rep, gamma=self._rep))

    def init_state_from_restart(self, rd) -> BayesWState:
        cfg = self.cfg
        st = self.init_state()
        eps = np.zeros(cfg.n_pad, dtype=np.float32)
        eps[: cfg.n_real] = rd.eps
        beta_slot = np.zeros(cfg.m_glob, dtype=np.float32)
        comp_slot = np.zeros(cfg.m_glob, dtype=np.int32)
        sel = self.slot_to_marker >= 0
        beta_slot[sel] = rd.beta[self.slot_to_marker[sel]]
        comp_slot[sel] = rd.components[self.slot_to_marker[sel]]
        put = self._put
        st = st._replace(
            eps=put(jnp.asarray(eps), self._shard_i),
            beta=put(jnp.asarray(beta_slot), self._shard_m),
            components=put(jnp.asarray(comp_slot), self._shard_m),
            mu=put(jnp.float32(rd.mu), self._rep),
            alpha=put(jnp.float32(rd.alpha), self._rep),
            sigma_g=put(jnp.asarray(rd.sigma_g, jnp.float32), self._rep),
            pi_l=put(jnp.asarray(rd.pi_l, jnp.float32), self._rep),
        )
        if rd.gamma is not None and cfg.n_cov > 0:
            st = st._replace(gamma=put(jnp.asarray(rd.gamma, jnp.float32),
                                       self._rep))
        return st

    # ------------------------------------------------------------------
    def _build_step(self):
        cfg = self.cfg
        max_ = marker_axes(cfg.n_dcn)
        pm = P(max_)
        rep = P()
        if cfg.n_ind > 1:
            pm2 = P(max_, IND_AXIS)
            pi = P(IND_AXIS)
            pi2 = P(IND_AXIS, None)
        else:
            pm2 = P(max_, None)
            pi = pi2 = rep
        state_specs = BayesWState(eps=pi, beta=pm, components=pm, mu=rep,
                                  alpha=rep, sigma_g=rep, pi_l=rep, gamma=rep)
        stats_specs = BayesWStats(m0=rep, cass=rep, beta_sqn=rep)

        fn = functools.partial(_local_iteration, self.cfg, *self._gh)
        sharded = jax.shard_map(
            fn, mesh=self.mesh,
            in_specs=(rep, rep, state_specs, pm2, pm, pm, pm, pm, pm,
                      rep, rep, pi, pi, pi2, rep),
            out_specs=(state_specs, stats_specs),
        )

        # Big arrays are jit ARGUMENTS, not closure captures (closure consts
        # get inlined into the lowered MLIR and the compile payload scales
        # with M — see BayesRRm._build_step).
        self._sharded = sharded
        self._consts = (self.packed, self.groups, self.mave, self.msd,
                        self.valid, self.sum_fail, self.cva_nz,
                        self.mtot_grp, self.ind_mask, self.fail, self.x_cov,
                        self.sum_fail_fix)

        def raw_step(seed, it, state):
            return sharded(seed, it, state, *self._consts)

        self.raw_step = raw_step
        return jax.jit(sharded)

    def step(self, state: BayesWState, iteration: int):
        return self._step(jnp.uint32(self.seed), jnp.int32(iteration), state,
                          *self._consts)

    # ------------------------------------------------------------------

    def run_steps(self, state, start_iteration: int, k: int):
        """k sweeps in one device dispatch (lax.scan over iterations) —
        identical chain to k step() calls; see BayesRRm.run_steps."""
        multi = self._multi.get(k)
        if multi is None:
            def kloop(seed, it0, st, *consts):
                def body(st, it):
                    return self._sharded(seed, it, st, *consts)
                return jax.lax.scan(body, st,
                                    it0 + jnp.arange(k, dtype=jnp.int32))
            multi = jax.jit(kloop)
            self._multi[k] = multi
        return multi(jnp.uint32(self.seed), jnp.int32(start_iteration), state,
                     *self._consts)

    def cov_order(self, iteration: int) -> np.ndarray:
        """Covariate processing order at `iteration` (.xiv format parity)."""
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.key(self.seed), iteration), _S_COVPERM)
        return np.asarray(jax.random.permutation(key, self.cfg.n_cov),
                          dtype=np.int32)

    def beta_global(self, state) -> np.ndarray:
        out = np.zeros(self.cfg.m_tot)
        sel = self.slot_to_marker >= 0
        out[self.slot_to_marker[sel]] = np.asarray(state.beta, np.float64)[sel]
        return out

    def components_global(self, state) -> np.ndarray:
        out = np.zeros(self.cfg.m_tot, dtype=np.int32)
        sel = self.slot_to_marker >= 0
        out[self.slot_to_marker[sel]] = np.asarray(state.components)[sel]
        return out
