"""BayesRRm-mt — multi-trait Gibbs sampler in JAX (and actually enabled).

Behavioral rebuild of BayesRRm_mt::runMpiGibbsMultiTraits
(src/BayesRRm_mt.cpp:290-1426) — which the reference ships but never builds
(main.cpp:73-75, Makefile:24-25). Semantics follow the mt source:

  * NT traits share one genotype shard; each trait keeps its own residual,
    mu, sigmaE, sigmaG, pi and beta column (BayesRRm_mt.cpp:449-520).
  * Missing phenotypes are handled by per-trait NaN *masks*, not removal
    (:281-289, :584-600): masked individuals contribute nothing to that
    trait's dot products, residual updates, or statistics.
  * Marker statistics are per (trait, marker), computed under the trait mask
    (:604-665).

Device mapping: a window's dot products become one fused decode + reduction
over the packed bytes with a trait axis (ops/window.py), so the T traits
share one read of the genotypes. Residuals are stored dense (N_pad, T) with
masked entries pinned to zero, which makes the masked dot products plain
matmuls. The reference's interleaved/planar epsilon layouts
(--interleave-phenotypes, :449-520) are an XLA layout detail here.

Exact mode (default, matching single-trait): the per-marker numerators are
linear in the residual, so the window Gram correction from BayesRRm carries
over per trait — num_j[t] += sum_{k<j} dbeta_k[t] G_t[j, k]. With full
phenotypes (no NaNs) the per-trait masked stats collapse to the shared
genotype stats, so ONE trait-independent Gram serves all T traits (the
integer-plane tensor-core Gram + rank-1 correction of ops/window.py); NaN
phenotypes fall back to per-trait masked Grams. Cross-shard blocks ship the
raw packed bytes (16x less traffic than planes). --stale gives the reference's
sync-rate window relaxation; window=1 is exact either way.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hydra_tpu.data.genotypes import Dataset, shard_layout
from hydra_tpu.ops.window import (gram_parts, planes, standardize_gram,
                                  window_axpy, window_dots)
from hydra_tpu.parallel.mesh import (
    IND_AXIS, MARKER_AXIS, det_psum, hier_psum, make_mesh, marker_axes,
    mesh_axes)
from hydra_tpu.samplers.bayesrrm import (S02E, S02F, V0E, V0G_DEFAULT,
                                         S02G_DEFAULT, group_sum,
                                         resolve_schedule)
from hydra_tpu.utils import dist

# On the GPU an f32 product without precision=HIGHEST may run in TF32
# (about 3 significant digits); every f32 contraction names HIGHEST.
_HI = jax.lax.Precision.HIGHEST

_S_MU, _S_UNIF, _S_NORM, _S_SIGMAG, _S_PI, _S_SIGMAE, _S_PERM = 0, 1, 2, 3, 4, 5, 6
_S_COV, _S_COVPERM = 7, 8
_S_INIT = 100


@dataclass(frozen=True)
class MtConfig:
    n_pad: int
    m_tot: int
    m_loc: int
    n_dev: int
    window: int
    k: int
    num_groups: int
    n_traits: int
    n_cov: int = 0
    n_ind: int = 1
    n_dcn: int = 1
    shuffle: bool = True
    schedule: str = "marker"   # marker | block (see
                               # bayesrrm.BayesRRmConfig.schedule)
    det_sync: bool = False     # topology-invariant reductions (--det-sync)
    complete: bool = False     # no missing genotypes
    exact: bool = False        # Gram-corrected exact sequential semantics
    full_pheno: bool = False   # no NaN phenotypes: trait-independent Gram
    # cross-shard exchange interval B (see bayesrrm.BayesRRmConfig): other
    # shards' delta-betas reach the in-window correction every B markers;
    # B = window (default) -> no in-window collective at all
    cross_sync: int = 0        # resolved in __init__; 0 = window

    @property
    def n_windows(self):
        return self.m_loc // self.window

    @property
    def m_glob(self):
        return self.m_loc * self.n_dev


class MtState(NamedTuple):
    eps: jax.Array        # (n_pad, T) — masked entries held at 0
    beta: jax.Array       # (m_glob, T)
    components: jax.Array  # (m_glob, T) int32
    acum: jax.Array       # (m_glob, T) — P(zero component) (.t<k>.acu output)
    mu: jax.Array         # (T,)
    sigma_e: jax.Array    # (T,)
    sigma_g: jax.Array    # (T, G)
    est_pi: jax.Array     # (T, G, K)
    gamma: jax.Array      # (F, T) per-trait fixed effects


class MtStats(NamedTuple):
    m0: jax.Array         # (T, G)
    cass: jax.Array       # (T, G, K)
    beta_sqn: jax.Array   # (T, G)


def _mt_gram_blocks(cfg: MtConfig, pk, mave_w, mstd_w, trait_mask, n_loc,
                    psum_i, ma, dev, local_only=False):
    """Cross-shard window Gram blocks for exact mode.

    local_only=True (cross_sync >= window, the default): the local shard's
    Gram alone — other shards' deltas ride the window-boundary residual
    psum, so no ring/all_gather at all.

    Returns blocks[d, j, k] (trait-shared, full phenotypes) or
    blocks[d, t, j, k] (per-trait masked Grams, NaN phenotypes) =
    x~_j(local) . x~_k(shard d) under trait t's mask. Multi-shard
    transport ships the RAW packed bytes + one small stats row per hop
    (16x less traffic than f32 planes; see bayesrrm's exact ring).
    All terms are linear in lane sums, so ind-sharded callers psum here.
    """
    f32 = jnp.float32
    W = pk.shape[0]
    T = cfg.n_traits

    if cfg.full_pheno:
        # no NaN phenotypes: per-trait masked stats are the tiled genotype
        # stats (column 0 == every column) and the trait mask covers all
        # real lanes (pads decode to 0) — ONE integer-plane Gram serves all
        # T traits (pad markers have mstd = 0)
        srow = jnp.stack([mave_w[:, 0], mstd_w[:, 0]])      # (2, W)

        def blk(pk_r, srow_r):
            parts = tuple(p.astype(f32) for p in
                          gram_parts(pk, pk_r, complete=cfg.complete))
            return psum_i(standardize_gram(parts, srow[0], srow[1],
                                           srow_r[0], srow_r[1], n_loc))
    else:
        # NaN phenotypes: per-(marker, trait) masked stats -> T Grams,
        # each under that trait's individual mask
        def xt_planes(pk_r, mave_t, mstd_t):
            g, m = planes(pk_r)
            g, m = g.reshape(W, -1), m.reshape(W, -1)        # (W, N)
            return (g[None] - mave_t[:, :, None] * m[None]) * mstd_t[:, :, None]

        xm = xt_planes(pk, mave_w.T, mstd_w.T) * trait_mask.T[:, None, :]
        srow = jnp.concatenate([mave_w.T, mstd_w.T], axis=0)  # (2T, W)

        def blk(pk_r, srow_r):
            xt_r = xt_planes(pk_r, srow_r[:T], srow_r[T:])
            return psum_i(jnp.einsum("twn,tvn->twv", xm, xt_r,
                                     preferred_element_type=f32,
                                     precision=_HI))

    if cfg.n_dev == 1 or local_only:
        return blk(pk, srow)[None]
    if cfg.n_dcn > 1:
        # hierarchical mesh: no linearized-axis ppermute — gather bytes
        pk_all = jax.lax.all_gather(pk, ma)                  # (n_dev, W, NB)
        srow_all = jax.lax.all_gather(srow, ma)
        return jnp.stack([blk(pk_all[d], srow_all[d])
                          for d in range(cfg.n_dev)])
    ring = [((i + 1) % cfg.n_dev, i) for i in range(cfg.n_dev)]
    buf_pk, buf_srow = pk, srow
    shape = (cfg.n_dev, W, W) if cfg.full_pheno else (cfg.n_dev, T, W, W)
    blocks = jax.lax.pcast(jnp.zeros(shape, f32), (MARKER_AXIS,),
                           to="varying")
    for r in range(cfg.n_dev):
        owner = (dev + r) % cfg.n_dev
        b = blk(buf_pk, buf_srow)
        oh = (jnp.arange(cfg.n_dev) == owner).astype(f32)
        oh = oh.reshape((cfg.n_dev,) + (1,) * (blocks.ndim - 1))
        blocks = blocks + oh * b[None]
        if r < cfg.n_dev - 1:
            buf_pk = jax.lax.ppermute(buf_pk, MARKER_AXIS, ring)
            buf_srow = jax.lax.ppermute(buf_srow, MARKER_AXIS, ring)
    return blocks


def _local_iteration(cfg: MtConfig, seed, it, state: MtState,
                     packed, groups, mave, mstd, valid,
                     cva, cvai, mtot_grp, trait_mask, n_per_trait, x_cov):
    f32 = jnp.float32
    T = cfg.n_traits
    km1 = cfg.k - 1
    W = cfg.window
    # cross-shard exchange interval (see MtConfig.cross_sync)
    B_cs = min(cfg.cross_sync, W) if cfg.cross_sync > 0 else W
    local_exact = cfg.n_dev == 1 or B_cs >= W
    ma = marker_axes(cfg.n_dcn)
    # --det-sync: topology-invariant all-reduce (see parallel/mesh.det_psum)
    if cfg.det_sync:
        def ma_sum(v):
            return det_psum(v, ma, cfg.n_dev)

        def hpsum(v, n_dcn):
            return det_psum(v, ma, cfg.n_dev)
    else:
        def ma_sum(v):
            return jax.lax.psum(v, ma)
        hpsum = hier_psum
    dev = jax.lax.axis_index(ma)

    # N-sharding (see bayesrrm._local_iteration): eps/trait_mask/packed byte
    # columns arrive as local inds chunks; identity psum when n_ind == 1.
    if cfg.n_ind > 1:
        def psum_i(x):
            return jax.lax.psum(x, IND_AXIS)
    else:
        def psum_i(x):
            return x

    it_key = jax.random.fold_in(jax.random.key(seed), it)

    def site(s):
        return jax.random.fold_in(it_key, s)

    eps = state.eps
    beta = state.beta
    comps = state.components
    acum = state.acum
    sigma_e = state.sigma_e            # (T,)
    sigma_g = state.sigma_g            # (T, G)
    est_pi = state.est_pi              # (T, G, K)
    dN = n_per_trait                   # (T,) non-NA count per trait
    dNm1 = dN - 1.0

    # ---- per-trait mu updates ----
    eps = eps + state.mu[None, :] * trait_mask
    epssum = psum_i(jnp.sum(eps, axis=0))      # (T,)
    mu = dist.norm_rng(site(_S_MU), epssum / dN, sigma_e / dN, (T,))
    eps = eps - mu[None, :] * trait_mask

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

    u_all = jax.random.uniform(site(_S_UNIF), (cfg.m_glob, T), f32)
    n_all = jax.random.normal(site(_S_NORM), (cfg.m_glob, T), f32)
    off = dev * cfg.m_loc
    u_loc = jax.lax.dynamic_slice(u_all, (off, 0), (cfg.m_loc, T))
    n_loc = jax.lax.dynamic_slice(n_all, (off, 0), (cfg.m_loc, T))

    # active per (marker, trait): sigma_g[t, group(m)] > 0 & valid & mstd > 0
    act_mt = (sigma_g.T[groups] > 0.0) & (valid[:, None] > 0) & (mstd > 0)

    i_2se = 0.5 / sigma_e              # (T,)
    # real individuals of this ind shard (full phenotypes: the trait mask
    # is the lane mask) for the complete-data integer Gram
    n_real_loc = jnp.sum(trait_mask[:, 0])
    tiny = f32(1e-30)

    def window_body(w, carry):
        eps, beta, comps, acum, cass = carry
        idx = jax.lax.dynamic_slice(perm, (w * W,), (W,))
        pk = jnp.take(packed, idx, axis=0)
        mave_w = jnp.take(mave, idx, axis=0)        # (W, T)
        mstd_w = jnp.take(mstd, idx, axis=0)        # (W, T)
        grp_w = jnp.take(groups, idx)
        act_w = jnp.take(act_mt, idx, axis=0)       # (W, T)
        bold_w = jnp.take(beta, idx, axis=0)        # (W, T)
        u_w = jnp.take(u_loc, idx, axis=0)
        nrm_w = jnp.take(n_loc, idx, axis=0)

        num0 = (psum_i(window_dots(pk, eps, mave_w, mstd_w))   # (W, T)
                + bold_w * dNm1[None, :])

        sig_g_w = jnp.transpose(sigma_g, (1, 0))[grp_w]     # (W, T)
        cva_w = cva[grp_w][:, None, 1:]                     # (W, 1, km1)
        cvai_w = cvai[grp_w][:, None, 1:]
        log_pi_w = jnp.log(jnp.maximum(
            jnp.transpose(est_pi, (1, 0, 2))[grp_w], tiny))  # (W, T, K)

        safe_g = jnp.maximum(sig_g_w, tiny)[:, :, None]
        denomk = dNm1[None, :, None] + (sigma_e[None, :, None] / safe_g) * cvai_w
        inv_denomk = 1.0 / denomk
        sd_k = jnp.sqrt(sigma_e[None, :, None] * inv_denomk)
        log_detk = jnp.log(
            (sig_g_w[:, :, None] / sigma_e[None, :, None])
            * dNm1[None, :, None] * cva_w + 1.0)

        logl_static = jnp.concatenate(
            [log_pi_w[:, :, :1], log_pi_w[:, :, 1:] - 0.5 * log_detk],
            axis=2)                                          # (W, T, K)

        def draw_rows(num, inv_d, sdk, lstat, u, nrm, act):
            """Mixture-component + beta draw; leading dims (W,) or none."""
            muk = num[..., None] * inv_d                     # (..., T, km1)
            logL = jnp.concatenate(
                [lstat[..., :1],
                 lstat[..., 1:] + muk * num[..., None] * i_2se[:, None]],
                axis=-1)
            mx = jnp.max(logL, axis=-1, keepdims=True)
            pr = jnp.exp(logL - mx)
            probs = pr / jnp.sum(pr, axis=-1, keepdims=True)
            cum = jnp.cumsum(probs, axis=-1)
            comp = jnp.minimum(
                jnp.sum((u[..., None] > cum).astype(jnp.int32), axis=-1),
                km1)
            ksel = jnp.maximum(comp - 1, 0)[..., None]
            beta_nz = (jnp.take_along_axis(muk, ksel, axis=-1)
                       + nrm[..., None]
                       * jnp.take_along_axis(sdk, ksel, axis=-1))[..., 0]
            bnew = jnp.where((comp > 0) & act, beta_nz, 0.0)
            return (bnew, jnp.where(act, comp, 0),
                    jnp.where(act, probs[..., 0], 1.0))

        if cfg.exact:
            # ---- window Gram blocks (see module docstring) ----
            # blocks[d, (t,) j, k] = x~_j(local) . x~_k(shard d) under the
            # trait mask; per-step correction reproduces exact sequential
            # Gibbs across the window and across shards (the single-trait
            # machinery of bayesrrm._local_iteration, per trait).
            blocks = _mt_gram_blocks(cfg, pk, mave_w, mstd_w, trait_mask,
                                     n_real_loc, psum_i, ma, dev,
                                     local_only=local_exact)

            def draw_one(j, num_j):
                bnew, comp_j, acum_j = draw_rows(
                    num_j, inv_denomk[j], sd_k[j], logl_static[j],
                    u_w[j], nrm_w[j], act_w[j])
                return bnew, comp_j, acum_j, bold_w[j] - bnew

            corr0 = jax.lax.pcast(jnp.zeros((W, T), f32), ma, to="varying")
            if cfg.n_dev > 1 and not local_exact and B_cs > 1:
                # batched cross-shard exchange (see bayesrrm): own-shard
                # corrections applied per step, other shards' every B_cs
                # steps via one (B_cs, T) all_gather
                own = jnp.take(blocks, dev, axis=0)  # (W,W) or (T,W,W)

                def inner_step(carry, jj):
                    corr, b = carry
                    j = b * B_cs + jj
                    bnew, comp_j, acum_j, db = draw_one(j, num0[j] + corr[j])
                    if own.ndim == 2:
                        corr = corr + own[:, j][:, None] * db[None, :]
                    else:
                        corr = corr + own[:, :, j].T * db[None, :]
                    return (corr, b), (bnew, comp_j, acum_j, db)

                def batch_body(corr, b):
                    (corr, _), outs = jax.lax.scan(
                        inner_step, (corr, b), jnp.arange(B_cs))
                    db_b = outs[3]                           # (B_cs, T)
                    db_all = jax.lax.all_gather(db_b, ma)    # (D, B_cs, T)
                    if own.ndim == 2:
                        cols = jax.lax.dynamic_slice(
                            blocks, (0, 0, b * B_cs),
                            (cfg.n_dev, W, B_cs))
                        cross = jnp.einsum("dst,dws->wt", db_all, cols,
                                           precision=_HI)
                        own_c = jax.lax.dynamic_slice(
                            own, (0, b * B_cs), (W, B_cs))
                        cross = cross - jnp.einsum(
                            "st,ws->wt", db_b, own_c, precision=_HI)
                    else:
                        cols = jax.lax.dynamic_slice(
                            blocks, (0, 0, 0, b * B_cs),
                            (cfg.n_dev, T, W, B_cs))
                        cross = jnp.einsum("dst,dtws->wt", db_all, cols,
                                           precision=_HI)
                        own_c = jax.lax.dynamic_slice(
                            own, (0, 0, b * B_cs), (T, W, B_cs))
                        cross = cross - jnp.einsum(
                            "st,tws->wt", db_b, own_c, precision=_HI)
                    return corr + cross, outs

                _, outs = jax.lax.scan(
                    batch_body, corr0, jnp.arange(W // B_cs))
                bnew_w, comp, acum0 = (
                    o.reshape((W,) + o.shape[2:]) for o in outs[:3])
            else:
                def marker_step(corr, j):
                    bnew, comp_j, acum_j, db = draw_one(j, num0[j] + corr[j])
                    if cfg.n_dev > 1 and not local_exact:
                        # one T-vector per shard crosses the mesh each step (the
                        # per-marker Sum|dBeta| allreduce analogue)
                        db_all = jax.lax.all_gather(db, ma)  # (n_dev, T)
                    else:
                        db_all = db[None]
                    if blocks.ndim == 3:     # trait-shared (D, W, W)
                        corr = corr + jnp.einsum("dt,dw->wt", db_all,
                                                 blocks[:, :, j],
                                                 precision=_HI)
                    else:                    # per-trait (D, T, W, W)
                        corr = corr + jnp.einsum("dt,dtw->wt", db_all,
                                                 blocks[:, :, :, j],
                                                 precision=_HI)
                    return corr, (bnew, comp_j, acum_j)

                _, (bnew_w, comp, acum0) = jax.lax.scan(
                    marker_step, corr0, jnp.arange(W))
        else:
            bnew_w, comp, acum0 = draw_rows(
                num0, inv_denomk, sd_k, logl_static, u_w, nrm_w, act_w)
        # dEps(:, t) = sum_w (bold - bnew)_wt x~_wt, under trait t's mask
        d_eps = hpsum(window_axpy(pk, bold_w - bnew_w, mave_w, mstd_w),
                      cfg.n_dcn) * trait_mask
        eps = eps + d_eps

        flat = (grp_w[:, None] * cfg.k + comp).reshape(-1)   # (W*T,)
        trait_ids = jnp.broadcast_to(jnp.arange(T)[None, :], (W, T)).reshape(-1)
        full_idx = trait_ids * (cfg.num_groups * cfg.k) + flat
        cass = cass + jax.ops.segment_sum(
            act_w.astype(f32).reshape(-1), full_idx,
            num_segments=T * cfg.num_groups * cfg.k
        ).reshape(T, cfg.num_groups, cfg.k)

        beta = beta.at[idx].set(bnew_w)
        comps = comps.at[idx].set(comp)
        acum = acum.at[idx].set(acum0)
        return eps, beta, comps, acum, cass

    cass0 = jax.lax.pcast(
        jnp.zeros((T, cfg.num_groups, cfg.k), f32), ma, to="varying")
    eps, beta, comps, acum, cass = jax.lax.fori_loop(
        0, cfg.n_windows, window_body, (eps, beta, comps, acum, cass0))

    cass = ma_sum(cass)
    bsq = group_sum((beta * beta).T, groups, cfg.num_groups)      # (T, G)
    beta_sqn = ma_sum(bsq)

    # ---- per-(trait, group) hypers ----
    m0 = mtot_grp.astype(f32)[None, :] - cass[:, :, 0]
    skip = (mtot_grp[None, :] == 0) | (m0 == 0) | (jnp.sum(cass, 2) == 0)
    keys = jax.random.split(site(_S_SIGMAG), T * cfg.num_groups)
    dof = V0G_DEFAULT + m0
    scale = (beta_sqn * m0 + V0G_DEFAULT * S02G_DEFAULT) / jnp.maximum(dof, tiny)
    draws = jax.vmap(dist.inv_scaled_chisq_rng)(
        keys, dof.reshape(-1), scale.reshape(-1)).reshape(T, cfg.num_groups)
    sigma_g = jnp.where(skip, 0.0, draws)
    pi_draw = dist.dirichlet_rng(site(_S_PI), cass + 1.0)
    est_pi = jnp.where(skip[:, :, None], est_pi, pi_draw)

    # ---- per-trait fixed-effects ridge sweep ----
    # The reference's mt covariate block (BayesRRm_mt.cpp:1215-1245) is
    # unfinished: it keeps ONE gamma vector, uses a scalar sigmaE, and
    # updates only the first Ntot residual entries (trait 0) — inside a
    # path whose restart branch exit(1)s ("ADAPT!!", :713). This is the
    # completed multi-trait generalization of the single-trait sweep
    # (BayesRRm.cpp:2648-2681): per-trait gamma columns, each trait's dot
    # products and residual updates taken under its NaN mask, shared keys
    # across shards (the Bcast equivalent).
    gamma = state.gamma
    if cfg.n_cov > 0:
        xi = jax.random.permutation(site(_S_COVPERM), cfg.n_cov)
        gdraws = jax.random.normal(site(_S_COV), (cfg.n_cov, T), f32)
        denom_f = dNm1 + sigma_e / S02F                      # (T,)

        def cov_step(carry, i):
            eps, gamma = carry
            colm = x_cov[:, xi[i]][:, None] * trait_mask     # (N_loc, T)
            g_old = gamma[xi[i]]                             # (T,)
            num_f = psum_i(jnp.sum(
                colm * (eps + g_old[None, :] * colm), axis=0))
            g_new = (num_f / denom_f
                     + gdraws[i] * jnp.sqrt(sigma_e / denom_f))
            eps = eps + (g_old - g_new)[None, :] * colm
            gamma = gamma.at[xi[i]].set(g_new)
            return (eps, gamma), None

        (eps, gamma), _ = jax.lax.scan(cov_step, (eps, gamma),
                                       jnp.arange(cfg.n_cov))

    e_sqn = psum_i(jnp.sum(eps * eps, axis=0))               # (T,)
    keys_e = jax.random.split(site(_S_SIGMAE), T)
    sigma_e = jax.vmap(dist.inv_scaled_chisq_rng)(
        keys_e, V0E + dN, (e_sqn + V0E * S02E) / (V0E + dN))

    new_state = MtState(eps=eps, beta=beta, components=comps, acum=acum,
                        mu=mu, sigma_e=sigma_e, sigma_g=sigma_g,
                        est_pi=est_pi, gamma=gamma)
    return new_state, MtStats(m0=m0, cass=cass, beta_sqn=beta_sqn)


class BayesRRmMT:
    """Driver for the multi-trait sampler.

    phenos: (T, N) raw phenotype matrix with NaN for missing — the per-trait
    masks follow readPhenotypeFileAndSetNanMask semantics (data.cpp:1578-1609)
    and each trait is centered/scaled under its mask (data.cpp:1495-1529).
    """

    def __init__(self, dataset: Dataset, phenos: np.ndarray, *,
                 window: int = 1, exact: bool = True, shuffle: bool = True,
                 seed: int = 0, mesh: Optional[Mesh] = None,
                 n_devices: int = 0, n_ind: int = 1, n_dcn: int = 1,
                 cross_sync: int = 0,
                 schedule: str = "auto", det_sync: bool = False):
        self.ds = dataset
        self.mesh = mesh if mesh is not None else make_mesh(
            n_devices, n_ind=n_ind, n_dcn=n_dcn)
        n_dev, n_ind, n_dcn = mesh_axes(self.mesh)
        self.seed = seed
        geno = dataset.geno
        T, n = phenos.shape
        if n != geno.n:
            raise ValueError("phenotype matrix does not match genotype N")

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
        complete_b = bool(geno.nm_global_sum == 0)
        full_ph = bool(np.isfinite(phenos).all())
        # exact with W = 1 is the plain sequential schedule; skip the
        # (identity) Gram machinery there
        exact_b = exact and window > 1
        cs = min(cross_sync, window) if cross_sync > 0 else window
        if exact_b and cs < window and window % cs:
            raise ValueError(
                f"--cross-sync {cs} must divide the window ({window})")
        schedule = resolve_schedule(schedule, exact_b)
        self.cfg = MtConfig(
            n_pad=geno.n_pad, m_tot=geno.m_global, m_loc=m_loc, n_dev=n_dev,
            window=window, k=K, num_groups=dataset.num_groups, n_traits=T,
            n_cov=0 if dataset.X is None else dataset.X.shape[1],
            n_ind=n_ind, n_dcn=n_dcn, shuffle=shuffle, schedule=schedule,
            det_sync=det_sync,
            complete=complete_b,
            exact=exact_b,
            full_pheno=full_ph,
            cross_sync=cs)
        cfg = self.cfg

        # masks + per-trait centered/scaled phenotypes
        mask = np.isfinite(phenos).astype(np.float64)        # (T, N)
        y = np.where(mask > 0, phenos, 0.0)
        nonas = mask.sum(axis=1)
        mean = (y * mask).sum(axis=1) / nonas
        y = (y - mean[:, None]) * mask
        sqn = np.sqrt((nonas - 1) / (y * y).sum(axis=1))
        y = y * sqn[:, None]
        self._y = y
        self._mask = mask
        self._nonas = nonas

        # per-(marker, trait) masked stats (BayesRRm_mt.cpp:604-665),
        # computed BLOCKWISE over markers — a dense (M, N) host decode is
        # gigabytes at bench scale and dominated init time.
        from hydra_tpu.io.plink import decode_bed_numpy
        if mask.all():
            # no NaN phenotypes: masked stats == the standard per-marker
            # stats already computed by GenotypeData (counts-based, native)
            mave = np.tile(geno.mave[:, None], (1, T))
            mstd = np.tile(geno.mstd[:, None], (1, T))
        else:
            mave = np.zeros((geno.m, T))
            mstd = np.zeros((geno.m, T))
            blk = max(1, (1 << 27) // max(geno.n, 1))   # ~128 MB f64 blocks
            for s0 in range(0, geno.m, blk):
                e0 = min(geno.m, s0 + blk)
                g_np, miss_np = decode_bed_numpy(geno.packed[s0:e0], geno.n)
                for t in range(T):
                    mt = miss_np * mask[t][None, :]
                    cnt = mt.sum(axis=1)
                    s = (g_np * mt).sum(axis=1)
                    mave[s0:e0, t] = s / np.maximum(cnt, 1)
                    var = (mt * (g_np - mave[s0:e0, t][:, None]) ** 2
                           ).sum(axis=1)
                    with np.errstate(divide="ignore"):
                        mstd[s0:e0, t] = np.sqrt(
                            np.maximum(cnt - 1, 1) / var)
            badm = ~np.isfinite(mstd)
            mstd[badm] = 0.0
            mave[badm] = 0.0

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
        mave_g = np.zeros((m_glob, T), dtype=np.float32)
        mstd_g = np.zeros((m_glob, T), dtype=np.float32)
        valid_g = np.zeros(m_glob, dtype=np.float32)
        slot_to_marker = np.full(m_glob, -1, dtype=np.int64)
        for d in range(n_dev):
            s, l = int(starts[d]), int(lengths[d])
            sl = slice(d * m_loc, d * m_loc + l)
            if d in local_d:
                ls = s - geno.marker_offset
                loc = slice(sl.start - slot_base, sl.stop - slot_base)
                packed_g[loc] = geno.packed[ls: ls + l]
                mave_g[sl] = mave[ls: ls + l]
                mstd_g[sl] = mstd[ls: ls + l]
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
                pp = rs.permutation(m_loc)
                if d in local_d:
                    loc = slice(sl.start - slot_base, sl.stop - slot_base)
                    packed_g[loc] = packed_g[loc][pp]
                groups_g[sl] = groups_g[sl][pp]
                mave_g[sl] = mave_g[sl][pp]
                mstd_g[sl] = mstd_g[sl][pp]
                valid_g[sl] = valid_g[sl][pp]
                slot_to_marker[sl] = slot_to_marker[sl][pp]
        self.slot_to_marker = slot_to_marker

        max_ = marker_axes(cfg.n_dcn)
        shard_m = NamedSharding(self.mesh, P(max_))
        shard_m2 = NamedSharding(self.mesh, P(max_, None))
        rep = NamedSharding(self.mesh, P())
        if cfg.n_ind > 1:
            shard_mb = NamedSharding(self.mesh, P(max_, IND_AXIS))
            shard_i2 = NamedSharding(self.mesh, P(IND_AXIS, None))
        else:
            shard_mb = shard_m2
            shard_i2 = rep
        self._shard_i2 = shard_i2
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
                (m_glob, nb), shard_mb, _pk_cb)
        else:
            self.packed = put(packed_h, shard_mb)
        mS = dataset.mS.astype(np.float32)
        cvai = np.zeros_like(mS)
        cvai[:, 1:] = 1.0 / mS[:, 1:]
        tm = np.zeros((geno.n_pad, T), dtype=np.float32)
        tm[: geno.n] = mask.T
        if dataset.X is not None:
            xpad = np.zeros((geno.n_pad, dataset.X.shape[1]), dtype=np.float32)
            xpad[: geno.n] = dataset.X
        else:
            xpad = np.zeros((geno.n_pad, 0), np.float32)
        # one batched pytree device_put for the small constants
        consts = put(
            dict(groups=groups_g, mave=mave_g, mstd=mstd_g, valid=valid_g,
                 cva=mS, cvai=cvai,
                 mtot_grp=np.asarray(np.bincount(
                     dataset.groups, minlength=dataset.num_groups),
                     np.int32),
                 trait_mask=tm,
                 n_per_trait=np.asarray(nonas, np.float32), x_cov=xpad),
            dict(groups=shard_m, mave=shard_m2, mstd=shard_m2,
                 valid=shard_m, cva=rep, cvai=rep, mtot_grp=rep,
                 trait_mask=shard_i2, n_per_trait=rep, x_cov=shard_i2))
        self.groups = consts["groups"]
        self.mave = consts["mave"]
        self.mstd = consts["mstd"]
        self.valid = consts["valid"]
        self.cva = consts["cva"]
        self.cvai = consts["cvai"]
        self.mtot_grp = consts["mtot_grp"]
        self.trait_mask = consts["trait_mask"]
        self.n_per_trait = consts["n_per_trait"]
        self.x_cov = consts["x_cov"]
        self._rep, self._shard_m, self._shard_m2 = rep, shard_m, shard_m2
        self._multi = {}
        self._step = self._build_step()

    def init_state(self) -> MtState:
        cfg = self.cfg
        T = cfg.n_traits
        eps = np.zeros((cfg.n_pad, T), dtype=np.float32)
        eps[: self.ds.geno.n] = self._y.T
        sigma_e = (self._y ** 2).sum(axis=1) / self._nonas * 0.5
        key = jax.random.fold_in(jax.random.key(self.seed), _S_INIT)
        sg = np.array(dist.beta_rng(key, 1.0, 1.0, (T, cfg.num_groups)))
        mS = self.ds.mS
        pi0 = np.zeros((T, cfg.num_groups, cfg.k))
        pi0[:, :, 0] = 0.5
        denom = mS[:, 1:].sum(axis=1, keepdims=True)
        pi0[:, :, 1:] = 0.5 * (mS[:, 1:] / denom)[None, :, :]
        # one batched pytree device_put (see constructor note)
        return self._put(
            MtState(
                eps=eps,
                beta=np.zeros((cfg.m_glob, T), np.float32),
                components=np.zeros((cfg.m_glob, T), np.int32),
                acum=np.zeros((cfg.m_glob, T), np.float32),
                mu=np.zeros(T, np.float32),
                sigma_e=np.asarray(sigma_e, np.float32),
                sigma_g=np.asarray(sg, np.float32),
                est_pi=np.asarray(pi0, np.float32),
                gamma=np.zeros((cfg.n_cov, T), np.float32)),
            MtState(
                eps=self._shard_i2, beta=self._shard_m2,
                components=self._shard_m2, acum=self._shard_m2,
                mu=self._rep, sigma_e=self._rep, sigma_g=self._rep,
                est_pi=self._rep, gamma=self._rep))

    def _build_step(self):
        cfg = self.cfg
        max_ = marker_axes(cfg.n_dcn)
        pm = P(max_)
        pm2 = P(max_, None)
        rep = P()
        if cfg.n_ind > 1:
            pmb = P(max_, IND_AXIS)
            pi2 = P(IND_AXIS, None)
        else:
            pmb = pm2
            pi2 = rep
        state_specs = MtState(eps=pi2, beta=pm2, components=pm2, acum=pm2,
                              mu=rep, sigma_e=rep, sigma_g=rep, est_pi=rep,
                              gamma=rep)
        stats_specs = MtStats(m0=rep, cass=rep, beta_sqn=rep)
        fn = functools.partial(_local_iteration, self.cfg)
        sharded = jax.shard_map(
            fn, mesh=self.mesh,
            in_specs=(rep, rep, state_specs, pmb, pm, pm2, pm2, pm,
                      rep, rep, rep, pi2, rep, pi2),
            out_specs=(state_specs, stats_specs))

        # Big arrays are jit ARGUMENTS, not closure captures (closure consts
        # get inlined into the lowered MLIR and the compile payload scales
        # with M — see BayesRRm._build_step).
        self._sharded = sharded
        self._consts = (self.packed, self.groups, self.mave, self.mstd,
                        self.valid, self.cva, self.cvai, self.mtot_grp,
                        self.trait_mask, self.n_per_trait, self.x_cov)

        def raw_step(seed, it, state):
            return sharded(seed, it, state, *self._consts)

        self.raw_step = raw_step
        return jax.jit(sharded)

    def step(self, state, iteration: int):
        return self._step(jnp.uint32(self.seed), jnp.int32(iteration), state,
                          *self._consts)


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

    def beta_global(self, state) -> np.ndarray:
        out = np.zeros((self.cfg.m_tot, self.cfg.n_traits))
        sel = self.slot_to_marker >= 0
        out[self.slot_to_marker[sel]] = np.asarray(state.beta, np.float64)[sel]
        return out

    def acum_global(self, state) -> np.ndarray:
        """(m_tot, T) P(zero component) in reference marker order (.acu)."""
        out = np.ones((self.cfg.m_tot, self.cfg.n_traits))
        sel = self.slot_to_marker >= 0
        out[self.slot_to_marker[sel]] = np.asarray(state.acum, np.float64)[sel]
        return out
