"""BayesRRm — spike + Gaussian-mixture Gibbs sampler in JAX.

Behavioral rebuild of BayesRRm::runMpiGibbs (src/BayesRRm.cpp:933-2939),
including grouped/annotated mixtures (C16) and the Finnish-horseshoe variant
BayesFH (C20, branches at BayesRRm.cpp:1125-1163, :1725-1760, :2557-2571).

Device mapping (see SURVEY §2 parallelism checklist):

  * Marker sharding over a 1-D mesh axis "markers" via jax.shard_map
    (reference: MPI ranks, mpi_assign_blocks_to_tasks BayesRRm.cpp:1021).
  * The stale-residual window: the reference keeps epsilon frozen between
    collective syncs (`--sync-rate` markers per rank, BayesRRm.cpp:2044-2488),
    so all dot products in a window share one epsilon. Here a window of W
    markers becomes ONE fused decode + reduction over the packed bytes
    (ops/window.py).
  * Exact mode additionally computes the window Gram matrix
    G = X~ @ X~.T (an integer-plane tensor-core product) and corrects each
    marker's dot product with the earlier in-window delta-betas:
        num_j = x~_j . eps0 + sum_{k<j} dbeta_k Gram_jk
    which reproduces *exact sequential* Gibbs (the reference's sync-rate=1
    semantics) while still batching all N-length work per window. The
    W-step recurrence runs as one Triton kernel on the GPU
    (ops/gibbs_kernel.py) and as a lax.scan elsewhere.
  * Residual sync: eps += psum(X~^T dbeta) over the marker mesh — replacing
    MPI_Allreduce(dEpsSum) (BayesRRm.cpp:2456) and making the sparse/BED
    Allgatherv codecs unnecessary.
  * Hyper-parameter draws use keys shared across devices — the functional
    replacement for MPI_Bcast from rank 0 (BayesRRm.cpp:2585,2705,2731).
  * Per-marker randomness is indexed by *global* marker id, so results are
    independent of the device count for a fixed window schedule.

Documented numerical deviations from the reference:
  * stable log-softmax for the component probabilities instead of the
    exp-overflow guard at BayesRRm.cpp:1884-1892 (same distribution, no
    700-threshold artifacts);
  * jax.random (threefry) instead of boost::mt19937 — distributional
    equivalence only, like the reference's own compiler-dependent shuffle
    caveat (BayesRRm.cpp:1688-1690);
  * fixed-effect draws use shared keys on all shards; the reference lets
    per-rank RNG streams diverge in this sweep (BayesRRm.cpp:2648-2681)
    which is only consistent for 1 rank — we follow BayesW's broadcast
    semantics (BayesW.cpp:1405) instead.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hydra_tpu.data.genotypes import Dataset, shard_layout
from hydra_tpu.io.pheno import center_and_scale
from hydra_tpu.ops.gibbs_kernel import (draw_marker, window_gibbs,
                                        window_gibbs_scan)
from hydra_tpu.ops.window import (gram_parts, standardize_gram, window_axpy,
                                  window_dots, window_gram)
from hydra_tpu.parallel.mesh import (
    IND_AXIS, MARKER_AXIS, det_psum, hier_psum, make_mesh, marker_axes,
    mesh_axes)
from hydra_tpu.utils import dist

# On the GPU an f32 product without precision=HIGHEST may run in TF32
# (about 3 significant digits); every f32 contraction on the sampling path
# names HIGHEST (the integer-plane bf16 Gram in ops/window.py is exact).
_HI = jax.lax.Precision.HIGHEST

# Hyper-priors (BayesRRm.h:29-34)
V0E = 1e-4
S02E = 1e-4
V0G_DEFAULT = 1e-4
S02G_DEFAULT = 1e-4
S02F = 1.0

def resolve_schedule(schedule: str, exact: bool) -> str:
    """--schedule: auto resolves to "marker" (the reference's per-sweep
    marker shuffle) on every backend; "block" is honoured on request."""
    if schedule not in ("auto", "marker", "block"):
        raise ValueError(f"schedule must be auto/marker/block, "
                         f"got {schedule!r}")
    if schedule == "block" and exact:
        # the chain stays EXACT sequential Gibbs (zero relaxation bias),
        # but the processing order becomes W-dependent, so W=1 == W=N
        # chain equality no longer holds
        print("INFO   : exact mode with --schedule block: the chain "
              "keeps exact sequential-Gibbs semantics, but the "
              "window-width invariance (identical chains for any "
              "--window) is waived — the scan order now depends on "
              "the window partition", flush=True)
    return "marker" if schedule == "auto" else schedule


def group_sum(v, groups, num_groups: int):
    """Per-group sums over the last (marker) axis of v, as one fused
    reduction. A float segment_sum lowers on the GPU to a scatter-add of
    atomics, whose order (and so the last bits of the sum) changes from run
    to run; the chain is then not reproducible, --det-sync included."""
    onehot = groups == jnp.arange(num_groups, dtype=groups.dtype)[:, None]
    return jnp.sum(jnp.where(onehot, v[..., None, :], 0.0), axis=-1)


# RNG site ids (folded into the per-iteration key)
_S_MU, _S_UNIF, _S_NORM, _S_SIGMAG, _S_PI, _S_SIGMAE = 0, 1, 2, 3, 4, 5
_S_PERM, _S_COV, _S_COVPERM, _S_NU, _S_LAM, _S_TAU, _S_CSLAB, _S_HTAU = (
    6, 7, 8, 9, 10, 11, 12, 13)
_S_INIT_SIGMAG, _S_INIT_FH = 100, 101


@dataclass(frozen=True)
class BayesRRmConfig:
    n_real: int          # individuals after NA correction (dN)
    n_pad: int
    m_tot: int           # real markers
    m_loc: int           # per-shard padded marker count (multiple of window)
    n_dev: int
    window: int
    k: int               # mixture components incl. zero
    num_groups: int
    n_cov: int
    n_ind: int = 1       # individual-axis shards (2-D mesh); 1 = replicated eps
    n_dcn: int = 1       # multi-slice: markers shard over ("dcn", "markers")
    exact: bool = True
    # Exact-mode cross-shard exchange interval B (markers). Within a shard
    # the window recurrence is always exact-sequential; OTHER shards'
    # delta-betas are applied to the in-window correction every B steps.
    # B == window (the default): one exchange per window — the residual
    # psum at the window boundary carries everything, so no in-window
    # collective at all (same comm profile as stale mode) and the
    # semantics are strictly FRESHER than the reference at syncRate=W
    # (the reference freezes eps within the window even on-rank,
    # BayesRRm.cpp:1700,2460). B == 1: strict syncRate=1 parity — every
    # step ships one scalar/shard (latency-bound; the reference
    # pays a full N-length MPI_Allreduce per marker for the same
    # semantics, BayesRRm.cpp:2051,2456). 1 < B < W: W/B all_gathers of
    # (B,)-vectors per window, corrections via the cross-shard Gram
    # blocks. Single-shard runs ignore this (always exact-sequential).
    cross_sync: int = 0  # resolved to min(B, window) in __init__; 0 = window
    fh: bool = False
    shuffle: bool = True
    # Marker-processing schedule. "marker" (reference semantics,
    # BayesRRm.cpp:1691-1694): a fresh per-sweep permutation of all
    # markers. "block": a one-time setup permutation of marker->slot
    # assignment (decorrelates genome-adjacent/LD markers) composed with
    # a per-sweep permutation of WINDOW BLOCKS. Within a stale window every
    # marker reads the same frozen residual, so the draw math is
    # identical; only the window PARTITION is fixed per chain (markers
    # sharing a block stay window-mates). That is a valid systematic-scan
    # Gibbs schedule (the posterior is untouched; scan-order choices
    # affect mixing only). Exact mode's window-invariance (W=1 == W=N)
    # holds only under "marker", whose marker ORDER is window-agnostic.
    schedule: str = "marker"
    use_triton: bool = False   # exact recurrence as the Triton kernel (GPU)
    complete: bool = False     # no missing genotypes anywhere
    det_sync: bool = False     # topology-invariant reductions (--det-sync)
    dtype: str = "float32"     # accumulation dtype (--dtype; reference is f64)
    # FH hyper-priors (options.hpp:89-96)
    v0L: float = 3.0
    v0t: float = 3.0
    v0c: float = 3.0
    s02c: float = 1.0
    tau0: float = 1.0

    @property
    def n_windows(self) -> int:
        return self.m_loc // self.window

    @property
    def m_glob(self) -> int:
        return self.m_loc * self.n_dev


class BayesRRmState(NamedTuple):
    eps: jax.Array          # (n_pad,) replicated residual
    beta: jax.Array         # (m_glob,) sharded
    components: jax.Array   # (m_glob,) int32 sharded
    acum: jax.Array         # (m_glob,) sharded — P(zero component) (.acu output)
    mu: jax.Array
    sigma_e: jax.Array
    sigma_g: jax.Array      # (G,)
    est_pi: jax.Array       # (G, K)
    gamma: jax.Array        # (F,)
    # FH state (zeros when fh=False)
    lambda_var: jax.Array   # (m_glob,)
    nu_var: jax.Array       # (m_glob,)
    c_slab: jax.Array       # (G,)
    tau: jax.Array
    hyp_tau: jax.Array


class IterStats(NamedTuple):
    m0: jax.Array               # (G,) non-zero markers per group
    cass: jax.Array             # (G, K)
    beta_sqn: jax.Array         # (G,)
    sum_abs_dbeta: jax.Array    # scalar — reference's cumSumDeltaBetas diagnostic


def _local_iteration(cfg: BayesRRmConfig, seed, it, state: BayesRRmState,
                     packed, groups, mave, mstd, valid,
                     cva, cvai, dirc, sigma_priors, mtot_grp, ind_mask, x_cov):
    """One Gibbs sweep on the local marker shard (runs under shard_map)."""
    f32 = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    mave, mstd = mave.astype(f32), mstd.astype(f32)
    valid, ind_mask, x_cov = valid.astype(f32), ind_mask.astype(f32), x_cov.astype(f32)
    cva, cvai, dirc = cva.astype(f32), cvai.astype(f32), dirc.astype(f32)
    sigma_priors = sigma_priors.astype(f32)
    dN = f32(cfg.n_real)
    dNm1 = f32(cfg.n_real - 1)
    km1 = cfg.k - 1
    W = cfg.window
    # cross-shard exchange interval (see BayesRRmConfig.cross_sync);
    # local_exact: no in-window collective — other shards' deltas arrive
    # via the window-boundary residual psum only
    B_cs = min(cfg.cross_sync, W) if cfg.cross_sync > 0 else W
    local_exact = cfg.n_dev == 1 or B_cs >= W
    # ma: the (possibly hierarchical) marker axis — ("dcn", "markers") on
    # multi-host meshes; collectives over `ma` reduce across all marker
    # shards, within each host first (see parallel/mesh.py).
    ma = marker_axes(cfg.n_dcn)
    dev = jax.lax.axis_index(ma)
    # --det-sync: topology-invariant all-reduce (all_gather + fixed-order
    # local sum) so 1 x 8 and 2 x 4 process layouts give BITWISE-identical
    # chains (parallel/mesh.py det_psum)
    if cfg.det_sync:
        def ma_sum(v):
            return det_psum(v, ma, cfg.n_dev)

        def hpsum(v, n_dcn):
            return det_psum(v, ma, cfg.n_dev)
    else:
        def ma_sum(v):
            return jax.lax.psum(v, ma)
        hpsum = hier_psum

    # Individual-axis sharding: eps / ind_mask / x_cov / packed byte columns
    # arrive as local N/n_ind chunks; N-length reductions need one extra psum
    # over IND_AXIS. With n_ind == 1 these are identity (no collective).
    if cfg.n_ind > 1:
        def psum_i(x):
            return jax.lax.psum(x, IND_AXIS)
        vma_axes = ma + (IND_AXIS,)
    else:
        def psum_i(x):
            return x
        vma_axes = ma

    base_key = jax.random.key(seed)
    it_key = jax.random.fold_in(base_key, it)

    def site(s):
        return jax.random.fold_in(it_key, s)

    eps = state.eps
    beta = state.beta
    comps = state.components
    acum = state.acum
    lam = state.lambda_var
    nu = state.nu_var
    sigma_e = state.sigma_e
    sigma_g = state.sigma_g
    est_pi = state.est_pi

    # ---- mu update (BayesRRm.cpp:1675-1686) ----
    eps = eps + state.mu * ind_mask
    epssum = psum_i(jnp.sum(eps))
    mu = dist.norm_rng(site(_S_MU), epssum / dN, sigma_e / dN, dtype=f32)
    eps = eps - mu * ind_mask

    # ---- marker order: per-shard permutation (BayesRRm.cpp:1691-1694) ----
    if cfg.schedule == "block" and cfg.shuffle:
        # block schedule: permute WINDOW BLOCKS (see BayesRRmConfig.schedule;
        # the setup-time slot permutation already decorrelated block
        # membership), expanded to the composite marker order
        wperm = jax.random.permutation(
            jax.random.fold_in(site(_S_PERM), dev), cfg.n_windows)
        perm = (wperm[:, None] * W
                + jnp.arange(W, dtype=wperm.dtype)).reshape(-1)
    elif cfg.shuffle:
        perm = jax.random.permutation(
            jax.random.fold_in(site(_S_PERM), dev), cfg.m_loc)
    else:
        perm = jnp.arange(cfg.m_loc)

    # ---- per-marker randomness, indexed by global slot id ----
    u_all = jax.random.uniform(site(_S_UNIF), (cfg.m_glob,), f32)
    n_all = jax.random.normal(site(_S_NORM), (cfg.m_glob,), f32)
    off = dev * cfg.m_loc
    u_loc = jax.lax.dynamic_slice(u_all, (off,), (cfg.m_loc,))
    n_loc = jax.lax.dynamic_slice(n_all, (off,), (cfg.m_loc,))
    if cfg.fh:
        g_shape = f32(0.5 + 0.5 * cfg.v0L)
        g_nu = jax.lax.dynamic_slice(
            jax.random.gamma(site(_S_NU), g_shape, (cfg.m_glob,), f32), (off,), (cfg.m_loc,))
        g_lam = jax.lax.dynamic_slice(
            jax.random.gamma(site(_S_LAM), g_shape, (cfg.m_glob,), f32), (off,), (cfg.m_loc,))
    else:
        g_nu = g_lam = jnp.ones((cfg.m_loc,), f32)

    # adaV: markers of zeroed groups are skipped (BayesRRm.cpp:1589-1597)
    active_all = (sigma_g[groups] > 0.0) & (valid > 0.0) & (mstd > 0.0)

    i_2se = 0.5 / sigma_e
    tiny = f32(1e-30)
    # this shard's real-individual count (complete-data integer Gram;
    # linear, so the ind-axis psum still applies)
    n_real_loc = jnp.sum(ind_mask)

    def gram_block(pk, rows, pk_r, rows_r):
        """blk[j, t] = x~_j(local) . x~_t(remote) from the integer plane
        products (rows = [mave; mstd])."""
        parts = gram_parts(pk, pk_r, complete=cfg.complete)
        parts = tuple(p.astype(f32) for p in parts)
        return psum_i(standardize_gram(parts, rows[0], rows[1], rows_r[0],
                                       rows_r[1], n_real_loc))

    def window_body(w, carry):
        eps, beta, comps, acum, lam, nu, cass, sum_abs_db = carry
        idx = jax.lax.dynamic_slice(perm, (w * W,), (W,))
        pk = jnp.take(packed, idx, axis=0)
        mave_w = jnp.take(mave, idx)
        mstd_w = jnp.take(mstd, idx)
        grp_w = jnp.take(groups, idx)
        act_w = jnp.take(active_all, idx)
        bold_w = jnp.take(beta, idx)
        u_w = jnp.take(u_loc, idx)
        nrm_w = jnp.take(n_loc, idx)
        base = psum_i(window_dots(pk, eps, mave_w, mstd_w))

        # group-dependent per-marker rows
        log_pi_w = jnp.log(jnp.maximum(est_pi[grp_w], tiny))   # (W, K)
        cva_w = cva[grp_w][:, 1:]                              # (W, km1)
        cvai_w = cvai[grp_w][:, 1:]
        sig_g_w = sigma_g[grp_w]

        if cfg.fh:
            # nu_var draw + shrinkage (BayesRRm.cpp:1729-1730)
            lam_w = jnp.take(lam, idx)
            nu_w = (cfg.v0L / lam_w + 1.0) / jnp.take(g_nu, idx)
            csl_w = state.c_slab[grp_w]
            lamt_w = state.tau * csl_w / (state.tau + csl_w * lam_w)
            lamt_w = jnp.maximum(lamt_w, tiny)
        else:
            nu_w = jnp.take(nu, idx)
            lamt_w = jnp.ones((W,), f32)

        # ---- per-marker constants, vectorized over the window ----
        if cfg.fh:
            denomk = dNm1 + (sigma_e / lamt_w)[:, None] * jnp.ones((1, km1), f32)
            log_detk = jnp.log((lamt_w / sigma_e) * dNm1 + 1.0)[:, None] \
                * jnp.ones((1, km1), f32)
        else:
            safe_g = jnp.maximum(sig_g_w, tiny)
            denomk = dNm1 + (sigma_e / safe_g)[:, None] * cvai_w     # (W, km1)
            log_detk = jnp.log(
                (sig_g_w / sigma_e)[:, None] * dNm1 * cva_w + 1.0)
        inv_denomk = 1.0 / denomk
        sd_k = jnp.sqrt(sigma_e * inv_denomk)                        # (W, km1)
        logl_static = jnp.concatenate(
            [log_pi_w[:, :1], log_pi_w[:, 1:] - 0.5 * log_detk], axis=1)
        num0 = base + bold_w * dNm1                                  # (W,)

        def draw_one(j, num_j):
            return draw_marker(num_j, logl_static[j], inv_denomk[j], sd_k[j],
                               u_w[j], nrm_w[j], act_w[j], bold_w[j], i_2se)

        if cfg.exact and local_exact:
            # Gram correction: num_j += sum_{t<j} dbeta_t Gram_jt recovers
            # exact sequential Gibbs within the shard. cross_sync >= window:
            # other shards' deltas ride the window-boundary residual psum
            # below, the only collective (same comm profile as stale mode;
            # semantics strictly fresher than the reference at
            # syncRate=W, which freezes eps on-rank too,
            # BayesRRm.cpp:1700,2460)
            gram = psum_i(window_gram(pk, mave_w, mstd_w, cfg.complete,
                                      n_real_loc))
            recur = (functools.partial(window_gibbs, vma=vma_axes)
                     if cfg.use_triton else window_gibbs_scan)
            dbeta, bnew_w, comp_w, acum_w = recur(
                gram, num0, logl_static, inv_denomk, sd_k, u_w, nrm_w,
                act_w.astype(f32), bold_w, i_2se)
        elif cfg.exact:
            # Across shards the Gram blocks additionally apply every OTHER
            # shard's step-t deltas to step j>t — reproducing the
            # reference's sync-rate=1 multi-rank semantics (one marker per
            # rank between residual syncs, same-step markers mutually
            # stale, BayesRRm.cpp:2044-2060) without any N-length
            # collective inside the window. The shards exchange the RAW
            # 2-bit packed bytes plus one (2, W) stats row per window (16x
            # less traffic than f32 planes); each block is rebuilt from
            # the integer plane products.
            rows = jnp.stack([mave_w, mstd_w])               # (2, W)
            if cfg.n_dcn > 1:
                # hierarchical mesh: ppermute has no linearized-axis form,
                # so gather every shard's window bytes once
                pk_all = jax.lax.all_gather(pk, ma)          # (n_dev, W, NB)
                rows_all = jax.lax.all_gather(rows, ma)
                blocks = jnp.stack([
                    gram_block(pk, rows, pk_all[d], rows_all[d])
                    for d in range(cfg.n_dev)])
            else:
                ring = [((i + 1) % cfg.n_dev, i) for i in range(cfg.n_dev)]
                buf_pk, buf_rows = pk, rows
                blocks = jax.lax.pcast(
                    jnp.zeros((cfg.n_dev, W, W), f32), (MARKER_AXIS,),
                    to="varying")
                for r in range(cfg.n_dev):
                    owner = (dev + r) % cfg.n_dev
                    blk = gram_block(pk, rows, buf_pk, buf_rows)
                    oh = (jnp.arange(cfg.n_dev) == owner).astype(f32)
                    blocks = blocks + oh[:, None, None] * blk[None]
                    if r < cfg.n_dev - 1:
                        buf_pk = jax.lax.ppermute(buf_pk, MARKER_AXIS, ring)
                        buf_rows = jax.lax.ppermute(
                            buf_rows, MARKER_AXIS, ring)

            corr0 = jax.lax.pcast(
                jnp.zeros((W,), f32), ma, to="varying")
            if B_cs > 1:
                # batched cross-shard exchange: the inner scan applies only
                # OWN-shard corrections (exact within shard); every B_cs
                # steps one (B_cs,)-vector all_gather applies the other
                # shards' deltas — W/B_cs collectives per window instead of
                # W (cross_sync=1) or the reference's W N-length allreduces
                own = jnp.take(blocks, dev, axis=0)          # (W, W) local

                def inner_step(carry, jj):
                    corr, b = carry
                    j = b * B_cs + jj
                    beta_new, comp, acum0, db = draw_one(j, num0[j] + corr[j])
                    corr = corr + db * own[:, j]
                    return (corr, b), (beta_new, comp, acum0, db)

                def batch_body(corr, b):
                    (corr, _), outs = jax.lax.scan(
                        inner_step, (corr, b), jnp.arange(B_cs))
                    db_b = outs[3]                           # (B_cs,)
                    db_all = jax.lax.all_gather(db_b, ma)    # (n_dev, B_cs)
                    cols = jax.lax.dynamic_slice(
                        blocks, (0, 0, b * B_cs), (cfg.n_dev, W, B_cs))
                    cross = jnp.einsum("dt,dwt->w", db_all, cols,
                                       precision=_HI)
                    own_cols = jax.lax.dynamic_slice(
                        own, (0, b * B_cs), (W, B_cs))
                    corr = corr + cross - jnp.einsum(
                        "t,wt->w", db_b, own_cols, precision=_HI)
                    return corr, outs

                _, outs = jax.lax.scan(
                    batch_body, corr0, jnp.arange(W // B_cs))
                bnew_w, comp_w, acum_w, dbeta = (
                    o.reshape(W) for o in outs)
            else:
                def marker_step(corr, j):
                    beta_new, comp, acum0, db = draw_one(j, num0[j] + corr[j])
                    # one scalar per shard crosses the mesh each step —
                    # strict syncRate=1 parity (the reference pays a full
                    # N-length MPI_Allreduce per marker for the same
                    # semantics, BayesRRm.cpp:2051,2456)
                    db_all = jax.lax.all_gather(db, ma)
                    corr = corr + jnp.tensordot(db_all, blocks[:, :, j], axes=1,
                                                precision=_HI)
                    return corr, (beta_new, comp, acum0, db)

                _, (bnew_w, comp_w, acum_w, dbeta) = jax.lax.scan(
                    marker_step, corr0, jnp.arange(W))
        else:
            # Stale-window semantics (the reference's sync-rate relaxation,
            # BayesRRm.cpp:2044-2488): draws are independent given the frozen
            # residual -> fully vectorized, no scan.
            bnew_w, comp_w, acum_w, dbeta = jax.vmap(draw_marker, in_axes=(
                0, 0, 0, 0, 0, 0, 0, 0, None))(
                num0, logl_static, inv_denomk, sd_k, u_w, nrm_w, act_w,
                bold_w, i_2se)

        # residual sync: dense psum over the marker mesh axis
        # (replaces MPI_Allreduce(dEpsSum), BayesRRm.cpp:2456-2460)
        d_eps = hpsum(window_axpy(pk, dbeta, mave_w, mstd_w), cfg.n_dcn)
        eps = eps + d_eps
        sum_abs_db = sum_abs_db + ma_sum(jnp.sum(jnp.abs(dbeta)))

        # component-assignment counts, active markers only (BayesRRm.cpp:1904)
        flat = grp_w * cfg.k + comp_w
        cass = cass + jax.ops.segment_sum(
            act_w.astype(f32), flat, num_segments=cfg.num_groups * cfg.k
        ).reshape(cfg.num_groups, cfg.k)

        beta = beta.at[idx].set(bnew_w)
        comps = comps.at[idx].set(comp_w)
        acum = acum.at[idx].set(acum_w)
        if cfg.fh:
            # local shrinkage draw after beta (BayesRRm.cpp:1952)
            rate = 0.5 * bnew_w * bnew_w / state.tau + cfg.v0L / nu_w
            lam_new = rate / jnp.take(g_lam, idx)
            lam = lam.at[idx].set(lam_new)
            nu = nu.at[idx].set(nu_w)
        return eps, beta, comps, acum, lam, nu, cass, sum_abs_db

    cass0 = jax.lax.pcast(
        jnp.zeros((cfg.num_groups, cfg.k), f32), ma, to="varying")
    eps, beta, comps, acum, lam, nu, cass, sum_abs_db = jax.lax.fori_loop(
        0, cfg.n_windows, window_body,
        (eps, beta, comps, acum, lam, nu, cass0, jnp.zeros((), f32)))

    # ---- cross-shard reductions (BayesRRm.cpp:2515-2521) ----
    cass = ma_sum(cass)
    bsqn_loc = group_sum(beta * beta, groups, cfg.num_groups)
    beta_sqn = ma_sum(bsqn_loc)

    # ---- per-group hyper-parameter updates (BayesRRm.cpp:2525-2578) ----
    m0 = mtot_grp.astype(f32) - cass[:, 0]
    cass_sum = jnp.sum(cass, axis=1)
    skip = (mtot_grp == 0) | (m0 == 0) | (cass_sum == 0)

    if cfg.fh:
        scaled_bsqn = ma_sum(
            jnp.sum(jnp.where(valid > 0, beta * beta / jnp.maximum(lam, 1e-30), 0.0)))
        tau = state.tau
        hyp_tau = state.hyp_tau
        c_slab = state.c_slab
        # sequential per-group tau chain (BayesRRm.cpp:2557-2562)
        for g in range(cfg.num_groups):
            kg = jax.random.fold_in(site(_S_TAU), g)
            ht = dist.inv_gamma_rate_rng(
                jax.random.fold_in(site(_S_HTAU), g), 0.5 + 0.5 * cfg.v0t,
                1.0 / (cfg.tau0 * cfg.tau0) + 1.0 / tau, dtype=f32)
            t = dist.inv_gamma_rate_rng(
                kg, 0.5 * (m0[g] + cfg.v0t), cfg.v0t / ht + 0.5 * scaled_bsqn,
                dtype=f32)
            cs = dist.inv_scaled_chisq_rng(
                jax.random.fold_in(site(_S_CSLAB), g), cfg.v0c + m0[g],
                (beta_sqn[g] * m0[g] + cfg.v0c * cfg.s02c) / (cfg.v0c + m0[g]),
                dtype=f32)
            hyp_tau = jnp.where(skip[g], hyp_tau, ht)
            tau = jnp.where(skip[g], tau, t)
            c_slab = c_slab.at[g].set(jnp.where(skip[g], c_slab[g], cs))
        sigma_g_new = beta_sqn                                     # :2565
    else:
        v0g = sigma_priors[:, 0]
        s02g = sigma_priors[:, 1]
        keys = jax.random.split(site(_S_SIGMAG), cfg.num_groups)
        draws = jax.vmap(
            lambda k, d, s: dist.inv_scaled_chisq_rng(k, d, s, dtype=f32)
        )(keys, v0g + m0, (beta_sqn * m0 + v0g * s02g) / jnp.maximum(v0g + m0, tiny))
        sigma_g_new = draws
        tau, hyp_tau, c_slab = state.tau, state.hyp_tau, state.c_slab
    sigma_g = jnp.where(skip, 0.0, sigma_g_new)

    # pi | Dirichlet(cass + dirc) (BayesRRm.cpp:2576-2577); skipped groups keep
    # their previous row (the reference `continue`s before this update).
    pi_draw = dist.dirichlet_rng(site(_S_PI), cass + dirc, dtype=f32)
    est_pi = jnp.where(skip[:, None], est_pi, pi_draw)

    # ---- fixed effects ridge sweep (BayesRRm.cpp:2648-2681) ----
    gamma = state.gamma
    if cfg.n_cov > 0:
        xi = jax.random.permutation(site(_S_COVPERM), cfg.n_cov)
        gdraws = jax.random.normal(site(_S_COV), (cfg.n_cov,), f32)
        denom_f = dNm1 + sigma_e / S02F

        def cov_step(carry, i):
            eps, gamma = carry
            col = x_cov[:, xi[i]]
            g_old = gamma[xi[i]]
            num_f = psum_i(
                jnp.dot(col, eps + g_old * col, preferred_element_type=f32, precision=_HI))
            g_new = num_f / denom_f + gdraws[i] * jnp.sqrt(sigma_e / denom_f)
            eps = eps + (g_old - g_new) * col
            gamma = gamma.at[xi[i]].set(g_new)
            return (eps, gamma), None

        (eps, gamma), _ = jax.lax.scan(cov_step, (eps, gamma), jnp.arange(cfg.n_cov))

    # ---- sigmaE (BayesRRm.cpp:2685-2690) ----
    e_sqn = psum_i(jnp.sum(eps * eps))
    sigma_e = dist.inv_scaled_chisq_rng(
        site(_S_SIGMAE), V0E + dN, (e_sqn + V0E * S02E) / (V0E + dN),
        dtype=f32)

    new_state = BayesRRmState(
        eps=eps, beta=beta, components=comps, acum=acum, mu=mu,
        sigma_e=sigma_e, sigma_g=sigma_g, est_pi=est_pi, gamma=gamma,
        lambda_var=lam, nu_var=nu, c_slab=c_slab, tau=tau, hyp_tau=hyp_tau)
    stats = IterStats(m0=m0, cass=cass, beta_sqn=beta_sqn,
                      sum_abs_dbeta=sum_abs_db)
    return new_state, stats


class BayesRRm:
    """Driver: data layout, state init, sharded iteration, chain loop.

    Equivalent role to BayesRRm::runMpiGibbs (BayesRRm.cpp:933): owns the
    sharded genotype arrays, the replicated residual, and the Gibbs schedule.
    Output writing / restart live in hydra_tpu.outputs and the CLI runner.
    """

    def __init__(self, dataset: Dataset, *, window: int = 1, exact: bool = True,
                 fh: bool = False, shuffle: bool = True, seed: int = 0,
                 mesh: Optional[Mesh] = None, n_devices: int = 0,
                 n_ind: int = 1, n_dcn: int = 1,
                 fh_params: Optional[dict] = None,
                 dtype: str = "float32", cross_sync: int = 0,
                 schedule: str = "auto", det_sync: bool = False):
        if dtype == "float64" and not jax.config.jax_enable_x64:
            raise ValueError(
                "--dtype float64 requires x64 mode "
                "(jax.config.update('jax_enable_x64', True) or JAX_ENABLE_X64=1)")
        self.ds = dataset
        self.mesh = mesh if mesh is not None else make_mesh(
            n_devices, n_ind=n_ind, n_dcn=n_dcn)
        n_dev, n_ind, n_dcn = mesh_axes(self.mesh)
        self.seed = seed

        geno = dataset.geno
        starts, lengths, m_loc = shard_layout(geno.m_global, n_dev, window,
                                              dataset.blocks)
        self.shard_starts, self.shard_lengths, self.m_loc = starts, lengths, m_loc
        # multi-process (jax.distributed): this process materializes only its
        # own marker shards; geno.packed may hold just the local rows
        self._n_procs = jax.process_count()
        if self._n_procs > 1 and n_ind > 1:
            raise NotImplementedError(
                "--ind-shards with multi-process execution is not supported "
                "yet (packed byte columns would shard across hosts)")

        K = dataset.mS.shape[1]
        fhp = fh_params or {}
        # cross-shard exchange interval (exact mode, D > 1): 0/auto -> one
        # exchange per window (the window-boundary residual psum; see
        # BayesRRmConfig.cross_sync for the semantics ladder)
        cs = min(cross_sync, window) if cross_sync > 0 else window
        if exact and cs < window and window % cs:
            raise ValueError(
                f"--cross-sync {cs} must divide the window ({window})")
        if geno.n_pad % (4 * n_ind):
            raise ValueError(
                f"individual padding {geno.n_pad} not divisible by "
                f"4*n_ind={4 * n_ind}; use a power-of-two inds axis <= 128")
        schedule = resolve_schedule(schedule, exact)
        self.cfg = BayesRRmConfig(
            n_real=geno.n, n_pad=geno.n_pad, m_tot=geno.m_global, m_loc=m_loc,
            n_dev=n_dev, n_ind=n_ind, n_dcn=n_dcn, window=window, k=K,
            num_groups=dataset.num_groups,
            n_cov=0 if dataset.X is None else dataset.X.shape[1],
            exact=exact, fh=fh, shuffle=shuffle, dtype=dtype,
            cross_sync=cs, schedule=schedule, det_sync=det_sync,
            # complete data (no missing genotypes among real individuals):
            # the window Gram reduces to one integer product + rank-1 terms
            complete=bool(geno.nm_global_sum == 0),
            use_triton=(dtype == "float32"
                        and self.mesh.devices.flat[0].platform == "gpu"),
            v0L=fhp.get("v0L", 3.0), v0t=fhp.get("v0t", 3.0),
            v0c=fhp.get("v0c", 3.0), s02c=fhp.get("s02c", 1.0),
            tau0=fhp.get("tau0", 1.0),
        )
        cfg = self.cfg

        # ---- global padded marker layout: slot = dev*m_loc + local ----
        # Setup phases are timed separately (self.setup_timings): host
        # layout copy, h-pack LUT pass, and the device_put transfer.
        _t0 = time.perf_counter()
        m_glob = cfg.m_glob
        nb = geno.packed.shape[1]
        # multi-process: the packed-byte buffer holds only this process's
        # contiguous slot range (each host loaded only its own .bed rows);
        # slot-indexed metadata stays global-shape (small) and remote slots
        # simply keep fill values — make_array_from_callback never reads them.
        if self._n_procs > 1:
            from hydra_tpu.parallel.distributed import local_marker_shards
            local_d = local_marker_shards(self.mesh)
            if local_d != list(range(min(local_d), max(local_d) + 1)):
                raise NotImplementedError(
                    "non-contiguous local marker shards")
            slot_base = min(local_d) * m_loc
            packed_g = np.full((len(local_d) * m_loc, nb), 0b01010101,
                               dtype=np.uint8)
        else:
            local_d = list(range(n_dev))
            slot_base = 0
            packed_g = np.full((m_glob, nb), 0b01010101, dtype=np.uint8)
        groups_g = np.zeros(m_glob, dtype=np.int32)
        mave_g = np.zeros(m_glob, dtype=np.float32)
        mstd_g = np.zeros(m_glob, dtype=np.float32)
        valid_g = np.zeros(m_glob, dtype=np.float32)
        slot_to_marker = np.full(m_glob, -1, dtype=np.int64)
        for d in range(n_dev):
            s, l = int(starts[d]), int(lengths[d])
            sl = slice(d * m_loc, d * m_loc + l)
            if d in local_d:
                ls = s - geno.marker_offset
                loc = slice(sl.start - slot_base, sl.stop - slot_base)
                packed_g[loc] = geno.packed[ls: ls + l]
                mave_g[sl] = geno.mave[ls: ls + l]
                mstd_g[sl] = geno.mstd[ls: ls + l]
            groups_g[sl] = dataset.groups[s: s + l]
            valid_g[sl] = 1.0
            slot_to_marker[d * m_loc: d * m_loc + l] = np.arange(s, s + l)
        if cfg.schedule == "block":
            # one-time setup permutation of marker -> slot assignment so
            # the fixed window blocks are RANDOM marker sets, not genome-
            # adjacent (LD-correlated) runs (BayesRRmConfig.schedule).
            # Deterministic in the chain seed, so a --restart of the same
            # seed rebuilds the identical layout. Applied per shard to
            # preserve shard membership / --marker-blocks-file semantics.
            # Transiently copies one shard's packed rows on the host.
            rs = np.random.RandomState((seed ^ 0x5EED1) & 0x7FFFFFFF)
            for d in range(n_dev):
                sl = slice(d * m_loc, (d + 1) * m_loc)
                # every process draws ALL shard permutations in order so the
                # RandomState stream (and thus every shard's layout) is
                # process-count invariant
                p = rs.permutation(m_loc)
                if d in local_d:
                    loc = slice(sl.start - slot_base, sl.stop - slot_base)
                    packed_g[loc] = packed_g[loc][p]
                groups_g[sl] = groups_g[sl][p]
                mave_g[sl] = mave_g[sl][p]
                mstd_g[sl] = mstd_g[sl][p]
                valid_g[sl] = valid_g[sl][p]
                slot_to_marker[sl] = slot_to_marker[sl][p]
        self.slot_to_marker = slot_to_marker

        max_ = marker_axes(cfg.n_dcn)
        shard_m = NamedSharding(self.mesh, P(max_))
        rep = NamedSharding(self.mesh, P())
        if cfg.n_ind > 1:
            # 2-D layout: byte columns shard over the inds axis too, and the
            # N-length vectors (eps, ind_mask, covariates) shard over inds.
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
        # device bytes are H-PACKED (crumb = 2 - geno, missing = 3): a
        # one-time host LUT that shrinks every on-device plane decode to
        # shift+and+cast (ops/decode.py). Host-side consumers (sparse io,
        # stats) keep the PLINK coding.
        from hydra_tpu.ops.decode import hpack_bytes
        _t1 = time.perf_counter()
        packed_h = hpack_bytes(packed_g)
        _t2 = time.perf_counter()
        if self._n_procs > 1:
            # compact local buffer -> global array: shard row ranges are
            # global, shift them into this process's buffer
            def _pk_cb(idx, _pk=packed_h):
                r0, r1, _ = idx[0].indices(m_glob)
                return _pk[r0 - slot_base: r1 - slot_base, idx[1]]

            self.packed = jax.make_array_from_callback(
                (m_glob, nb), shard_m2, _pk_cb)
        else:
            self.packed = put(packed_h, shard_m2)
        jax.block_until_ready(self.packed)
        _t3 = time.perf_counter()
        self.setup_timings = {"layout_s": _t1 - _t0, "hpack_s": _t2 - _t1,
                              "device_put_s": _t3 - _t2}
        del packed_h

        # mixture grids (BayesRRm.cpp:1004-1108)
        mS = dataset.mS.astype(np.float32)
        cvai = np.zeros_like(mS)
        cvai[:, 1:] = 1.0 / mS[:, 1:]
        # Dirichlet prior rows (ones, or --dPriorsFile; BayesRRm.cpp:2551-2554)
        dirc = (dataset.d_priors if dataset.d_priors is not None
                else np.ones((dataset.num_groups, K)))
        # sigmaG priors (v0G, s02G) per group (--groupPriorsFile; :2544-2548)
        sp = (dataset.priors if dataset.priors is not None
              else np.full((dataset.num_groups, 2), (V0G_DEFAULT, S02G_DEFAULT)))
        mtot_grp = np.bincount(dataset.groups, minlength=dataset.num_groups)
        ind_mask = np.zeros(geno.n_pad, dtype=np.float32)
        ind_mask[: geno.n] = 1.0
        if dataset.X is not None:
            xpad = np.zeros((geno.n_pad, dataset.X.shape[1]), dtype=np.float32)
            xpad[: geno.n] = dataset.X
        else:
            xpad = np.zeros((geno.n_pad, 0), np.float32)

        # one batched pytree device_put for every small constant
        consts = put(
            dict(groups=groups_g, mave=mave_g,
                 mstd=mstd_g, valid=valid_g, cva=mS,
                 cvai=cvai,
                 dirc=np.asarray(dirc, np.float32),
                 sigma_priors=np.asarray(sp, np.float32),
                 mtot_grp=np.asarray(mtot_grp, np.int32),
                 ind_mask=ind_mask, x_cov=xpad),
            dict(groups=shard_m, mave=shard_m,
                 mstd=shard_m, valid=shard_m, cva=rep, cvai=rep, dirc=rep,
                 sigma_priors=rep, mtot_grp=rep, ind_mask=shard_i,
                 x_cov=shard_i2))
        self.groups = consts["groups"]
        self.mave = consts["mave"]
        self.mstd = consts["mstd"]
        self.valid = consts["valid"]
        self.cva = consts["cva"]
        self.cvai = consts["cvai"]
        self.dirc = consts["dirc"]
        self.sigma_priors = consts["sigma_priors"]
        self.mtot_grp = consts["mtot_grp"]
        self.ind_mask = consts["ind_mask"]
        self.x_cov = consts["x_cov"]

        self._rep = rep
        self._shard_m = shard_m
        self._step = self._build_step()
        self.setup_timings["other_puts_s"] = time.perf_counter() - _t3

    # ------------------------------------------------------------------
    def init_state(self) -> BayesRRmState:
        """init_from_scratch equivalent (BayesRRm.cpp:1224-1240, :1564-1584)."""
        cfg = self.cfg
        fdt = jnp.float64 if cfg.dtype == "float64" else jnp.float32
        y = center_and_scale(self.ds.y)
        eps = np.zeros(cfg.n_pad, dtype=fdt)
        eps[: cfg.n_real] = y
        sigma_e = float(np.sum(y * y) / cfg.n_real * 0.5)

        key = jax.random.key(self.seed)
        # sigmaG ~ Beta(1,1) per group, zero empty groups (:1231-1240)
        sg = np.array(dist.beta_rng(
            jax.random.fold_in(key, _S_INIT_SIGMAG), 1.0, 1.0,
            (cfg.num_groups,)))
        mtot_grp = np.bincount(self.ds.groups, minlength=cfg.num_groups)
        sg[mtot_grp == 0] = 0.0

        # priorPi: col0 = 0.5, rest proportional to cVa (:1097-1107)
        mS = self.ds.mS
        pi0 = np.zeros((cfg.num_groups, cfg.k))
        pi0[:, 0] = 0.5
        denom = mS[:, 1:].sum(axis=1, keepdims=True)
        pi0[:, 1:] = 0.5 * mS[:, 1:] / denom

        if cfg.fh:
            kfh = jax.random.fold_in(key, _S_INIT_FH)
            hyp_tau = float(dist.inv_gamma_rate_rng(
                jax.random.fold_in(kfh, 0), 0.5, 1.0 / (cfg.tau0 ** 2)))
            tau = float(dist.inv_gamma_rate_rng(
                jax.random.fold_in(kfh, 1), 0.5 * cfg.v0t,
                cfg.v0t / hyp_tau))
            c_slab = np.asarray(jax.vmap(
                lambda k: dist.inv_scaled_chisq_rng(k, cfg.v0c, cfg.s02c)
            )(jax.random.split(jax.random.fold_in(kfh, 2),
                               cfg.num_groups)))
            lam0 = float(c_slab.sum() / cfg.m_tot)       # :1160-1161
        else:
            hyp_tau, tau = 1.0, 1.0
            c_slab = np.zeros(cfg.num_groups)
            lam0 = 1.0

        # one batched pytree device_put of host NumPy arrays
        ndt = np.float64 if cfg.dtype == "float64" else np.float32
        return self._put(
            BayesRRmState(
                eps=eps,
                beta=np.zeros(cfg.m_glob, ndt),
                components=np.zeros(cfg.m_glob, np.int32),
                acum=np.zeros(cfg.m_glob, ndt),
                mu=ndt(0.0),
                sigma_e=ndt(sigma_e),
                sigma_g=np.asarray(sg, ndt),
                est_pi=np.asarray(pi0, ndt),
                gamma=np.zeros(max(cfg.n_cov, 0), ndt),
                lambda_var=np.full(cfg.m_glob, lam0, ndt),
                nu_var=np.zeros(cfg.m_glob, ndt),
                c_slab=np.asarray(c_slab, ndt),
                tau=ndt(tau),
                hyp_tau=ndt(hyp_tau)),
            BayesRRmState(
                eps=self._shard_i, beta=self._shard_m,
                components=self._shard_m, acum=self._shard_m,
                mu=self._rep, sigma_e=self._rep, sigma_g=self._rep,
                est_pi=self._rep, gamma=self._rep,
                lambda_var=self._shard_m, nu_var=self._shard_m,
                c_slab=self._rep, tau=self._rep, hyp_tau=self._rep))

    # ------------------------------------------------------------------
    def init_state_from_restart(self, rd) -> BayesRRmState:
        """Rebuild device state from a RestartData (init_from_restart,
        BayesRRm.cpp:842-928). Resumes at rd.start_iteration."""
        cfg = self.cfg
        fdt = jnp.float64 if cfg.dtype == "float64" else jnp.float32
        st = self.init_state()
        eps = np.zeros(cfg.n_pad, dtype=fdt)
        eps[: cfg.n_real] = rd.eps
        beta_slot = np.zeros(cfg.m_glob, dtype=fdt)
        comp_slot = np.zeros(cfg.m_glob, dtype=np.int32)
        sel = self.slot_to_marker >= 0
        beta_slot[sel] = rd.beta[self.slot_to_marker[sel]]
        comp_slot[sel] = rd.components[self.slot_to_marker[sel]]
        put = self._put
        st = st._replace(
            eps=put(jnp.asarray(eps), self._shard_i),
            beta=put(jnp.asarray(beta_slot), self._shard_m),
            components=put(jnp.asarray(comp_slot), self._shard_m),
            mu=put(fdt(rd.mu), self._rep),
            sigma_e=put(fdt(rd.sigma_e), self._rep),
            sigma_g=put(jnp.asarray(rd.sigma_g, fdt), self._rep),
            est_pi=put(jnp.asarray(rd.est_pi, fdt), self._rep),
        )
        if rd.gamma is not None and cfg.n_cov > 0:
            st = st._replace(gamma=put(jnp.asarray(rd.gamma, fdt), self._rep))
        if rd.fh_state is not None and cfg.fh:
            lam_slot = np.ones(cfg.m_glob, dtype=fdt)
            nu_slot = np.zeros(cfg.m_glob, dtype=fdt)
            lam_slot[sel] = rd.fh_state["lambda_var"][self.slot_to_marker[sel]]
            nu_slot[sel] = rd.fh_state["nu_var"][self.slot_to_marker[sel]]
            st = st._replace(
                lambda_var=put(jnp.asarray(lam_slot), self._shard_m),
                nu_var=put(jnp.asarray(nu_slot), self._shard_m),
                c_slab=put(jnp.asarray(rd.fh_state["c_slab"], fdt), self._rep),
                tau=put(fdt(rd.fh_state["tau"]), self._rep),
                hyp_tau=put(fdt(rd.fh_state["hyp_tau"]), self._rep),
            )
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
        state_specs = BayesRRmState(
            eps=pi, beta=pm, components=pm, acum=pm, mu=rep, sigma_e=rep,
            sigma_g=rep, est_pi=rep, gamma=rep, lambda_var=pm, nu_var=pm,
            c_slab=rep, tau=rep, hyp_tau=rep)
        stats_specs = IterStats(m0=rep, cass=rep, beta_sqn=rep, sum_abs_dbeta=rep)

        fn = functools.partial(_local_iteration, cfg)
        self._sharded = sharded = jax.shard_map(
            fn, mesh=self.mesh,
            in_specs=(rep, rep, state_specs, pm2, pm, pm, pm, pm,
                      rep, rep, rep, rep, rep, pi, pi2),
            out_specs=(state_specs, stats_specs),
        )

        # The genotype bytes and per-marker constants are passed as explicit
        # jit ARGUMENTS, never closure captures: closed-over device arrays
        # are inlined into the lowered program as dense constants, which
        # makes the compile payload scale with M (1.25 GB of MLIR at
        # M=100K x N=50K).
        self._consts = (self.packed, self.groups, self.mave,
                        self.mstd, self.valid, self.cva, self.cvai, self.dirc,
                        self.sigma_priors, self.mtot_grp, self.ind_mask,
                        self.x_cov)

        def raw_step(seed, it, state):
            return sharded(seed, it, state, *self._consts)

        self.raw_step = raw_step  # un-jitted (compile checks, graft)
        self._multi = {}          # run_steps executables, keyed by k
        return jax.jit(sharded)

    def step(self, state: BayesRRmState, iteration: int
             ) -> Tuple[BayesRRmState, IterStats]:
        return self._step(jnp.uint32(self.seed), jnp.int32(iteration), state,
                          *self._consts)

    def run_steps(self, state: BayesRRmState, start_iteration: int, k: int
                  ) -> Tuple[BayesRRmState, IterStats]:
        """k Gibbs sweeps in ONE device dispatch (lax.scan over iterations).

        Identical chain to k calls of step() — the iteration number is the
        scanned variable, so per-iteration RNG keys match exactly. Production
        chains fuse the sweeps between two thin/save boundaries into one
        dispatch, so the host is not in the loop every sweep. Returns the
        final state and the stacked (k, ...) IterStats."""
        multi = self._multi.get(k)
        if multi is None:
            def kloop(seed, it0, st, *consts):
                def body(st, it):
                    return self._sharded(seed, it, st, *consts)
                return jax.lax.scan(body, st, it0 + jnp.arange(k, dtype=jnp.int32))
            multi = jax.jit(kloop)
            self._multi[k] = multi
        return multi(jnp.uint32(self.seed), jnp.int32(start_iteration), state,
                     *self._consts)

    # ------------------------------------------------------------------
    def cov_order(self, iteration: int) -> np.ndarray:
        """The covariate processing order used at `iteration` (re-derives the
        in-step permutation; written to .xiv.0 for reference format parity —
        counter-based restart never consumes it)."""
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.key(self.seed), iteration), _S_COVPERM)
        return np.asarray(jax.random.permutation(key, self.cfg.n_cov),
                          dtype=np.int32)

    def beta_global(self, state: BayesRRmState) -> np.ndarray:
        """Gather beta into reference marker order (Mtot,)."""
        return self._to_marker_order(np.asarray(state.beta, dtype=np.float64))

    def components_global(self, state: BayesRRmState) -> np.ndarray:
        return self._to_marker_order(
            np.asarray(state.components, dtype=np.int64)).astype(np.int32)

    def acum_global(self, state: BayesRRmState) -> np.ndarray:
        return self._to_marker_order(np.asarray(state.acum, dtype=np.float64))

    def _to_marker_order(self, flat: np.ndarray) -> np.ndarray:
        out = np.zeros(self.cfg.m_tot, dtype=flat.dtype)
        sel = self.slot_to_marker >= 0
        out[self.slot_to_marker[sel]] = flat[sel]
        return out

    def run(self, n_iterations: int, state: Optional[BayesRRmState] = None,
            start_iteration: int = 0, callback=None):
        """Plain chain loop; the CLI runner adds thin/save output handling."""
        if state is None:
            state = self.init_state()
        stats = None
        for it in range(start_iteration, n_iterations):
            state, stats = self.step(state, it)
            if callback is not None:
                callback(it, state, stats)
        return state, stats
