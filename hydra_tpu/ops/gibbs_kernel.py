"""The exact-mode window Gibbs recurrence: a Pallas kernel (Triton route)
and the `lax.scan` it replaces on the GPU.

Exact sequential Gibbs needs, per marker j of a window:

    num_j  = num0_j + sum_{t<j} dbeta_t * Gram_jt
    comp_j ~ categorical(softmax(logL(num_j)))
    beta_j ~ N(muk_comp, sd_comp)        (0 for the spike)
    dbeta_j = beta_old_j - beta_j

a data-dependent chain of W steps. As a `lax.scan` every step is a loop
iteration of several tiny XLA kernels. This kernel runs the whole chain in
one program: the running dbeta vector and the per-step outputs live in
registers, the (W, W) Gram row of the next step is loaded while the current
step computes, and the per-marker constants are read row by row.

Triton wants power-of-two block shapes, so the wrapper pads W and K: padded
markers are never visited (the loop runs over the real W) and have zero Gram
rows and columns; padded mixture components get a log-weight of -1e30, so
their probability underflows to exactly zero.

All randomness is drawn outside (u: categorical uniforms, nrm: standard
normals), so the kernel is deterministic given its inputs.

Equivalent math: hydra's per-marker update (BayesRRm.cpp:1744-1921) with the
window's earlier updates folded in through the Gram row, i.e. the same sweep
as sync-rate=1 sequential Gibbs.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# per-marker scalar columns of the `mv` table
_C_NUM0, _C_U, _C_NRM, _C_ACT, _C_BOLD, _C_I2SE = 0, 1, 2, 3, 4, 5
_MV_COLS = 8
_NEG = -1e30


def pow2(n: int, lo: int = 1) -> int:
    """Smallest power of two >= max(n, lo)."""
    n = max(int(n), lo)
    return 1 << (n - 1).bit_length()


def _kernel(W: int, K: int, g_ref, mv_ref, logl_ref, invd_ref, sd_ref,
            out_ref):
    f32 = jnp.float32
    Wp = g_ref.shape[0]
    Kp = logl_ref.shape[1]
    lanes = jax.lax.broadcasted_iota(jnp.int32, (Wp,), 0)
    kk = jax.lax.broadcasted_iota(jnp.int32, (Kp,), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (_MV_COLS,), 0)

    def col(row, c):
        return jnp.sum(jnp.where(cols == c, row, 0.0))

    def step(j, carry):
        dbeta, bnew, comp_v, acum_v, grow = carry
        # next step's Gram row, issued before this step's dependent chain
        grow_next = g_ref[jnp.minimum(j + 1, Wp - 1), :]
        row = mv_ref[j, :]
        logl = logl_ref[j, :]
        invd = invd_ref[j, :]
        sd = sd_ref[j, :]

        num = col(row, _C_NUM0) + jnp.sum(grow * dbeta)
        muk = num * invd                      # 0 for the spike (invd = 0)
        logL = logl + muk * num * col(row, _C_I2SE)
        pr = jnp.exp(logL - jnp.max(logL))
        probs = pr / jnp.sum(pr)
        cum = jnp.cumsum(probs, axis=0)
        comp = jnp.minimum(
            jnp.sum((col(row, _C_U) > cum).astype(jnp.int32)), K - 1)
        # table column k holds component k, so the slab of component comp
        # (comp >= 1) is column comp; the spike reads column 1 unused
        beta_nz = jnp.sum(jnp.where(kk == jnp.maximum(comp, 1),
                                    muk + col(row, _C_NRM) * sd, 0.0))
        act = col(row, _C_ACT) > 0
        beta_new = jnp.where((comp > 0) & act, beta_nz, 0.0)
        comp = jnp.where(act, comp, 0)
        acum0 = jnp.where(act, jnp.sum(jnp.where(kk == 0, probs, 0.0)), 1.0)
        db = col(row, _C_BOLD) - beta_new

        here = lanes == j
        return (jnp.where(here, db, dbeta),
                jnp.where(here, beta_new, bnew),
                jnp.where(here, comp.astype(f32), comp_v),
                jnp.where(here, acum0, acum_v),
                grow_next)

    zeros = jnp.zeros((Wp,), f32)
    dbeta, bnew, comp_v, acum_v, _ = jax.lax.fori_loop(
        0, W, step, (zeros, zeros, zeros, zeros, g_ref[0, :]))
    out_ref[0, :] = dbeta
    out_ref[1, :] = bnew
    out_ref[2, :] = comp_v
    out_ref[3, :] = acum_v


def draw_marker(num, logl, invd, sd, u, nrm, act, bold, i2se):
    """One marker's component + beta draw given its corrected dot product.

    logl (K,), invd/sd (K-1,); act is a bool or a 0/1 float. Returns
    (beta_new, comp, acum0, dbeta). Stable softmax in place of the
    reference's exp-overflow guard (BayesRRm.cpp:1883-1892)."""
    km1 = logl.shape[-1] - 1
    act = act > 0
    muk = num * invd
    logL = jnp.concatenate([logl[:1], logl[1:] + muk * num * i2se])
    pr = jnp.exp(logL - jnp.max(logL))
    probs = pr / jnp.sum(pr)
    cum = jnp.cumsum(probs)
    comp = jnp.minimum(jnp.sum((u > cum).astype(jnp.int32)), km1)
    ksel = jnp.maximum(comp - 1, 0)
    beta_new = jnp.where((comp > 0) & act, muk[ksel] + nrm * sd[ksel], 0.0)
    comp = jnp.where(act, comp, 0)
    acum0 = jnp.where(act, probs[0], 1.0)
    return beta_new, comp, acum0, bold - beta_new


def window_gibbs_scan(gram, num0, logl_static, inv_denomk, sd_k, u, nrm, act,
                      bold, i2se
                      ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """The same recurrence as window_gibbs, as a `lax.scan` over the W
    markers (any dtype, any backend). Returns (dbeta, beta_new, comp,
    acum0)."""
    def step(corr, j):
        bn, comp, ac, db = draw_marker(
            num0[j] + corr[j], logl_static[j], inv_denomk[j], sd_k[j], u[j],
            nrm[j], act[j], bold[j], i2se)
        return corr + db * gram[:, j], (db, bn, comp, ac)

    # num0 * 0 rather than zeros: inherits num0's shard_map varying axes
    _, (dbeta, bnew, comp, acum) = jax.lax.scan(
        step, num0 * 0, jnp.arange(num0.shape[0]))
    return dbeta, bnew, comp, acum


def window_gibbs(gram, num0, logl_static, inv_denomk, sd_k, u, nrm, act,
                 bold, i2se, interpret: bool = False, vma=None
                 ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Run the W-step recurrence; returns (dbeta, beta_new, comp, acum0).

    Shapes: gram (W, W); num0/u/nrm/act/bold (W,); logl_static (W, K);
    inv_denomk/sd_k (W, K-1). Any W and K: both are padded to powers of two
    here. `vma`: varying-manual-axes set when called inside shard_map.
    `interpret=True` runs the kernel in the Pallas interpreter (CPU tests);
    otherwise it compiles through Triton and needs a GPU.
    """
    W, K = logl_static.shape
    f32 = jnp.float32
    Wp, Kp = pow2(W, 8), pow2(K, 2)
    pw = Wp - W
    gram_p = jnp.pad(gram.astype(f32), ((0, pw), (0, pw)))
    i2se_col = jnp.broadcast_to(jnp.asarray(i2se, f32), (W,))
    mv = jnp.stack([num0, u, nrm, act, bold, i2se_col], axis=1).astype(f32)
    mv = jnp.pad(mv, ((0, pw), (0, _MV_COLS - mv.shape[1])))
    zero_col = jnp.zeros((W, 1), f32)
    logl = jnp.pad(logl_static.astype(f32), ((0, pw), (0, Kp - K)),
                   constant_values=_NEG)
    invd = jnp.pad(jnp.concatenate([zero_col, inv_denomk.astype(f32)], 1),
                   ((0, pw), (0, Kp - K)))
    sd = jnp.pad(jnp.concatenate([zero_col, sd_k.astype(f32)], 1),
                 ((0, pw), (0, Kp - K)))
    out_shape = (jax.ShapeDtypeStruct((4, Wp), f32, vma=set(vma)) if vma
                 else jax.ShapeDtypeStruct((4, Wp), f32))
    out = pl.pallas_call(
        functools.partial(_kernel, W, K),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="window_gibbs",
    )(gram_p, mv, logl, invd, sd)
    out = out[:, :W]
    return out[0], out[1], out[2].astype(jnp.int32), out[3]
