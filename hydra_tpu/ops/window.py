"""Window primitives on H-PACKED genotype bytes, written in plain jnp.

Every N-length product of a window is written as an elementwise 2-bit decode
followed by a reduction, so XLA fuses the decode into the reduction kernel:
the kernel reads only the packed bytes (W x N/4 uint8) and the residual,
never a decoded (W, N) float plane.

Layout: byte b of a marker row holds individuals 4b..4b+3 (LSB first), so
an N-length vector v viewed as v.reshape(NB, 4) pairs column k with bit
plane k of every byte. Planes come out as (W, NB, 4) and need no
interleaving.

The window Gram goes to the tensor cores as an integer product: genotypes
and the missing mask take values in {0, 1, 2}, exact in bf16, and their
products summed in float32 stay exact while N < 2^22. The standardisation
x~_j = mstd_j (g_j - mave_j m_j) is applied afterwards as rank-1 terms.

Precision: on the GPU an f32 product without `precision=HIGHEST` may run in
TF32 (about 3 significant digits), so every f32 product here is written
as an elementwise multiply + reduction (full f32), never as a dot.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

_SHIFTS = (0, 2, 4, 6)


def planes(pk: jax.Array, dtype=jnp.float32) -> Tuple[jax.Array, jax.Array]:
    """(W, NB) H-packed bytes -> (geno, mask), each (W, NB, 4) in `dtype`.

    The crumb c stores h = 2 - geno with 3 = missing (ops/decode.py), so
    mask = (c != 3) and geno = (2 - c) * mask. Padding individuals are
    missing-coded and decode to zero in both planes."""
    c = (pk.astype(jnp.int32)[..., None]
         >> jnp.asarray(_SHIFTS, jnp.int32)) & 3
    m = 1 - ((c + 1) >> 2)
    return ((2 - c) * m).astype(dtype), m.astype(dtype)


def _quad(v: jax.Array) -> jax.Array:
    """(N,) or (N, T) vector -> (NB, 4) or (NB, 4, T), matching planes()."""
    return v.reshape((v.shape[0] // 4, 4) + v.shape[1:])


def window_dots(pk: jax.Array, v: jax.Array, mave: jax.Array,
                mstd: jax.Array) -> jax.Array:
    """x~_w . v for every marker of the window, x~ = mstd (geno - mave mask):
    (W,) for v (N,); (W, T) for v (N, T) with per-trait (W, T) stats."""
    g, m = planes(pk, v.dtype)
    q = _quad(v)
    if v.ndim == 2:
        g, m = g[..., None], m[..., None]
    s1, s2 = jnp.sum(g * q, axis=(1, 2)), jnp.sum(m * q, axis=(1, 2))
    return mstd * (s1 - mave * s2)


def window_axpy(pk: jax.Array, coef: jax.Array, mave: jax.Array,
                mstd: jax.Array) -> jax.Array:
    """sum_w coef_w x~_w: (N,) for coef (W,); (N, T) for coef (W, T) with
    per-trait (W, T) stats."""
    g, m = planes(pk, coef.dtype)
    c1 = coef * mstd
    c2 = -c1 * mave
    if coef.ndim == 1:
        out = jnp.sum(c1[:, None, None] * g + c2[:, None, None] * m, axis=0)
        return out.reshape(-1)
    out = jnp.sum(c1[:, None, None, :] * g[..., None]
                  + c2[:, None, None, :] * m[..., None], axis=0)
    return out.reshape(-1, coef.shape[1])


def level_sums(pk: jax.Array, v: jax.Array
               ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """BayesW partial sums per marker: (sum v over geno==1, geno==2,
    non-missing), each (W,)."""
    g, m = planes(pk, v.dtype)
    q = _quad(v)
    one = jnp.where(g == 1, q, 0.0)            # g == 1 implies m == 1
    two = jnp.where(g == 2, q, 0.0)
    return (jnp.sum(one, axis=(1, 2)), jnp.sum(two, axis=(1, 2)),
            jnp.sum(m * q, axis=(1, 2)))


def int_gram(a: jax.Array, b: jax.Array) -> jax.Array:
    """a @ b.T over the (NB, 4) individual axes of two integer-valued plane
    stacks, on the tensor cores in bf16 with f32 accumulation (exact)."""
    a2 = a.reshape(a.shape[0], -1).astype(jnp.bfloat16)
    b2 = b.reshape(b.shape[0], -1).astype(jnp.bfloat16)
    return jax.lax.dot_general(a2, b2, (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.float32)


def gram_parts(pk: jax.Array, pk_r: Optional[jax.Array] = None,
               complete: bool = False):
    """Raw integer Gram pieces between a window and a remote window.

    complete=True: (G, v, v_r) with G = geno . geno_r and v = sum(geno) per
    marker (the mask is the lane mask for every marker). Otherwise
    (GG, GM, MG, MM): the four geno/mask products."""
    g, m = planes(pk)
    if pk_r is None:
        g_r, m_r = g, m
    else:
        g_r, m_r = planes(pk_r)
    if complete:
        return (int_gram(g, g_r), jnp.sum(g, axis=(1, 2)),
                jnp.sum(g_r, axis=(1, 2)))
    W = g.shape[0]
    full = int_gram(jnp.concatenate([g, m]), jnp.concatenate([g_r, m_r]))
    return full[:W, :W], full[:W, W:], full[W:, :W], full[W:, W:]


def standardize_gram(parts, mave, mstd, mave_r, mstd_r, n_real=None):
    """Standardised Gram x~_j . x~_t from gram_parts' integer pieces.

    Linear in the pieces (and n_real), so shards of the individual axis may
    sum the result."""
    mj, mt = mave[:, None], mave_r[None, :]
    scale = mstd[:, None] * mstd_r[None, :]
    if len(parts) == 3:
        G, v, v_r = parts
        return scale * (G - mt * v[:, None] - mj * v_r[None, :]
                        + n_real * (mj * mt))
    GG, GM, MG, MM = parts
    return scale * (GG - mt * GM - mj * MG + (mj * mt) * MM)


def window_gram(pk: jax.Array, mave: jax.Array, mstd: jax.Array,
                complete: bool, n_real=None) -> jax.Array:
    """(W, W) standardised Gram of one window. complete=True needs n_real,
    this shard's count of real individuals."""
    parts = gram_parts(pk, complete=complete)
    parts = tuple(p.astype(mave.dtype) for p in parts)
    return standardize_gram(parts, mave, mstd, mave, mstd, n_real)
