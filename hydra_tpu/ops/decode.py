"""Decode of packed 2-bit PLINK genotypes, and the h-packed device format.

Device replacement for the reference's two genotype kernel paths:
  * the AVX2 LUT dot product over raw BED bytes (BayesRRm.cpp:1774-1808,
    dotp_lut_a/b in src/dotp_lut.h), and
  * the sparse index-list kernels sparse_dotprod / sparse_scaadd
    (BayesRRm.cpp:250-342).

Representation: genotypes stay packed in device memory as (M, ceil(N/4))
uint8 — 4 individuals per byte, LSB-first. The samplers decode inside the
window reductions (ops/window.py); the decoded planes are

    A (geno)  : code 00 -> 2, 10 -> 1, 11 -> 0, 01 (missing) -> 0
    B (mask)  : 0 where missing else 1

exactly mirroring dotp_lut_a / dotp_lut_b (mk_lut.cpp:7-73).

The hot-loop identity (see BayesRRm.cpp:1809 and sparse_dotprod:316-342):

    num_j  = mstd_j * (A_j . eps - mave_j * (B_j . eps)) = x~_j . eps
    where x~_j = mstd_j * (A_j - mave_j * B_j)   (standardized, missing -> 0)

so a window of W markers needs two (W,N)x(N,) products instead of W
sequential sparse dot products.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# h-packed DEVICE format ("hpack"): a load-time repack of the PLINK crumbs
# chosen so the on-device decode is minimal. Each 2-bit crumb stores
# h = 2 - genotype directly, with 3 = missing:
#
#     PLINK 00 (geno 2) -> 0      PLINK 10 (geno 1) -> 1
#     PLINK 11 (geno 0) -> 2      PLINK 01 (missing) -> 3
#
# Complete-data consumers then decode a plane with just shift+and+cast
# (3 ops vs 5 for the arithmetic h-decode of PLINK codes), and the mask
# falls out of one extra compare. The repack is a byte-level 256-entry
# LUT applied once on the host before device_put — GenotypeData.packed
# and every file format stay PLINK-coded; only sampler device arrays (and
# ops/window.py, which decodes them) speak hpack.
# ---------------------------------------------------------------------------

_HP_CRUMB = np.array([0, 3, 1, 2], dtype=np.uint8)     # PLINK code -> hpack


def _build_hpack_lut() -> np.ndarray:
    b = np.arange(256, dtype=np.uint16)
    out = np.zeros(256, dtype=np.uint8)
    for k in range(4):
        out |= _HP_CRUMB[(b >> (2 * k)) & 3] << (2 * k)
    return out


HPACK_LUT = _build_hpack_lut()
# hpack is a crumb bijection; the inverse recovers PLINK coding
UNHPACK_LUT = np.zeros(256, dtype=np.uint8)
UNHPACK_LUT[HPACK_LUT] = np.arange(256, dtype=np.uint8)


def hpack_bytes(packed: np.ndarray) -> np.ndarray:
    """PLINK-coded packed bytes -> h-packed device bytes (host-side LUT).

    Native OpenMP pass when available (the NumPy fancy-index runs at
    ~0.25 GB/s — minutes of setup at M=500K, days at UKB scale)."""
    from hydra_tpu import native

    out = native.bed_hpack(packed)
    if out is not None:
        return out
    # vectorized bitwise form of the crumb map 0->0,1->3,2->1,3->2:
    # out = (L << 1) | (L ^ H) with L/H the crumb low/high bit planes
    lo = packed & np.uint8(0x55)
    hi = (packed >> np.uint8(1)) & np.uint8(0x55)
    return ((lo << np.uint8(1)) | (lo ^ hi)).astype(np.uint8)


def unhpack_bytes(packed: np.ndarray) -> np.ndarray:
    """h-packed device bytes -> PLINK-coded bytes (inverse of hpack_bytes)."""
    return UNHPACK_LUT[packed]


def decode_planes(packed: jax.Array, dtype=jnp.float32) -> Tuple[jax.Array, jax.Array]:
    """Decode packed bytes (..., NB) uint8 -> (geno A, mask B), (..., NB*4).

    Arithmetic decode (no gather): cheaper than a table lookup on device.
    code = 0 -> (2,1); 1 -> (0,0); 2 -> (1,1); 3 -> (0,1).
    """
    b = packed
    c0 = b & 3
    c1 = (b >> 2) & 3
    c2 = (b >> 4) & 3
    c3 = (b >> 6) & 3
    codes = jnp.stack([c0, c1, c2, c3], axis=-1).reshape(*b.shape[:-1], -1)
    geno = jnp.where(codes == 0, 2, jnp.where(codes == 2, 1, 0)).astype(dtype)
    mask = (codes != 1).astype(dtype)
    return geno, mask


def standardized_window(
    packed: jax.Array, mave: jax.Array, mstd: jax.Array, dtype=jnp.float32
) -> jax.Array:
    """x~ = mstd * (A - mave * B) for a window: (W, NB) u8 -> (W, N) dtype.

    `mstd` is 1/sd for BayesRRm (BayesRRm.cpp:1507) and the same standardized
    column definition underlies sparse_scaadd's three-level scatter
    (BayesRRm.cpp:250-281).
    """
    A, B = decode_planes(packed, dtype)
    return (A - mave[:, None] * B) * mstd[:, None]


def window_dot(packed: jax.Array, eps: jax.Array, dtype=jnp.float32
               ) -> Tuple[jax.Array, jax.Array]:
    """(s1, s2) = (A @ eps, B @ eps) for a window of markers.

    Equivalent of the fused LUT dot product producing s1 = sum g*eps and
    s2 = sum mask*eps (BayesRRm.cpp:1774-1808).
    """
    A, B = decode_planes(packed, dtype)
    # HIGHEST: an f32 product may otherwise run in TF32 on the GPU
    hi = jax.lax.Precision.HIGHEST
    s1 = jnp.dot(A, eps, preferred_element_type=dtype, precision=hi)
    s2 = jnp.dot(B, eps, preferred_element_type=dtype, precision=hi)
    return s1, s2


@functools.partial(jax.jit, static_argnames=("block",))
def marker_counts(packed: jax.Array, block: int = 1024) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Per-marker counts (N1, N2, NM) from packed bytes.

    Feeds the marker statistics mave/mstd (BayesRRm.cpp:1502-1508); NM counts
    include any byte-level padding codes, so callers must pass rows whose pad
    columns are missing-coded and subtract structural padding themselves or
    (as GenotypeData does) count before padding individuals.
    """
    def count_block(pk):
        A, B = decode_planes(pk, jnp.float32)
        n1 = jnp.sum((A == 1.0) & (B == 1.0), axis=-1)
        n2 = jnp.sum(A == 2.0, axis=-1)
        nm = jnp.sum(B == 0.0, axis=-1)
        return n1, n2, nm

    m = packed.shape[0]
    outs1, outs2, outsm = [], [], []
    for s in range(0, m, block):
        n1, n2, nm = count_block(packed[s: s + block])
        outs1.append(n1)
        outs2.append(n2)
        outsm.append(nm)
    return (jnp.concatenate(outs1), jnp.concatenate(outs2), jnp.concatenate(outsm))
