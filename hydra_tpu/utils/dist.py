"""JAX-native samplers replacing the reference's boost RNG wrapper.

Equivalents of Distributions_boost (src/distributions_boost.cpp:28-136):
norm_rng, gamma_rng (shape/scale and shape/rate), inv_gamma_rng,
inv_gamma_rate_rng, inv_scaled_chisq_rng, beta_rng, dirichlet_rng, unif_rng.

The reference uses a per-rank boost::mt19937 with sequential draws; here
every draw site receives an explicit counter-based key, derived from
(seed, iteration, site), which makes results independent of device count and
execution order. Bit-exact replication of boost streams is impossible and not
attempted — acceptance is distributional (the reference itself accepts
compiler-dependent shuffles, BayesRRm.cpp:1688-1690).

All functions are jit/vmap-safe and operate in float32 by default (float64
when jax_enable_x64 is on and dtype passed).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def norm_rng(key, mean, sigma2, shape=(), dtype=jnp.float32):
    """N(mean, sigma2) — note: second arg is the *variance*
    (distributions_boost.cpp:109-113)."""
    mean = jnp.asarray(mean, dtype)
    std = jnp.sqrt(jnp.asarray(sigma2, dtype))
    return mean + std * jax.random.normal(key, shape or jnp.shape(mean), dtype)


def unif_rng(key, shape=(), dtype=jnp.float32):
    return jax.random.uniform(key, shape, dtype)


def gamma_rng(key, shape_param, scale=1.0, shape=(), dtype=jnp.float32):
    """Gamma(shape, scale) (distributions_boost.cpp:57-61, 93-95)."""
    g = jax.random.gamma(key, jnp.asarray(shape_param, dtype),
                         shape or jnp.shape(shape_param), dtype)
    return g * jnp.asarray(scale, dtype)


def gamma_rate_rng(key, shape_param, rate, shape=(), dtype=jnp.float32):
    """Gamma with rate parameterization (distributions_boost.cpp:101-103)."""
    return gamma_rng(key, shape_param, 1.0 / jnp.asarray(rate, dtype), shape, dtype)


def inv_gamma_rng(key, shape_param, scale, shape=(), dtype=jnp.float32):
    """InvGamma(shape, scale): 1/Gamma(shape, 1/scale)
    (distributions_boost.cpp:89-91)."""
    return 1.0 / gamma_rng(key, shape_param, 1.0 / jnp.asarray(scale, dtype), shape, dtype)


def inv_gamma_rate_rng(key, shape_param, rate, shape=(), dtype=jnp.float32):
    """1/Gamma(shape, rate-parameterized) (distributions_boost.cpp:97-99)."""
    return 1.0 / gamma_rate_rng(key, shape_param, rate, shape, dtype)


def inv_scaled_chisq_rng(key, dof, scale, shape=(), dtype=jnp.float32):
    """Scaled inverse chi-squared: InvGamma(dof/2, dof*scale/2)
    (distributions_boost.cpp:105-107)."""
    dof = jnp.asarray(dof, dtype)
    return inv_gamma_rng(key, 0.5 * dof, 0.5 * dof * jnp.asarray(scale, dtype),
                         shape, dtype)


def beta_rng(key, a, b, shape=(), dtype=jnp.float32):
    """Beta(a, b) via two gammas (distributions_boost.cpp:132-136).

    Ga/(Ga+Gb) construction: jax.random.beta's direct path compiles orders of
    magnitude slower on some backends; the gamma route is equivalent.
    """
    k1, k2 = jax.random.split(key)
    ga = jax.random.gamma(k1, jnp.asarray(a, dtype), shape or None, dtype)
    gb = jax.random.gamma(k2, jnp.asarray(b, dtype), shape or None, dtype)
    return ga / (ga + gb)


def dirichlet_rng(key, alpha, dtype=jnp.float32):
    """Dirichlet via gamma normalization (distributions_boost.cpp:79-87).

    alpha may be 1-D (returns 1-D) or 2-D (row-wise, returns same shape).
    """
    alpha = jnp.asarray(alpha, dtype)
    g = jax.random.gamma(key, alpha, alpha.shape, dtype)
    return g / jnp.sum(g, axis=-1, keepdims=True)
