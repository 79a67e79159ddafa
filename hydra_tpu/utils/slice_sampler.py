"""Vectorized slice sampling — the JAX-native replacement for Gilks' ARMS.

The reference samples four log-concave conditionals (mu, fixed effects,
Weibull shape alpha, non-zero beta) with adaptive rejection metropolis
sampling (src/BayesW_arms.cpp, 922 LoC of envelope bookkeeping driven by C
rand()). On TPU that envelope construction is hostile (data-dependent piecewise
hulls); slice sampling (Neal 2003) has the same correct stationary
distribution for any continuous density, needs only log-density evaluations,
and vectorizes over a batch of independent draws — which is exactly the shape
of the windowed marker loop.

Fixed iteration budgets keep everything jit-compatible:
  * stepping-out with `n_expand` fixed width steps each side,
  * shrinkage with `n_shrink` rejection steps.
For log-concave targets the shrinkage loop accepts geometrically fast; if the
budget is ever exhausted the current point is kept (a no-op Gibbs step —
still a valid, if lazy, transition kernel).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp


def slice_noise(key: jax.Array, shape=(), n_shrink: int = 24):
    """The randomness one slice transition consumes, drawn from `key`:
    (log_exp (shape,), u_bracket (shape,), u_shrink (n_shrink,) + shape).

    Split exactly as slice_sample does internally; callers that need
    per-target keys (e.g. per-marker schedules) vmap this over keys and
    pass the stacked noise to slice_sample_noise."""
    k_h, k_u, k_s = jax.random.split(key, 3)
    le = jax.random.exponential(k_h, shape)
    ub = jax.random.uniform(k_u, shape)
    uu = jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(k_s, i), shape))(jnp.arange(n_shrink))
    return le, ub, uu


def slice_sample(
    logf: Callable,
    x0: jax.Array,
    key: jax.Array,
    width,
    lower=-jnp.inf,
    upper=jnp.inf,
    n_expand: int = 10,
    n_shrink: int = 24,
    mask=None,
    unroll: bool = False,
) -> jax.Array:
    """One slice-sampling transition for a batch of independent targets.

    logf: maps (B,) points -> (B,) log densities (vectorized over the batch;
          for a scalar target use shape ()).
    x0:   current points (B,).
    width: initial bracket width (scalar or (B,)).
    mask: optional (B,) bool; False lanes return x0 untouched (their logf
          values may be garbage — they never influence accepted lanes).
    unroll: statically unroll the expand/shrink loops. The different
          fusion boundaries break bitwise equality between step() and
          run_steps() dispatches, so it is off by default.
    """
    le, ub, uu = slice_noise(key, jnp.shape(x0), n_shrink)
    return slice_sample_noise(logf, x0, le, ub, uu, width, lower, upper,
                              n_expand=n_expand, n_shrink=n_shrink,
                              mask=mask, unroll=unroll)


def slice_sample_noise(
    logf: Callable,
    x0: jax.Array,
    log_exp: jax.Array,     # (B,) exponential draws for the level
    u_bracket: jax.Array,   # (B,) uniforms placing the initial bracket
    u_shrink: jax.Array,    # (n_shrink,) + (B,) shrink-step uniforms
    width,
    lower=-jnp.inf,
    upper=jnp.inf,
    n_expand: int = 10,
    n_shrink: int = 24,
    mask=None,
    unroll: bool = False,
) -> jax.Array:
    """slice_sample with the randomness passed in explicitly (slice_noise).

    Lets callers key the schedule per target (e.g. per MARKER by global
    slot id, so the draw stream is independent of window width and device
    count) while the transition math stays identical."""
    shape = jnp.shape(x0)
    f0 = logf(x0)
    log_y = f0 - log_exp

    u = u_bracket
    width = jnp.broadcast_to(jnp.asarray(width, x0.dtype), shape)
    left = x0 - width * u
    right = left + width

    def expand_body(_, lr):
        left, right = lr
        left = jnp.where((logf(left) > log_y) & (left > lower),
                         left - width, left)
        right = jnp.where((logf(right) > log_y) & (right < upper),
                          right + width, right)
        return left, right

    if unroll:
        lr = (left, right)
        for i in range(n_expand):
            lr = expand_body(i, lr)
        left, right = lr
    else:
        left, right = jax.lax.fori_loop(0, n_expand, expand_body,
                                        (left, right))
    left = jnp.maximum(left, lower)
    right = jnp.minimum(right, upper)

    def shrink_body(i, carry):
        left, right, x, accepted = carry
        uu = u_shrink[i]
        xc = left + uu * (right - left)
        ok = logf(xc) > log_y
        take = ok & jnp.logical_not(accepted)
        x = jnp.where(take, xc, x)
        accepted = accepted | ok
        shrinkable = jnp.logical_not(ok) & jnp.logical_not(accepted)
        left = jnp.where(shrinkable & (xc < x0), xc, left)
        right = jnp.where(shrinkable & (xc >= x0), xc, right)
        return left, right, x, accepted

    # (x0 != x0) is all-False with x0's varying-axes type — keeps the carry
    # consistent under shard_map's manual-axes checking.
    carry = (left, right, x0, x0 != x0)
    if unroll:
        for i in range(n_shrink):
            carry = shrink_body(i, carry)
        _, _, x, accepted = carry
    else:
        _, _, x, accepted = jax.lax.fori_loop(
            0, n_shrink, shrink_body, carry)
    x = jnp.where(accepted, x, x0)
    if mask is not None:
        x = jnp.where(mask, x, x0)
    return x
