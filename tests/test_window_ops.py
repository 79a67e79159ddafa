"""Window primitives on h-packed bytes (ops/window.py) against a float64
NumPy decode of the same PLINK bytes (io/plink.decode_bed_numpy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hydra_tpu.ops import window as wops
from hydra_tpu.testing.windows import packed_window


def make_window(W, n, missing, seed=0):
    pk, g, m, mave, mstd = packed_window(W, n, missing, seed)
    return jnp.asarray(pk), g, m, mave, mstd


def _rel(a, ref):
    return np.max(np.abs(np.asarray(a, np.float64) - ref)) / np.max(np.abs(ref))


def _f32(a):
    return jnp.asarray(np.asarray(a, np.float32))


CASES = [(0.0, 1001), (0.0, 2050), (0.03, 1001), (0.03, 2050)]
IDS = ["complete-n1001", "complete-n2050", "missing-n1001", "missing-n2050"]


@pytest.mark.parametrize("missing,n", CASES, ids=IDS)
def test_window_dots(missing, n):
    pk, g, m, mave, mstd = make_window(32, n, missing, seed=n)
    rs = np.random.RandomState(1)
    eps = np.zeros(g.shape[1])
    eps[:n] = rs.randn(n)
    xt = (g - mave[:, None] * m) * mstd[:, None]
    out = jax.jit(wops.window_dots)(pk, _f32(eps), _f32(mave), _f32(mstd))
    assert out.shape == (32,)
    assert _rel(out, xt @ eps) < 1e-5


@pytest.mark.parametrize("missing,n", CASES, ids=IDS)
def test_window_axpy(missing, n):
    pk, g, m, mave, mstd = make_window(24, n, missing, seed=n + 1)
    coef = np.random.RandomState(2).randn(24) * 0.1
    xt = (g - mave[:, None] * m) * mstd[:, None]
    out = jax.jit(wops.window_axpy)(pk, _f32(coef), _f32(mave), _f32(mstd))
    assert out.shape == (g.shape[1],)
    assert _rel(out, coef @ xt) < 1e-5
    # pad individuals decode to zero in both planes: no residual leaks there
    assert np.all(np.asarray(out)[n:] == 0)


@pytest.mark.parametrize("missing,n", CASES, ids=IDS)
def test_window_gram(missing, n):
    pk, g, m, mave, mstd = make_window(16, n, missing, seed=n + 2)
    xt = (g - mave[:, None] * m) * mstd[:, None]
    complete = missing == 0.0
    out = jax.jit(wops.window_gram, static_argnums=3)(
        pk, _f32(mave), _f32(mstd), complete, jnp.float32(n))
    assert _rel(out, xt @ xt.T) < 1e-5


@pytest.mark.parametrize("missing", [0.0, 0.03], ids=["complete", "missing"])
def test_integer_gram_parts_are_exact(missing):
    """The bf16 integer-plane products equal the float64 integer Grams
    exactly (values in {0, 1, 2}, sums far below 2^24)."""
    pk, g, m, _, _ = make_window(32, 3001, missing, seed=7)
    pk_r, g_r, m_r, _, _ = make_window(32, 3001, missing, seed=8)
    parts = jax.jit(wops.gram_parts, static_argnums=2)(
        pk, pk_r, missing == 0.0)
    if missing == 0.0:
        G, v, v_r = (np.asarray(p, np.float64) for p in parts)
        np.testing.assert_array_equal(G, g @ g_r.T)
        np.testing.assert_array_equal(v, g.sum(1))
        np.testing.assert_array_equal(v_r, g_r.sum(1))
    else:
        GG, GM, MG, MM = (np.asarray(p, np.float64) for p in parts)
        np.testing.assert_array_equal(GG, g @ g_r.T)
        np.testing.assert_array_equal(GM, g @ m_r.T)
        np.testing.assert_array_equal(MG, m @ g_r.T)
        np.testing.assert_array_equal(MM, m @ m_r.T)


@pytest.mark.parametrize("missing", [0.0, 0.03], ids=["complete", "missing"])
def test_multitrait_dots_and_axpy(missing):
    """(N, T) residuals with per-(marker, trait) stats, as BayesRRm-mt."""
    n, W, T = 1501, 16, 3
    pk, g, m, _, _ = make_window(W, n, missing, seed=9)
    rs = np.random.RandomState(3)
    mave = rs.uniform(0.2, 1.8, (W, T))
    mstd = rs.uniform(0.5, 2.0, (W, T))
    eps = np.zeros((g.shape[1], T))
    eps[:n] = rs.randn(n, T)
    coef = rs.randn(W, T) * 0.1
    dots = jax.jit(wops.window_dots)(pk, _f32(eps), _f32(mave), _f32(mstd))
    axpy = jax.jit(wops.window_axpy)(pk, _f32(coef), _f32(mave), _f32(mstd))
    ref_dots = np.stack([((g - mave[:, t, None] * m) * mstd[:, t, None])
                         @ eps[:, t] for t in range(T)], axis=1)
    ref_axpy = np.stack([coef[:, t] @ ((g - mave[:, t, None] * m)
                                        * mstd[:, t, None])
                         for t in range(T)], axis=1)
    assert dots.shape == (W, T) and axpy.shape == (g.shape[1], T)
    assert _rel(dots, ref_dots) < 1e-5
    assert _rel(axpy, ref_axpy) < 1e-5


@pytest.mark.parametrize("missing", [0.0, 0.03], ids=["complete", "missing"])
def test_level_sums(missing):
    """BayesW's per-class partial sums (partial_sum, BayesW.cpp:49-65)."""
    n = 1003
    pk, g, m, _, _ = make_window(16, n, missing, seed=11)
    vi = np.zeros(g.shape[1])
    vi[:n] = np.random.RandomState(4).exponential(1.0, n)
    s1, s2, sb = jax.jit(wops.level_sums)(pk, _f32(vi))
    assert _rel(s1, ((g == 1) & (m == 1)) @ vi) < 1e-5
    assert _rel(s2, (g == 2) @ vi) < 1e-5
    assert _rel(sb, m @ vi) < 1e-5


def test_planes_decode_pads_to_zero():
    pk, g, m, _, _ = make_window(4, 1001, 0.03, seed=5)
    gp, mp = wops.planes(pk)
    assert gp.shape == (4, pk.shape[1], 4)
    np.testing.assert_array_equal(np.asarray(gp).reshape(4, -1), g)
    np.testing.assert_array_equal(np.asarray(mp).reshape(4, -1), m)
