"""Exact-mode recurrence: the Triton kernel (Pallas interpreter on the CPU)
against the lax.scan the samplers run elsewhere, plus the wrapper's padding
and the kernel's lowering to Triton for CUDA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hydra_tpu.ops.gibbs_kernel import pow2, window_gibbs, window_gibbs_scan
from hydra_tpu.testing.windows import recurrence_window, scan_cum_edges


def make_inputs(W, K, seed=0, inactive=True, fh=False):
    return tuple(jnp.asarray(a) for a in recurrence_window(
        W, K, seed=seed, inactive=inactive, fh=fh))


def assert_recurrences_agree(a, b):
    """Same components (the CPU runs both in f32 with no draw near a
    cumulative-probability edge at these seeds; chip_smoke.py allows edge
    flips on the card); beta/dbeta/acum equal to 1e-4 relative."""
    dbeta_a, bnew_a, comp_a, acum_a = (np.asarray(x) for x in a)
    dbeta_b, bnew_b, comp_b, acum_b = (np.asarray(x) for x in b)
    np.testing.assert_array_equal(comp_a, comp_b)
    same = comp_a == comp_b
    scale = max(np.max(np.abs(bnew_b)), 1e-6)
    np.testing.assert_allclose(bnew_a[same], bnew_b[same], rtol=1e-4,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(dbeta_a[same], dbeta_b[same], rtol=1e-4,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(acum_a[same], acum_b[same], rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("inactive", [False, True], ids=["all_active",
                                                         "some_inactive"])
@pytest.mark.parametrize("K", [2, 3, 4, 5])
@pytest.mark.parametrize("W", [8, 16, 64, 128])
def test_kernel_matches_scan(W, K, inactive):
    args = make_inputs(W, K, seed=W * 10 + K, inactive=inactive)
    ker = window_gibbs(*args, interpret=True)
    ref = jax.jit(window_gibbs_scan)(*args)
    assert_recurrences_agree(ker, ref)
    act = np.asarray(args[7]) > 0
    # inactive markers stay at the spike with P(zero) reported as 1
    assert np.all(np.asarray(ker[2])[~act] == 0)
    assert np.all(np.asarray(ker[1])[~act] == 0)
    assert np.all(np.asarray(ker[3])[~act] == 1)
    assert (np.asarray(ker[2]) > 0).any()          # the chain did move


def test_kernel_matches_scan_horseshoe_constants():
    args = make_inputs(64, 4, seed=3, fh=True)
    assert_recurrences_agree(window_gibbs(*args, interpret=True),
                             jax.jit(window_gibbs_scan)(*args))


@pytest.mark.parametrize("W,Wp", [(5, 8), (24, 32), (100, 128)])
def test_wrapper_pads_to_power_of_two(W, Wp):
    assert pow2(W, 8) == Wp
    args = make_inputs(W, 3, seed=W)
    out = window_gibbs(*args, interpret=True)
    assert [o.shape for o in out] == [(W,)] * 4
    assert out[2].dtype == jnp.int32
    assert_recurrences_agree(out, jax.jit(window_gibbs_scan)(*args))


def test_pow2_floor_and_exact_powers():
    assert [pow2(n) for n in (1, 2, 3, 4, 5, 127, 128, 129)] == \
        [1, 2, 4, 4, 8, 128, 128, 256]
    assert pow2(3, 8) == 8 and pow2(2, 2) == 2


@pytest.mark.parametrize("W,K", [(64, 4), (128, 4), (100, 5)])
def test_kernel_lowers_to_triton_for_cuda(W, K):
    """The compiled route (no interpreter) lowers to one Triton call for
    CUDA; compiling it to PTX happens on the card (chip_smoke.py)."""
    args = make_inputs(W, K)
    exp = jax.export.export(
        jax.jit(window_gibbs), platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(*args)
    text = exp.mlir_module()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert "num_warps = 1" in text


def test_scan_cum_edges_reproduce_the_scan_components():
    """The float64 replay of the scan's draws (used on the card to tell an
    edge flip from a wrong draw) gives the scan's own components."""
    args = make_inputs(64, 4, seed=5)
    db, _, comp, _ = jax.jit(window_gibbs_scan)(*args)
    cum = scan_cum_edges(args, db)
    u = np.asarray(args[5], np.float64)[:, None]
    replay = np.minimum((u > cum).sum(axis=1), 3)
    act = np.asarray(args[7]) > 0
    np.testing.assert_array_equal(np.where(act, replay, 0), np.asarray(comp))
