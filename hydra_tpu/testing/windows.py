"""Recurrence inputs for one exact-mode window, built the way the sampler
builds them (bayesrrm._local_iteration): a standardised Gram from binomial
genotypes, the residual dot products, and BayesRRm or horseshoe mixture
constants. Shared by the kernel tests and chip_smoke.py, which compare the
Triton recurrence (ops/gibbs_kernel.window_gibbs) with its lax.scan."""

from __future__ import annotations

import numpy as np


def recurrence_window(W: int, K: int, seed: int = 0, inactive: bool = True,
                      fh: bool = False, n: int = 1024):
    """Arguments of window_gibbs / window_gibbs_scan as float32 NumPy arrays
    (gram, num0, logl_static, inv_denomk, sd_k, u, nrm, act, bold, i2se).
    inactive=True zeroes `act` for about a fifth of the markers."""
    rs = np.random.RandomState(seed)
    p = rs.uniform(0.05, 0.5, (W, 1))
    g = rs.binomial(2, p, (W, n)).astype(np.float64)
    sd = np.maximum(g.std(axis=1, keepdims=True), 1e-3)
    xt = (g - g.mean(axis=1, keepdims=True)) / sd
    km1 = K - 1
    sigma_e, sigma_g, dNm1 = 0.5, 0.5, n - 1.0
    if fh:
        lamt = rs.uniform(1e-4, 1e-2, W)
        denomk = dNm1 + np.repeat((sigma_e / lamt)[:, None], km1, 1)
        log_detk = np.repeat(np.log(lamt / sigma_e * dNm1 + 1.0)[:, None],
                             km1, 1)
    else:
        cva = np.logspace(-4, -1, km1)[None, :]
        denomk = dNm1 + sigma_e / (sigma_g * cva) + np.zeros((W, 1))
        log_detk = (np.log(sigma_g / sigma_e * dNm1 * cva + 1.0)
                    + np.zeros((W, 1)))
    log_pi = np.log(np.r_[0.5, np.full(km1, 0.5 / km1)])
    logl = np.concatenate([np.full((W, 1), log_pi[0]),
                           log_pi[1:] - 0.5 * log_detk], axis=1)
    invd = 1.0 / denomk
    y = rs.randn(n)
    act = np.ones(W) if not inactive else (rs.rand(W) > 0.2).astype(float)
    f32 = np.float32
    return (f32(xt @ xt.T), f32(xt @ y * 2.0), f32(logl), f32(invd),
            f32(np.sqrt(sigma_e * invd)), f32(rs.rand(W)), f32(rs.randn(W)),
            f32(act), f32(rs.randn(W) * 0.02), f32(0.5 / sigma_e))


def scan_cum_edges(args, dbeta_scan):
    """Cumulative component probabilities each marker's draw saw in the
    scan recurrence (float64, from the scan's own dbeta): (W, K)."""
    gram, num0, logl, invd = (np.asarray(a, np.float64) for a in args[:4])
    i2se = float(args[9])
    db = np.asarray(dbeta_scan, np.float64)
    W = gram.shape[0]
    # num_j = num0_j + sum_{t<j} Gram_jt dbeta_t
    num = num0 + np.sum(np.tril(gram, -1) * db[None, :], axis=1)
    muk = num[:, None] * invd
    logL = np.concatenate([logl[:, :1], logl[:, 1:] + muk * num[:, None] * i2se],
                          axis=1)
    pr = np.exp(logL - logL.max(axis=1, keepdims=True))
    return np.cumsum(pr / pr.sum(axis=1, keepdims=True), axis=1).reshape(W, -1)


def packed_window(W: int, n: int, missing: float, seed: int = 0):
    """A window of W markers over n real individuals, padded as the samplers
    pad them (pads missing-coded): (h-packed device bytes, geno, mask, mave,
    mstd), geno/mask decoded in float64 from the PLINK bytes by
    io/plink.decode_bed_numpy, mave/mstd arbitrary positive stats."""
    from hydra_tpu.data.genotypes import pad_individuals
    from hydra_tpu.io.plink import MISSING_CODE, decode_bed_numpy
    from hydra_tpu.ops.decode import hpack_bytes

    rs = np.random.RandomState(seed)
    n_pad = pad_individuals(n)
    # PLINK codes: 0 = hom alt (2), 2 = het (1), 3 = hom ref (0), 1 = missing
    codes = np.array([0, 2, 3], np.uint8)[rs.randint(0, 3, (W, n_pad))]
    if missing:
        codes[rs.rand(W, n_pad) < missing] = MISSING_CODE
    codes[:, n:] = MISSING_CODE
    plink = (codes[:, 0::4] | (codes[:, 1::4] << 2) | (codes[:, 2::4] << 4)
             | (codes[:, 3::4] << 6)).astype(np.uint8)
    g, m = decode_bed_numpy(plink, n_pad)
    return (hpack_bytes(plink), g.astype(np.float64), m.astype(np.float64),
            rs.uniform(0.2, 1.8, W), rs.uniform(0.5, 2.0, W))
