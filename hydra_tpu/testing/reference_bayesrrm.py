"""Slow NumPy golden model of one BayesRRm Gibbs sweep.

Independent sequential transcription of the conditional updates described at
BayesRRm.cpp:1644-2690 (same math as hydra_tpu.samplers.bayesrrm, but written
in the naive per-marker order with NumPy RNG). Used by tests to validate the
JAX sampler's window/Gram batching against plain sequential Gibbs.
"""

from __future__ import annotations

import numpy as np


def sweep(
    xt: np.ndarray,        # (M, N) standardized genotypes (missing -> 0)
    y_eps: np.ndarray,     # (N,) current residual epsilon
    beta: np.ndarray,      # (M,)
    groups: np.ndarray,    # (M,) int
    mS: np.ndarray,        # (G, K) incl. zero column
    sigma_g: np.ndarray,   # (G,)
    sigma_e: float,
    mu: float,
    est_pi: np.ndarray,    # (G, K)
    rng: np.random.RandomState,
    v0e: float = 1e-4, s02e: float = 1e-4,
    v0g: float = 1e-4, s02g: float = 1e-4,
):
    m, n = xt.shape
    K = mS.shape[1]
    G = mS.shape[0]
    dN, dNm1 = float(n), float(n - 1)
    eps = y_eps.copy()
    beta = beta.copy()

    # mu update
    eps += mu
    mu = rng.normal(eps.sum() / dN, np.sqrt(sigma_e / dN))
    eps -= mu

    comps = np.zeros(m, dtype=int)
    i2se = 0.5 / sigma_e
    for j in range(m):
        g = groups[j]
        cva = mS[g, 1:]
        b_old = beta[j]
        num = xt[j] @ eps + b_old * dNm1
        denom = dNm1 + (sigma_e / sigma_g[g]) / cva
        muk = num / denom
        logL = np.concatenate([
            [np.log(est_pi[g, 0])],
            np.log(est_pi[g, 1:]) - 0.5 * np.log((sigma_g[g] / sigma_e) * dNm1 * cva + 1.0)
            + muk * num * i2se,
        ])
        pr = np.exp(logL - logL.max())
        pr /= pr.sum()
        u = rng.uniform()
        comp = int(np.searchsorted(np.cumsum(pr), u))
        comp = min(comp, K - 1)
        if comp == 0:
            b_new = 0.0
        else:
            b_new = rng.normal(muk[comp - 1], np.sqrt(sigma_e / denom[comp - 1]))
        comps[j] = comp
        eps += (b_old - b_new) * xt[j]
        beta[j] = b_new

    # group updates
    cass = np.zeros((G, K))
    for j in range(m):
        cass[groups[j], comps[j]] += 1
    bsqn = np.zeros(G)
    for j in range(m):
        bsqn[groups[j]] += beta[j] ** 2
    for g in range(G):
        m0 = cass[g].sum() - cass[g, 0]
        if m0 > 0:
            dof = v0g + m0
            scale = (bsqn[g] * m0 + v0g * s02g) / dof
            sigma_g[g] = (0.5 * dof * scale) / rng.gamma(0.5 * dof)
            alpha = cass[g] + 1.0
            draw = rng.gamma(alpha)
            est_pi[g] = draw / draw.sum()
        else:
            sigma_g[g] = 0.0
    e_sqn = eps @ eps
    dof = v0e + dN
    scale = (e_sqn + v0e * s02e) / dof
    sigma_e = (0.5 * dof * scale) / rng.gamma(0.5 * dof)
    return dict(eps=eps, beta=beta, comps=comps, mu=mu, sigma_g=sigma_g,
                sigma_e=sigma_e, est_pi=est_pi, cass=cass, bsqn=bsqn)
