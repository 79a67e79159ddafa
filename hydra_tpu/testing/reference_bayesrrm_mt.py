"""Slow NumPy golden model of one multi-trait BayesRRm Gibbs sweep.

Independent sequential transcription of the multi-trait conditional updates
(BayesRRm_mt.cpp:290-1426 semantics: per-trait residual/mu/sigmaE/sigmaG/pi,
NaN masks instead of individual removal :281-289, per-(trait,marker) masked
statistics :604-665). Written in the naive one-marker-at-a-time order with
NumPy RNG — no JAX, no windows, no sharing of dot products across traits —
so tests can pin the JAX sampler's batched (W,N)x(N,T) window updates
against plain sequential Gibbs.

The covariate block is the completed per-trait generalization of the
single-trait ridge sweep (BayesRRm.cpp:2648-2681); the reference's own mt
covariate code is unfinished (see samplers/bayesrrm_mt.py docstring).
"""

from __future__ import annotations

import numpy as np

V0E = 1e-4
S02E = 1e-4
V0G = 1e-4
S02G = 1e-4
S02F = 1.0


def sweep(
    g: np.ndarray,           # (M, N) raw genotype values, missing -> 0
    missmask: np.ndarray,    # (M, N) 1 where observed, 0 where missing
    trait_mask: np.ndarray,  # (N, T) 1 where the trait's phenotype is non-NA
    eps: np.ndarray,         # (N, T) residuals, masked entries held at 0
    beta: np.ndarray,        # (M, T)
    mave: np.ndarray,        # (M, T) per-(marker,trait) masked mean
    mstd: np.ndarray,        # (M, T) per-(marker,trait) masked 1/sd (0=dead)
    groups: np.ndarray,      # (M,) int
    mS: np.ndarray,          # (G, K) incl. zero column
    sigma_g: np.ndarray,     # (T, G)
    sigma_e: np.ndarray,     # (T,)
    mu: np.ndarray,          # (T,)
    est_pi: np.ndarray,      # (T, G, K)
    rng: np.random.RandomState,
    x_cov: np.ndarray | None = None,   # (N, F)
    gamma: np.ndarray | None = None,   # (F, T)
):
    m, n = g.shape
    T = trait_mask.shape[1]
    G, K = mS.shape
    eps = eps.copy()
    beta = beta.copy()
    sigma_g = sigma_g.copy()
    est_pi = est_pi.copy()
    dN = trait_mask.sum(axis=0)            # (T,) non-NA count per trait
    dNm1 = dN - 1.0

    # ---- per-trait mu updates ----
    mu_new = np.zeros(T)
    for t in range(T):
        eps[:, t] += mu[t] * trait_mask[:, t]
        mu_new[t] = rng.normal(eps[:, t].sum() / dN[t],
                               np.sqrt(sigma_e[t] / dN[t]))
        eps[:, t] -= mu_new[t] * trait_mask[:, t]

    comps = np.zeros((m, T), dtype=int)
    for j in range(m):
        grp = groups[j]
        cva = mS[grp, 1:]
        for t in range(T):
            if mstd[j, t] <= 0 or sigma_g[t, grp] <= 0:
                if beta[j, t] != 0.0:
                    # dead marker keeps no effect; fold it back first
                    xjt = mstd[j, t] * (g[j] - mave[j, t] * missmask[j])
                    eps[:, t] += beta[j, t] * xjt * trait_mask[:, t]
                    beta[j, t] = 0.0
                comps[j, t] = 0
                continue
            # masked standardized marker column for this trait
            xjt = mstd[j, t] * (g[j] - mave[j, t] * missmask[j])
            b_old = beta[j, t]
            num = xjt @ eps[:, t] + b_old * dNm1[t]
            denom = dNm1[t] + (sigma_e[t] / sigma_g[t, grp]) / cva
            muk = num / denom
            logL = np.concatenate([
                [np.log(max(est_pi[t, grp, 0], 1e-30))],
                np.log(np.maximum(est_pi[t, grp, 1:], 1e-30))
                - 0.5 * np.log((sigma_g[t, grp] / sigma_e[t]) * dNm1[t] * cva
                               + 1.0)
                + muk * num * (0.5 / sigma_e[t]),
            ])
            pr = np.exp(logL - logL.max())
            pr /= pr.sum()
            comp = int(np.searchsorted(np.cumsum(pr), rng.uniform()))
            comp = min(comp, K - 1)
            if comp == 0:
                b_new = 0.0
            else:
                b_new = rng.normal(muk[comp - 1],
                                   np.sqrt(sigma_e[t] / denom[comp - 1]))
            comps[j, t] = comp
            eps[:, t] += (b_old - b_new) * xjt * trait_mask[:, t]
            beta[j, t] = b_new

    # ---- per-(trait, group) hyperparameters ----
    cass = np.zeros((T, G, K))
    bsqn = np.zeros((T, G))
    for j in range(m):
        for t in range(T):
            cass[t, groups[j], comps[j, t]] += 1
            bsqn[t, groups[j]] += beta[j, t] ** 2
    for t in range(T):
        for grp in range(G):
            m0 = cass[t, grp].sum() - cass[t, grp, 0]
            if cass[t, grp].sum() > 0 and m0 > 0:
                dof = V0G + m0
                scale = (bsqn[t, grp] * m0 + V0G * S02G) / dof
                sigma_g[t, grp] = (0.5 * dof * scale) / rng.gamma(0.5 * dof)
                draw = rng.gamma(cass[t, grp] + 1.0)
                est_pi[t, grp] = draw / draw.sum()
            else:
                sigma_g[t, grp] = 0.0

    # ---- per-trait fixed-effects ridge sweep ----
    if x_cov is not None and x_cov.shape[1] > 0:
        gamma = gamma.copy()
        for i in rng.permutation(x_cov.shape[1]):
            for t in range(T):
                colm = x_cov[:, i] * trait_mask[:, t]
                g_old = gamma[i, t]
                denom_f = dNm1[t] + sigma_e[t] / S02F
                num_f = colm @ (eps[:, t] + g_old * colm)
                g_new = (num_f / denom_f
                         + rng.normal() * np.sqrt(sigma_e[t] / denom_f))
                eps[:, t] += (g_old - g_new) * colm
                gamma[i, t] = g_new

    # ---- per-trait sigmaE ----
    sigma_e = sigma_e.copy()
    for t in range(T):
        e_sqn = eps[:, t] @ eps[:, t]
        dof = V0E + dN[t]
        scale = (e_sqn + V0E * S02E) / dof
        sigma_e[t] = (0.5 * dof * scale) / rng.gamma(0.5 * dof)

    return dict(eps=eps, beta=beta, comps=comps, mu=mu_new, sigma_g=sigma_g,
                sigma_e=sigma_e, est_pi=est_pi, cass=cass, gamma=gamma)
