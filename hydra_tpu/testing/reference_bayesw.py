"""Slow NumPy golden model of one BayesW (Weibull survival) Gibbs sweep.

Independent sequential transcription of the reference's conditional updates
(BayesW.cpp): mu via mu_dens (:77-88), Weibull shape via alpha_dens
(:132-142), per-marker adaptive Gauss-Hermite marginal likelihoods
(gh_integrand_adaptive :161-169, marginal_likelihood_vec_calc :713-726 —
including the sigma_ad Jacobian the reference returns at :711), the
component draw against the spike marginal pi_0*sqrt(pi) (:1473, :1536), the
non-zero beta draw from beta_dens (:145-156) inside the +-2*sqrt(sumSigmaG
* C_k) hull (:1562), and the group hypers sigmaG ~ inv-gamma(alpha_sigma +
m0/2, beta_sigma + m0*betasq/2) (:1893) and pi_L ~ Dirichlet(cass+1)
(:1899-1903).

The reference draws the scalar conditionals with Gilks' ARS
(BayesW_arms.cpp); here every scalar conditional is drawn by dense-grid
inverse-CDF sampling — numerically exact for log-concave densities and
completely independent of both ARS and the JAX sampler's slice sampler, so
posterior agreement between this model and hydra_tpu.samplers.bayesw
validates the slice-sampling replacement end to end.

All survival densities are evaluated in the mathematically identical
"expm1 form" (see samplers/bayesw.py module docstring) to stay finite in
float64 at any N.
"""

from __future__ import annotations

import numpy as np

EULER_MASCHERONI = 0.577215664901532
SQRT_PI = 1.77245385090552
ALPHA_0 = 0.01
KAPPA_0 = 0.01
SIGMA_MU = 100.0
ALPHA_SIGMA = 1.0
BETA_SIGMA = 0.0001


def grid_draw(logf, lo, hi, rng, n=4001):
    """Inverse-CDF draw from exp(logf) restricted to [lo, hi] on a dense
    grid (trapezoid CDF). Exact in the grid limit for smooth densities."""
    xs = np.linspace(lo, hi, n)
    lf = logf(xs)
    lf = lf - lf.max()
    w = np.exp(lf)
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (w[1:] + w[:-1]))])
    cdf /= cdf[-1]
    u = rng.uniform()
    return float(np.interp(u, cdf, xs))


def sweep(
    xt: np.ndarray,        # (M, N) standardized genotypes ((g-mave)/sd; 0 for missing)
    geno: np.ndarray,      # (M, N) raw genotype codes 0/1/2 (-1 missing)
    mave: np.ndarray,      # (M,)
    msd: np.ndarray,       # (M,) standard deviation (bW convention, not 1/sd)
    eps0: np.ndarray,      # (N,) current residual y - mu - X beta
    fail: np.ndarray,      # (N,) failure indicators
    beta: np.ndarray,      # (M,)
    groups: np.ndarray,    # (M,)
    cva_nz: np.ndarray,    # (G, K-1) non-zero mixture values
    sigma_g: np.ndarray,   # (G,)
    mu: float,
    alpha: float,
    pi_l: np.ndarray,      # (G, K)
    rng: np.random.RandomState,
    quad_n: int = 25,
):
    m, n = xt.shape
    G, km1 = cva_nz.shape
    K = km1 + 1
    eps = eps0.astype(np.float64).copy()
    beta = beta.astype(np.float64).copy()
    d_events = fail.sum()

    gh_x, gh_w = np.polynomial.hermite.hermgauss(quad_n)
    gh_wa = gh_w * np.exp(gh_x * gh_x)          # adjusted weights

    # ---- 1. mu (mu_dens BayesW.cpp:77-88) ----
    # log f(x) = -alpha d x - sum_i exp(alpha (eps_i + mu - x) - EuMasc)
    #            - x^2 / (2 sigma_mu), expm1 form relative to x = mu
    w0 = np.exp(alpha * eps - EULER_MASCHERONI).sum()
    mu_old = mu
    sd_mu = 1.0 / (alpha * np.sqrt(n))

    def mu_logf(x):
        return (-alpha * d_events * x
                - w0 * np.expm1(-alpha * (x - mu_old))
                - x * x / (2.0 * SIGMA_MU))

    mu = grid_draw(mu_logf, mu_old - 8 * sd_mu, mu_old + 8 * sd_mu, rng)
    eps = eps + (mu_old - mu)

    # ---- 2. alpha (alpha_dens BayesW.cpp:132-142) ----
    vi_cur = np.exp(alpha * eps - EULER_MASCHERONI)
    c_lin = (eps * fail).sum() - KAPPA_0
    a_old = alpha
    sd_a = 0.8 * alpha / np.sqrt(max(d_events, 4.0))

    def alpha_logf(x):
        dx = x - a_old
        return ((ALPHA_0 + d_events - 1.0) * (np.log(x) - np.log(a_old))
                + dx * c_lin
                - (vi_cur[None, :] * np.expm1(np.outer(dx, eps))).sum(axis=1))

    alpha = grid_draw(lambda xs: alpha_logf(np.atleast_1d(xs)),
                      max(a_old - 8 * sd_a, 1e-6), a_old + 8 * sd_a, rng)

    # ---- 3. vi + sequential marker loop (BayesW.cpp:1480-1612) ----
    vi = np.exp(alpha * eps - EULER_MASCHERONI)
    comps = np.zeros(m, dtype=int)
    cass = np.zeros((G, K))
    sum_sigma_g = sigma_g.sum()

    # sum_failure per marker (BayesW.cpp:1222-1229)
    sum_fail = np.array([
        (((geno[j] == 1) * fail).sum() + 2.0 * ((geno[j] == 2) * fail).sum()
         - mave[j] * d_events) / msd[j]
        for j in range(m)])

    for j in range(m):
        g = groups[j]
        b_old = beta[j]
        # residual / vi without this marker's effect (tmp_vi recompute,
        # BayesW.cpp:1499-1516)
        eps_wo = eps + b_old * xt[j]
        vi_wo = np.exp(alpha * eps_wo - EULER_MASCHERONI)
        i0 = geno[j] == 0
        i1 = geno[j] == 1
        i2 = geno[j] == 2
        vi0 = vi_wo[i0].sum()
        vi1 = vi_wo[i1].sum()
        vi2 = vi_wo[i2].sum()
        vsum = vi_wo.sum()

        mean, sd = mave[j], msd[j]
        th0 = alpha * mean / sd
        th1 = alpha * (mean - 1.0) / sd
        th2 = alpha * (mean - 2.0) / sd
        sf = sum_fail[j]

        # marginal likelihoods (marginal_likelihood_vec_calc :713-726)
        exp_sum = (vi1 * (1 - 2 * mean) + 4 * (1 - mean) * vi2
                   + vsum * mean * mean) / (sd * sd)
        ml = np.empty(K)
        ml[0] = pi_l[g, 0] * SQRT_PI
        for k in range(km1):
            ck = cva_nz[g, k]
            sqrt2ck = np.sqrt(2.0 * ck * sigma_g[g])
            sigma_ad = 1.0 / np.sqrt(
                1.0 + alpha * alpha * sigma_g[g] * ck * exp_sum)
            s = sigma_ad * gh_x
            sq = s * sqrt2ck
            temp = (-alpha * sq * sf
                    - vi0 * np.expm1(th0 * sq)
                    - vi1 * np.expm1(th1 * sq)
                    - vi2 * np.expm1(th2 * sq)
                    - s * s)
            # sigma_ad Jacobian: reference returns sigma*temp (:711)
            ml[k + 1] = pi_l[g, k + 1] * sigma_ad * (gh_wa * np.exp(temp)).sum()

        probs = ml / ml.sum()
        u = rng.uniform()
        comp = int(np.searchsorted(np.cumsum(probs), u))
        comp = min(comp, K - 1)
        comps[j] = comp
        cass[g, comp] += 1

        if comp == 0:
            b_new = 0.0
        else:
            ck = cva_nz[g, comp - 1]
            safe = 2.0 * np.sqrt(sum_sigma_g * ck)

            def beta_logf(x):
                return (-alpha * x * sf
                        - vi0 * np.expm1(th0 * x)
                        - vi1 * np.expm1(th1 * x)
                        - vi2 * np.expm1(th2 * x)
                        - x * x / (2.0 * ck * sigma_g[g]))

            b_new = grid_draw(beta_logf, b_old - safe, b_old + safe, rng)

        eps = eps + (b_old - b_new) * xt[j]
        beta[j] = b_new
        vi = np.exp(alpha * eps - EULER_MASCHERONI)

    # ---- 4. hypers (BayesW.cpp:1885-1905) ----
    bsqn = np.zeros(G)
    for j in range(m):
        bsqn[groups[j]] += beta[j] ** 2
    m0 = cass.sum(axis=1) - cass[:, 0]
    for g in range(G):
        shape = ALPHA_SIGMA + 0.5 * m0[g]
        rate = BETA_SIGMA + 0.5 * m0[g] * bsqn[g]
        sigma_g[g] = rate / rng.gamma(shape)     # inv-gamma(shape, rate)
        draw = rng.gamma(cass[g] + 1.0)
        pi_l[g] = draw / draw.sum()

    return dict(eps=eps, beta=beta, comps=comps, mu=mu, alpha=alpha,
                sigma_g=sigma_g, pi_l=pi_l, cass=cass, m0=m0, bsqn=bsqn)
