"""f32 accuracy audit at reference scale N≈500K (VERDICT r1 item 10).

The reference is f64 end-to-end (BayesRRm.cpp passim); this rebuild
accumulates in f32 by default (--dtype float64 runs the f64 chain).
This audit measures what that costs at the reference's UK-Biobank scale
(N=458K -> we use 500K):

1. Deterministic op-level error: with a fixed f64 state, compute the
   N-length reductions the sampler relies on (e_sqn, per-marker s1/s2
   window dots, epsilon-update round trip) in f32 vs f64 and report
   relative errors.
2. Chain-level error: run two chains (same seed) with --dtype float32 and
   float64 and compare h2 posterior mean/sd; the dtype discrepancy must be
   small against the posterior spread.

Usage: python scripts/f32_audit.py [--n 500000] [--m 500] [--iters 150]
       [--out F32_AUDIT.md]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def op_level(m, n, seed=5):
    """Relative errors of the sampler's N-length f32 reductions vs f64."""
    rs = np.random.RandomState(seed)
    # genotypes in {0,1,2} with realistic MAF; eps ~ residual at h2=0.5
    maf = rs.uniform(0.05, 0.5, m)
    g = (rs.binomial(1, maf[:, None], (m, n))
         + rs.binomial(1, maf[:, None], (m, n))).astype(np.float64)
    eps = rs.randn(n) * np.sqrt(0.5)
    mave = g.mean(axis=1)
    mstd = 1.0 / g.std(axis=1)

    out = {}
    # e_sqn = eps . eps
    ref = float(eps @ eps)
    got = float(np.float32(eps.astype(np.float32) @ eps.astype(np.float32)))
    out["e_sqn"] = abs(got - ref) / abs(ref)

    # raw window dots s1 = G@eps, s2 = M@eps (the mainline statistics)
    s1_ref = g @ eps
    s1_f32 = (g.astype(np.float32) @ eps.astype(np.float32)).astype(np.float64)
    out["s1_dot"] = float(np.max(np.abs(s1_f32 - s1_ref)
                                 / np.maximum(np.abs(s1_ref), 1e-6)))

    # standardized num = mstd * (s1 - mave*sm) — catastrophic cancellation
    # candidate: s1 ~ mave*sum(eps) when beta=0
    sm_ref = eps.sum()
    num_ref = mstd * (s1_ref - mave * sm_ref)
    sm_f32 = float(np.float32(eps.astype(np.float32).sum()))
    num_f32 = (mstd.astype(np.float32)
               * (s1_f32.astype(np.float32) - mave.astype(np.float32) * sm_f32))
    scale = np.sqrt(float(eps @ eps) * n) / n  # typical |num| scale sqrt(N)*sd
    out["num_standardized"] = float(
        np.max(np.abs(num_f32.astype(np.float64) - num_ref)) / (scale * np.sqrt(n)))

    # epsilon update round trip: eps += db * x for 1000 sequential updates
    x = ((g - mave[:, None]) * mstd[:, None])
    db = rs.randn(m) * 0.01
    eps64 = eps.copy()
    eps32 = eps.astype(np.float32).copy()
    for j in range(m):
        eps64 += db[j] * x[j]
        eps32 += np.float32(db[j]) * x[j].astype(np.float32)
    out["eps_after_m_updates"] = float(
        np.max(np.abs(eps32.astype(np.float64) - eps64))
        / np.max(np.abs(eps64)))
    return out


def chain_level(m, n, iters, burn, seed=11):
    """h2 trajectories, f32 vs f64 sampler (same data, same seed)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from hydra_tpu.parallel.mesh import make_mesh
    from hydra_tpu.samplers.bayesrrm import BayesRRm
    from bench import make_problem

    ds = make_problem(m, n)
    res = {}
    for dt in ("float32", "float64"):
        sampler = BayesRRm(ds, window=64, seed=seed, mesh=make_mesh(1),
                           dtype=dt)
        state = sampler.init_state()
        h2s = []
        t0 = time.time()
        k = 10
        it = 0
        while it < iters:
            state, stats = sampler.run_steps(state, it, k)
            it += k
            if it > burn:
                sg = np.asarray(state.sigma_g, np.float64).sum()
                se = float(state.sigma_e)
                h2s.append(sg / (sg + se))
        h2s = np.asarray(h2s)
        res[dt] = dict(h2_mean=float(h2s.mean()), h2_sd=float(h2s.std()),
                       seconds=time.time() - t0)
        print(f"# chain {dt}: h2 = {h2s.mean():.4f} +- {h2s.std():.4f} "
              f"({time.time()-t0:.0f} s)", flush=True)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=500_000)
    ap.add_argument("--m", type=int, default=500)
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--burn", type=int, default=50)
    ap.add_argument("--chain-n", type=int, default=100_000)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    ops = op_level(args.m, args.n)
    print(json.dumps({"op_level": ops}), flush=True)
    chains = chain_level(args.m, args.chain_n, args.iters, args.burn)
    print(json.dumps({"chain_level": chains}), flush=True)

    if args.out:
        f32c, f64c = chains["float32"], chains["float64"]
        with open(args.out, "w") as fh:
            fh.write(f"# f32 accuracy audit (op level at N={args.n:,}, "
                     f"chains at N={args.chain_n:,}, M={args.m})\n\n"
                     "Reference is f64 end-to-end; hydra_tpu accumulates in "
                     "f32 by default.\n\n## Op-level relative error (f32 vs f64, "
                     "fixed state)\n\n| reduction | rel err |\n|---|---|\n")
            for k, v in ops.items():
                fh.write(f"| {k} | {v:.2e} |\n")
            fh.write("\n## Chain-level (same seed, window 64, "
                     f"{args.iters} iters)\n\n"
                     "| dtype | h2 mean | h2 sd |\n|---|---|---|\n")
            for dt in ("float32", "float64"):
                c = chains[dt]
                fh.write(f"| {dt} | {c['h2_mean']:.4f} | {c['h2_sd']:.4f} |\n")
            dd = abs(f32c["h2_mean"] - f64c["h2_mean"])
            fh.write(f"\nh2 mean discrepancy = {dd:.4f} vs posterior sd "
                     f"{f64c['h2_sd']:.4f} — "
                     f"{'OK (within 1 sd)' if dd < f64c['h2_sd'] else 'EXCEEDS 1 sd'}.\n")
        print(f"# wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
