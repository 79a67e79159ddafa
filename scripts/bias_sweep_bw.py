"""BayesW stale-window posterior bias sweep (BIAS_SWEEP.md companion).

Same question as scripts/bias_sweep.py but for the Weibull survival sampler:
how does the window/sync-rate relaxation (epsilon and vi frozen within a
window, BayesW.cpp:1659-1850) shift the posterior? Runs W in {1, 8, 64, 256}
on a simulated age-at-onset problem with known Weibull shape alpha and
reports posterior mean / CI of alpha, sigmaG and the non-zero marker count.

W=1 is the reference's sequential sync-rate=1 semantics; its production
runs use sync-rate >= 5 across ranks.

Usage: python scripts/bias_sweep_bw.py [--iters 800] [--burn 300]
       [--m 4000] [--n 3000] [--out BIAS_SWEEP_BW.md] [--device cpu]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ALPHA_TRUE = 10.0


def make_survival(m, n, seed=1, cache=""):
    from bench import load_or_make_problem, make_problem

    ds = (load_or_make_problem(m, n, cache) if cache
          else make_problem(m, n, seed=seed))
    rs = np.random.RandomState(11)
    w = rs.gumbel(size=n)
    # log-time = mu + genetic signal + Gumbel/alpha (Weibull log-time model)
    ds.y = 4.0 + 0.02 * np.asarray(ds.y, np.float64) + w / ALPHA_TRUE
    ds.fail = (rs.random(n) > 0.2).astype(np.float64)
    return ds


def run_chain(ds, window, iters, burn, seed=101, quad=25):
    """Posterior trace with the chain advanced in fused 5-sweep blocks
    (run_steps is chain-identical to 5 step() calls and keeps the host out
    of the loop). Thinning is every 5 sweeps — the trace records the state
    after iterations 4, 9, ... >= burn."""
    import jax
    from hydra_tpu.parallel.mesh import make_mesh
    from hydra_tpu.samplers.bayesw import BayesW

    sampler = BayesW(ds, window=window, seed=seed, mesh=make_mesh(1),
                     quad_points=quad)
    state = sampler.init_state()
    alphas, sgs, m0s = [], [], []
    t0 = time.time()
    it = 0
    while it < iters:
        k = min(5, iters - it)
        state, stats = sampler.run_steps(state, it, k)
        it += k
        if it > burn:
            alphas.append(float(state.alpha))
            sgs.append(float(np.asarray(state.sigma_g).sum()))
            m0s.append(int(np.asarray(stats.m0)[-1].sum()))
    jax.block_until_ready(state.eps)
    dt = time.time() - t0
    alphas = np.asarray(alphas)
    sgs = np.asarray(sgs)
    return dict(window=window,
                alpha_mean=float(alphas.mean()),
                alpha_lo=float(np.percentile(alphas, 5)),
                alpha_hi=float(np.percentile(alphas, 95)),
                sg_mean=float(sgs.mean()),
                sg_lo=float(np.percentile(sgs, 5)),
                sg_hi=float(np.percentile(sgs, 95)),
                m0_mean=float(np.mean(m0s)), seconds=dt,
                ms_per_sweep=dt / iters * 1e3)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=4_000)
    ap.add_argument("--n", type=int, default=3_000)
    ap.add_argument("--iters", type=int, default=800)
    ap.add_argument("--burn", type=int, default=300)
    ap.add_argument("--windows", default="1,8,64,256")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="", choices=["", "cpu", "gpu"],
                    help="default: $BIAS_DEVICE, else the CPU")
    ap.add_argument("--problem-cache", default="",
                    help="bench npz cache (marker-prefix slices allowed)")
    args = ap.parse_args()

    from hydra_tpu.platform import configure
    configure(args.device or os.environ.get("BIAS_DEVICE", "cpu"))

    ds = make_survival(args.m, args.n, cache=args.problem_cache)
    results = []
    for w in [int(x) for x in args.windows.split(",") if x]:
        r = run_chain(ds, w, args.iters, args.burn)
        r["label"] = f"stale W={w}"
        print(json.dumps(r), flush=True)
        results.append(r)

    if args.out:
        with open(args.out, "w") as fh:
            fh.write(f"# BayesW stale-window bias sweep (M={args.m}, "
                     f"N={args.n}, true alpha={ALPHA_TRUE}, "
                     f"{args.iters} iters, burn {args.burn})\n\n")
            fh.write("| config | alpha mean | alpha 5-95% | sigmaG mean "
                     "| sigmaG 5-95% | m0 | ms/sweep |\n")
            fh.write("|---|---|---|---|---|---|---|\n")
            for r in results:
                fh.write(f"| {r['label']} | {r['alpha_mean']:.3f} "
                         f"| [{r['alpha_lo']:.3f}, {r['alpha_hi']:.3f}] "
                         f"| {r['sg_mean']:.5f} "
                         f"| [{r['sg_lo']:.5f}, {r['sg_hi']:.5f}] "
                         f"| {r['m0_mean']:.0f} "
                         f"| {r['ms_per_sweep']:.1f} |\n")
        print(f"# wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
