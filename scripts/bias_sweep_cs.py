"""Cross-shard exchange-interval bias sweep (VERDICT r3 item 1b).

Round 4 changed the multi-shard exact default from per-marker delta-beta
exchange (cross_sync=1, strict syncRate-1 parity, latency-bound: one scalar
all_gather per marker step) to one exchange per window (cross_sync=window:
no in-window collective at all — other shards' deltas ride the
window-boundary residual psum). This sweep quantifies what that relaxation
does to the posterior, exactly as BIAS_SWEEP.md did for stale windows:
D-shard chains at fixed window W for B in {1, 8, W} plus stale-W context,
posterior h2 mean/CI and m0 against truth.

Semantics ladder (markers j in a window, shards d):
  B=1   marker j sees ALL deltas t<j from every shard (reference syncRate=1)
  B     marker j sees own-shard deltas t<j + other shards' t < B*floor(j/B)
  B=W   own-shard deltas t<j + other shards' previous-window deltas only
  stale marker j sees NO deltas from this window (reference sync-rate=W,
        which freezes eps even on-rank — strictly staler than B=W)

Runs on the virtual CPU mesh (multi-shard exact needs D>1; one real chip).

Usage: python scripts/bias_sweep_cs.py [--iters 1000] [--burn 300]
       [--m 8000] [--n 4000] [--ndev 4] [--window 64] [--out BIAS_SWEEP_CS.md]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_chain(ds, window, exact, cross_sync, n_dev, iters, burn, seed=101):
    import jax
    from hydra_tpu.parallel.mesh import make_mesh
    from hydra_tpu.samplers.bayesrrm import BayesRRm

    sampler = BayesRRm(ds, window=window, exact=exact, seed=seed,
                       mesh=make_mesh(n_dev), cross_sync=cross_sync,
                       shuffle=True)
    state = sampler.init_state()
    h2s, m0s = [], []
    t0 = time.time()
    for it in range(iters):
        state, stats = sampler.step(state, it)
        if it >= burn and it % 5 == 0:
            sg = float(np.asarray(state.sigma_g).sum())
            se = float(state.sigma_e)
            h2s.append(sg / (sg + se))
            m0s.append(int(np.asarray(stats.m0).sum()))
    jax.block_until_ready(state.eps)
    dt = time.time() - t0
    h2s = np.asarray(h2s)
    return dict(window=window, exact=exact, cross_sync=cross_sync,
                h2_mean=float(h2s.mean()), h2_sd=float(h2s.std()),
                h2_lo=float(np.percentile(h2s, 5)),
                h2_hi=float(np.percentile(h2s, 95)),
                m0_mean=float(np.mean(m0s)), seconds=dt,
                ms_per_sweep=dt / iters * 1e3)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=8_000)
    ap.add_argument("--n", type=int, default=4_000)
    ap.add_argument("--ndev", type=int, default=4)
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--burn", type=int, default=300)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    # multi-shard exact needs >1 device: virtual CPU mesh
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count="
                               + str(max(8, args.ndev)))
    import jax
    jax.config.update("jax_platforms", "cpu")

    from bench import make_problem

    ds = make_problem(args.m, args.n)
    W = args.window
    configs = [("exact B=1 (syncRate-1 parity)", True, 1),
               ("exact B=8", True, 8),
               (f"exact B=W={W} (round-4 default)", True, W),
               (f"stale W={W} (reference sync-rate relaxation)", False, 0)]
    results = []
    for label, exact, cs in configs:
        r = run_chain(ds, W, exact, cs, args.ndev, args.iters, args.burn)
        r["label"] = label
        print(json.dumps(r), flush=True)
        results.append(r)

    if args.out:
        with open(args.out, "w") as fh:
            fh.write(f"# Cross-shard exchange-interval bias sweep "
                     f"(M={args.m}, N={args.n}, true h2=0.5, D={args.ndev} "
                     f"marker shards, window {W}, {args.iters} iters, "
                     f"burn {args.burn})\n\n")
            fh.write("Exact-mode multi-shard semantics vs the cross-shard "
                     "exchange interval B\n(--cross-sync; B=W is the round-4 "
                     "default: one exchange per window via the\nresidual "
                     "psum, zero in-window collectives). ms/sweep is virtual "
                     "CPU-mesh\ntime — comparative only, not device "
                     "performance.\n\n")
            fh.write("| config | h2 mean | h2 5-95% | m0 | ms/sweep |\n")
            fh.write("|---|---|---|---|---|\n")
            for r in results:
                fh.write(f"| {r['label']} | {r['h2_mean']:.4f} "
                         f"| [{r['h2_lo']:.4f}, {r['h2_hi']:.4f}] "
                         f"| {r['m0_mean']:.0f} | {r['ms_per_sweep']:.1f} |\n")
        print(f"# wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
