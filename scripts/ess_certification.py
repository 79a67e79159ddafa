"""ESS/second certification of the shipped defaults (VERDICT r4 item 4).

At production scale (M=100K x N=50K, the /tmp/soak panel from
scripts/soak_restart.py), run the candidate schedules/windows as REAL CLI
chains on the GPU and produce the decision-grade table:

    config x {s/sweep (chain proc time), ESS of h2/sigmaG/sigmaE per 1,000
    sweeps, ESS/s}

This converts BIAS_SWEEP_SCHED.md's 3-seed posterior-mean argument for the
block schedule into a mixing-efficiency measurement: stale windows and the
block schedule only earn their speed if the ESS each wall-second buys is
higher than exact+marker's.

Usage:
    python scripts/soak_restart.py --iters 0   # (once) builds /tmp/soak data
    python scripts/ess_certification.py [--iters 2000] [--burnin-rec 60]
        [--configs exact_block,stale_w256_block,...] [--out ESS_CERT.md]
"""

import argparse
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CONFIGS = {
    # name: (extra CLI flags)
    "exact_block": ["--window", "128"],
    "exact_marker": ["--window", "128", "--schedule", "marker"],
    "stale_w64_block": ["--stale", "--sync-rate", "64"],
    "stale_w256_block": ["--stale", "--sync-rate", "256"],
    "stale_w256_marker": ["--stale", "--sync-rate", "256",
                          "--schedule", "marker"],
}


def run_config(name, flags, base, iters, workdir):
    out = os.path.join(workdir, "ess_" + name)
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, "-m", "hydra_tpu.cli", "--mpibayes", "bayesMPI",
           "--bfile", base, "--pheno", base + ".phen",
           "--mcmc-out-dir", out, "--mcmc-out-name", "c",
           "--chain-length", str(iters), "--thin", "5", "--save", "500",
           "--seed", "1234", "--S", "0.001,0.01,0.1"] + flags
    t0 = time.time()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=7200,
                       env=env)
    wall = time.time() - t0
    if r.returncode != 0:
        print(f"FAILED {name}:\n{r.stdout[-1500:]}\n{r.stderr[-1500:]}",
              flush=True)
        return None
    m = re.search(r"time to process the data: ([0-9.]+) sec", r.stdout)
    proc_s = float(m.group(1)) if m else wall
    return dict(out=os.path.join(out, "c.csv"), wall=wall, proc_s=proc_s,
                log=r.stdout)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--burnin-rec", type=int, default=60,
                    help="burn-in in thinned records (thin=5)")
    ap.add_argument("--base", default="/tmp/soak/soak")
    ap.add_argument("--workdir", default="/tmp/ess_cert")
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--out", default=os.path.join(REPO, "ESS_CERT.md"))
    args = ap.parse_args()

    from hydra_tpu import postproc

    rows = []
    for name in args.configs.split(","):
        flags = CONFIGS[name]
        print(f"== {name}: {' '.join(flags)}", flush=True)
        res = run_config(name, flags, args.base, args.iters, args.workdir)
        if res is None:
            continue
        stats = postproc.chain_stats([res["out"]], burnin=args.burnin_rec,
                                     out=sys.stderr)
        used_sweeps = args.iters - args.burnin_rec * 5
        frac = used_sweeps / args.iters
        row = dict(name=name, proc_s=res["proc_s"], wall=res["wall"],
                   ms_per_sweep=1000.0 * res["proc_s"] / args.iters)
        for p in ("h2", "sigmaG", "sigmaE"):
            ess = stats[p]["ess"]
            row[f"ess_{p}_per_1k"] = ess / used_sweeps * 1000.0
            row[f"ess_{p}_per_s"] = ess / (res["proc_s"] * frac)
            row[f"mean_{p}"] = stats[p]["mean"]
        rows.append(row)
        print(f"   {row['ms_per_sweep']:.1f} ms/sweep, "
              f"h2 ESS/1k = {row['ess_h2_per_1k']:.1f}, "
              f"h2 ESS/s = {row['ess_h2_per_s']:.2f}, "
              f"h2 mean = {row['mean_h2']:.4f}", flush=True)

    with open(args.out, "w") as fh:
        fh.write("# ESS/second certification — M=100K x N=50K "
                 f"(iters={args.iters}, thin=5, burnin {args.burnin_rec} "
                 "records; generator truth h2=0.5)\n\n")
        fh.write("Decision metric for the shipped defaults: does the faster "
                 "schedule also buy more EFFECTIVE samples per second?\n\n")
        fh.write("| config | ms/sweep | ESS(h2)/1k sweeps | ESS(h2)/s | "
                 "ESS(sigmaG)/s | ESS(sigmaE)/s | posterior h2 |\n")
        fh.write("|---|---|---|---|---|---|---|\n")
        for r in rows:
            fh.write(f"| {r['name']} | {r['ms_per_sweep']:.1f} | "
                     f"{r['ess_h2_per_1k']:.1f} | {r['ess_h2_per_s']:.2f} | "
                     f"{r['ess_sigmaG_per_s']:.2f} | "
                     f"{r['ess_sigmaE_per_s']:.2f} | "
                     f"{r['mean_h2']:.4f} |\n")
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
