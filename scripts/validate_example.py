"""End-to-end validation on the example dataset — plot_example.R's check in
text form, for every sampler family:

  --model normal  per-annotation genetic variance vs simulated truth
                  (BayesRRm; the reference's example/plot_example.R check)
  --model fh      same data through bayesFHMPI (horseshoe); h2 via
                  sigmaG = beta_squaredNorm
  --model bayesw  Weibull.phen/fail; posterior alpha and h2_w vs
                  example/Weibull.h2 truth (alpha=10, h2~0.5)
  --model mt      normal.phen + normal2.phen as 2 traits; per-trait h2

Usage:
  python scripts/simulate_example.py --out /tmp/ex --m 2000 --n 2000
  python scripts/validate_example.py --dir /tmp/ex --chain 600 --burn 300 \
      [--model normal|fh|bayesw|mt]

Exit code 0 on PASS.
"""

import argparse
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def read_truth(path):
    truth = {}
    with open(path) as fh:
        for line in fh:
            k, v = line.split()
            truth[k] = float(v)
    return truth


def csv_post_burn(path, burn):
    rows = []
    with open(path) as fh:
        for line in fh:
            tok = [t.strip() for t in line.split(",")]
            if int(tok[0]) >= burn:
                rows.append(tok)
    return rows


def h2_gate(h2_chain, truth, label, floor=0.02, min_ess=100.0):
    """Posterior-sd-scaled PASS gate with an ESS requirement.

    The reference's plot_example.R eyeballs the posterior histogram against
    the simulated truth; the text form here requires (a) the posterior mean
    within max(3 posterior sd, floor) of truth and (b) split-R-hat ESS of
    the h2 chain >= min_ess so the sd estimate is actually meaningful
    (VERDICT r3: 600-iteration chains with a fixed 0.1 gate were too loose)."""
    from hydra_tpu.postproc import _split_rhat_ess

    h2_chain = np.asarray(h2_chain, dtype=np.float64)
    mean, sd = h2_chain.mean(), h2_chain.std()
    rhat, ess = _split_rhat_ess(h2_chain[None, :])
    tol = max(3.0 * sd, floor)
    ok = abs(mean - truth) < tol and ess >= min_ess
    print(f"{label}: h2 = {mean:.4f} +- {sd:.4f} vs truth {truth:.4f} "
          f"(|d| = {abs(mean - truth):.4f}, gate {tol:.4f}), "
          f"ESS = {ess:.0f} (>= {min_ess:.0f}), rhat = {rhat:.3f}"
          f" -> {'PASS' if ok else 'FAIL'}")
    return ok


def validate_normal(args, bed, fh_mode=False):
    from hydra_tpu.options import parse_args as popt
    from hydra_tpu.runner import run_bayesrrm

    out = os.path.join(args.dir, "mcmc_fh" if fh_mode else "mcmc")
    opt = popt([
        "--mpibayes", "bayesFHMPI" if fh_mode else "bayesMPI",
        "--bfile", bed,
        "--pheno", os.path.join(args.dir, "normal.phen"),
        "--groupIndexFile", os.path.join(args.dir, "normal.group"),
        "--groupMixtureFile", os.path.join(args.dir, "normal.mS"),
        "--chain-length", str(args.chain), "--thin", "5", "--save", "20",
        "--window", str(args.window),
        *([] if args.exact else ["--stale"]),
        "--mcmc-out-dir", out, "--mcmc-out-name", "ex",
        "--seed", str(args.seed),
    ])
    run_bayesrrm(opt, verbose=True)

    rows = csv_post_burn(os.path.join(out, "ex.csv"), args.burn)
    arr = []
    for tok in rows:
        g = int(tok[1])
        arr.append([float(v) for v in tok[2:2 + g]] + [float(tok[2 + g])])
    arr = np.asarray(arr)
    sg = arr[:, :-1].mean(axis=0)
    se = arr[:, -1].mean()
    truth = read_truth(os.path.join(args.dir, "normal.h2"))
    print(f"\nper-annotation variance: sigmaG = {sg}, sigmaE = {se:.4f}")
    print(f"a1 = {sg[0] / (sg.sum() + se):.4f} vs truth {truth['a1']:.4f}")
    print(f"a2 = {sg[1] / (sg.sum() + se):.4f} vs truth {truth['a2']:.4f}")
    sg_t = arr[:, :-1].sum(axis=1)
    h2_chain = sg_t / (sg_t + arr[:, -1])
    return h2_gate(h2_chain, truth["h2_est"], "fh" if fh_mode else "normal")


def validate_bayesw(args, bed):
    from hydra_tpu.options import parse_args as popt
    from hydra_tpu.runner_bayesw import run_bayesw

    out = os.path.join(args.dir, "mcmc_bw")
    opt = popt([
        "--mpibayes", "bayesWMPI", "--bfile", bed,
        "--pheno", os.path.join(args.dir, "Weibull.phen"),
        "--failure", os.path.join(args.dir, "Weibull.fail"),
        "--S", "0.001,0.01,0.1", "--quad_points", "15",
        "--chain-length", str(args.chain), "--thin", "5", "--save", "20",
        "--window", str(min(args.window, 64)),
        "--mcmc-out-dir", out, "--mcmc-out-name", "exw",
        "--seed", str(args.seed),
    ])
    run_bayesw(opt, verbose=True)

    rows = csv_post_burn(os.path.join(out, "exw.csv"), args.burn)
    mu = np.mean([float(t[1]) for t in rows])
    alpha = np.mean([float(t[3]) for t in rows])
    h2w_chain = np.array([float(t[4]) for t in rows])
    truth = read_truth(os.path.join(args.dir, "Weibull.h2"))
    print(f"\nposterior: mu = {mu:.4f} vs {truth['mu']:.4f}, "
          f"alpha = {alpha:.3f} vs {truth['alpha']:.3f}")
    return (h2_gate(h2w_chain, truth["h2"], "bayesw h2_w", floor=0.05)
            and abs(alpha - truth["alpha"]) / truth["alpha"] < 0.2
            and abs(mu - truth["mu"]) < 0.1)


def validate_mt(args, bed):
    from hydra_tpu.options import parse_args as popt
    from hydra_tpu.runner import run_bayesrrm_mt

    out = os.path.join(args.dir, "mcmc_mt")
    opt = popt([
        "--mpibayes", "bayesMPI", "--bfile", bed,
        "--pheno", (os.path.join(args.dir, "normal.phen") + ","
                    + os.path.join(args.dir, "normal2.phen")),
        "--S", "0.001,0.01,0.1",
        "--chain-length", str(args.chain), "--thin", "5", "--save", "20",
        "--window", str(args.window),
        *([] if args.exact else ["--stale"]),
        "--mcmc-out-dir", out, "--mcmc-out-name", "exmt",
        "--seed", str(args.seed),
    ])
    run_bayesrrm_mt(opt, verbose=True)

    ok = True
    for t, h2file in ((0, "normal.h2"), (1, "normal2.h2")):
        rows = csv_post_burn(os.path.join(out, f"exmt.t{t}.csv"), args.burn)
        arr = []
        for tok in rows:
            g = int(tok[1])
            arr.append([float(v) for v in tok[2:2 + g]] + [float(tok[2 + g])])
        arr = np.asarray(arr)
        truth = read_truth(os.path.join(args.dir, h2file))
        sg_t = arr[:, :-1].sum(axis=1)
        h2_chain = sg_t / (sg_t + arr[:, -1])
        ok = h2_gate(h2_chain, truth["h2_est"], f"mt trait {t}") and ok
    return ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--model", default="normal",
                    choices=["normal", "fh", "bayesw", "mt"])
    ap.add_argument("--chain", type=int, default=600)
    ap.add_argument("--burn", type=int, default=300)
    ap.add_argument("--window", type=int, default=32)
    ap.add_argument("--exact", action="store_true",
                    help="validate the exact (Gram-corrected) default "
                         "semantics instead of --stale")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--device", default="", choices=["", "cpu", "gpu"],
                    help="cpu or gpu (default: the GPU)")
    args = ap.parse_args()

    from hydra_tpu.platform import configure
    configure(args.device)

    bed = glob.glob(os.path.join(args.dir, "*.bed"))[0][:-4]
    if args.model == "normal":
        ok = validate_normal(args, bed)
    elif args.model == "fh":
        ok = validate_normal(args, bed, fh_mode=True)
    elif args.model == "bayesw":
        ok = validate_bayesw(args, bed)
    else:
        ok = validate_mt(args, bed)
    print(f"VALIDATION ({args.model}):", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
