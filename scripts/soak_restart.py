"""Production-cadence soak with a mid-flight kill (VERDICT r3 item 8).

A real production chain at M=100K x N=50K on the GPU with the production
thin/save cadence, SIGKILLed at ~60% of the chain, restarted with
--restart, and checked BITWISE against an uninterrupted same-seed run:

  1. full  : chain --iters iterations, timed (the writer-overhead anchor)
  2. cut   : same seed; the process is SIGKILLed once the csv shows
             iteration >= kill_at (a hard crash — no atexit, no flush)
  3. rs    : --restart from cut's last save; must resume at it+1
  4. compare cut_rs rows/records against full for every post-restart
     iteration: csv rows byte-equal, .bet/.cpn records byte-equal
  5. report wall/iteration for the full run vs the sweep-only bench rate
     (writer + host-pull + dispatch overhead as a % of sweep time)

Mirrors the reference's srun_restart.sh scenario (test/scripts/
srun_restart.sh:140-200) at production scale.

Usage: python scripts/soak_restart.py [--iters 2000] [--kill-at 1200]
       [--from-cache .cache_M1M_N50K.npz] [--m 100000] [--workdir /tmp/soak]
"""

import argparse
import os
import signal
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BED_MAGIC = b"\x6c\x1b\x01"


def build_inputs(cache, m, workdir, model="brr"):
    os.makedirs(workdir, exist_ok=True)
    base = os.path.join(workdir, "soak")
    if os.path.exists(base + ".bed"):
        print(f"# reusing {base}.bed", flush=True)
        _aux_inputs(base, model)
        return base
    t0 = time.time()
    with np.load(cache) as z:
        n = int(z["n"])
        nbytes = -(-n // 4)
        packed = z["packed"][:m, :nbytes]
        y = z["y"]
    with open(base + ".bed", "wb") as fh:
        fh.write(BED_MAGIC)
        packed.tofile(fh)
    with open(base + ".fam", "w") as fh:
        for i in range(n):
            fh.write(f"F{i} I{i} 0 0 1 -9\n")
    with open(base + ".bim", "w") as fh:
        for j in range(m):
            fh.write(f"1 rs{j} 0 {j} A C\n")
    with open(base + ".phen", "w") as fh:
        for i in range(n):
            fh.write(f"F{i} I{i} {y[i]:.6f}\n")
    print(f"# built {base}.* (M={m} N={n}) in {time.time() - t0:.0f} s",
          flush=True)
    _aux_inputs(base, model)
    return base


def _aux_inputs(base, model):
    """Survival (.fail + log-time phen) / second-trait files on demand."""
    rs = np.random.RandomState(97)
    y = np.array([float(l.split()[2]) for l in open(base + ".phen")])
    n = len(y)
    if model == "bw" and not os.path.exists(base + ".bw.phen"):
        # log event times from the same genetic signal; 80% events
        with open(base + ".bw.phen", "w") as fh:
            for i in range(n):
                fh.write(f"F{i} I{i} {4.0 + 0.25 * y[i]:.6f}\n")
        with open(base + ".fail", "w") as fh:
            for i in range(n):
                fh.write(f"{int(rs.random() < 0.8)}\n")
    if model == "mt" and not os.path.exists(base + ".t2.phen"):
        # second trait: shared signal + noise, 2% NA (the NaN-mask path)
        y2 = 0.7 * y + 0.71 * rs.randn(n) * y.std()
        with open(base + ".t2.phen", "w") as fh:
            for i in range(n):
                v = "NA" if rs.random() < 0.02 else f"{y2[i]:.6f}"
                fh.write(f"F{i} I{i} {v}\n")


def cli_args(base, out, name, iters, seed=None, restart=False, device="",
             model="brr"):
    bayes = "bayesWMPI" if model == "bw" else "bayesMPI"
    if model == "bw":
        pheno = base + ".bw.phen"
    elif model == "mt":
        pheno = base + ".phen," + base + ".t2.phen"
    else:
        pheno = base + ".phen"
    a = [sys.executable, "-m", "hydra_tpu.cli", "--mpibayes", bayes,
         "--bfile", base, "--pheno", pheno,
         "--mcmc-out-dir", out, "--mcmc-out-name", name,
         "--chain-length", str(iters), "--thin", "5", "--save", "20",
         "--S", "0.001,0.01,0.1"]
    if model == "bw":
        a += ["--failure", base + ".fail", "--sync-rate", "64"]
    if device:
        a += ["--device", device]
    if seed is not None:
        a += ["--seed", str(seed)]
    if restart:
        a += ["--restart"]
    return a


def last_csv_iter(path):
    try:
        with open(path) as fh:
            rows = fh.read().strip().split("\n")
        return int(rows[-1].split(",")[0]) if rows and rows[-1] else -1
    except (OSError, ValueError):
        return -1


def records(path, dtype, m):
    raw = open(path, "rb").read()
    rec, out = 4 + m * np.dtype(dtype).itemsize, {}
    for r in range((len(raw) - 4) // rec):
        chunk = raw[4 + r * rec: 4 + (r + 1) * rec]
        out[int(np.frombuffer(chunk[:4], np.uint32)[0])] = chunk[4:]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--kill-at", type=int, default=1200)
    ap.add_argument("--m", type=int, default=100_000)
    ap.add_argument("--from-cache", default=os.path.join(
        REPO, ".cache_M1M_N50K.npz"))
    ap.add_argument("--workdir", default="/tmp/soak")
    ap.add_argument("--seed", type=int, default=31)
    ap.add_argument("--device", default="",
                    help="CLI platform override (smoke tests on cpu)")
    ap.add_argument("--bench-ms", type=float, default=0.0,
                    help="sweep-only ms/sweep anchor for the overhead line "
                         "(e.g. the exact bench row at this shape)")
    ap.add_argument("--model", choices=("brr", "bw", "mt"), default="brr",
                    help="sampler family to soak (VERDICT r4 item 7: BayesW "
                         "and mt get the same SIGKILL/restart rehearsal)")
    args = ap.parse_args()

    base = build_inputs(args.from_cache, args.m, args.workdir, args.model)
    sub = "mcmc" if args.model == "brr" else "mcmc_" + args.model
    out = os.path.join(args.workdir, sub)
    os.makedirs(out, exist_ok=True)

    # 1. uninterrupted run, timed
    t0 = time.time()
    subprocess.run(cli_args(base, out, "full", args.iters, seed=args.seed,
                            device=args.device, model=args.model),
                   check=True, cwd=REPO,
                   stdout=open(os.path.join(args.workdir, "full.log"), "w"),
                   stderr=subprocess.STDOUT)
    wall_full = time.time() - t0
    per_it = wall_full / args.iters * 1e3
    print(f"# full run: {wall_full:.1f} s wall = {per_it:.2f} ms/iteration "
          f"(incl. setup+compile)", flush=True)
    if args.bench_ms:
        ovh = (per_it - args.bench_ms) / args.bench_ms * 100.0
        print(f"# writer+dispatch overhead vs sweep-only {args.bench_ms:.2f} "
              f"ms: {ovh:.1f}%", flush=True)

    # 2. cut run, SIGKILLed mid-flight
    proc = subprocess.Popen(
        cli_args(base, out, "cut", args.iters, seed=args.seed,
                 device=args.device, model=args.model), cwd=REPO,
        stdout=open(os.path.join(args.workdir, "cut.log"), "w"),
        stderr=subprocess.STDOUT)
    csv = os.path.join(out, "cut.t0.csv" if args.model == "mt"
                       else "cut.csv")
    while proc.poll() is None:
        if last_csv_iter(csv) >= args.kill_at:
            os.kill(proc.pid, signal.SIGKILL)  # exact pid, hard kill
            print(f"# SIGKILL at csv iteration {last_csv_iter(csv)}",
                  flush=True)
            break
        time.sleep(2)
    proc.wait()
    if proc.returncode == 0:
        raise SystemExit("cut run finished before the kill — raise --iters")

    # 3. restart (no --seed: must come from cut.rng.0)
    subprocess.run(cli_args(base, out, "cut", args.iters, restart=True,
                            device=args.device, model=args.model),
                   check=True, cwd=REPO,
                   stdout=open(os.path.join(args.workdir, "rs.log"), "w"),
                   stderr=subprocess.STDOUT)

    # 4. bitwise comparison post-restart (per-trait suffixes for mt)
    suffixes = [".t0", ".t1"] if args.model == "mt" else [""]
    for sfx in suffixes:
        _compare(out, args, sfx)


def _compare(out, args, sfx):
    fb = os.path.join(out, "full" + sfx)
    rb = os.path.join(out, "cut_rs" + sfx)
    full_rows = {int(r.split(",")[0]): r.strip()
                 for r in open(fb + ".csv").read().strip().split("\n")}
    rs_rows = {int(r.split(",")[0]): r.strip()
               for r in open(rb + ".csv").read().strip().split("\n")}
    assert rs_rows, "restart produced no csv rows"
    bad = [it for it, row in rs_rows.items() if row != full_rows.get(it)]
    assert not bad, f"csv rows differ post-restart: {bad[:5]}"
    full_bet = records(fb + ".bet", np.float64, args.m)
    rs_bet = records(rb + ".bet", np.float64, args.m)
    bad = [it for it in rs_bet if rs_bet[it] != full_bet.get(it)]
    assert not bad, f".bet records differ post-restart: {bad[:5]}"
    full_cpn = records(fb + ".cpn", np.int32, args.m)
    rs_cpn = records(rb + ".cpn", np.int32, args.m)
    bad = [it for it in rs_cpn if rs_cpn[it] != full_cpn.get(it)]
    assert not bad, f".cpn records differ post-restart: {bad[:5]}"
    print(f"# SOAK PASS [{args.model}{sfx}]: {len(rs_rows)} csv rows + "
          f"{len(rs_bet)} .bet + {len(rs_cpn)} .cpn records "
          f"bitwise-identical to the uninterrupted run after a SIGKILL at "
          f"~{args.kill_at}/{args.iters}", flush=True)


if __name__ == "__main__":
    main()
