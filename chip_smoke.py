#!/usr/bin/env python3
"""Smoke test of hydra_tpu on NVIDIA GPUs, through the entry points a user
calls (`python -m hydra_tpu.cli`, i.e. hydra_tpu.cli.main).

    python chip_smoke.py                # one card: the five phases below
    python chip_smoke.py --four-cards   # four cards of one host: marker
                                        # sharding only (phase four_cards)

One card:
  device      platform is the GPU; device kind, bytes_limit, card name and
              power limit.
  parity      the Triton exact-mode recurrence against its lax.scan (W=64
              and 128, K=4, inactive markers, BayesRRm and horseshoe
              constants), and the window dots / Gram / axpy against a
              float64 NumPy decode at N=50,000, W=128, complete and 2%
              missing; per-window times of both recurrences.
  main_path   exact BayesRRm (the default) through the CLI at M=100,000 x
              N=50,000 for 20 sweeps with thin 5 / save 10 writers; outputs
              finite; compile time, ms/sweep with the Triton recurrence and
              with the scan, peak device memory.
  samplers    stale BayesRRm, bayesFHMPI, bayesWMPI with a .fail file and
              two-trait BayesRRm (one trait 2% NA) through the CLI at the
              reference example shape M=10,000 x N=5,000.
  gpu_vs_cpu  one stale sweep on the GPU and, in a subprocess, on the CPU
              agree; 300 GPU sweeps recover h2 = 0.5 +- 0.1.

Four cards: exact BayesRRm at M=500,000 x N=50,000 through the CLI as one
process over 4 cards and as 4 processes x 1 card (--det-sync 1): .bet/.csv
bitwise equal; and a 300-sweep M=10,000 x N=5,000 chain on 4 cards vs 1
card: posterior-mean h2 within 0.05.

Every timing line carries the card's name and power limit. The last line of
stdout is one JSON object; it has "ok": true only when every phase passed.
Without a GPU, or without the hydra_tpu package beside this file, the script
exits non-zero and prints no result line. Generated data lives in
.smoke_data/ at the root of the checkout and is removed at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
ONE_CARD = ("device", "parity", "main_path", "samplers", "gpu_vs_cpu")
FOUR_CARDS = ("four_cards",)
# panel shapes (M markers, N individuals)
MAIN = (100_000, 50_000)      # main path, one card
EXAMPLE = (10_000, 5_000)     # the reference example shape
SHARDED = (500_000, 50_000)   # BASELINE.json's 4-way marker-shard config
PARITY_N = 50_000             # individuals of the window-ops parity check


def phases(four_cards: bool) -> tuple:
    """The phases a run makes: the four-card path alone, or the one-card
    phases."""
    return FOUR_CARDS if four_cards else ONE_CARD


def card_label() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of every visible card."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return " | ".join(l.strip() for l in r.stdout.splitlines()
                          if l.strip()) or "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


class Smoke:
    def __init__(self, work: str):
        self.work = work
        self.card = card_label()
        self.failed = []

    def say(self, msg: str):
        print(msg, flush=True)

    def timed(self, what: str, seconds: float, unit: str = "s"):
        val = seconds * 1e3 if unit == "ms" else seconds
        self.say(f"TIME  {what}: {val:.3f} {unit}  [{self.card}]")

    def check(self, cond: bool, what: str):
        self.say(f"{'PASS' if cond else 'FAIL'}  {what}")
        if not cond:
            self.failed.append(what)

    # ---------------------------------------------------------------- data
    def trio(self, name: str, m: int, n: int):
        """PLINK trio + .phen from bench.make_problem's blockwise generator
        (packed bytes only; never a dense (M, N) array). Returns (base,
        dataset)."""
        import numpy as np

        import bench

        base = os.path.join(self.work, name)
        t0 = time.perf_counter()
        ds = bench.make_problem(m, n)
        nb = -(-n // 4)
        with open(base + ".bed", "wb") as fh:
            fh.write(b"\x6c\x1b\x01")
            for s in range(0, m, 8192):
                fh.write(np.ascontiguousarray(
                    ds.geno.packed[s:s + 8192, :nb]).tobytes())
        with open(base + ".fam", "w") as fh:
            fh.writelines(f"f{i} i{i} 0 0 1 -9\n" for i in range(n))
        with open(base + ".bim", "w") as fh:
            fh.writelines(f"1 rs{j} 0 {j + 1} A C\n" for j in range(m))
        write_phen(base + ".phen", ds.y)
        self.timed(f"generate {name} M={m} N={n} trio", time.perf_counter() - t0)
        return base, ds

    # ------------------------------------------------------------- running
    def cli(self, tag: str, args: list) -> str:
        """hydra_tpu.cli.main in this process; returns its stdout."""
        from hydra_tpu.cli import main

        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(list(args))
        self.timed(f"CLI {tag} wall (load + compile + chain + writers)",
                   time.perf_counter() - t0)
        out = buf.getvalue()
        self.check(rc == 0, f"CLI {tag} exit code {rc}")
        return out


def write_phen(path: str, y, na=None):
    with open(path, "w") as fh:
        for i, v in enumerate(y):
            val = "NA" if na is not None and na[i] else f"{v:.6f}"
            fh.write(f"f{i} i{i} {val}\n")


def read_outputs(base: str):
    """(.bet records, .cpn records, .csv rows) of a BayesRRm run."""
    import numpy as np

    from hydra_tpu.postproc import _read_records

    bet = list(_read_records(base + ".bet", np.float64))
    cpn = list(_read_records(base + ".cpn", np.int32))
    with open(base + ".csv") as fh:
        rows = [[float(t) for t in line.split(",")] for line in fh
                if line.strip()]
    return bet, cpn, rows


def h2_posterior(rows, burn: int) -> float:
    """Posterior-mean h2 from BayesRRm .csv rows (it, G, sigmaG.., sigmaE,
    h2, ...)."""
    import numpy as np

    return float(np.mean([r[2 + int(r[1]) + 1] for r in rows if r[0] >= burn]))


def result_ms_per_sweep(stdout: str) -> float:
    """Median per-sweep proc time of the CLI's RESULT lines from it 10 on
    (the reference's format: seconds to 3 decimals, so 1 ms resolution)."""
    import numpy as np

    vals = []
    for line in stdout.splitlines():
        if line.startswith("RESULT : it") and "proc =" in line:
            it = int(line.split("it")[1].split(",")[0])
            if it >= 10:
                vals.append(float(line.split("proc =")[1].split("s,")[0]))
    return float(np.median(vals)) * 1e3 if vals else float("nan")


# =================================================================== phases
def phase_device(sm: Smoke):
    import jax

    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    sm.say(f"device: platform={dev.platform} kind={dev.device_kind} "
           f"count={len(jax.devices())} bytes_limit={stats.get('bytes_limit')}")
    sm.say(f"card: {sm.card}")
    sm.check(dev.platform == "gpu", "platform is gpu")
    sm.check(len(jax.devices()) == 1, "exactly one device")
    sm.check(stats.get("bytes_limit", 0) > 0, "device memory limit reported")


def phase_parity(sm: Smoke):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hydra_tpu.ops import window as wops
    from hydra_tpu.ops.gibbs_kernel import window_gibbs, window_gibbs_scan
    from hydra_tpu.testing.windows import (packed_window, recurrence_window,
                                           scan_cum_edges)

    ker_j, scan_j = jax.jit(window_gibbs), jax.jit(window_gibbs_scan)
    for W in (64, 128):
        for fh in (False, True):
            slots = agree = 0
            edge_ok = beta_ok = True
            worst = 0.0
            for seed in range(16):
                args = recurrence_window(W, 4, seed=seed, inactive=True,
                                         fh=fh, n=5000)
                k = [np.asarray(x) for x in ker_j(*args)]
                s = [np.asarray(x) for x in scan_j(*args)]
                same = k[2] == s[2]
                slots += W
                agree += int(same.sum())
                # a flip changes every later dot product: only the first is
                # attributable, and it must sit on a cumulative edge (f32
                # sums in another order)
                upto = W
                if not same.all():
                    upto = int(np.argmin(same))
                    cum = scan_cum_edges(args, s[0])[upto, :-1]
                    edge_ok &= bool(np.min(np.abs(args[5][upto] - cum)) < 1e-5)
                scale = max(float(np.max(np.abs(s[1]))), 1e-12)
                for a, b in ((k[0], s[0]), (k[1], s[1])):
                    err = float(np.max(np.abs(a[:upto] - b[:upto]),
                                       initial=0.0)) / scale
                    worst = max(worst, err)
                    beta_ok &= err <= 1e-4
            label = f"W={W} K=4 {'horseshoe' if fh else 'BayesRRm'}"
            sm.check(agree >= 0.999 * slots,
                     f"recurrence {label}: comp agrees on {agree}/{slots}")
            sm.check(edge_ok, f"recurrence {label}: flips only on edges")
            sm.check(beta_ok, f"recurrence {label}: beta/dbeta rel err "
                              f"{worst:.2e} <= 1e-4")
        # per-window time inside one jitted loop, as the sweep calls it
        args = [jnp.asarray(a) for a in recurrence_window(W, 4, seed=1,
                                                          n=5000)]
        for name, fn, reps in (("triton", window_gibbs, 400),
                               ("scan", window_gibbs_scan, 20)):
            sm.timed(f"recurrence {name} per window W={W}",
                     loop_time(fn, args, reps), "ms")

    n, W = PARITY_N, 128
    for missing in (0.0, 0.02):
        pk, g, m, mave, mstd = packed_window(W, n, missing, seed=3)
        rs = np.random.RandomState(4)
        eps = np.zeros(g.shape[1])
        eps[:n] = rs.randn(n)
        coef = rs.randn(W) * 0.01
        xt = (g - mave[:, None] * m) * mstd[:, None]
        f = lambda a: jnp.asarray(np.asarray(a, np.float32))
        complete = missing == 0.0
        dots, gram, axpy = jax.jit(
            lambda pk, e, mv, ms, c: (
                wops.window_dots(pk, e, mv, ms),
                wops.window_gram(pk, mv, ms, complete, jnp.float32(n)),
                wops.window_axpy(pk, c, mv, ms)))(
            jnp.asarray(pk), f(eps), f(mave), f(mstd), f(coef))
        tag = "complete" if complete else "2% missing"
        for name, got, ref in (("dots", dots, xt @ eps),
                               ("gram", gram, xt @ xt.T),
                               ("axpy", axpy, coef @ xt)):
            err = (np.max(np.abs(np.asarray(got, np.float64) - ref))
                   / np.max(np.abs(ref)))
            sm.check(err < 1e-5, f"window {name} {tag} N={n} W={W}: "
                                 f"rel err {err:.2e} < 1e-5")
        parts = jax.jit(lambda p: wops.gram_parts(p, complete=complete))(
            jnp.asarray(pk))
        exact = np.array_equal(np.asarray(parts[0], np.float64), g @ g.T)
        if not complete:
            exact &= np.array_equal(np.asarray(parts[3], np.float64), m @ m.T)
        sm.check(bool(exact), f"integer-plane Gram {tag} exactly equal")


def loop_time(fn, args, reps: int) -> float:
    """Seconds per call of fn inside one jitted fori_loop (median of 3)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    def body(i, acc):
        a = list(args)
        a[1] = a[1] + i.astype(jnp.float32) * 1e-4
        return acc + jnp.sum(fn(*a)[0])

    f = jax.jit(lambda: jax.lax.fori_loop(0, reps, body, jnp.float32(0)))
    f().block_until_ready()
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        f().block_until_ready()
        ts.append((time.perf_counter() - t0) / reps)
    return float(np.median(ts))


def sweep_times(sm: Smoke, ds, triton: bool, k: int, blocks: int):
    """(first call s, ms/sweep median) of exact BayesRRm, W=128, one card."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from hydra_tpu.parallel.mesh import make_mesh
    from hydra_tpu.samplers.bayesrrm import BayesRRm

    s = BayesRRm(ds, window=128, exact=True, seed=11, mesh=make_mesh(1))
    if s.cfg.use_triton != triton:
        s.cfg = dataclasses.replace(s.cfg, use_triton=triton)
        s._step = s._build_step()
    st = s.init_state()
    t0 = time.perf_counter()
    st, _ = s.run_steps(st, 0, k)
    float(jnp.sum(st.eps))
    first = time.perf_counter() - t0
    ts, it = [], k
    for _ in range(blocks):
        t0 = time.perf_counter()
        st, _ = s.run_steps(st, it, k)
        float(jnp.sum(st.eps))
        ts.append((time.perf_counter() - t0) / k)
        it += k
    sm.check(bool(np.isfinite(np.asarray(st.eps)).all()),
             f"library chain finite (triton={triton})")
    return first, float(np.median(ts)) * 1e3


def phase_main_path(sm: Smoke):
    import jax
    import numpy as np

    m, n = MAIN
    base, ds = sm.trio("main", m, n)
    out = os.path.join(sm.work, "out_main")
    stdout = sm.cli(f"exact BayesRRm M={m} N={n} 20 sweeps", [
        "--mpibayes", "bayesMPI", "--bfile", base, "--pheno", base + ".phen",
        "--mcmc-out-dir", out, "--mcmc-out-name", "main",
        "--chain-length", "20", "--thin", "5", "--save", "10", "--seed", "7",
        "--n-devices", "1"])
    bet, cpn, rows = read_outputs(os.path.join(out, "main"))
    sm.check([it for it, _ in bet] == [0, 5, 10, 15] and len(cpn) == 4
             and len(rows) == 4, "main path wrote 4 thinned .bet/.cpn/.csv "
                                 "records")
    sm.check(all(np.isfinite(v).all() and len(v) == m for _, v in bet)
             and all(np.isfinite(r).all() for r in rows),
             "main path outputs finite")
    sm.check(os.path.exists(os.path.join(out, "main.xbet")),
             "main path save writer ran")
    sm.say(f"main path: CLI RESULT ms/sweep {result_ms_per_sweep(stdout):.3f}"
           f"  [{sm.card}]")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    sm.say(f"main path: peak_bytes_in_use {peak}")
    del bet, cpn
    for triton, k, blocks in ((True, 5, 3), (False, 1, 2)):
        first, ms = sweep_times(sm, ds, triton, k, blocks)
        name = "triton" if triton else "scan"
        sm.timed(f"exact M={m} N={n} W=128 {name}: compile + first {k} "
                 f"sweep(s)", first)
        sm.timed(f"exact M={m} N={n} W=128 {name}: per sweep", ms / 1e3,
                 "ms")


def phase_samplers(sm: Smoke):
    import numpy as np

    from hydra_tpu.samplers.bayesw import EULER_MASCHERONI

    m, n = EXAMPLE
    base, ds = sm.trio("example", m, n)
    sm.base_example = base
    rs = np.random.RandomState(9)
    # survival transform of the same panel (bench._time_bayesw): log-time
    # with Weibull noise, 20% censored
    w = np.log(rs.exponential(1.0, n)) + EULER_MASCHERONI
    write_phen(base + ".wphen", 4.0 + 0.02 * np.asarray(ds.y) + w / 10.0)
    with open(base + ".fail", "w") as fh:
        fh.writelines(f"{int(v)}\n" for v in rs.random(n) > 0.2)
    write_phen(base + ".t2phen", np.asarray(ds.y) + rs.randn(n) * 0.5,
               na=rs.random(n) < 0.02)
    common = ["--bfile", base, "--chain-length", "10", "--thin", "5",
              "--save", "10", "--seed", "3", "--n-devices", "1"]
    runs = (
        ("stale", ["--mpibayes", "bayesMPI", "--pheno", base + ".phen",
                   "--stale", "--window", "64"], ["stale"]),
        ("fh", ["--mpibayes", "bayesFHMPI", "--pheno", base + ".phen"],
         ["fh"]),
        ("bw", ["--mpibayes", "bayesWMPI", "--pheno", base + ".wphen",
                "--failure", base + ".fail", "--window", "32"], ["bw"]),
        ("mt", ["--mpibayes", "bayesMPI", "--pheno",
                base + ".phen," + base + ".t2phen"], ["mt.t0", "mt.t1"]),
    )
    out = os.path.join(sm.work, "out_samplers")
    for tag, args, outs in runs:
        sm.cli(f"{tag} M={m} N={n}", args + common + [
            "--mcmc-out-dir", out, "--mcmc-out-name", tag])
        for o in outs:
            bet, _, rows = read_outputs(os.path.join(out, o))
            sm.check(len(rows) == 2 and len(bet) == 2
                     and all(np.isfinite(r).all() for r in rows)
                     and all(np.isfinite(v).all() for _, v in bet),
                     f"{o}: 2 finite thinned records")


def phase_gpu_vs_cpu(sm: Smoke):
    import numpy as np

    base = (getattr(sm, "base_example", None)
            or sm.trio("example", *EXAMPLE)[0])
    out = os.path.join(sm.work, "out_cmp")
    flags = ["--mpibayes", "bayesMPI", "--bfile", base, "--pheno",
             base + ".phen", "--stale", "--window", "64", "--thin", "5",
             "--seed", "21", "--n-devices", "1", "--mcmc-out-dir", out]
    sm.cli("stale 300 sweeps (GPU)", flags + [
        "--chain-length", "300", "--save", "300", "--mcmc-out-name", "gpu"])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "hydra_tpu.cli", "--device", "cpu"] + flags
        + ["--chain-length", "1", "--save", "5", "--mcmc-out-name", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=900)
    sm.timed("CLI stale 1 sweep (CPU subprocess) wall",
             time.perf_counter() - t0)
    sm.check(r.returncode == 0, f"CPU run exit code {r.returncode}"
             + ("" if r.returncode == 0 else f": {r.stderr[-800:]}"))
    if r.returncode:
        return
    bg, cg, rg = read_outputs(os.path.join(out, "gpu"))
    bc, cc, rc = read_outputs(os.path.join(out, "cpu"))
    comp_g, comp_c = cg[0][1], cc[0][1]
    same = comp_g == comp_c
    sm.check(same.mean() >= 0.999,
             f"GPU vs CPU sweep 0: components agree on {same.mean():.5f}")
    dbeta = float(np.max(np.abs(bg[0][1][same] - bc[0][1][same])))
    sm.check(dbeta <= 2e-4, f"GPU vs CPU beta max diff {dbeta:.2e} <= 2e-4")
    se_g, se_c = rg[0][2 + int(rg[0][1])], rc[0][2 + int(rc[0][1])]
    rel = abs(se_g - se_c) / abs(se_c)
    sm.check(rel <= 2e-3, f"GPU vs CPU sigma_e rel diff {rel:.2e} <= 2e-3")
    h2 = h2_posterior(rg, 150)
    sm.check(abs(h2 - 0.5) <= 0.1, f"300 GPU sweeps: posterior h2 {h2:.4f} "
                                   "within 0.5 +- 0.1")


def run_cli_subprocess(sm: Smoke, tag: str, args: list, timeout=420) -> str:
    """The CLI in a child process (the parent holds no card memory in the
    four-card phase); returns its stdout."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "hydra_tpu.cli"] + args,
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=timeout)
    sm.timed(f"CLI {tag} wall", time.perf_counter() - t0)
    sm.check(r.returncode == 0, f"CLI {tag} exit code {r.returncode}"
             + ("" if r.returncode == 0 else f": {r.stderr[-800:]}"))
    return r.stdout


def four_bitwise(sm: Smoke, base: str, m: int, n: int, tag: str = "sharded",
                 timeout=420) -> bool:
    """Exact BayesRRm on the panel `base` with --det-sync 1 as 1 process x 4
    cards and as 4 processes x 1 card: .bet/.csv/.cpn must be bitwise
    equal."""
    import filecmp

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from run_multiprocess import launch, wait_all

    flags = ["--mpibayes", "bayesMPI", "--bfile", base, "--pheno",
             base + ".phen", "--chain-length", "20", "--thin", "5",
             "--save", "10", "--seed", "5", "--det-sync", "1"]
    out1 = os.path.join(sm.work, f"{tag}_1x4")
    out4 = os.path.join(sm.work, f"{tag}_4x1")
    so = run_cli_subprocess(sm, f"exact M={m} N={n}, 1 process x 4 cards",
                            flags + ["--n-devices", "4", "--mcmc-out-dir",
                                     out1, "--mcmc-out-name", "c"], timeout)
    sm.say(f"1x4 RESULT ms/sweep {result_ms_per_sweep(so):.3f}  [{sm.card}]")
    logs = os.path.join(sm.work, f"{tag}_logs")
    os.makedirs(logs, exist_ok=True)
    t0 = time.perf_counter()
    procs = launch(4, 1, flags + ["--mcmc-out-dir", out4,
                                  "--mcmc-out-name", "c"],
                   device="gpu", repo=ROOT, stdout_dir=logs)
    codes = wait_all(procs, timeout=timeout)
    sm.timed(f"CLI exact M={m} N={n}, 4 processes x 1 card wall",
             time.perf_counter() - t0)
    sm.check(codes == [0, 0, 0, 0], f"4x1 exit codes {codes}")
    for pid in range(4):
        with open(os.path.join(logs, f"proc{pid}.log")) as fh:
            text = fh.read()
        if codes != [0, 0, 0, 0]:
            sm.say(f"---- process {pid} log (tail)\n" + text[-3000:])
        elif pid == 0:
            sm.say(f"4x1 RESULT ms/sweep {result_ms_per_sweep(text):.3f}"
                   f"  [{sm.card}]")
    ok = True
    for ext in (".bet", ".csv", ".cpn"):
        a, b = (os.path.join(o, "c" + ext) for o in (out1, out4))
        same = os.path.exists(b) and filecmp.cmp(a, b, shallow=False)
        sm.check(same, f"1x4 vs 4x1 {ext} bitwise equal")
        ok &= same
    return ok and codes == [0, 0, 0, 0]


def four_h2(sm: Smoke, base: str):
    """300-sweep chains on the example panel `base` on 4 cards and on 1
    card: posterior-mean h2 within 0.05."""
    h2 = {}
    for nd in (1, 4):
        od = os.path.join(sm.work, f"out_h2_{nd}")
        so = run_cli_subprocess(
            sm, f"exact M={EXAMPLE[0]} N={EXAMPLE[1]} 300 sweeps on {nd} "
                "card(s)",
            ["--mpibayes", "bayesMPI", "--bfile", base, "--pheno",
             base + ".phen", "--chain-length", "300", "--thin", "5",
             "--save", "300", "--seed", "8", "--n-devices", str(nd),
             "--mcmc-out-dir", od, "--mcmc-out-name", "c"])
        sm.say(f"M={EXAMPLE[0]} N={EXAMPLE[1]} on {nd} card(s): RESULT "
               f"ms/sweep {result_ms_per_sweep(so):.3f}  [{sm.card}]")
        _, _, rows = read_outputs(os.path.join(od, "c"))
        h2[nd] = h2_posterior(rows, 150)
    diff = abs(h2[4] - h2[1])
    sm.check(diff <= 0.05, f"posterior h2 4 cards {h2[4]:.4f} vs 1 card "
                           f"{h2[1]:.4f}: |diff| {diff:.4f} <= 0.05")


def phase_four_cards(sm: Smoke):
    from concurrent.futures import ThreadPoolExecutor

    example = sm.trio("example", *EXAMPLE)[0]
    # the host generates the sharded panel while the cards run the example
    # chains
    with ThreadPoolExecutor(1) as pool:
        sharded = pool.submit(lambda: sm.trio("sharded", *SHARDED)[0])
        four_h2(sm, example)
        base = sharded.result()
    four_bitwise(sm, base, *SHARDED)


# ===================================================================== main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card marker-sharding phase")
    ap.add_argument("--keep-data", action="store_true",
                    help="keep the generated panels in .smoke_data/")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    try:
        from hydra_tpu.platform import NoDeviceError, configure
        import bench  # noqa: F401  (the panel generator)
    except ImportError as e:
        print(f"chip_smoke: the hydra_tpu checkout is not beside this file "
              f"({e})", file=sys.stderr)
        return 2
    if args.four_cards:
        # this process only checks the cards and starts the CLI processes;
        # it must not reserve their memory
        os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"
    try:
        configure("gpu")
    except NoDeviceError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    # the CLI processes started below reserve their cards' memory as usual
    os.environ.pop("XLA_PYTHON_CLIENT_PREALLOCATE", None)
    import jax

    devs = jax.devices()
    want = 4 if args.four_cards else 1
    if len(devs) < want:
        print(f"chip_smoke: needs {want} GPU(s), JAX sees {len(devs)}",
              file=sys.stderr)
        return 1

    work = os.path.join(ROOT, ".smoke_data")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    sm = Smoke(work)
    run = {"device": phase_device, "parity": phase_parity,
           "main_path": phase_main_path, "samplers": phase_samplers,
           "gpu_vs_cpu": phase_gpu_vs_cpu, "four_cards": phase_four_cards}
    t_all = time.perf_counter()
    try:
        for name in phases(args.four_cards):
            sm.say(f"==== phase {name}")
            t0 = time.perf_counter()
            try:
                run[name](sm)
            except Exception:           # a phase failure is reported, the
                traceback.print_exc()   # remaining phases still run
                sm.failed.append(f"phase {name} raised")
            sm.timed(f"phase {name}", time.perf_counter() - t0)
    finally:
        if not args.keep_data:
            shutil.rmtree(work, ignore_errors=True)
    sm.timed("all phases", time.perf_counter() - t_all)
    if sm.failed:
        sm.say("FAILED: " + "; ".join(sm.failed))
    sm.say(card_label())
    print(json.dumps({"ok": not sm.failed,
                      "device": {"platform": devs[0].platform,
                                 "kind": devs[0].device_kind,
                                 "count": len(devs)}}), flush=True)
    return 1 if sm.failed else 0


if __name__ == "__main__":
    sys.exit(main())
