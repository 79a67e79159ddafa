"""Benchmark: BayesRRm Gibbs sweep on the reference's example problem size.

Problem: M=10,000 markers x N=5,000 individuals (example/t_M10K_N_5K.dim) —
the reference's correctness/benchmark dataset. Metric (BASELINE.md): marker
updates/s per chip and wall-clock per full Gibbs sweep.

Baseline: the reference publishes no numbers and its binary cannot run here
(Intel MPI runtime absent). `vs_baseline` therefore compares against a
measured run of hydra_tpu's own faithful sequential NumPy implementation
(hydra_tpu/testing/reference_bayesrrm.py — same math, same per-marker order
the reference executes, BLAS-vectorized dot products) on this host's CPU,
cached in BASELINE_MEASURED.json. That is a *favorable* stand-in for the
single-rank C++ reference.

Usage: python bench.py [--m 10000] [--n 5000] [--iters 12] [--window 64]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

M_DEFAULT, N_DEFAULT = 10_000, 5_000
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "BASELINE_MEASURED.json")


def _pack_block(geno, nbytes):
    from hydra_tpu.io.plink import MISSING_CODE

    blk, n = geno.shape
    # geno -> inverted PLINK code: 0->0b11, 1->0b10, 2->0b00
    code = (3 - geno - (geno >> 1)).astype(np.uint8)
    padded = np.full((blk, nbytes * 4), MISSING_CODE, dtype=np.uint8)
    padded[:, :n] = code
    return (padded[:, 0::4] | (padded[:, 1::4] << 2)
            | (padded[:, 2::4] << 4) | (padded[:, 3::4] << 6)).astype(np.uint8)


def make_problem(m, n, seed=1, block=4096):
    """Synthetic problem, generated blockwise (UKB-scale M x N never needs a
    dense float genotype matrix in host RAM)."""
    from hydra_tpu.data.genotypes import Dataset, GenotypeData, make_default_groups
    from hydra_tpu.io.plink import bed_bytes_per_marker, decode_bed_numpy

    from hydra_tpu import native

    t0 = time.time()
    rs = np.random.RandomState(seed)
    rg = np.random.default_rng(seed + 1)
    maf = rs.uniform(0.05, 0.5, m)
    nbytes = bed_bytes_per_marker(n)
    packed = np.empty((m, nbytes), dtype=np.uint8)
    # one byte draw per genotype, HWE thresholds:
    # P(g=2) = p^2, P(g>=1) = 1-(1-p)^2  ->  g = (u < a) + (u < b)
    thr_a = np.clip((1.0 - (1.0 - maf) ** 2) * 256.0, 1, 255).astype(np.uint8)
    thr_b = np.clip((maf ** 2) * 256.0, 1, 255).astype(np.uint8)
    for s in range(0, m, block):
        e = min(m, s + block)
        u = np.frombuffer(rg.bytes((e - s) * n), dtype=np.uint8
                          ).reshape(e - s, n)
        blk = native.bed_generate(u, thr_a[s:e], thr_b[s:e], nbytes)
        if blk is None:  # no toolchain: NumPy fallback
            geno = ((u < thr_a[s:e, None]).astype(np.uint8)
                    + (u < thr_b[s:e, None]).astype(np.uint8))
            blk = _pack_block(geno, nbytes)
        packed[s:e] = blk
    print(f"# gen: packed {m}x{nbytes} in {time.time() - t0:.1f} s",
          file=sys.stderr, flush=True)
    t0 = time.time()
    gd = GenotypeData.from_packed(packed, n, np.array([], dtype=np.int64))
    print(f"# gen: marker stats in {time.time() - t0:.1f} s",
          file=sys.stderr, flush=True)

    # phenotype from a causal subset only (decode just those rows, blockwise
    # f32 — a single (ncausal, N) f64 intermediate is ~7 GB at N=458K)
    t0 = time.time()
    ncausal = max(10, min(m // 10, 2000))
    causal = np.sort(rs.choice(m, ncausal, replace=False))
    beta_c = rs.randn(ncausal) * np.sqrt(0.5 / ncausal)
    y = np.zeros(n, dtype=np.float64)
    for cs in range(0, ncausal, 256):
        ce = min(ncausal, cs + 256)
        rows = causal[cs:ce]
        g_c, mask_c = decode_bed_numpy(gd.packed[rows], n)
        xs = ((g_c - gd.mave[rows][:, None] * mask_c)
              * gd.mstd[rows][:, None]).astype(np.float32)
        y += xs.T @ beta_c[cs:ce].astype(np.float32)
    y += rs.randn(n) * np.sqrt(0.5)
    groups, mS = make_default_groups(m, [0.0001, 0.001, 0.01])
    print(f"# gen: phenotype in {time.time() - t0:.1f} s",
          file=sys.stderr, flush=True)
    return Dataset(geno=gd, y=y, groups=groups, num_groups=1, mS=mS)


# Bump when make_problem's generation math changes (scheme 2 = blockwise
# f32 phenotype accumulation, 2026-08-19 — NOT bit-identical to the earlier
# f64 generation for the same seed). A cache from another scheme/seed is a
# subtly different problem; reject it instead of silently benchmarking it.
GEN_SCHEME = 2
GEN_SEED = 1  # make_problem's default seed


def load_or_make_problem(m, n, cache_path=""):
    """make_problem with an optional on-disk cache: at-scale generation is
    host-bound (~13 min at M=500K x N=50K or M=20K x N=458K), so repeated
    hardware measurements of the same config reload the packed bytes +
    phenotype instead (marker stats are recomputed from the packed bytes).
    The cache records the generation seed + scheme version and is rejected
    on mismatch; a corrupt/partial file is treated as a cache miss."""
    from hydra_tpu.data.genotypes import Dataset, GenotypeData, make_default_groups

    if cache_path and os.path.exists(cache_path):
        t0 = time.time()
        try:
            with np.load(cache_path) as z:
                packed, y, n_cached = z["packed"], z["y"], int(z["n"])
                seed = int(z["seed"]) if "seed" in z else -1
                scheme = int(z["scheme"]) if "scheme" in z else -1
        except Exception as e:  # partial/corrupt write: regenerate
            print(f"# gen: problem cache unreadable ({e}); regenerating",
                  file=sys.stderr, flush=True)
            packed = None
        if packed is not None:
            if packed.shape[0] > m and n_cached == n:
                # marker-prefix slice of a bigger cache: valid timing
                # problem (the phenotype keeps its signal from whichever
                # causal markers remain in the panel)
                print(f"# gen: slicing cache M={packed.shape[0]} -> {m}",
                      file=sys.stderr, flush=True)
                packed = packed[:m]
            if packed.shape[0] != m or n_cached != n:
                raise SystemExit(f"--problem-cache {cache_path} holds "
                                 f"M={packed.shape[0]} N={n_cached}, not the "
                                 f"requested M={m} N={n}")
            if (seed, scheme) != (GEN_SEED, GEN_SCHEME):
                raise SystemExit(
                    f"--problem-cache {cache_path} was generated with "
                    f"seed={seed} scheme={scheme}; current generator is "
                    f"seed={GEN_SEED} scheme={GEN_SCHEME} — a different "
                    f"problem. Delete the cache to regenerate.")
            gd = GenotypeData.from_packed(packed, n,
                                          np.array([], dtype=np.int64))
            groups, mS = make_default_groups(m, [0.0001, 0.001, 0.01])
            print(f"# gen: loaded problem cache in {time.time() - t0:.1f} s",
                  file=sys.stderr, flush=True)
            return Dataset(geno=gd, y=y, groups=groups, num_groups=1, mS=mS)
    ds = make_problem(m, n)
    if cache_path:
        t0 = time.time()
        # write-then-rename so a disk-full mid-savez never leaves a partial
        # file that poisons every later run
        tmp = cache_path + ".tmp.npz"  # np.savez appends .npz otherwise
        np.savez(tmp, packed=ds.geno.packed, y=np.asarray(ds.y), n=n,
                 seed=GEN_SEED, scheme=GEN_SCHEME)
        os.replace(tmp, cache_path)
        print(f"# gen: saved problem cache in {time.time() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return ds


def measure_numpy_baseline(ds, sweeps=2, cached_only=False):
    """Sequential reference-math sweep timing (cached). cached_only:
    return (None, False) rather than measure (--skip-baseline still uses
    an existing cached number for a real vs_baseline ratio)."""
    key = f"numpy_seq_m{ds.m}_n{ds.n}"
    if os.path.exists(CACHE):
        with open(CACHE) as fh:
            cache = json.load(fh)
        if key in cache:
            return cache[key], False
    else:
        cache = {}
    if cached_only:
        return None, False
    from hydra_tpu.io.pheno import center_and_scale
    from hydra_tpu.io.plink import decode_bed_numpy
    from hydra_tpu.testing.reference_bayesrrm import sweep

    y = center_and_scale(ds.y)
    g, mask = decode_bed_numpy(ds.geno.packed, ds.geno.n_pad)
    xt = ((g - ds.geno.mave[:, None] * mask) * ds.geno.mstd[:, None])[:, : ds.n]
    rng = np.random.RandomState(5)
    st = dict(eps=y.copy(), beta=np.zeros(ds.m), mu=0.0,
              sigma_g=np.array([0.5]), sigma_e=0.5,
              est_pi=np.tile([[0.5, 0.17, 0.17, 0.16]], (1, 1)))
    t0 = time.time()
    for _ in range(sweeps):
        out = sweep(xt, st["eps"], st["beta"], ds.groups, ds.mS,
                    st["sigma_g"], st["sigma_e"], st["mu"], st["est_pi"], rng)
        st.update(eps=out["eps"], beta=out["beta"], mu=out["mu"],
                  sigma_g=out["sigma_g"], sigma_e=out["sigma_e"],
                  est_pi=out["est_pi"])
    per_sweep = (time.time() - t0) / sweeps
    cache[key] = per_sweep
    with open(CACHE, "w") as fh:
        json.dump(cache, fh, indent=1)
    return per_sweep, True


def _time_bayesw(ds, args):
    import jax
    from hydra_tpu.parallel.mesh import make_mesh
    from hydra_tpu.samplers.bayesw import BayesW, EULER_MASCHERONI

    rs = np.random.RandomState(9)
    alpha_true = 10.0
    w = np.log(rs.exponential(1.0, ds.n)) + EULER_MASCHERONI
    ds.y = 4.0 + 0.02 * ds.y + w / alpha_true
    ds.fail = (rs.random(ds.n) > 0.2).astype(np.float64)

    import jax.numpy as jnp

    sampler = BayesW(ds, window=args.window, seed=13, mesh=make_mesh(1),
                     schedule=args.schedule, quad_points=25)
    state = sampler.init_state()
    # fused k-sweep dispatches (see the BayesRRm timing comment)
    k = max(1, min(args.iters, 50))
    state, _ = sampler.run_steps(state, 0, k)
    float(jnp.sum(state.eps))
    it, times = k, []
    for _ in range(3):
        t0 = time.time()
        state, _ = sampler.run_steps(state, it, k)
        float(jnp.sum(state.eps))
        times.append((time.time() - t0) / k)
        it += k
    return float(np.median(times)), state


def run_bayesw_bench(ds, args):
    """Weibull sampler throughput on a survival transform of the problem.

    Baseline = the same sampler on this host's CPU backend (measured in a
    subprocess with --device cpu, cached) — the honest stand-in given the
    reference binary cannot run here and there is no NumPy BayesW."""
    per_sweep, state = _time_bayesw(ds, args)
    print(f"# per-sweep: {per_sweep * 1e3:.2f} ms  |  "
          f"alpha = {float(state.alpha):.3f}", file=sys.stderr)
    if args.device == "cpu":
        # baseline subprocess: just report the timing
        print(json.dumps({"per_sweep_s": per_sweep}))
        return
    vs = 1.0
    base = _cpu_subprocess_baseline(
        ["--model", "bayesw", "--m", str(args.m), "--n", str(args.n),
         "--window", str(args.window), "--iters", "3"],
        key=f"bayesw_cpu_m{args.m}_n{args.n}_w{args.window}",
        cached_only=args.skip_baseline)
    if base:
        vs = base / per_sweep
        print(f"# cpu-backend baseline: {base:.3f} s/sweep", file=sys.stderr)
    print(json.dumps({
        "metric": f"BayesW marker updates/s/chip (M={args.m}, N={args.n}, "
                  f"window={args.window})",
        "value": round(args.m / per_sweep, 1),
        "unit": "markers/s",
        "vs_baseline": round(vs, 3),
    }))


def run_mt_bench(ds, args, n_traits=4):
    """Multi-trait sampler throughput (T traits share one decode pass per
    window). Baseline = same sampler on the host CPU backend."""
    import jax
    import jax.numpy as jnp
    from hydra_tpu.parallel.mesh import make_mesh
    from hydra_tpu.samplers.bayesrrm_mt import BayesRRmMT

    rs = np.random.RandomState(7)
    ph = np.tile(ds.y, (n_traits, 1)) + rs.randn(n_traits, ds.n) * 0.3
    sampler = BayesRRmMT(ds, ph, window=args.window, exact=args.exact,
                         schedule=args.schedule, seed=17, mesh=make_mesh(1))
    if args.exact:
        print("# mt exact (Gram-corrected) mode", file=sys.stderr, flush=True)
    state = sampler.init_state()
    k = max(1, min(args.iters, 10))
    state, _ = sampler.run_steps(state, 0, k)
    float(jnp.sum(state.eps))
    it, times = k, []
    for _ in range(3):
        t0 = time.time()
        state, _ = sampler.run_steps(state, it, k)
        float(jnp.sum(state.eps))
        times.append((time.time() - t0) / k)
        it += k
    per_sweep = float(np.median(times))
    sg = np.asarray(state.sigma_g).sum(axis=1)
    se = np.asarray(state.sigma_e)
    print(f"# per-sweep: {per_sweep * 1e3:.2f} ms (T={n_traits})  |  "
          f"h2/trait = {np.round(sg / (sg + se), 3)}", file=sys.stderr)
    if args.device == "cpu":
        print(json.dumps({"per_sweep_s": per_sweep}))
        return
    vs = 1.0
    base = _cpu_subprocess_baseline(
        ["--model", "mt", "--m", str(args.m), "--n", str(args.n),
         "--window", str(args.window), "--iters", "3"],
        key=f"mt_cpu_m{args.m}_n{args.n}_w{args.window}",
        cached_only=args.skip_baseline)
    if base:
        vs = base / per_sweep
        print(f"# cpu-backend baseline: {base:.3f} s/sweep", file=sys.stderr)
    print(json.dumps({
        "metric": f"BayesRRm-mt marker-trait updates/s/chip (M={args.m}, "
                  f"N={args.n}, T={n_traits}, window={args.window}"
                  f"{', exact' if args.exact else ''})",
        "value": round(args.m * n_traits / per_sweep, 1),
        "unit": "marker-traits/s",
        "vs_baseline": round(vs, 3),
    }))


def _cpu_subprocess_baseline(extra_args, key, cached_only=False):
    """Measure the same bench on the host CPU backend (cached).

    cached_only: return the cached value or None — never measure (used by
    --skip-baseline so an existing baseline still yields a real ratio)."""
    import subprocess
    cache = {}
    if os.path.exists(CACHE):
        with open(CACHE) as fh:
            cache = json.load(fh)
        if key in cache:
            return cache[key]
    if cached_only:
        return None
    env = dict(os.environ)
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--device", "cpu",
         "--skip-baseline"] + extra_args,
        capture_output=True, text=True, env=env, timeout=3600)
    per_sweep = None
    for line in r.stdout.strip().splitlines():
        try:
            per_sweep = json.loads(line).get("per_sweep_s")
        except (json.JSONDecodeError, AttributeError):
            continue
    if per_sweep:
        cache[key] = per_sweep
        with open(CACHE, "w") as fh:
            json.dump(cache, fh, indent=1)
    return per_sweep


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=M_DEFAULT)
    ap.add_argument("--n", type=int, default=N_DEFAULT)
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--window", type=int, default=64)
    # Default = stale-window relaxation (the reference's production
    # configuration: CSCS strong-scaling runs use --sync-rate 5 across
    # 83-332 ranks => hundreds of stale markers per window). --exact runs
    # Gram-corrected sequential Gibbs (sync-rate=1 semantics).
    ap.add_argument("--exact", action="store_true")
    ap.add_argument("--schedule", default="auto",
                    choices=["auto", "marker", "block"])
    ap.add_argument("--skip-baseline", action="store_true")
    ap.add_argument("--model", choices=["bayesrrm", "bayesw", "mt"],
                    default="bayesrrm")
    ap.add_argument("--device", default="", choices=["", "cpu", "gpu"],
                    help="cpu for the baseline subprocess; default: the GPU, "
                         "and an error when there is none")
    ap.add_argument("--problem-cache", default="",
                    help="npz path: cache/reload the synthetic problem "
                         "(skips the host-bound generation on reruns)")
    args = ap.parse_args()

    from hydra_tpu.platform import configure
    configure(args.device)
    import jax
    import jax.numpy as jnp
    from hydra_tpu.parallel.mesh import make_mesh
    from hydra_tpu.samplers.bayesrrm import BayesRRm

    ds = load_or_make_problem(args.m, args.n, args.problem_cache)

    if args.model == "bayesw":
        run_bayesw_bench(ds, args)
        return
    if args.model == "mt":
        run_mt_bench(ds, args)
        return

    baseline_s = None
    if args.device != "cpu":
        baseline_s, fresh = measure_numpy_baseline(
            ds, cached_only=args.skip_baseline)
        if baseline_s:
            print(f"# numpy sequential baseline: {baseline_s:.3f} s/sweep"
                  f"{' (measured now)' if fresh else ' (cached)'}",
                  file=sys.stderr)

    mesh = make_mesh(1)
    t0 = time.time()
    sampler = BayesRRm(ds, window=args.window, exact=args.exact,
                       seed=11, mesh=mesh, schedule=args.schedule)
    ctor_s = time.time() - t0
    t0 = time.time()
    state = sampler.init_state()
    init_s = time.time() - t0
    setup_s = ctor_s + init_s
    st = dict(getattr(sampler, "setup_timings", {}))
    print(f"# setup: layout+device_put in {setup_s:.1f} s "
          f"(layout {st.get('layout_s', 0):.1f} + h-pack "
          f"{st.get('hpack_s', 0):.1f} + device_put "
          f"{st.get('device_put_s', 0):.1f} + small-puts "
          f"{st.get('other_puts_s', 0):.1f} + init_state {init_s:.1f})",
          file=sys.stderr, flush=True)
    # warmup/compile
    t0 = time.time()
    state, _ = sampler.step(state, 0)
    jax.block_until_ready(state.eps)
    print(f"# setup: compile+first step in {time.time() - t0:.1f} s",
          file=sys.stderr, flush=True)
    # Timing: fused k-sweep dispatches (run_steps = lax.scan over sweeps in
    # ONE executable, as the CLI runs between thin/save boundaries); a host
    # fetch of a scalar fences each block, and the median block is kept.
    # Cap at 50 so --iters <= 50 still means one block.
    k = max(1, min(args.iters, 50))
    n_blocks = max(3, args.iters // k)
    state, _ = sampler.run_steps(state, 1, k)     # compile the fused loop
    float(jnp.sum(state.eps))
    it = 1 + k
    block_times = []
    for _ in range(n_blocks):
        t0 = time.time()
        state, stats = sampler.run_steps(state, it, k)
        float(jnp.sum(state.eps))                 # fence via host fetch
        block_times.append(time.time() - t0)
        it += k
    per_sweep = float(np.median(block_times)) / k
    print(f"# block times (ms): "
          f"{[round(b * 1e3) for b in sorted(block_times)]}", file=sys.stderr)
    markers_per_s = args.m / per_sweep

    sg = float(np.asarray(state.sigma_g).sum())
    se = float(state.sigma_e)
    dev = jax.devices()[0]
    print(f"# per-sweep: {per_sweep * 1e3:.2f} ms  |  h2 = {sg / (sg + se):.3f}  "
          f"| device: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          file=sys.stderr)

    # traffic floor: stale mode streams the packed bytes twice per sweep
    # (window dots + axpy); the residual is re-read/written once per window.
    # Exact mode adds the Gram pass.
    packed_bytes = ds.geno.packed.size if hasattr(ds.geno.packed, "size") else 0
    eps_bytes = sampler.cfg.n_windows * sampler.cfg.n_pad * 4 * 2
    traffic = 2 * packed_bytes + eps_bytes
    print(f"# device traffic/sweep >= {traffic / 1e6:.1f} MB (packed 2x"
          f" {packed_bytes / 1e6:.1f} + eps {eps_bytes / 1e6:.1f})"
          f"  =>  achieved {traffic / per_sweep / 1e9:.1f} GB/s"
          f"  ({sampler.cfg.n_windows} windows,"
          f" {per_sweep / sampler.cfg.n_windows * 1e6:.1f} us/window)",
          file=sys.stderr)

    if args.device == "cpu":
        print(json.dumps({"per_sweep_s": per_sweep}))
        return
    vs = (baseline_s / per_sweep) if baseline_s else 1.0
    out = {
        "metric": f"BayesRRm marker updates/s/chip (M={args.m}, N={args.n}, "
                  f"window={args.window}, {'exact' if args.exact else 'stale'})",
        "value": round(markers_per_s, 1),
        "unit": "markers/s",
        "vs_baseline": round(vs, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
