"""Ground the --check-RAM memory estimator against a live run.

Builds the real BayesRRm sampler at the requested scale, then compares
diag/ramcheck.estimate_bytes against two measured quantities:

  * resident device arrays: sum of nbytes over jax.live_arrays() on the
    target backend after init (genotype shard + state + constants);
  * the compiled step's own accounting: jit(...).lower(...).compile()
    .memory_analysis() — argument/output/temp/generated-code sizes, which is
    XLA's statement of what the sweep NEEDS (the transient workspace the
    estimator's window_ws term models).

Prints an error report; the estimator aims for +-15%.

Usage: python scripts/check_ram_ground.py [--m 100000] [--from-cache ...]
       [--device cpu]   (cpu = structural check on the virtual mesh)
"""

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=100_000)
    ap.add_argument("--from-cache",
                    default=os.path.join(REPO, ".cache_M100K_N50K.npz"))
    ap.add_argument("--device", default="")
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--stale", action="store_true")
    args = ap.parse_args()

    from hydra_tpu.platform import configure
    configure(args.device)
    import jax

    from hydra_tpu.data.genotypes import Dataset, GenotypeData, make_default_groups
    from hydra_tpu.diag.ramcheck import estimate_bytes
    from hydra_tpu.io.pheno import PhenoData
    from hydra_tpu.samplers.bayesrrm import BayesRRm

    with np.load(args.from_cache) as z:
        n = int(z["n"])
        nbytes = -(-n // 4)
        packed = z["packed"][: args.m, :nbytes]
        y = z["y"]
    geno = GenotypeData.from_packed(packed, n, np.array([], np.int64))
    groups, mS = make_default_groups(args.m, [0.001, 0.01, 0.1])
    ds = Dataset(geno=geno, y=y, groups=groups, num_groups=1, mS=mS)

    window = args.window or (128 if not args.stale else 256)
    backend = jax.default_backend()
    t0 = time.time()
    sampler = BayesRRm(ds, window=window, exact=not args.stale, seed=7)
    state = sampler.init_state()
    st2, _ = sampler.step(state, 0)
    jax.block_until_ready(st2)
    print(f"# setup+init+step in {time.time() - t0:.0f} s on {backend}")

    live = 0
    per_kind = {}
    for arr in jax.live_arrays():
        try:
            plat = list(arr.devices())[0].platform
        except Exception:
            continue
        if plat != backend:
            continue
        # addressable-shard bytes only
        nb = sum(s.data.nbytes for s in arr.addressable_shards)
        live += nb
    print(f"resident device arrays: {live / 1e9:.3f} GB")

    mem = None
    try:
        lowered = sampler._step.lower(np.uint32(7), np.int32(0), state,
                                      *sampler._consts)
        mem = lowered.compile().memory_analysis()
        print(f"XLA memory_analysis: args {mem.argument_size_in_bytes / 1e9:.3f} "
              f"GB, temp {mem.temp_size_in_bytes / 1e9:.3f} GB, "
              f"output {mem.output_size_in_bytes / 1e9:.3f} GB, "
              f"code {mem.generated_code_size_in_bytes / 1e6:.1f} MB")
    except Exception as e:
        print(f"memory_analysis unavailable: {e}")

    est = estimate_bytes(args.m, n, n_chips=1, window=window,
                         k=ds.mS.shape[1], num_groups=1)
    print(f"estimator: total {est['total'] / 1e9:.3f} GB "
          f"(geno {est['geno'] / 1e9:.3f}, eps {est['eps'] / 1e9:.3f}, "
          f"state {est['marker_state'] / 1e9:.3f}, "
          f"window_ws {est['window_ws'] / 1e9:.3f})")
    resident_est = est["geno"] + est["eps"] + est["marker_state"]
    print(f"resident err: est {resident_est / 1e9:.3f} vs live "
          f"{live / 1e9:.3f} GB -> "
          f"{100 * (resident_est - live) / max(live, 1):+.1f}%")
    if mem is not None:
        need = live + mem.temp_size_in_bytes
        print(f"total-need err: est {est['total'] / 1e9:.3f} vs live+temp "
              f"{need / 1e9:.3f} GB -> "
              f"{100 * (est['total'] - need) / max(need, 1):+.1f}%")


if __name__ == "__main__":
    main()
