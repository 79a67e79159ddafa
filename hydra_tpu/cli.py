"""Command-line entry point: `python -m hydra_tpu.cli <hydra-style flags>`.

Dispatch mirrors main.cpp:47-177:
  --bed-to-sparse                 -> sparse-file converter (C6)
  --check-RAM                     -> device/host memory estimator (C24)
  --mpibayes bayesMPI             -> BayesRRm
  --mpibayes bayesFHMPI           -> BayesRRm with horseshoe priors
  --mpibayes bayesWMPI            -> BayesW (Weibull survival)
"""

from __future__ import annotations

import os
import sys

from hydra_tpu.options import parse_args


def main(argv=None) -> int:
    opt = parse_args(argv)

    if opt.bed_to_sparse:
        # host-only: no device is used
        from hydra_tpu.io import plink
        from hydra_tpu.io.sparse import write_sparse_files
        n = opt.number_individuals or plink.read_fam(opt.bed_file + ".fam").n
        m = opt.number_markers or plink.read_bim(opt.bed_file + ".bim").m
        out = (opt.sparse_dir + "/" + opt.sparse_basename
               if opt.sparse_dir else opt.bed_file)
        # --blocks-per-rank splits the conversion into independent passes to
        # bound memory (BayesRRm.cpp:469-471; single logical rank here)
        block_size = min(8192, -(-m // max(1, opt.blocks_per_rank)))
        print(f"INFO   : converting {opt.bed_file}.bed (M={m}, N={n}) -> {out}.s* "
              f"in blocks of {block_size} markers")
        write_sparse_files(opt.bed_file + ".bed", n, m, out,
                           block_size=block_size)
        return 0

    # Platform and compile cache BEFORE any backend starts: the GPU, or the
    # CPU when asked for (--device cpu / JAX_PLATFORMS=cpu); no silent
    # fallback when no GPU is found.
    from hydra_tpu.parallel.distributed import init_distributed
    from hydra_tpu.platform import (NoDeviceError, require_device,
                                    select_platform)
    if opt.check_ram:
        # reads the device's memory limit only: reserve none of it
        os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")
    want = select_platform(opt.device)
    # multi-process jobs: no-op for a single process (parallel/distributed.py)
    init_distributed()
    try:
        require_device(want)
    except NoDeviceError as e:
        print(f"FATAL  : {e}", file=sys.stderr)
        return 2

    if opt.check_ram:
        from hydra_tpu.diag.ramcheck import check_ram_usage
        check_ram_usage(opt)
        return 0

    if opt.bayes_type in ("bayesMPI", "bayesFHMPI"):
        if opt.multi_phen:
            from hydra_tpu.runner import run_bayesrrm_mt
            run_bayesrrm_mt(opt)
        else:
            from hydra_tpu.runner import run_bayesrrm
            run_bayesrrm(opt)
        return 0

    if opt.bayes_type == "bayesWMPI":
        from hydra_tpu.runner_bayesw import run_bayesw
        run_bayesw(opt)
        return 0

    print(f"FATAL  : Wrong analysis requested: {opt.bayes_type!r} "
          f"(expected bayesMPI | bayesWMPI | bayesFHMPI)", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
