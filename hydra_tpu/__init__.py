"""hydra_tpu — Bayesian whole-genome regression on the GPU, in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
medical-genomics-group/hydra (MPI + OpenMP + AVX C++17): BayesR-style
spike-and-slab Gibbs sampling over PLINK .bed genotype matrices, with

  * BayesRRm  — Gaussian mixture prior, grouped/annotated mixtures
                (reference: src/BayesRRm.cpp:933 runMpiGibbs)
  * BayesW    — Weibull survival model (reference: src/BayesW.cpp:905)
  * BayesFH   — regularized-horseshoe variant (reference: BayesRRm.cpp:1125-1163)
  * BayesRRm-mt — multi-trait sampler (reference: src/BayesRRm_mt.cpp, enabled here)

Design (not a port):
  * Genotypes live in device memory as packed 2-bit PLINK bytes,
    marker-sharded over a 1-D `jax.sharding.Mesh` axis; decode happens on
    device inside the window reductions (replaces the reference's AVX LUT
    kernels src/dotp_lut.h + sparse index lists C5-C7).
  * The Gibbs hot loop exploits the reference's own stale-residual window
    (`--sync-rate`, BayesRRm.cpp:2044-2488): all marker dot products within a
    window share one residual vector, so they batch into one pass over the
    packed bytes; a Gram-matrix correction (the default, exact mode)
    recovers *exact* sequential Gibbs semantics while keeping the batching.
  * Cross-shard residual synchronization is a dense `jax.lax.psum` over the
    mesh (replaces MPI_Allreduce / sparse Allgatherv codecs,
    BayesRRm.cpp:2236-2456).
  * boost::mt19937 / C rand() are replaced by counter-based jax.random keys
    derived from (seed, iteration, global marker index) so results are
    independent of device count (validated distributionally, not bit-exact —
    the reference itself tolerates compiler-dependent shuffles,
    BayesRRm.cpp:1688-1690).
"""

__version__ = "0.1.0"

from hydra_tpu.options import Options  # noqa: F401
