"""Test configuration: force an 8-device virtual CPU mesh.

Multi-device sharding is validated on host CPU devices
(xla_force_host_platform_device_count), per SURVEY.md §4's rebuild test
strategy; GPU runs use the same code paths (chip_smoke.py runs them on the
card).
"""

import os

# Unit tests always run on the virtual CPU mesh, whatever the environment
# says; subprocesses they start inherit JAX_PLATFORMS=cpu.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# A pytest plugin may have imported jax before this conftest ran; the config
# update still wins as long as no backend has been initialized yet.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def rng():
    return np.random.RandomState(42)


def make_synthetic_bed(tmpdir, m, n, seed=0, maf_low=0.05, maf_high=0.5,
                       missing_rate=0.0):
    """Write a synthetic PLINK trio (.bed/.bim/.fam); returns (basename, genotypes).

    genotypes: (M, N) int with -1 for missing.
    """
    from hydra_tpu.io.plink import write_bed

    rs = np.random.RandomState(seed)
    maf = rs.uniform(maf_low, maf_high, size=m)
    geno = (rs.random((m, n)) < maf[:, None]).astype(np.int64) + (
        rs.random((m, n)) < maf[:, None]
    ).astype(np.int64)
    if missing_rate > 0:
        miss = rs.random((m, n)) < missing_rate
        geno[miss] = -1
    base = str(tmpdir / "synth")
    write_bed(base + ".bed", geno)
    with open(base + ".fam", "w") as fh:
        for i in range(n):
            fh.write(f"per{i} per{i} 0 0 0 -9\n")
    with open(base + ".bim", "w") as fh:
        for j in range(m):
            fh.write(f"1 snp{j} 0 {j + 1} A C\n")
    return base, geno


@pytest.fixture
def synthetic_bed_factory(tmp_path):
    def factory(m, n, **kw):
        return make_synthetic_bed(tmp_path, m, n, **kw)

    return factory
