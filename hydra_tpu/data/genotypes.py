"""Dataset assembly: packed genotypes + phenotypes + groups, padded for the
device layout.

Host-side equivalent of the reference's data-loading block
(BayesRRm.cpp:1317-1515): read genotypes (BED or sparse files), apply the
missing-phenotype correction (C8, data.cpp:1112-1158 — here: drop individual
columns and re-pack), compute marker statistics (C9, BayesRRm.cpp:1502-1508),
and lay everything out for the device mesh:

  * individuals padded to a lane-friendly multiple (pad codes = missing, so
    decoded planes are zero there and contribute nothing to any reduction);
  * markers padded so every shard holds the same number of whole windows
    (padded markers have valid=0 and never touch the model state).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from hydra_tpu.io import plink, sparse as sparse_io
from hydra_tpu.io.pheno import PhenoData

IND_ALIGN = 512          # individuals padded to multiple of this (128 bytes packed)
_PAD_BYTE = 0b01010101   # 4 missing codes


def pad_individuals(n: int) -> int:
    """Padded individual count: n rounded up to a multiple of IND_ALIGN.

    The packed width is then a multiple of 128 bytes, and the individual
    axis splits evenly over any power-of-two --ind-shards <= 128. Pad
    individuals are missing-coded and masked everywhere, so this only
    changes shapes, never numerics."""
    return -(-n // IND_ALIGN) * IND_ALIGN


def _pad_packed_columns(packed: np.ndarray, n: int, n_pad: int) -> np.ndarray:
    """Pad individuals to n_pad with missing codes (decode to zero planes)."""
    m, nbytes = packed.shape
    nbytes_pad = n_pad // 4
    out = np.full((m, nbytes_pad), _PAD_BYTE, dtype=np.uint8)
    out[:, :nbytes] = packed
    # Mark the tail of the last partially-used byte as missing
    rem = n % 4
    if rem:
        last = n // 4
        keep_mask = (1 << (2 * rem)) - 1
        out[:, last] = (packed[:, last] & keep_mask) | (_PAD_BYTE & ~keep_mask & 0xFF)
    return out


@dataclass
class GenotypeData:
    """Packed genotypes for the full (host-local) marker range."""
    packed: np.ndarray        # (M, N_pad // 4) uint8, NA-corrected, padded
    n: int                    # individuals after NA correction (Ntot - numNAs)
    n_pad: int
    m: int                    # markers (unpadded)
    mave: np.ndarray          # (M,) per-marker mean      (BayesRRm.cpp:1503)
    mstd: np.ndarray          # (M,) 1/sd                 (BayesRRm.cpp:1507)
    msd: np.ndarray           # (M,) sd                   (BayesW.cpp:1220)
    n1: np.ndarray
    n2: np.ndarray
    nm: np.ndarray
    # multi-process per-host loading (jax.distributed): this host's packed
    # rows cover global markers [marker_offset, marker_offset + m); m_tot is
    # the global marker count and nm_tot the global missing-genotype count
    # (None => this host holds ALL markers, the single-process case)
    marker_offset: int = 0
    m_tot: Optional[int] = None
    nm_tot: Optional[float] = None

    @property
    def m_global(self) -> int:
        return self.m if self.m_tot is None else self.m_tot

    @property
    def nm_global_sum(self) -> float:
        return (float(np.asarray(self.nm).sum())
                if self.nm_tot is None else self.nm_tot)

    @staticmethod
    def from_packed(packed: np.ndarray, n: int, na_indices: np.ndarray) -> "GenotypeData":
        from hydra_tpu import native

        if len(na_indices):
            repacked = native.bed_remove_individuals(packed, n, na_indices)
            if repacked is None:
                repacked = plink.remove_individuals_packed(packed, n, na_indices)
            packed = repacked
            n = n - len(na_indices)
        m = packed.shape[0]
        n_pad = pad_individuals(n)
        packed = _pad_packed_columns(packed, n, n_pad)
        counts = native.bed_counts(packed, n)
        if counts is not None:
            n1, n2, nm = (c.astype(np.float64) for c in counts)
        else:
            geno, mask = plink.decode_bed_numpy(packed, n)
            n1 = ((geno == 1.0) & (mask == 1.0)).sum(axis=1).astype(np.float64)
            n2 = (geno == 2.0).sum(axis=1).astype(np.float64)
            nm = (mask == 0.0).sum(axis=1).astype(np.float64)
        dn = float(n)
        with np.errstate(divide="ignore", invalid="ignore"):
            mave = (n1 + 2.0 * n2) / (dn - nm)
            var = (
                n1 * (1.0 - mave) ** 2
                + n2 * (2.0 - mave) ** 2
                + (dn - n1 - n2 - nm) * mave**2
            )
            mstd = np.sqrt((dn - 1.0) / var)
            msd = np.sqrt(var / (dn - 1.0))
        # Monomorphic markers have undefined std in the reference; disable them
        # cleanly here (zero weight) instead of propagating inf.
        bad = ~np.isfinite(mstd)
        mave[bad] = 0.0
        mstd[bad] = 0.0
        msd[bad] = 0.0
        return GenotypeData(packed, n, n_pad, m, mave, mstd, msd, n1, n2, nm)


@dataclass
class Dataset:
    geno: GenotypeData
    y: np.ndarray                       # (N,) phenotype, NA-compacted (not yet scaled)
    groups: np.ndarray                  # (M,) int32 marker -> group
    num_groups: int
    mS: np.ndarray                      # (G, K) mixture grid incl. 0.0 column
    fail: Optional[np.ndarray] = None   # (N,) failure indicators (BayesW)
    X: Optional[np.ndarray] = None      # (N, F) covariates
    priors: Optional[np.ndarray] = None     # (G, 2) sigmaG (v0, s0) priors
    d_priors: Optional[np.ndarray] = None   # (G, K) Dirichlet priors
    num_nas: int = 0
    blocks: Optional[Tuple[np.ndarray, np.ndarray]] = None  # custom shard blocks

    @property
    def n(self) -> int:
        return self.geno.n

    @property
    def m(self) -> int:
        # GLOBAL marker count (== local count except under per-host loading)
        return self.geno.m_global


def make_default_groups(m: int, S: List[float]) -> Tuple[np.ndarray, np.ndarray]:
    """Single group 0 with the --S grid, 0.0 prepended (BayesRRm.cpp:984-996)."""
    groups = np.zeros(m, dtype=np.int32)
    mS = np.asarray([[0.0] + list(S)], dtype=np.float64)
    if any(s <= 0.0 for s in S):
        raise ValueError("mixture value can only be strictly positive")
    return groups, mS


def load_dataset(
    bed_basename: str = "",
    sparse_basename: str = "",
    pheno: Optional[PhenoData] = None,
    n: int = 0,
    m: int = 0,
    groups: Optional[np.ndarray] = None,
    mS: Optional[np.ndarray] = None,
    S: Optional[List[float]] = None,
    priors: Optional[np.ndarray] = None,
    d_priors: Optional[np.ndarray] = None,
    blocks: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    marker_offset: int = 0,
    marker_count: Optional[int] = None,
) -> Dataset:
    """Assemble a Dataset from BED or hydra sparse files.

    Mirrors the source selection of main.cpp:60-136 / BayesRRm.cpp:1347-1412.
    marker_offset/marker_count restrict the .bed read to this host's marker
    shards (the per-host analogue of the reference's MPI-IO collective reads,
    data.cpp:671-739): groups/phenotypes stay global, genotype rows and their
    statistics are local, and GenotypeData records the offset.
    """
    local_slice = marker_count is not None
    if bed_basename:
        if n == 0 or m == 0:
            fam = plink.read_fam(bed_basename + ".fam")
            bim = plink.read_bim(bed_basename + ".bim")
            n, m = fam.n, bim.m
        if not local_slice:
            marker_count = m
        t0 = time.perf_counter()
        if local_slice:
            # serialize co-hosted processes' reads with an flock: storage
            # that collapses under concurrent streams (measured 0.17 GB/s
            # aggregate for 4 readers vs 1.2 single-stream on virtio)
            # recovers ~single-stream bandwidth; on separate hosts the
            # lock is local and uncontended (scripts/bench_mp_ingest.py)
            import fcntl
            with open(bed_basename + ".bed", "rb") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                packed = plink.read_bed(bed_basename + ".bed", n, m,
                                        marker_start=marker_offset,
                                        marker_count=marker_count)
                fcntl.flock(lk, fcntl.LOCK_UN)
        else:
            packed = plink.read_bed(bed_basename + ".bed", n, m,
                                    marker_start=marker_offset,
                                    marker_count=marker_count)
        tl = time.perf_counter() - t0
        # data-load bandwidth log (BayesRRm.cpp:1420-1424)
        import jax as _jax
        print(f"INFO   : rank {_jax.process_index():3d} took {tl:.3f} seconds to load  "
              f"{packed.nbytes} bytes  =>  BW = {packed.nbytes * 1e-9 / max(tl, 1e-9):7.3f} GB/s",
              flush=True)
        if sparse_basename:
            # "BOTH" / mixed representation (main.cpp:134, C7): the dense
            # packed-byte device format subsumes the per-marker BED/sparse
            # choice with identical numerics (io/sparse.py docstring). The
            # sparse .dim is still read to cross-check the two sources agree.
            sn, sm = sparse_io.read_dim(sparse_basename)
            if (sn, sm) != (n, m):
                raise ValueError(
                    f"mixed representation: sparse files are ({sm} x {sn}) "
                    f"but BED is ({m} x {n})")
            print("INFO   : mixed representation requested; the packed-BED "
                  "device format subsumes it (threshold-fnz moot, numerics "
                  "identical)", flush=True)
    elif sparse_basename:
        sp = sparse_io.read_sparse_files(sparse_basename)
        n, m = sp.n, sp.m
        packed = sparse_io.sparse_to_packed_bed(sp)
    else:
        raise ValueError("either BED, SPARSE or BOTH")  # main.cpp:134

    if pheno is None:
        raise ValueError("phenotype data is required")
    geno = GenotypeData.from_packed(packed, n, pheno.na_indices)
    if local_slice:
        from hydra_tpu.parallel.distributed import allreduce_host_sum
        geno.marker_offset = marker_offset
        geno.m_tot = m
        # the complete-data kernel gate needs the GLOBAL missing count
        geno.nm_tot = allreduce_host_sum(float(np.asarray(geno.nm).sum()))
    if groups is None or mS is None:
        groups, mS = make_default_groups(m, S or [0.01, 0.001, 0.0001])
    if len(groups) != m:
        raise ValueError(f"group file covers {len(groups)} markers, expected {m}")
    num_groups = int(mS.shape[0])
    if groups.max(initial=0) >= num_groups:
        raise ValueError("group index exceeds number of groups in mixture file")
    return Dataset(
        geno=geno,
        y=pheno.y,
        groups=np.asarray(groups, dtype=np.int32),
        num_groups=num_groups,
        mS=np.asarray(mS, dtype=np.float64),
        fail=pheno.fail,
        X=pheno.X,
        priors=priors,
        d_priors=d_priors,
        num_nas=pheno.num_nas,
        blocks=blocks,
    )


def shard_layout(
    mtot: int, n_dev: int, window: int,
    blocks: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Compute (starts, lengths, m_loc_pad) for marker sharding.

    Equal split like mpi_define_blocks_of_markers (BayesRRm.cpp:396-413), or a
    user block file (mpi_assign_blocks_to_tasks :781-827). Every shard is
    padded to the same m_loc_pad = ceil(max_len / window) * window so the
    windowed sweep is SPMD-uniform (ranks past their last marker contribute
    zero deltas, mirroring BayesRRm.cpp:2029-2034).
    """
    from hydra_tpu.io.groups import assign_blocks_to_tasks

    if blocks is not None:
        starts, lengths = assign_blocks_to_tasks(
            len(blocks[0]), blocks[0], blocks[1], mtot, n_dev
        )
    else:
        starts, lengths = assign_blocks_to_tasks(0, None, None, mtot, n_dev)
    max_len = int(lengths.max())
    m_loc_pad = ((max_len + window - 1) // window) * window
    return starts, lengths, m_loc_pad
