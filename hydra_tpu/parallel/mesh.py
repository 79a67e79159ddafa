"""Device mesh setup for marker (and optional individual) sharding.

The reference's only parallelism strategy is 1-D marker sharding over MPI
ranks with a replicated residual vector (SURVEY §2 C12). The equivalent here
is a 1-D `jax.sharding.Mesh` over axis "markers": per-marker state is sharded
on that axis, the residual (epsilon) is replicated, and residual deltas are
combined with `jax.lax.psum` (NCCL over NVLink within a host) — replacing
MPI_Allreduce and making the sparse/BED Allgatherv codecs
(BayesRRm.cpp:2080-2452) unnecessary (dense N-vectors are cheap there).

Beyond the reference: an optional second axis "inds" shards the *individual*
dimension. The reference replicates the full N-vector epsilon on every rank
(BayesRRm.cpp:1528-1537) so N is bounded by node RAM; here the bound is
device memory, and for biobank-scale N the residual, covariates and the packed byte
columns shard over "inds", with partial dot products combined by one extra
psum over that axis (SURVEY §5 "long-context" analogue — the extension the
reference has no prior art for).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

MARKER_AXIS = "markers"
IND_AXIS = "inds"
DCN_AXIS = "dcn"


def make_mesh(n_devices: int = 0, devices: Optional[list] = None,
              n_ind: int = 1, n_dcn: int = 1) -> Mesh:
    """Mesh over ("markers",) — optionally ("dcn", "markers"[, "inds"]).

    n_devices == 0 uses all visible devices. n_ind splits the device pool:
    n_devices must be a multiple of n_ind; marker axis gets n_devices/n_ind.
    Multi-host: pass the global device list (jax.devices() already spans
    hosts under jax.distributed). Keep "inds" within a host so its psums
    stay on NVLink.

    n_dcn > 1 declares a *hierarchical* marker axis for multi-host runs:
    markers shard over the flattened ("dcn", "markers") axes, and the
    samplers split the residual all-reduce into a within-host psum over
    "markers" (NVLink) followed by chunked psums across hosts over "dcn" —
    the bandwidth-optimal decomposition of the reference's cross-node
    MPI_Allreduce (BayesRRm.cpp:2456). Order the device list host-major so
    "dcn" really crosses hosts.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices > 0:
        devices = devices[:n_devices]
    n_dcn = max(int(n_dcn), 1)
    n_ind = max(int(n_ind), 1)
    if len(devices) % (n_ind * n_dcn):
        raise ValueError(
            f"n_ind*n_dcn={n_ind}*{n_dcn} must divide the device count "
            f"{len(devices)}")
    if n_ind <= 1 and n_dcn <= 1:
        return Mesh(np.asarray(devices), (MARKER_AXIS,))
    n_marker = len(devices) // (n_ind * n_dcn)
    if n_dcn <= 1:
        grid = np.asarray(devices).reshape(n_marker, n_ind)
        return Mesh(grid, (MARKER_AXIS, IND_AXIS))
    if n_ind <= 1:
        grid = np.asarray(devices).reshape(n_dcn, n_marker)
        return Mesh(grid, (DCN_AXIS, MARKER_AXIS))
    grid = np.asarray(devices).reshape(n_dcn, n_marker, n_ind)
    return Mesh(grid, (DCN_AXIS, MARKER_AXIS, IND_AXIS))


def mesh_axes(mesh: Mesh) -> tuple:
    """(total_marker_shards, n_ind_shards, n_dcn_slices).

    total_marker_shards includes the dcn factor: per-marker arrays shard
    over the flattened ("dcn", "markers") axes, so layout code only ever
    needs the product."""
    n_ind = mesh.shape.get(IND_AXIS, 1)
    n_dcn = mesh.shape.get(DCN_AXIS, 1)
    return n_dcn * mesh.shape[MARKER_AXIS], n_ind, n_dcn


def marker_axes(n_dcn: int) -> tuple:
    """Axis-name tuple for collectives over the (possibly hierarchical)
    marker dimension — what MPI_COMM_WORLD reductions map to."""
    return (DCN_AXIS, MARKER_AXIS) if n_dcn > 1 else (MARKER_AXIS,)


def det_psum(v, axes, n_dev: int):
    """Topology-invariant all-reduce: one-hot psum + fixed-order local sum.

    lax.psum's reduction order depends on the backend topology (XLA's
    in-process tree vs Gloo's cross-process ring), so the same 8-shard mesh
    gives ULP-different sums as 1 process x 8 devices vs 2 x 4. Here each
    shard scatters its addend into its own row of a (n_dev, ...) buffer and
    the psum only ever adds a value to zeros — exact in ANY reduction order
    (x + 0.0 == x bitwise; a -0.0 addend becomes +0.0 in every topology
    alike) — then the shard-axis sum happens in the COMPILED LOCAL reduction,
    identical for every process layout. psum keeps the result vma-invariant
    (an all_gather+sum would be 'varying' and break replicated loop
    carries). Cost: an n_dev-fold larger collective payload. Enabled by
    --det-sync for multi-process bitwise validation (tests/test_multiprocess)
    and reproducible cross-topology production runs; the reference has no
    equivalent (MPI_Allreduce is likewise order-unstable across topologies)."""
    import jax.numpy as jnp

    idx = jax.lax.axis_index(axes)
    z = jnp.zeros((n_dev,) + v.shape, v.dtype)
    g = jax.lax.psum(z.at[idx].set(v), axes)
    return jnp.sum(g, axis=0)


def hier_psum(v, n_dcn: int, n_chunks: int = 8):
    """All-reduce a replicated vector over the marker hierarchy.

    n_dcn == 1: plain psum over "markers". n_dcn > 1: psum over "markers"
    (within a host) first so the network carries one already-reduced copy
    per host, then the cross-host reduction is split into n_chunks
    independent psums over "dcn" — separate collectives XLA can pipeline
    against each other (the chunked policy of SURVEY §5; replaces the
    reference's flat
    MPI_Allreduce across nodes, BayesRRm.cpp:2456). Falls back to one psum
    when the length does not divide."""
    import jax

    v = jax.lax.psum(v, MARKER_AXIS)
    if n_dcn <= 1:
        return v
    n = v.shape[0] if v.ndim else 0
    if v.ndim != 1 or n_chunks <= 1 or n % n_chunks:
        return jax.lax.psum(v, DCN_AXIS)
    parts = v.reshape(n_chunks, n // n_chunks)
    import jax.numpy as jnp
    return jnp.concatenate(
        [jax.lax.psum(parts[c], DCN_AXIS) for c in range(n_chunks)])
