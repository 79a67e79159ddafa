"""Multi-process initialization — the analogue of hydra's SLURM/MPI setup.

The reference launches via `srun`/mvapich (CSCS/*.sh); here every process
(one per GPU, on one or several hosts) runs the same CLI and
`init_distributed()` wires them into one `jax.distributed` job. After
initialization `jax.devices()` spans all processes, so the marker mesh and
psum residual sync work unchanged — NVLink within a host, the network across
hosts (raise --window to amortize cross-host latency, the direct analogue of
raising --sync-rate across nodes).
"""

from __future__ import annotations

import os
from typing import Optional


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed from args or environment.

    Settings come from HYDRA_COORDINATOR / HYDRA_NUM_PROCS / HYDRA_PROC_ID
    (or SLURM variables); K processes on one host each see their own card
    through CUDA_VISIBLE_DEVICES (scripts/run_multiprocess.py). Returns True
    if distributed mode was initialized.
    """
    import jax

    coordinator = coordinator or os.environ.get("HYDRA_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get(
            "HYDRA_NUM_PROCS", os.environ.get("SLURM_NTASKS", "0")) or 0)
    if process_id is None:
        process_id = int(os.environ.get(
            "HYDRA_PROC_ID", os.environ.get("SLURM_PROCID", "0")) or 0)

    if coordinator:
        jax.distributed.initialize(
            coordinator_address=coordinator, num_processes=num_processes,
            process_id=process_id)
        return True
    return False


def is_primary() -> bool:
    import jax
    return jax.process_index() == 0


def put_global(tree, shardings):
    """device_put that also works when `shardings` span multiple processes.

    Single process: plain jax.device_put (supports pytrees). Multi-process:
    every process passes the same HOST value for replicated leaves, and for
    marker-sharded leaves only the rows of this process's shards need to be
    real data (jax.make_array_from_callback materializes addressable shards
    only — the equivalent of each MPI rank holding just its marker block,
    mpi_utils.hpp:8-67)."""
    import jax
    import numpy as np

    if jax.process_count() == 1:
        return jax.device_put(tree, shardings)

    def one(a, s):
        a = np.asarray(a)
        return jax.make_array_from_callback(
            a.shape, s, lambda idx, a=a: a[idx])

    return jax.tree.map(one, tree, shardings)


def fetch_global(tree):
    """jax.device_get that reconstructs globally-sharded arrays.

    Leaves whose shards all live on this process (replicated state, or any
    array in a single-process run) transfer directly; marker-sharded leaves
    in a multi-process run go through an all-gather collective, so EVERY
    process must call this at the same point (the analogue of the
    reference's collective MPI_Gatherv into rank 0's writer buffers,
    BayesRRm.cpp:2768-2795)."""
    import jax

    if jax.process_count() == 1:
        return jax.device_get(tree)
    from jax.experimental import multihost_utils

    flat, treedef = jax.tree.flatten(tree)
    out = []
    for x in flat:
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            out.append(multihost_utils.process_allgather(x, tiled=True))
        else:
            out.append(jax.device_get(x))
    return jax.tree.unflatten(treedef, out)


def local_marker_shards(mesh) -> list:
    """Flattened marker-shard slot indices owned by this process.

    The sampler's slot layout indexes marker shards by the mesh's flattened
    device order; under jax.distributed each process's devices are
    contiguous in that order, so per-host data loading covers a contiguous
    global marker range."""
    import jax

    me = jax.process_index()
    flat = mesh.devices.reshape(-1)
    return [d for d, dev in enumerate(flat) if dev.process_index == me]


def allreduce_host_sum(value: float) -> float:
    """Sum a host scalar across processes (MPI_Allreduce analogue for load-
    time metadata, e.g. the global missing-genotype count that gates the
    complete-data kernels). No-op single-process."""
    import jax

    if jax.process_count() == 1:
        return float(value)
    import numpy as np
    from jax.experimental import multihost_utils

    return float(multihost_utils.process_allgather(
        np.asarray([value], np.float64)).sum())
