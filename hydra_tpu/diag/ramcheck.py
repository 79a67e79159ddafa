"""Device/host memory estimator — the analogue of --check-RAM (C24).

The reference simulates per-node malloc of the sparse structures across a
SLURM layout (checkRamUsage, BayesRRm.cpp:2947-3084). Here the model is the
packed-BED layout: per-device memory = genotype shard + replicated residual
buffers + per-marker state + window workspace. The estimate is compared
with the memory JAX may use on the device this run sees
(`memory_stats()["bytes_limit"]`); no size is assumed for a device that
reports none.
"""

from __future__ import annotations

from hydra_tpu.data.genotypes import pad_individuals
from hydra_tpu.options import Options


def estimate_bytes(m_tot: int, n: int, n_chips: int, window: int,
                   k: int = 4, num_groups: int = 1, n_ind: int = 1) -> dict:
    """Per-device bytes for an (n_chips/n_ind markers) x (n_ind inds) mesh.

    n_ind > 1 (--ind-shards) divides every N-length buffer — residual,
    workspace planes, genotype byte columns — by the inds axis size."""
    n_pad = pad_individuals(n)
    n_marker_chips = max(1, n_chips // max(n_ind, 1))
    n_loc = -(-n_pad // max(n_ind, 1))
    m_loc = -(-m_tot // n_marker_chips)
    m_loc = -(-m_loc // window) * window
    geno = m_loc * (n_loc // 4)                    # packed 2-bit genotypes
    eps = 2 * n_loc * 4                            # eps + delta buffer
    marker_state = m_loc * (4 + 4 + 4 + 4 + 4 + 4)  # beta/comp/acum/mave/mstd/valid
    window_ws = window * n_loc * 4 * 2             # decoded planes (upper bound
                                                   # of the transient workspace)
    gram = window * window * 4
    total = geno + eps + marker_state + window_ws + gram
    return dict(geno=geno, eps=eps, marker_state=marker_state,
                window_ws=window_ws, gram=gram, total=total,
                m_loc=m_loc, n_pad=n_pad, n_loc=n_loc)


def check_ram_sparse(opt: Options) -> dict:
    """Reference-parity path: read the REAL .sl1/.sl2/.slm element counts and
    simulate the SLURM node packing (checkRamUsage, BayesRRm.cpp:2947-3084).

    Node n holds tasks [n*tpn, (n+1)*tpn) while nodes past `nfull` drop one
    task (the reference's block task-assignment replica, :3030-3037); each
    task's RAM is (n1+n2+nm) u32 indices over its marker range."""
    import numpy as np

    from hydra_tpu.io.groups import (assign_blocks_to_tasks,
                                     read_marker_blocks_file)

    basename = (opt.sparse_dir + "/" + opt.sparse_basename
                if opt.sparse_dir else opt.sparse_basename)
    n1l = np.fromfile(basename + ".sl1", dtype=np.uint64)
    n2l = np.fromfile(basename + ".sl2", dtype=np.uint64)
    nml = np.fromfile(basename + ".slm", dtype=np.uint64)
    mtot = len(n1l)

    tpn = max(1, opt.check_ram_tpn or 1)
    nranks = max(1, opt.check_ram_tasks or 1)
    blocks = (read_marker_blocks_file(opt.marker_blocks_file)
              if opt.marker_blocks_file else None)
    if blocks is not None:
        nranks = len(blocks[0])
        starts, lens = assign_blocks_to_tasks(
            nranks, blocks[0], blocks[1], mtot, nranks)
    else:
        starts, lens = assign_blocks_to_tasks(0, None, None, mtot, nranks)
    nnodes = -(-nranks // tpn)
    nfull = nranks + nnodes * (1 - tpn)
    print(f"INFO  : will simulate {nranks} ranks on {nnodes} nodes with "
          f"max {tpn} tasks per node.")
    print(f"INFO   : longest  task has {int(lens.max())} markers.")
    print(f"INFO   : smallest task has {int(lens.min())} markers.")
    print(f"INFO   : number of nodes fully loaded: {nfull}")

    node_gb = []
    task = 0
    for node in range(nnodes):
        this_tpn = tpn if node < nfull else tpn - 1
        ram = 0.0
        for _ in range(this_tpn):
            s, l = int(starts[task]), int(lens[task])
            n1 = int(n1l[s: s + l].sum())
            n2 = int(n2l[s: s + l].sum())
            nm = int(nml[s: s + l].sum())
            gb = (n1 + n2 + nm) * 4 * 1e-9
            ram += gb
            print(f"   - t {task:3d}  n {node:2d} sm {s:7d}  l {l:6d} "
                  f"markers. Number of 1s: {n1}, 2s: {n2}, ms: {nm} "
                  f"=> RAM: {gb:7.3f} GB; RAM on node: {ram:7.3f}")
            task += 1
        node_gb.append(ram)
    mx = int(np.argmax(node_gb))
    print(f"    => max RAM required on a node will be {max(node_gb):7.3f} GB "
          f"on node {mx}")
    print(f"    => setting up your sbatch with {nranks} tasks and {tpn} "
          f"tasks per node should work; Will require {nnodes} nodes!")
    return dict(node_gb=node_gb, max_gb=max(node_gb), nodes=nnodes,
                nranks=nranks)


def device_bytes_limit():
    """Bytes JAX may allocate on the first visible device, or None when the
    device reports no limit (the CPU)."""
    import jax

    stats = jax.devices()[0].memory_stats()
    return (stats or {}).get("bytes_limit")


def check_ram_usage(opt: Options) -> dict:
    if opt.read_from_sparse_files:
        return check_ram_sparse(opt)
    from hydra_tpu.io import plink
    n = opt.number_individuals or plink.read_fam(opt.bed_file + ".fam").n
    m = opt.number_markers or plink.read_bim(opt.bed_file + ".bim").m
    chips = max(1, opt.check_ram_tasks or 1)
    est = estimate_bytes(m, n, chips, max(opt.window, 1),
                         n_ind=max(getattr(opt, "ind_shards", 1), 1))
    gb = est["total"] / 1e9
    print(f"INFO   : M={m} N={n} over {chips} device(s), window={opt.window}, "
          f"ind-shards={getattr(opt, 'ind_shards', 1)}")
    print(f"INFO   : per-device memory estimate: {gb:.3f} GB "
          f"(geno {est['geno'] / 1e9:.3f}, workspace {est['window_ws'] / 1e9:.3f})")
    # --check-RAM-tasks-per-node: devices per host (the reference's per-node
    # grouping, BayesRRm.cpp:2947-3084). Host RAM must stage every local
    # device's genotype shard during load, so report the per-host aggregate.
    tpn = max(0, opt.check_ram_tpn)
    if tpn:
        hosts = -(-chips // tpn)
        host_gb = est["total"] * min(tpn, chips) / 1e9
        est["hosts"] = hosts
        est["per_host"] = est["total"] * min(tpn, chips)
        print(f"INFO   : {tpn} device(s)/host -> {hosts} host(s); per-host "
              f"aggregate (host staging at load): {host_gb:.3f} GB")
    limit = device_bytes_limit()
    est["bytes_limit"] = limit
    if limit is None:
        print("INFO   : this device reports no memory limit (CPU run); "
              "no device-memory check made")
    elif est["total"] > limit:
        print(f"WARNING: exceeds the {limit / 1e9:.1f} GB JAX may use on "
              f"this device; need >= {-(-est['total'] // int(limit))} "
              "devices or a smaller window")
    else:
        print(f"INFO   : fits the {limit / 1e9:.1f} GB JAX may use on this "
              "device")
    return est
