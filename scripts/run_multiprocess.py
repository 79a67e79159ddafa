"""Launch the CLI as a multi-process jax.distributed job on one host.

The process-level analogue of the reference's `srun`/mvapich launch
(main.cpp:20 MPI_Init; CSCS/*.sh): K separate Python processes each run the
unmodified CLI, wired into one jax.distributed job via a localhost
coordinator. Each process sees only its own local devices, loads only its
own marker shards from the .bed (runner.dataset_from_options per-host read),
and only process 0 writes output files (outputs.writers.NullWriter on the
rest).

CPU (virtual devices):
    python scripts/run_multiprocess.py --nprocs 2 --devices-per-proc 4 -- \
        --mpibayes bayesMPI --bfile demo --pheno demo.phen ...

GPUs, one process per card (process p sees only cards p*D .. p*D+D-1
through CUDA_VISIBLE_DEVICES, so no process reserves memory on another's
card):
    python scripts/run_multiprocess.py --device gpu --nprocs 4 \
        --devices-per-proc 1 -- --mpibayes bayesMPI ...

Across hosts, each host runs the CLI itself with HYDRA_COORDINATOR /
HYDRA_NUM_PROCS / HYDRA_PROC_ID set (parallel/distributed.py).
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(nprocs: int, devices_per_proc: int, cli_args, *,
           device: str = "cpu", repo: str = None, port: int = None,
           stdout_dir: str = None):
    """Spawn the K CLI processes; returns the Popen list."""
    repo = repo or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = port or free_port()
    # numbering within the cards this launcher itself may see
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = (visible.split(",") if visible
             else [str(i) for i in range(nprocs * devices_per_proc)])
    procs = []
    for pid in range(nprocs):
        env = dict(
            os.environ,
            PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
            HYDRA_COORDINATOR=f"localhost:{port}",
            HYDRA_NUM_PROCS=str(nprocs),
            HYDRA_PROC_ID=str(pid),
        )
        if device == "gpu":
            env["CUDA_VISIBLE_DEVICES"] = ",".join(
                cards[pid * devices_per_proc:(pid + 1) * devices_per_proc])
            # by default the processes of one job split XLA's autotuning
            # among themselves and exchange the results; on the 4 x H100
            # host that compile crashed (SIGSEGV in backend_compile) in some
            # of the processes, so each process autotunes its own program
            env["XLA_FLAGS"] = ("--xla_gpu_shard_autotuning=false "
                                + env.get("XLA_FLAGS", "")).strip()
        else:
            # strip any inherited device-count flag (e.g. from the test
            # harness env) — XLA takes the LAST occurrence, which would
            # silently change the worker's device count and thus the mesh
            import re
            inherited = re.sub(
                r"--xla_force_host_platform_device_count=\d+\s*", "",
                env.get("XLA_FLAGS", ""))
            env["XLA_FLAGS"] = (
                f"--xla_force_host_platform_device_count={devices_per_proc} "
                + inherited)
        cmd = [sys.executable, "-m", "hydra_tpu.cli",
               "--device", device] + list(cli_args)
        if stdout_dir:
            out = open(os.path.join(stdout_dir, f"proc{pid}.log"), "w")
        else:
            out = None
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=out, stderr=subprocess.STDOUT if out else None))
    return procs


def wait_all(procs, timeout: float = 1800, kill_on_failure: bool = True):
    """Wait for all processes; if one dies (crash or kill) the rest would
    hang in their next collective — mirror MPI job semantics by killing the
    whole gang. Returns the exit-code list."""
    deadline = time.time() + timeout
    codes = [None] * len(procs)
    while time.time() < deadline and any(c is None for c in codes):
        for i, p in enumerate(procs):
            if codes[i] is None:
                codes[i] = p.poll()
        if kill_on_failure and any(c not in (None, 0) for c in codes):
            time.sleep(2.0)  # grace: let peers exit on their own
            for i, p in enumerate(procs):
                if p.poll() is None:
                    p.kill()
        time.sleep(0.1)
    for i, p in enumerate(procs):
        if p.poll() is None:
            p.kill()
            codes[i] = "timeout"
        elif codes[i] is None:
            codes[i] = p.poll()
    return codes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--device", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--timeout", type=float, default=1800)
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("cli_args", nargs=argparse.REMAINDER,
                    help="-- then hydra CLI flags")
    args = ap.parse_args()
    cli = args.cli_args
    if cli and cli[0] == "--":
        cli = cli[1:]
    procs = launch(args.nprocs, args.devices_per_proc, cli,
                   device=args.device, stdout_dir=args.log_dir)
    deadline = time.time() + args.timeout
    codes = [None] * len(procs)
    try:
        while time.time() < deadline and any(c is None for c in codes):
            for i, p in enumerate(procs):
                if codes[i] is None:
                    codes[i] = p.poll()
            time.sleep(0.2)
        for i, p in enumerate(procs):
            if codes[i] is None:
                p.send_signal(signal.SIGKILL)
                codes[i] = "timeout"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    print(f"exit codes: {codes}")
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
