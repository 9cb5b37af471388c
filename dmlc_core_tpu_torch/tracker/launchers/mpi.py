"""MPI launcher: one mpirun for all ranks with env forwarding.

Parity: reference tracker/dmlc_tracker/mpi.py (OpenMPI '-x K=V' vs MPICH
'-env K V' flag detection).
"""
from __future__ import annotations

import subprocess

from ..submit import submit


def _mpi_flavor() -> str:
    try:
        out = subprocess.run(["mpirun", "--version"], capture_output=True,
                             text=True).stdout.lower()
    except FileNotFoundError:
        raise SystemExit("--cluster=mpi requires mpirun on PATH") from None
    return "openmpi" if "open mpi" in out or "open-mpi" in out else "mpich"


def run(args) -> None:
    flavor = _mpi_flavor()

    def spawn_all(num_workers: int, num_servers: int, envs: dict) -> None:
        env_pairs = dict(envs)
        env_pairs.update(args.extra_env)
        env_pairs["DMLC_JOB_CLUSTER"] = "mpi"

        def mpirun(role: str, n: int) -> None:
            if n == 0:
                return
            cmd = ["mpirun", "-n", str(n)]
            if args.host_file:
                cmd += ["--hostfile", args.host_file]
            pairs = dict(env_pairs)
            pairs["DMLC_ROLE"] = role
            for k, v in pairs.items():
                if flavor == "openmpi":
                    cmd += ["-x", f"{k}={v}"]
                else:
                    cmd += ["-env", k, str(v)]
            cmd += args.command
            subprocess.Popen(cmd)

        mpirun("server", num_servers)
        mpirun("worker", num_workers)

    tracker = submit(args.num_workers, args.num_servers, spawn_all,
                     host_ip=args.host_ip, extra_envs=args.extra_env)
    tracker.join()
