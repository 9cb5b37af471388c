"""Slurm launcher: srun per role with env prefix.

Parity: reference tracker/dmlc_tracker/slurm.py (two srun calls, env
exported via --export).
"""
from __future__ import annotations

import subprocess

from ..submit import submit


def run(args) -> None:
    def spawn_all(num_workers: int, num_servers: int, envs: dict) -> None:
        def srun(role: str, n: int) -> None:
            if n == 0:
                return
            pairs = dict(envs)
            pairs.update(args.extra_env)
            pairs.update({"DMLC_ROLE": role, "DMLC_JOB_CLUSTER": "slurm"})
            export = "ALL," + ",".join(f"{k}={v}" for k, v in pairs.items())
            cmd = ["srun", f"--ntasks={n}", f"--export={export}"]
            if args.jobname:
                cmd.append(f"--job-name={args.jobname}-{role}")
            cmd += args.command
            subprocess.Popen(cmd)

        srun("server", num_servers)
        srun("worker", num_workers)

    tracker = submit(args.num_workers, args.num_servers, spawn_all,
                     host_ip=args.host_ip, extra_envs=args.extra_env)
    tracker.join()
