"""Sun Grid Engine launcher: qsub array job whose wrapper script derives
DMLC_TASK_ID from $SGE_TASK_ID.

Parity: reference tracker/dmlc_tracker/sge.py.
"""
from __future__ import annotations

import os
import stat
import subprocess
import tempfile

from ..submit import submit


def run(args) -> None:
    def spawn_all(num_workers: int, num_servers: int, envs: dict) -> None:
        pairs = dict(envs)
        pairs.update(args.extra_env)
        pairs["DMLC_JOB_CLUSTER"] = "sge"

        def qsub(role: str, n: int) -> None:
            if n == 0:
                return
            lines = ["#!/bin/bash", "#$ -S /bin/bash"]
            for k, v in pairs.items():
                lines.append(f"export {k}={v}")
            lines.append(f"export DMLC_ROLE={role}")
            lines.append("export DMLC_TASK_ID=$((SGE_TASK_ID - 1))")
            lines.append(" ".join(args.command))
            fd, path = tempfile.mkstemp(prefix=f"dmlc_{role}_", suffix=".sh")
            with os.fdopen(fd, "w") as f:
                f.write("\n".join(lines) + "\n")
            os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR)
            name = (args.jobname or "dmlc") + "-" + role
            subprocess.run(["qsub", "-cwd", "-t", f"1-{n}", "-N", name, path],
                           check=True)

        qsub("server", num_servers)
        qsub("worker", num_workers)

    tracker = submit(args.num_workers, args.num_servers, spawn_all,
                     host_ip=args.host_ip, extra_envs=args.extra_env)
    tracker.join()
