"""Local launcher: workers/servers as subprocesses with retry.

Parity: reference tracker/dmlc_tracker/local.py (threaded spawn, DMLC_*
per-role env, DMLC_NUM_ATTEMPT retry loop).
"""
from __future__ import annotations

import logging
import os
import subprocess

from ..submit import submit
from ._threads import RankThreads

LOGGER = logging.getLogger("dmlc_tpu.local")


def run(args) -> None:
    ranks = RankThreads()

    def spawn_all(num_workers: int, num_servers: int, envs: dict) -> None:
        def one(role: str, task_id: int) -> None:
            env = os.environ.copy()
            env.update({k: str(v) for k, v in envs.items()})
            env.update(args.extra_env)
            env["DMLC_ROLE"] = role
            env["DMLC_TASK_ID"] = str(task_id)
            env["DMLC_JOB_CLUSTER"] = "local"
            attempts = max(args.local_num_attempt, 1)
            for attempt in range(attempts):
                env["DMLC_NUM_ATTEMPT"] = str(attempt)
                proc = subprocess.run(args.command, env=env)
                if proc.returncode == 0:
                    return
                LOGGER.warning("%s %d exited %d (attempt %d/%d)", role, task_id,
                               proc.returncode, attempt + 1, attempts)
            raise RuntimeError(f"{role} {task_id} failed after {attempts} attempts")

        for i in range(num_servers):
            ranks.spawn(one, "server", i)
        for i in range(num_workers):
            ranks.spawn(one, "worker", i)

    tracker = submit(args.num_workers, args.num_servers, spawn_all,
                     host_ip="127.0.0.1", pscmd=None, extra_envs=args.extra_env,
                     data_service=getattr(args, "data_service", 0))
    ranks.join_tracker(tracker)
