"""Mesos launcher (parity: reference tracker/dmlc_tracker/mesos.py).

Uses `mesos-execute` per rank with the DMLC_* contract in the task env.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import threading

from ..submit import submit


def run(args) -> None:
    if shutil.which("mesos-execute") is None:
        raise SystemExit("--cluster=mesos requires mesos-execute on PATH")
    master = args.extra_env.get("MESOS_MASTER", "zk://localhost:2181/mesos")

    def spawn_all(num_workers: int, num_servers: int, envs: dict) -> None:
        def one(role: str, task_id: int) -> None:
            pairs = dict(envs)
            pairs.update(args.extra_env)
            pairs.update({"DMLC_ROLE": role, "DMLC_TASK_ID": task_id,
                          "DMLC_JOB_CLUSTER": "mesos"})
            env_json = json.dumps(
                {"variables": [{"name": k, "value": str(v)} for k, v in pairs.items()]})
            cmd = ["mesos-execute", f"--master={master}",
                   f"--name=dmlc-{role}-{task_id}",
                   f"--resources=cpus:{args.worker_cores};mem:{args.worker_memory_mb}",
                   f"--env={env_json}",
                   "--command=" + " ".join(args.command)]
            subprocess.run(cmd)

        for i in range(num_servers):
            threading.Thread(target=one, args=("server", i), daemon=True).start()
        for i in range(num_workers):
            threading.Thread(target=one, args=("worker", i), daemon=True).start()

    tracker = submit(args.num_workers, args.num_servers, spawn_all,
                     host_ip=args.host_ip, extra_envs=args.extra_env)
    tracker.join()
