"""SSH launcher: one env-exported ssh command per rank.

Parity: reference tracker/dmlc_tracker/ssh.py (host-file parse tolerating
mpi 'slots=' syntax, optional rsync of the working dir, env forwarding).
"""
from __future__ import annotations

import logging
import os
import subprocess

from ..submit import submit
from ._threads import RankThreads

LOGGER = logging.getLogger("dmlc_tpu.ssh")

FORWARD_ENV = ["OMP_NUM_THREADS", "LD_LIBRARY_PATH", "PYTHONPATH", "DMLC_INTERFACE",
               "AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY"]


def parse_host_file(path: str):
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            token = line.split()[0]  # tolerate 'host slots=N'
            host, _, port = token.partition(":")
            hosts.append((host, int(port) if port else 22))
    if not hosts:
        raise ValueError(f"no hosts in {path}")
    return hosts


def _export_prefix(envs: dict) -> str:
    pairs = dict(envs)
    for key in FORWARD_ENV:
        if key in os.environ:
            pairs.setdefault(key, os.environ[key])
    return "; ".join(f"export {k}={v!s}" for k, v in pairs.items())


def run(args) -> None:
    if not args.host_file:
        raise SystemExit("--cluster=ssh requires --host-file")
    hosts = parse_host_file(args.host_file)
    ranks = RankThreads()

    def spawn_all(num_workers: int, num_servers: int, envs: dict) -> None:
        def one(role: str, task_id: int, host: str, port: int) -> None:
            env = dict(envs)
            env.update(args.extra_env)
            env.update({"DMLC_ROLE": role, "DMLC_TASK_ID": task_id,
                        "DMLC_JOB_CLUSTER": "ssh", "DMLC_NODE_HOST": host})
            cwd = os.getcwd()
            if args.sync_dst_dir:
                subprocess.run(["rsync", "-az", cwd + "/",
                                f"{host}:{args.sync_dst_dir}/"], check=True)
                cwd = args.sync_dst_dir
            remote = (f"{_export_prefix(env)}; cd {cwd}; "
                      + " ".join(args.command))
            cmd = ["ssh", "-o", "StrictHostKeyChecking=no", "-p", str(port), host, remote]
            proc = subprocess.run(cmd)
            if proc.returncode != 0:
                raise RuntimeError(f"{role} {task_id} on {host} exited {proc.returncode}")

        idx = 0
        for i in range(num_servers):
            host, port = hosts[idx % len(hosts)]
            ranks.spawn(one, "server", i, host, port)
            idx += 1
        for i in range(num_workers):
            host, port = hosts[idx % len(hosts)]
            ranks.spawn(one, "worker", i, host, port)
            idx += 1

    tracker = submit(args.num_workers, args.num_servers, spawn_all,
                     host_ip=args.host_ip, extra_envs=args.extra_env)
    ranks.join_tracker(tracker)
