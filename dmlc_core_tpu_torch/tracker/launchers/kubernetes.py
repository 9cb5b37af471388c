"""Kubernetes launcher (parity: reference tracker/dmlc_tracker/kubernetes.py).

Creates one Job per role with `parallelism`/`completions` = rank count and
the DMLC_* contract in the pod env; ranks come from the pod's
JOB_COMPLETION_INDEX (indexed Jobs).  Uses kubectl (the python kubernetes
client is not baked into this image); manifests are emitted to stdout with
--dry-run for inspection when kubectl is absent.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

from ..submit import submit


def _job_manifest(name: str, image: str, n: int, pairs: dict, command: list,
                  cores: int, memory_mb: int, retries: int | None = None) -> dict:
    env = [{"name": k, "value": str(v)} for k, v in pairs.items()]
    env.append({"name": "DMLC_TASK_ID",
                "valueFrom": {"fieldRef": {
                    "fieldPath": "metadata.annotations['batch.kubernetes.io/job-completion-index']"}}})
    spec = {
        "completions": n,
        "parallelism": n,
        "completionMode": "Indexed",
    }
    if retries is not None:
        # per-rank restarts (k8s >= 1.28 with JobBackoffLimitPerIndex): one
        # flaky worker retries alone instead of burning the Job-wide budget.
        # Emitted only when --container-retries is explicitly set — clusters
        # older than 1.28 reject the field at admission.
        spec["backoffLimitPerIndex"] = retries
    else:
        spec["backoffLimit"] = 3  # Job-wide default, accepted everywhere
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": name},
        "spec": {
            **spec,
            "template": {
                "spec": {
                    "restartPolicy": "Never",
                    "containers": [{
                        "name": "dmlc",
                        "image": image,
                        "command": command,
                        "env": env,
                        "resources": {"requests": {
                            "cpu": str(cores), "memory": f"{memory_mb}Mi"}},
                    }],
                }
            },
        },
    }


def run(args) -> None:
    image = args.extra_env.get("DMLC_K8S_IMAGE", "python:3.12")
    jobname = args.jobname or "dmlc-job"

    dry_run = shutil.which("kubectl") is None

    def spawn_all(num_workers: int, num_servers: int, envs: dict) -> None:
        def launch(role: str, n: int) -> None:
            if n == 0:
                return
            pairs = dict(envs)
            pairs.update(args.extra_env)
            pairs.update({"DMLC_ROLE": role, "DMLC_JOB_CLUSTER": "kubernetes"})
            manifest = _job_manifest(f"{jobname}-{role}", image, n, pairs,
                                     args.command, args.worker_cores,
                                     args.worker_memory_mb,
                                     getattr(args, "container_retries", None))
            text = json.dumps(manifest)
            if dry_run:
                sys.stdout.write(text + "\n")
                return
            subprocess.run(["kubectl", "apply", "-f", "-"], input=text,
                           text=True, check=True)

        launch("server", num_servers)
        launch("worker", num_workers)

    tracker = submit(args.num_workers, args.num_servers, spawn_all,
                     host_ip=args.host_ip, extra_envs=args.extra_env)
    if dry_run:
        # manifests were only printed — no pods will ever phone home, so
        # joining the tracker would block forever
        sys.stderr.write("kubectl not found: manifests emitted to stdout, "
                         "not submitted; skipping tracker join\n")
        tracker.stop()
        return
    tracker.join()
