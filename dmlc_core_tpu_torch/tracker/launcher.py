"""In-container bootstrap (the port of ``dmlc_core_tpu.tracker.launcher``).

Run as the container entry point: unzips shipped archives, extends
LD_LIBRARY_PATH/CLASSPATH from a hadoop install when present, derives
DMLC_TASK_ID from scheduler-specific env (SGE_TASK_ID, Slurm PROCID, k8s
job completion index), then execs the user command.
"""
from __future__ import annotations

import glob
import os
import subprocess
import sys
import zipfile


def unzip_archives(workdir: str = ".") -> None:
    for path in glob.glob(os.path.join(workdir, "*.zip")):
        with zipfile.ZipFile(path) as zf:
            zf.extractall(workdir)


def derive_task_id(env: dict) -> None:
    if "DMLC_TASK_ID" in env:
        return
    if env.get("SGE_TASK_ID", "").isdigit():
        # non-array SGE jobs export the literal string "undefined"
        env["DMLC_TASK_ID"] = str(int(env["SGE_TASK_ID"]) - 1)
    elif "SLURM_PROCID" in env:
        env["DMLC_TASK_ID"] = env["SLURM_PROCID"]
    elif "JOB_COMPLETION_INDEX" in env:
        env["DMLC_TASK_ID"] = env["JOB_COMPLETION_INDEX"]
    elif "OMPI_COMM_WORLD_RANK" in env:
        env["DMLC_TASK_ID"] = env["OMPI_COMM_WORLD_RANK"]
    elif "PMI_RANK" in env:
        env["DMLC_TASK_ID"] = env["PMI_RANK"]


def extend_hadoop_paths(env: dict) -> None:
    hadoop_home = env.get("HADOOP_HOME") or env.get("HADOOP_HDFS_HOME")
    if not hadoop_home:
        return
    lib = os.path.join(hadoop_home, "lib", "native")
    env["LD_LIBRARY_PATH"] = lib + ":" + env.get("LD_LIBRARY_PATH", "")
    jars = glob.glob(os.path.join(hadoop_home, "share", "hadoop", "*", "*.jar"))
    if jars:
        env["CLASSPATH"] = ":".join(jars) + ":" + env.get("CLASSPATH", "")


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m dmlc_core_tpu_torch.tracker.launcher "
              "<command>...",
              file=sys.stderr)
        return 2
    env = os.environ.copy()
    unzip_archives()
    derive_task_id(env)
    extend_hadoop_paths(env)
    return subprocess.call(argv, env=env)


if __name__ == "__main__":
    raise SystemExit(main())
