"""dmlc-submit CLI options (the port of ``dmlc_core_tpu.tracker.opts``)."""
from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="dmlc-submit",
        description="Submit a distributed DMLC job (PyTorch/CUDA build).")
    parser.add_argument(
        "--cluster", "-c",
        choices=["local", "ssh", "tpu", "mpi", "sge", "slurm", "yarn", "mesos",
                 "kubernetes"],
        default=os.environ.get("DMLC_SUBMIT_CLUSTER", "local"),
        help="cluster backend (env fallback DMLC_SUBMIT_CLUSTER)")
    parser.add_argument("--num-workers", "-n", type=int, required=True,
                        help="number of worker processes")
    parser.add_argument("--num-servers", "-s", type=int, default=0,
                        help="number of parameter-server processes")
    parser.add_argument("--worker-cores", type=int, default=1,
                        help="cores per worker (resource hints for schedulers)")
    parser.add_argument("--worker-memory-mb", type=int, default=1024)
    parser.add_argument("--host-file", "-H", default=None,
                        help="ssh/mpi: file listing one host[:port] per line")
    parser.add_argument("--host-ip", default=os.environ.get("DMLC_TRACKER_HOST", "auto"),
                        help="IP the tracker binds/advertises")
    parser.add_argument("--jobname", default=None, help="job name")
    parser.add_argument("--queue", default=os.environ.get("DMLC_JOB_QUEUE", "default"),
                        help="yarn: submission queue")
    # default None = "not explicitly set": yarn substitutes 3; kubernetes
    # omits backoffLimitPerIndex (rejected at admission before k8s 1.28)
    parser.add_argument("--container-retries", type=int,
                        default=(int(os.environ["DMLC_NUM_ATTEMPT"])
                                 if "DMLC_NUM_ATTEMPT" in os.environ else None),
                        help="yarn/kubernetes: per-container restart attempts")
    parser.add_argument("--sync-dst-dir", default=None,
                        help="ssh: rsync the working dir to this remote path first")
    parser.add_argument("--local-num-attempt", type=int,
                        default=int(os.environ.get("DMLC_NUM_ATTEMPT", "1")),
                        help="local: restart attempts for failed workers")
    parser.add_argument("--data-service", type=int,
                        default=int(os.environ.get("DMLC_DATA_SERVICE", "0")),
                        help="spawn N staging-service workers next to the "
                             "tracker (env fallback DMLC_DATA_SERVICE)")
    parser.add_argument("--env", action="append", default=[],
                        help="extra KEY=VALUE exported to every worker (repeatable)")
    parser.add_argument("--log-level", default="INFO",
                        choices=["DEBUG", "INFO", "WARNING", "ERROR"])
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="worker command line")
    return parser


def parse(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if not args.command:
        raise SystemExit("dmlc-submit: missing worker command")
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    extra = {}
    for item in args.env:
        key, _, value = item.partition("=")
        extra[key] = value
    args.extra_env = extra
    return args
