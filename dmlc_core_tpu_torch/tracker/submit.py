"""Job submission core: start the tracker, hand envs to a launcher backend.

The port of ``dmlc_core_tpu.tracker.submit``.  The env contract handed to
workers is the same (DMLC_TRACKER_URI/PORT, DMLC_ROLE, DMLC_TASK_ID,
DMLC_NUM_WORKER/SERVER, DMLC_PS_ROOT_URI/PORT, DMLC_JOB_CLUSTER), with
DMLC_JAX_COORDINATOR (tracker host, tracker port + 1: where
``parallel.init_from_env`` binds the ``torch.distributed`` store, and
where a JAX-package worker binds its coordination service) and
DMLC_TRACKER_METRICS_PORT, the tracker's telemetry channel
(``tracker/metrics.py``), on which the data service's staging workers
register (``data_service > 0``).
"""
from __future__ import annotations

import atexit
import logging
import os
import subprocess
import sys
from typing import Callable, List, Optional

from .rendezvous import PSTracker, RabitTracker, get_host_ip

LOGGER = logging.getLogger(__name__)


def spawn_data_service(count: int, envs: dict) -> List[subprocess.Popen]:
    """Start ``count`` staging workers (``python -m
    dmlc_core_tpu_torch.dataservice.server``) as local subprocesses under
    the job's env contract; each registers with the tracker's lease board
    over the metrics channel.  They are reaped at interpreter exit."""
    env = os.environ.copy()
    env.update({k: str(v) for k, v in envs.items()})
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.dataservice.server"],
        env=env) for _ in range(count)]
    LOGGER.info("spawned %d data-service staging worker(s)", count)

    def _reap() -> None:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
    atexit.register(_reap)
    return procs


def submit(num_workers: int, num_servers: int, fun_submit: Callable,
           host_ip: str = "auto", pscmd: Optional[str] = None,
           extra_envs: Optional[dict] = None,
           data_service: int = 0) -> RabitTracker | PSTracker:
    """Start the rendezvous and call fun_submit(num_workers, num_servers, envs).

    Returns the tracker (caller may join()); rabit mode when num_servers == 0,
    parameter-server scheduler mode otherwise.  ``data_service > 0`` also
    spawns that many staging workers beside the tracker (their Popen
    handles land on ``tracker.data_service_procs``).
    """
    envs = {"DMLC_NUM_WORKER": num_workers, "DMLC_NUM_SERVER": num_servers}
    envs.update(extra_envs or {})
    ip = get_host_ip(host_ip)

    if num_servers == 0:
        tracker = RabitTracker(host_ip=ip, num_workers=num_workers)
        envs.update(tracker.worker_envs())
        envs["DMLC_JAX_COORDINATOR"] = f"{ip}:{tracker.port + 1}"
        tracker.start()
        tracker.data_service_procs = (
            spawn_data_service(data_service, envs) if data_service > 0
            and tracker.alive() else [])
        if tracker.alive():
            fun_submit(num_workers, num_servers, envs)
        return tracker
    tracker = PSTracker(host_ip=ip, cmd=pscmd, envs=envs)
    envs.update(tracker.worker_envs())
    tracker.data_service_procs = (
        spawn_data_service(data_service, envs) if data_service > 0 else [])
    if tracker.alive() or pscmd is None:
        fun_submit(num_workers, num_servers, envs)
    return tracker


def main(argv=None) -> None:
    from . import launchers
    from .opts import parse

    args = parse(argv)
    logging.basicConfig(level=getattr(logging, args.log_level))
    launcher = launchers.get(args.cluster)
    launcher(args)


if __name__ == "__main__":
    main()
