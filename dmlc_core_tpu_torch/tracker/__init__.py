"""Distributed job bootstrap: the rabit-compatible rendezvous tracker, a
worker client, the tracker's telemetry channel, and the cluster launchers
behind ``python -m dmlc_core_tpu_torch.tracker.dmlc_submit``."""
from .rendezvous import PSTracker, RabitTracker, WorkerClient, get_host_ip
from .submit import submit

__all__ = ["RabitTracker", "PSTracker", "WorkerClient", "get_host_ip", "submit"]
