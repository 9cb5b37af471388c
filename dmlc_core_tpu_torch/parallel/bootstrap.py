"""Multi-process bootstrap from the DMLC_* env contract.

The tracker hands every worker its coordinates through env vars:
DMLC_TRACKER_URI/PORT, DMLC_ROLE, DMLC_TASK_ID, DMLC_NUM_WORKER.  This
module keeps that contract as the JAX package's ``parallel.bootstrap``
does and maps it onto ``torch.distributed.init_process_group``: rank 0
binds the process group's TCP store on the tracker host at
``DMLC_TRACKER_PORT + coordinator_port_offset`` (the tracker itself owns
DMLC_TRACKER_PORT), and the collectives run over NCCL on cards or gloo on
the CPU.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from .._device import resolve_device


@dataclass
class DmlcEnvInfo:
    role: str
    task_id: int
    num_workers: int
    tracker_uri: Optional[str]
    tracker_port: Optional[int]

    @property
    def coordinator_address(self) -> Optional[str]:
        if self.tracker_uri is None:
            return None
        return f"{self.tracker_uri}:{self.tracker_port}"


def dmlc_env_info() -> DmlcEnvInfo:
    """Read the worker-side DMLC_* contract (absent vars: one process)."""
    return DmlcEnvInfo(
        role=os.environ.get("DMLC_ROLE", "worker"),
        task_id=int(os.environ.get("DMLC_TASK_ID", "0")),
        num_workers=int(os.environ.get("DMLC_NUM_WORKER", "1")),
        tracker_uri=os.environ.get("DMLC_TRACKER_URI"),
        tracker_port=int(os.environ["DMLC_TRACKER_PORT"])
        if "DMLC_TRACKER_PORT" in os.environ else None,
    )


def init_from_env(coordinator_port_offset: int = 1,
                  backend: Optional[str] = None,
                  device=None) -> DmlcEnvInfo:
    """Join the job's ``torch.distributed`` process group from the DMLC_*
    contract when it has more than one worker; a no-op for one worker.

    ``init_process_group(backend, init_method="tcp://<tracker uri>:<tracker
    port + coordinator_port_offset>", world_size=DMLC_NUM_WORKER,
    rank=DMLC_TASK_ID)``.  ``device`` is the rank's device, the card unless
    the caller asks for the CPU (it raises without a card, as every entry
    point does); the caller picks which card a rank runs on.
    ``backend=None`` picks ``nccl`` for a card and ``gloo`` for the CPU; a
    backend that fails raises, and no other is tried.  Several ranks on one
    card need ``gloo``: NCCL refuses two ranks on one device.
    """
    import torch.distributed as dist

    dev = resolve_device("cuda" if device is None else device)
    info = dmlc_env_info()
    if info.num_workers <= 1 or info.tracker_uri is None:
        return info
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    port = info.tracker_port + coordinator_port_offset
    dist.init_process_group(
        backend, init_method=f"tcp://{info.tracker_uri}:{port}",
        world_size=info.num_workers, rank=info.task_id)
    return info
