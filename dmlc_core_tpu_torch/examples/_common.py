"""What the example programs share: joining the job a launcher started,
and the plan of a ``--shard`` run."""
from __future__ import annotations

import os
from typing import Optional

import torch


def local_ranks(rank: int, ranks: int, coord: Optional[str] = None):
    """``(local rank, local ranks)``: this rank's place among the ranks of
    its own host.  ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` where the launcher
    sets them; every rank on this host for a local job (``dmlc_submit
    --cluster=local``, or a ``coord`` on the loopback); else one rank a
    host."""
    env = os.environ
    if "LOCAL_RANK" in env and "LOCAL_WORLD_SIZE" in env:
        return int(env["LOCAL_RANK"]), int(env["LOCAL_WORLD_SIZE"])
    host = coord.rsplit(":", 1)[0] if coord else None
    if env.get("DMLC_JOB_CLUSTER") == "local" or host in ("127.0.0.1",
                                                          "localhost"):
        return rank, ranks
    return 0, 1


def join_job(device: str, coord: Optional[str] = None,
             nprocs: Optional[int] = None, pid: Optional[int] = None):
    """Join this process's job and return ``(rank, ranks, device,
    worker)``, ``worker`` the tracker client to shut down at the end (None
    when no tracker started the job).

    With ``coord`` (``host:port``), a TCP ``init_process_group`` of
    ``nprocs`` ranks as rank ``pid``; else the DMLC_* contract of
    ``dmlc_submit`` (the rank first rendezvouses with the job's tracker,
    then ``parallel.init_from_env``); a process outside any job is a
    1-rank job.  On the card a rank runs on the card of its local rank
    (``local_ranks``) and takes ``nccl`` when its host's ranks have a card
    each, ``gloo`` when they share cards (NCCL refuses two ranks on one
    device); on the CPU, ``gloo``."""
    import torch.distributed as dist

    from .._device import resolve_device
    from ..parallel import dmlc_env_info, init_from_env
    dev = resolve_device(device)
    if coord:
        rank, ranks = int(pid), int(nprocs)
    else:
        info = dmlc_env_info()
        rank, ranks = info.task_id, info.num_workers
    backend = None  # nccl on the card, gloo on the CPU
    if dev.type == "cuda":
        local, here = local_ranks(rank, ranks, coord)
        count = torch.cuda.device_count()
        dev = torch.device("cuda", local % count)
        torch.cuda.set_device(dev)
        if here > count:
            backend = "gloo"
    worker = None
    if coord:
        if ranks > 1:
            dist.init_process_group(
                backend or ("nccl" if dev.type == "cuda" else "gloo"),
                init_method=f"tcp://{coord}", world_size=ranks, rank=rank)
    elif ranks > 1 and os.environ.get("DMLC_TRACKER_URI"):
        from ..tracker import WorkerClient
        worker = WorkerClient().start(world_size=ranks)
        init_from_env(backend=backend, device=dev)
    return rank, ranks, dev, worker


def leave_job(worker) -> None:
    """Leave the process group and tell the tracker this rank is done."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    if worker is not None:
        worker.shutdown()


def sdot_backend(dev) -> Optional[str]:
    """The sparse dot products' route: the segment-sum kernel on the card;
    on the CPU ``index_add`` (the kernel's plain version is a one-hot
    contraction, minutes at an example's epochs there)."""
    return "pallas" if torch.device(dev).type == "cuda" else None
