"""``--cluster=tpu``: refused.

The JAX package's backend places one rank on each host of a TPU VM slice
and hands it a JAX coordinator.  The port runs on NVIDIA cards, where a
job's ranks go through ``local``, ``ssh``, ``mpi``, ``slurm`` or another
scheduler's backend and join ``torch.distributed`` through
``parallel.init_from_env``.
"""
from __future__ import annotations


def run(args) -> None:
    raise ValueError(
        "--cluster=tpu places ranks on TPU VM slices; the PyTorch/CUDA port "
        "runs on NVIDIA cards: use --cluster=local, ssh, mpi, slurm, sge, "
        "yarn, mesos or kubernetes")
