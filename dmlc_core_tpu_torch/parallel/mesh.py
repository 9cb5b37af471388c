"""Process meshes over ``torch.distributed``.

The reference's only scaling axis is row-sharded data parallelism
(``InputSplit(uri, rank, nparts)`` and a rabit all-reduce downstream).  The
JAX package maps that axis onto a device mesh inside one process; the port
follows PyTorch's idiom instead: one process (rank) per card, and the mesh
is a ``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks.
A rank's rows are its local tensors; the collectives run over the
process group (NCCL on cards, gloo on the CPU and for several ranks on one
card).
"""
from __future__ import annotations

import socket
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch.distributed as dist


def world() -> tuple:
    """(rank, world size) of this process: (0, 1) without an initialised
    process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def mesh_device_type() -> str:
    """The ``DeviceMesh`` device type for the default group's backend:
    ``cuda`` for NCCL, ``cpu`` for gloo (whose collectives the port stages
    through host memory)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def host_count(ranks: Sequence[int]) -> int:
    """Distinct hosts among the world's ``ranks`` (by host name, gathered
    once over the default group: a collective)."""
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return len({names[r] for r in ranks})


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",), devices=None):
    """A ``DeviceMesh`` over every rank of the world (or the given ranks).

    Default: a 1-D ``data`` mesh over all ranks, the dmlc data-parallel
    world.  A 2-axis mesh with no sizes defaults to ``(hosts,
    ranks_per_host)`` when the ranks live on more than one host.  Sizes
    that do not factor the available ranks raise ``ValueError``, never a
    silently wrong mesh.  Needs an initialised process group
    (``parallel.init_from_env``); every rank calls it, in the same order
    (the mesh makes its groups once)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "process group (parallel.init_from_env)")
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    n = len(ranks)
    if axis_sizes is None:
        if len(axis_names) == 1:
            axis_sizes = (n,)
        elif len(axis_names) == 2:
            hosts = host_count(ranks)
            if hosts > 1 and n % hosts == 0:
                axis_sizes = (hosts, n // hosts)
    check_sizes(axis_sizes, axis_names, n)
    return DeviceMesh(mesh_device_type(),
                      np.asarray(ranks).reshape(tuple(axis_sizes)).tolist(),
                      mesh_dim_names=tuple(axis_names))


def check_sizes(axis_sizes, axis_names, n: int) -> None:
    """The JAX package's mesh-size rules and errors, over ``n`` ranks."""
    if axis_sizes is None:
        raise ValueError(
            f"axis_sizes required for mesh axes {tuple(axis_names)} over "
            f"{n} single-host device(s)")
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(
            f"mesh axis_sizes {tuple(axis_sizes)} do not factor the {n} "
            f"available device(s)")


@dataclass(frozen=True)
class RowSharding:
    """Rows sharded over the mesh's ``axes``: each rank holds its own rows
    as local tensors (the counterpart of ``NamedSharding(mesh,
    P(axis))``).  Staging iterators take it as ``sharding=``."""

    mesh: object
    axes: tuple = ("data",)


@dataclass(frozen=True)
class Replicated:
    """Every rank holds the whole value (``NamedSharding(mesh, P())``)."""

    mesh: object


def data_sharding(mesh, axis: str = "data") -> RowSharding:
    """Shard the leading (row) dimension over the ``axis`` of ``mesh``."""
    return RowSharding(mesh, (axis,) if isinstance(axis, str)
                       else tuple(axis))


def replicated_sharding(mesh) -> Replicated:
    """The fully replicated layout (model parameters in pure DP)."""
    return Replicated(mesh)
