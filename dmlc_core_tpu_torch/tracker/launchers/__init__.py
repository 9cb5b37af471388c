"""Cluster launcher backends for dmlc-submit (``tpu`` is refused: the
port runs on NVIDIA cards)."""
from __future__ import annotations

from importlib import import_module

_BACKENDS = {
    "local": ".local",
    "ssh": ".ssh",
    "tpu": ".tpu",
    "mpi": ".mpi",
    "sge": ".sge",
    "slurm": ".slurm",
    "yarn": ".yarn",
    "mesos": ".mesos",
    "kubernetes": ".kubernetes",
}


def get(name: str):
    """Resolve a launcher's run(args) entry point."""
    if name not in _BACKENDS:
        raise ValueError(f"unknown cluster backend '{name}' (have {sorted(_BACKENDS)})")
    return import_module(_BACKENDS[name], __package__).run
