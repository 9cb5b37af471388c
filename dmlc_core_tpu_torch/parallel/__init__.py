"""Distributed execution over ``torch.distributed``: process meshes,
collectives, the mesh planner and the multi-process bootstrap from the
DMLC_* env contract (the JAX package's ``parallel``, one process a card)."""
from .bootstrap import DmlcEnvInfo, dmlc_env_info, init_from_env
from .collective import (allreduce, allreduce_bench, collective_bench,
                         collective_sweep)
from .mesh import (data_sharding, local_index, make_mesh,
                   replicated_sharding)
from .meshplan import MeshPlan, plan_allreduce_bench

__all__ = [
    "make_mesh", "data_sharding", "replicated_sharding", "local_index",
    "allreduce", "allreduce_bench", "collective_bench", "collective_sweep",
    "MeshPlan", "plan_allreduce_bench",
    "init_from_env", "dmlc_env_info", "DmlcEnvInfo",
]
