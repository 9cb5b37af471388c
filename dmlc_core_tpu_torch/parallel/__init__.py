"""Multi-process bootstrap from the DMLC_* env contract into
``torch.distributed``.

The JAX package's ``parallel`` also holds its device meshes, collectives
and mesh planner (``make_mesh``, ``allreduce``, ``MeshPlan``); they are not
ported yet (ROADMAP A6b).
"""
from .bootstrap import DmlcEnvInfo, dmlc_env_info, init_from_env

__all__ = ["DmlcEnvInfo", "dmlc_env_info", "init_from_env"]
