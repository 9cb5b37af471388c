"""Mesh plan: one object owning the ranks' topology, the row layout and the
collective each payload takes, over ``torch.distributed``.

The port of ``dmlc_core_tpu.parallel.meshplan``, over processes instead of
the devices of one process:

* **Topology**: hosts are distinct host names among the ranks; ranks on one
  host are its chips.  More than one host gives a 2-D ``("host", "chip")``
  ``DeviceMesh``; one host the 1-D ``data`` mesh.  ``DMLCTPU_MESH_HOSTS``
  forces a synthetic host factor (how 4 ranks on one machine exercise the
  2-D route).
* **Collective strategy**: payloads under ``DMLCTPU_MESH_HIER_THRESHOLD_KB``
  take one flat ``all_reduce`` over the plan's ranks; on a 2-axis plan
  larger ones take the hierarchical route: reduce-scatter within each
  host's group, all-reduce of each block across the hosts' peer groups,
  all-gather within the host.  A 1-axis plan stays flat (the JAX package
  routes it hierarchically past the threshold too).
  ``DMLCTPU_MESH_COLLECTIVE`` overrides the per-payload choice, and
  ``DMLCTPU_MESH_OVERLAP_CHUNKS`` sets the GBDT level loop's feature chunks.
* **Spec adaptation**: every API that takes ``histogram_mesh=`` takes a
  plan, a ``DeviceMesh`` or the ``(mesh, axis)`` tuple (:meth:`from_spec`).
* **dp x tp**: a plan on a ``("data", "model")`` mesh whose axes are
  ``("data",)`` shards rows over ``data`` only: its reductions, gathers,
  ``num_shards`` and ``row_offsets`` run over the ranks that share this
  rank's ``model`` coordinate (one rank of each data group), and
  :attr:`model` is the plan over the other axis (the ranks of this rank's
  data group), which sums the partial results of a table sharded by
  feature (:meth:`table_sharding`).

A plan's groups are made once, when it is built, in the same order on
every rank (building a plan is a collective).  A gloo plan stages CUDA
tensors through host memory (:mod:`.collective`).  Integer payloads reduce
exactly on every route, so the GBDT's fixed-point histograms are the same
bits whatever the rank count or strategy; a float payload on the
hierarchical route may differ from the flat one by rounding.

Without an initialised process group a plan covers one process: every
reduction returns its input.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import telemetry
from ..timer import Stopwatch
from .collective import (_all_gather_flat, _reduce_scatter, on_group_device,
                         reduce_op)
from .mesh import (data_sharding, host_count, make_mesh, replicated_sharding,
                   world)

_STRATEGIES = ("auto", "flat", "hier")


def _env_collective() -> str:
    mode = os.environ.get("DMLCTPU_MESH_COLLECTIVE", "auto").strip().lower()
    if mode not in _STRATEGIES:
        raise ValueError(
            f"DMLCTPU_MESH_COLLECTIVE={mode!r} not in {_STRATEGIES}")
    return mode


def _env_threshold_bytes() -> int:
    return int(os.environ.get("DMLCTPU_MESH_HIER_THRESHOLD_KB", "256")) << 10


def _env_overlap_chunks() -> int:
    return max(1, int(os.environ.get("DMLCTPU_MESH_OVERLAP_CHUNKS", "1")))


class _Done:
    """A finished reduction, behind the same ``wait()`` as a pending one."""

    def __init__(self, out):
        self._out = out

    def wait(self) -> torch.Tensor:
        return self._out


class _Pending:
    """An ``all_reduce`` in flight: ``wait()`` returns its result on the
    input's device."""

    def __init__(self, work, buf, back, scale):
        self._work, self._buf, self._back, self._scale = work, buf, back, scale

    def wait(self) -> torch.Tensor:
        self._work.wait()
        out = self._back(self._buf)
        return out / self._scale if self._scale != 1 else out


class MeshPlan:
    """Topology + row layout + per-payload collective strategy.

    Parameters
    ----------
    mesh:
        The ``DeviceMesh`` to plan over (None: one process).
    axes:
        Row-sharding axis names, major to minor.  2-D plans are ``("host",
        "chip")``; a 1-D plan's axis doubles as the chip axis.  Defaults to
        every mesh axis.
    collective:
        "auto" (by payload and axes), "flat" or "hier".  Default: the
        ``DMLCTPU_MESH_COLLECTIVE`` knob, else "auto".
    hier_threshold_bytes:
        the payload at which "auto" takes the hierarchical route on a
        2-axis plan.
        Default: ``DMLCTPU_MESH_HIER_THRESHOLD_KB`` (256 KiB).
    overlap_chunks:
        feature chunks of the GBDT level loop's reduce/compute overlap (1:
        unchunked).  Default: ``DMLCTPU_MESH_OVERLAP_CHUNKS``.
    """

    def __init__(self, mesh, axes: Optional[Sequence[str]] = None,
                 collective: Optional[str] = None,
                 hier_threshold_bytes: Optional[int] = None,
                 overlap_chunks: Optional[int] = None, *, _outer=None):
        names = tuple(mesh.mesh_dim_names) if mesh is not None else ("data",)
        axes = tuple(axes) if axes is not None else names
        for a in axes:
            if a not in names:
                raise ValueError(
                    f"plan axis {a!r} not in mesh axes {names}")
        if not axes or len(axes) > 2:
            raise ValueError(f"MeshPlan wants 1 or 2 axes, got {axes!r}")
        rest = tuple(a for a in names if a not in axes)
        if rest and (len(axes) != 1 or len(rest) != 1):
            raise ValueError(
                f"a MeshPlan over mesh axes {names} takes all of them as row"
                f" axes, or one row axis and one model axis; got {axes!r}")
        collective = (collective if collective is not None
                      else _env_collective())
        if collective not in _STRATEGIES:
            raise ValueError(
                f"collective {collective!r} not in {_STRATEGIES}")
        self.mesh = mesh
        self.axes = axes
        self.collective = collective
        self.hier_threshold_bytes = (
            hier_threshold_bytes if hier_threshold_bytes is not None
            else _env_threshold_bytes())
        self.overlap_chunks = (
            max(1, int(overlap_chunks)) if overlap_chunks is not None
            else _env_overlap_chunks())
        self.shape = ({a: 1 for a in axes} if mesh is None else
                      {a: int(mesh.size(names.index(a))) for a in axes})
        self.backend = dist.get_backend() if mesh is not None else "none"
        self.fabric = "nvlink" if self.backend == "nccl" else "host"
        #: the mesh axis a table's features are sharded over (None: rows
        #: over every mesh axis), and the plan over it (whose own ``model``
        #: is this plan)
        self.model_axis = rest[0] if rest else None
        self.model: Optional[MeshPlan] = _outer
        # the groups, made once and in the same order on every rank; the
        # plan's own collectives run on row_group (None: the world)
        self.chip_group = self.host_group = None
        self.row_group = self.coord_group = None
        self.shard_index = 0
        if mesh is not None:
            ranks = np.asarray(mesh.mesh.tolist()).reshape(-1)
            if sorted(ranks.tolist()) != list(range(dist.get_world_size())):
                raise ValueError("a MeshPlan covers every rank of the world "
                                 f"once; mesh ranks {ranks.tolist()}")
            self.shard_index = int(np.nonzero(ranks == dist.get_rank())[0][0])
            if list(ranks) != sorted(ranks.tolist()):
                raise ValueError("a MeshPlan lays rows out in rank order; "
                                 f"mesh ranks {ranks.tolist()}")
            self.chip_group = mesh.get_group(self.chip_axis)
            if self.host_axis is not None:
                self.host_group = mesh.get_group(self.host_axis)
            if self.model_axis is None:
                # staging coordination runs on host memory: a gloo group
                self.coord_group = (None if self.backend == "gloo"
                                    else dist.new_group(backend="gloo"))
            else:
                self.shard_index = int(mesh.get_coordinate()[
                    names.index(self.chip_axis)])
                self.row_group = self.chip_group
                if self.backend != "gloo":
                    self.coord_group = _gloo_group_along(mesh,
                                                         self.chip_axis)
                if _outer is None:
                    self.model = MeshPlan(mesh, (self.model_axis,), "flat",
                                          _outer=self)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def build(cls, devices=None, hosts: Optional[int] = None,
              **kwargs) -> "MeshPlan":
        """Discover the topology and build the mesh over the world's ranks
        (or the given ranks, ``devices``).  Hosts come from the ranks' host
        names unless ``hosts`` (or ``DMLCTPU_MESH_HOSTS``) forces a
        synthetic factor.  Without a process group: a one-process plan."""
        if not (dist.is_available() and dist.is_initialized()):
            return cls(None, ("data",), **kwargs)
        n_world = world()[1]
        ranks = (list(range(n_world)) if devices is None
                 else [int(r) for r in devices])
        n = len(ranks)
        if hosts is None:
            hosts = int(os.environ.get("DMLCTPU_MESH_HOSTS", "0")) or None
        if hosts is None:
            hosts = host_count(ranks)
        if hosts > 1:
            if n % hosts:
                raise ValueError(
                    f"{n} device(s) do not split over {hosts} host(s)")
            mesh = make_mesh((hosts, n // hosts), ("host", "chip"), ranks)
            return cls(mesh, ("host", "chip"), **kwargs)
        return cls(make_mesh((n,), ("data",), ranks), ("data",), **kwargs)

    @classmethod
    def from_spec(cls, spec, **kwargs) -> Optional["MeshPlan"]:
        """Adapt any accepted mesh spec to a plan: ``None`` -> ``None``; a
        ``MeshPlan`` passes through; a ``DeviceMesh`` plans over all its
        axes; the ``(mesh, axis)`` tuple (axis a name or a tuple of names)
        is validated and wrapped."""
        if spec is None:
            return None
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, tuple):
            mesh, axis = spec
            axes = (axis,) if isinstance(axis, str) else tuple(axis)
            for a in axes:
                if a not in tuple(mesh.mesh_dim_names):
                    raise ValueError(
                        f"histogram_mesh axis {a!r} not in mesh axes "
                        f"{tuple(mesh.mesh_dim_names)}")
            return cls(mesh, axes, **kwargs)
        if hasattr(spec, "mesh_dim_names"):
            return cls(spec, **kwargs)
        if hasattr(spec, "axes") and hasattr(spec, "mesh"):  # RowSharding
            return cls(spec.mesh, spec.axes, **kwargs)
        raise TypeError(f"not a mesh spec: {type(spec).__name__}")

    # ------------------------------------------------------------------
    # layout
    # ------------------------------------------------------------------
    @property
    def chip_axis(self) -> str:
        return self.axes[-1]

    @property
    def host_axis(self) -> Optional[str]:
        return self.axes[0] if len(self.axes) > 1 else None

    @property
    def num_shards(self) -> int:
        """Row shards: the ranks along the plan's axes (data groups, on a
        plan with a model axis)."""
        return int(np.prod([self.shape[a] for a in self.axes]))

    def data_sharding(self):
        """Rows over every plan axis (``mesh.data_sharding``)."""
        return data_sharding(self.mesh, self.axes)

    def table_sharding(self):
        """A parameter table's leading (feature) dimension over the model
        axis (``NamedSharding(mesh, P("model", ...))``); raises on a plan
        without one."""
        if self.model_axis is None:
            raise ValueError(f"plan over mesh axes {self.axes} has no model "
                             "axis to shard a table over")
        return data_sharding(self.mesh, self.model_axis)

    def replicated_sharding(self):
        """Every rank holds the whole value (``mesh.replicated_sharding``)."""
        return replicated_sharding(self.mesh)

    def describe(self) -> dict:
        c = self.shape[self.chip_axis]
        out = {"devices": self.num_shards,
               "hosts": self.num_shards // c, "chips_per_host": c,
               "axes": list(self.axes), "fabric": self.fabric,
               "backend": self.backend, "collective": self.collective,
               "hier_threshold_bytes": self.hier_threshold_bytes,
               "overlap_chunks": self.overlap_chunks}
        if self.model is not None:
            out["model_axis"] = self.model_axis
            out["model_shards"] = self.model.num_shards
        return out

    # ------------------------------------------------------------------
    # collectives
    # ------------------------------------------------------------------
    def strategy_for(self, nbytes: int) -> str:
        """flat | hier for a payload of ``nbytes``.  "auto" takes the
        hierarchical route only on a 2-axis plan: on one axis it would be a
        reduce-scatter and an all-gather in the group a flat ring
        all-reduce already covers."""
        if self.num_shards <= 1:
            return "flat"
        if self.collective != "auto":
            return self.collective
        return ("hier" if self.host_axis is not None
                and nbytes >= self.hier_threshold_bytes else "flat")

    def allreduce(self, x: torch.Tensor, op: str = "sum",
                  strategy: Optional[str] = None) -> torch.Tensor:
        """All-reduce ``x`` over the plan's ranks; a new tensor on ``x``'s
        device, the same bits on every rank.  The strategy defaults to
        :meth:`strategy_for` of the payload; every reduction counts its
        bytes into ``mesh.collective_bytes``."""
        return self.allreduce_async(x, op, strategy).wait()

    def allreduce_async(self, x: torch.Tensor, op: str = "sum",
                        strategy: Optional[str] = None):
        """:meth:`allreduce` issued without waiting: returns a handle whose
        ``wait()`` gives the result.  The flat route is an ``async_op``
        ``all_reduce``; the hierarchical route runs to its end here."""
        rop = reduce_op(op)
        if self.num_shards <= 1:
            return _Done(x)
        nbytes = x.numel() * x.element_size()
        strat = strategy or self.strategy_for(nbytes)
        telemetry.counter_add("mesh.collective_bytes", nbytes)
        n = self.num_shards if op == "mean" else 1
        buf, group, back = self._stage(x)
        if strat == "flat" or (group is not None
                               and group is not self.row_group):
            work = dist.all_reduce(buf, rop, group=group, async_op=True)
            return _Pending(work, buf, back, n)
        out = back(self._hier(buf, rop))
        return _Done(out / n if n != 1 else out)

    def _stage(self, x: torch.Tensor):
        """(a fresh copy of ``x`` where the plan's collectives take it, the
        group for it (None: the plan's own), the function that brings a
        result back to ``x``'s device).  An NCCL plan takes a host tensor on
        its gloo coordination group."""
        group = (self.coord_group if self.backend == "nccl"
                 and x.device.type == "cpu" else self.row_group)
        buf, back = on_group_device(x, group)
        return buf, group, back

    def _hier(self, x: torch.Tensor, rop) -> torch.Tensor:
        """Reduce-scatter within the host (chip group), all-reduce each
        block across the hosts (host group), all-gather within the host.
        ``x`` lies where the backend takes it."""
        c = self.shape[self.chip_axis]
        flat = x.reshape(-1)
        size = flat.numel()
        m = -(-size // c)
        if m * c != size:  # pad to c blocks; the tail never leaks back
            flat = torch.cat([flat, flat.new_zeros(m * c - size)])
        block = flat.new_empty(m)
        _reduce_scatter(block, flat, rop, self.chip_group)
        if self.host_group is not None:
            dist.all_reduce(block, rop, group=self.host_group)
        out = flat.new_empty(m * c)
        _all_gather_flat(out, block, self.chip_group)
        return out[:size].reshape(x.shape)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[num_shards, *x.shape]: every rank's ``x``, in row-shard order
        (one flat ``all_gather``)."""
        if self.num_shards <= 1:
            return x[None]
        buf, group, back = self._stage(x)
        out = buf.new_empty((self.num_shards,) + tuple(buf.shape))
        _all_gather_flat(out.reshape(-1), buf.reshape(-1), group)
        return back(out)

    def row_offsets(self, rows: int) -> tuple:
        """(this rank's first global row, the total rows) for ``rows``
        local rows, gathered over the plan (a collective)."""
        counts = self.all_gather(torch.tensor([int(rows)],
                                              dtype=torch.int64))
        counts = counts.reshape(-1).tolist()
        return int(sum(counts[:self.shard_index])), int(sum(counts))


def _gloo_group_along(mesh, axis: str):
    """This rank's gloo group along ``axis`` of ``mesh`` (the ranks that
    differ from it only there), made with every other group along the
    axis, in the same order on every rank (``new_group`` is a
    collective)."""
    names = tuple(mesh.mesh_dim_names)
    grid = np.moveaxis(np.asarray(mesh.mesh.tolist()), names.index(axis), -1)
    mine = None
    for ranks in grid.reshape(-1, grid.shape[-1]).tolist():
        group = dist.new_group(ranks, backend="gloo")
        if dist.get_rank() in ranks:
            mine = group
    return mine


def plan_allreduce_bench(plan: MeshPlan, strategy: str = "auto",
                         mib_per_device: float = 8.0, iters: int = 10,
                         warmup: int = 2) -> dict:
    """Bus bandwidth of the plan's all-reduce at a forced strategy, with the
    JAX package's conventions: a ``mib_per_device`` MiB f32 array split
    over the ranks, per-rank bytes as the payload, the NCCL-tests 2(n-1)/n
    bus factor.  The buffer lives on the card for NCCL, in host memory for
    gloo; warm-up calls run before the timed loop."""
    n = plan.num_shards
    nfloats = max(n, int(mib_per_device * (1 << 20) // 4))
    nfloats -= nfloats % n
    forced = None if strategy == "auto" else strategy
    dev = (torch.device("cuda", torch.cuda.current_device())
           if plan.backend == "nccl" else torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(plan.shard_index)
                         .standard_normal(nfloats // n, dtype=np.float32)
                         ).to(dev)
    for _ in range(max(1, warmup)):
        plan.allreduce(x, "sum", strategy=forced)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if plan.num_shards > 1:
        dist.barrier()
    watch = Stopwatch()
    for _ in range(iters):
        out = plan.allreduce(x, "sum", strategy=forced)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = watch.elapsed() / max(iters, 1)
    del out
    nbytes = nfloats * 4 // n
    algo = nbytes / secs / 1e9
    return {"devices": n, "bytes": nbytes, "seconds_per_iter": secs,
            "algo_gbps": algo, "bus_gbps": algo * 2.0 * (n - 1) / max(n, 1),
            "strategy": strategy if forced else plan.strategy_for(nbytes),
            "op": "allreduce"}


__all__ = ["MeshPlan", "plan_allreduce_bench"]
