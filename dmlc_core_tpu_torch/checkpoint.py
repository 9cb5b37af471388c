"""Checkpoint and resume over the native stream substrate.

The port of ``dmlc_core_tpu.checkpoint``.  A pytree (nested ``dict`` /
``list`` / ``tuple`` / namedtuple / ``defaultdict`` of tensors, numpy
arrays or scalars; a module's ``state_dict()`` works) is written as a
RecordIO container through the native ``RecordIOWriter``: one record of
JSON metadata, then one record of raw bytes per leaf, so ``save(params,
"s3://...")`` works against every registered file system backend.

The file is the JAX package's, byte for byte, for the same arrays: leaves
are taken in JAX's flatten order (a mapping's keys sorted, whatever order
they were inserted in; a ``state_dict()`` lists its parameters in
registration order), and the metadata holds the same JSON, ``treedef``
written in ``jax.tree``'s spelling (``PyTreeDef({'b': *, 'v': *, 'w':
*})``; a namedtuple ``CustomNode(namedtuple[NT], [*, *])``, a
``defaultdict`` ``CustomNode(defaultdict[(<class 'list'>, ('a',))],
[*])``), and a leaf's shape is its array's (``[]`` for a 0-d array or a
Python scalar).  A checkpoint written by either package loads in the
other; ``load(like=...)`` gives back the template's namedtuple class and
``defaultdict`` factory.

``bfloat16`` leaves are written as their 2-byte words and read back as
``torch.bfloat16`` without ``ml_dtypes``.  The native RecordIO writer
refuses a record of 2^29 bytes or more, so a single leaf that large cannot
be checkpointed (neither package splits leaves).

Multi-process runs (``torch.distributed`` over more than one process):
every process calls ``save`` in the same order.  A leaf sharded over a
``DeviceMesh`` (a ``DTensor``) is gathered to its global value on every
process (a collective); process 0 writes the file, which is byte for byte
the one-process file of the same values; then every process syncs on the
write's outcome, so a failed write raises on all of them.  ``load`` reads
the file on every process.
"""
from __future__ import annotations

import json
from collections import defaultdict
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from ._device import resolve_device
from .io import RecordIOReader, RecordIOWriter
from .parallel.mesh import world

_FORMAT_VERSION = 1


def _global_value(leaf):
    """A ``DTensor`` leaf's global value (a collective); other leaves as
    they are."""
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # older torch
        from torch.distributed._tensor import DTensor
    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def _sync_write(ok: bool) -> bool:
    """Every process learns whether the writer's write succeeded (one
    all-reduce of a flag, on the card for NCCL)."""
    dist = torch.distributed
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, dist.ReduceOp.MIN)
    return bool(flag.item())


def _flatten(tree: Any, leaves: list) -> str:
    """Append ``tree``'s leaves to ``leaves`` in ``jax.tree.flatten``'s
    order and return its treedef in ``str(treedef)``'s spelling (without
    the ``PyTreeDef(...)`` wrapper)."""
    if tree is None:
        return "None"
    if _is_namedtuple(tree):
        parts = ", ".join(_flatten(x, leaves) for x in tree)
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{parts}])"
    if isinstance(tree, defaultdict):
        keys = tuple(sorted(tree))
        parts = ", ".join(_flatten(tree[k], leaves) for k in keys)
        return (f"CustomNode(defaultdict[({tree.default_factory!r}, "
                f"{keys!r})], [{parts}])")
    if isinstance(tree, Mapping):
        parts = [f"{k!r}: {_flatten(tree[k], leaves)}" for k in sorted(tree)]
        return "{" + ", ".join(parts) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_flatten(x, leaves) for x in tree) + "]"
    if isinstance(tree, tuple):
        parts = [_flatten(x, leaves) for x in tree]
        return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
    leaves.append(tree)
    return "*"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _unflatten(like: Any, arrays) -> Any:
    """``like``'s structure with its leaves taken from the ``arrays``
    iterator in flatten order (a mapping keeps ``like``'s key order and
    type, a ``defaultdict`` its factory; a namedtuple its class)."""
    if like is None:
        return None
    if isinstance(like, Mapping):
        got = {k: _unflatten(like[k], arrays) for k in sorted(like)}
        if isinstance(like, defaultdict):
            return defaultdict(like.default_factory,
                               ((k, got[k]) for k in like))
        return type(like)((k, got[k]) for k in like) \
            if isinstance(like, dict) else got
    if isinstance(like, list):
        return [_unflatten(x, arrays) for x in like]
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(x, arrays) for x in like))
    if isinstance(like, tuple):
        return tuple(_unflatten(x, arrays) for x in like)
    return next(arrays)


def _leaf_bytes(leaf) -> tuple:
    """(dtype name as the JAX package writes it, shape, raw bytes)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)  # numpy has no bfloat16: the raw words
        return name, list(t.shape), t.numpy().tobytes()
    a = np.asarray(leaf)  # the shape before ascontiguousarray, which
    # makes a 0-d array 1-d
    return str(a.dtype), list(a.shape), np.ascontiguousarray(a).tobytes()


def _leaf_from_bytes(spec: dict, payload: bytes):
    """A numpy array, or a CPU tensor for a dtype numpy has no type of its
    own for (``ml_dtypes`` names such as ``bfloat16``: numpy knows them
    only as opaque ``V`` types, and only once ``ml_dtypes`` is imported)."""
    name, shape = spec["dtype"], spec["shape"]
    try:
        dt = np.dtype(name)
    except TypeError:
        dt = None
    if dt is None or dt.kind == "V":
        tdt = getattr(torch, name, None)
        if not isinstance(tdt, torch.dtype):
            raise ValueError(f"checkpoint leaf of unknown dtype {name!r}")
        return torch.frombuffer(bytearray(payload), dtype=tdt).reshape(shape)
    return np.frombuffer(payload, dtype=dt).reshape(shape).copy()


def save(pytree: Any, uri: str) -> int:
    """Write a pytree checkpoint to ``uri``; returns the number of leaves
    (0 on a process that does not write).  Tensors on the card are copied
    to the host first.  In a multi-process run see the module
    docstring."""
    rank, nprocs = world()
    leaves: list = []
    treedef = f"PyTreeDef({_flatten(pytree, leaves)})"
    leaves = [_global_value(x) for x in leaves]
    write_err = None
    if rank == 0:
        try:
            host = [_leaf_bytes(x) for x in leaves]
            meta = {
                "version": _FORMAT_VERSION,
                "treedef": treedef,
                "leaves": [{"dtype": name, "shape": shape}
                           for name, shape, _ in host],
            }
            with RecordIOWriter(uri) as writer:
                writer.write(json.dumps(meta).encode())
                for _, _, raw in host:
                    writer.write(raw)
        except Exception as e:  # noqa: BLE001  re-raised after the sync
            write_err = e
    if nprocs > 1 and not _sync_write(write_err is None) \
            and write_err is None:
        raise RuntimeError(
            f"checkpoint write failed on the writer process: {uri}")
    if write_err is not None:
        raise write_err
    return len(leaves) if rank == 0 else 0


def load(uri: str, like: Any = None, device="cuda"):
    """Read a checkpoint.

    Without ``like``: the flat list of leaves in flatten order (numpy
    arrays; a ``bfloat16`` leaf is a CPU ``torch.bfloat16`` tensor) plus
    the metadata dict (its ``treedef`` is informational).  With ``like``
    (an example pytree, such as a ``state_dict()``): its structure with
    every leaf a tensor on ``device`` (the card unless the caller asks for
    the CPU), in the dtype the file holds."""
    with RecordIOReader(uri) as reader:
        records = iter(reader)
        meta = json.loads(next(records).decode())
        if meta.get("version") != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {meta.get('version')}")
        arrays = [_leaf_from_bytes(spec, payload)
                  for spec, payload in zip(meta["leaves"], records)]
    if len(arrays) != len(meta["leaves"]):
        raise ValueError("checkpoint truncated: leaf count mismatch")
    if like is None:
        return arrays, meta
    dev = resolve_device(device)
    template: list = []
    _flatten(like, template)
    if len(template) != len(arrays):
        raise ValueError(f"checkpoint has {len(arrays)} leaves, template "
                         f"has {len(template)}")
    tensors = (torch.as_tensor(a).to(dev) for a in arrays)
    return _unflatten(like, tensors)
