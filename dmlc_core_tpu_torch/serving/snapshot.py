"""Model snapshot wire format (DTSNAP01) — the payload of a FRAME_SNAPSHOT push.

Byte for byte the JAX package's format: an 8-byte magic, a length-prefixed
JSON meta record (model family, constructor config, leaf manifest,
sequence number), then the raw leaf bytes back-to-back in manifest order.
A GBDT snapshot also carries its binner, as the cuts array and the
binner's constructor knobs, so ``cuts_digest()`` survives the round trip.
The same numpy params (and cuts) therefore pack to the same payload and the
same :func:`snapshot_digest` in both packages, and a snapshot packed by
either loads in the other.
"""
from __future__ import annotations

import hashlib
import json
import struct
from typing import Optional, Tuple

import numpy as np
import torch

MAGIC = b"DTSNAP01"
_U32 = struct.Struct("<I")

_FAMILIES = ("linear", "fm", "ffm", "gbdt")


def family_cls(family: str):
    """The port's model class for a snapshot family."""
    from .. import models
    table = {"linear": models.SparseLinearModel,
             "fm": models.FactorizationMachine,
             "ffm": models.FieldAwareFactorizationMachine,
             "gbdt": models.GBDT}
    if family not in table:
        raise ValueError(f"unknown model family '{family}' "
                         f"(expected one of {_FAMILIES})")
    return table[family]


def snapshot_digest(data: bytes) -> str:
    """16-hex content digest of a packed snapshot payload."""
    return hashlib.sha256(bytes(data)).hexdigest()[:16]


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(v))


def pack_snapshot(family: str, config: dict, params: dict, binner=None,
                  seq: int = 0) -> bytes:
    """Serialize (family, constructor config, flat params dict[, binner])
    into one payload.  ``config`` holds the keyword arguments that rebuild
    the model (JSON-serializable, no ``device``); ``params`` a flat dict of
    numpy arrays, scalars or tensors (a model's ``state_dict()`` or a GBDT
    forest works); ``binner`` a fitted ``QuantileBinner`` (gbdt)."""
    family_cls(family)  # validate early, before any bytes move
    manifest = []
    blobs = []
    for key in sorted(params):
        v = params[key]
        if v is None:
            manifest.append({"key": key, "kind": "none"})
            continue
        if isinstance(v, dict):
            raise ValueError(f"params['{key}'] is nested; snapshots carry "
                             "flat param dicts only")
        a = _to_numpy(v)
        if a.dtype == object:
            raise ValueError(f"params['{key}'] is not an array")
        manifest.append({"key": key, "kind": "array",
                         "dtype": a.dtype.str, "shape": list(a.shape)})
        blobs.append(a.tobytes())
    meta = {"version": 1, "family": family, "config": dict(config),
            "seq": int(seq), "leaves": manifest}
    if binner is not None:
        if binner.cuts is None:
            raise ValueError("binner must be fitted before snapshotting")
        cuts = np.ascontiguousarray(_to_numpy(binner.cuts).astype(
            np.float32))
        meta["binner"] = {"num_bins": binner.num_bins,
                          "missing_aware": binner.missing_aware,
                          "cuts_shape": list(cuts.shape)}
        blobs.append(cuts.tobytes())
    head = json.dumps(meta, sort_keys=True).encode()
    return b"".join([MAGIC, _U32.pack(len(head)), head] + blobs)


def unpack_snapshot(data) -> Tuple[str, dict, dict, Optional[object]]:
    """Decode a payload -> ``(family, config, params, binner)`` with numpy
    leaves (owned copies; 0-d leaves stay 0-d).  The binner, when the
    snapshot has one, is a fitted ``QuantileBinner`` holding its cuts on the
    host, as the params are; ``ScoringEngine`` copies it to its device."""
    data = bytes(data)
    if data[:len(MAGIC)] != MAGIC:
        raise ValueError("not a model snapshot (bad magic)")
    off = len(MAGIC)
    (head_len,) = _U32.unpack_from(data, off)
    off += _U32.size
    meta = json.loads(data[off:off + head_len].decode())
    off += head_len
    if meta.get("version") != 1:
        raise ValueError(f"unsupported snapshot version {meta.get('version')}")
    params = {}
    for leaf in meta["leaves"]:
        if leaf["kind"] == "none":
            params[leaf["key"]] = None
            continue
        dt = np.dtype(leaf["dtype"])
        shape = tuple(leaf["shape"])
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if off + dt.itemsize * count > len(data):
            raise ValueError("snapshot payload ends inside leaf "
                             f"'{leaf['key']}' (torn write?)")
        a = np.frombuffer(data, dt, count=count, offset=off).reshape(shape)
        off += dt.itemsize * count
        params[leaf["key"]] = a.copy()  # frombuffer views are read-only
    binner = None
    if "binner" in meta:
        from ..models import QuantileBinner
        b = meta["binner"]
        shape = tuple(b["cuts_shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if off + 4 * count > len(data):
            raise ValueError("snapshot payload ends inside the binner cuts "
                             "(torn write?)")
        cuts = np.frombuffer(data, np.float32, count=count,
                             offset=off).reshape(shape)
        off += 4 * count
        binner = QuantileBinner.from_cuts(cuts, b["num_bins"],
                                          missing_aware=b["missing_aware"],
                                          device="cpu")
    if off != len(data):
        raise ValueError(f"snapshot payload has {len(data) - off} "
                         "trailing bytes (torn write?)")
    return meta["family"], meta["config"], params, binner
