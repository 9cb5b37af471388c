"""ScoringIterator — pack ad-hoc sparse requests into bucketed batches.

A request batch of R rows / N nonzeros packs into the pow-2 bucket
geometry ``(bucket_pow2(R), bucket_pow2(N))``, so the set of batch shapes
the device sees stays logarithmic in the request-size range.

Host buffers are recycled per geometry: each (rows, nnz) bucket keeps one
arena, one pinned host allocation that holds every leaf back to back, so a
pack is one host-to-device copy.  The copy runs without blocking the host;
a CUDA event recorded after it is waited on before the arena is written
again, so a recycled arena never overwrites a batch still in flight.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from .._device import resolve_device
from ..data.staging import (F32_LEAVES, PaddedBatch, bucket_pow2,
                            to_device_async)

#: one scoring request row: (indices, values[, ...])
Request = Sequence


class _Arena:
    """Recycled host buffer for one (rows, nnz, with_field) geometry: the
    leaves are 4-byte slices of one int32 allocation, pinned when the
    batches go to a CUDA device."""

    def __init__(self, rows: int, nnz: int, with_field: bool,
                 device: torch.device):
        sizes = [("label", rows), ("weight", rows), ("row_ptr", rows + 1),
                 ("index", nnz), ("value", nnz)]
        if with_field:
            sizes.append(("field", nnz))
        self.field = None
        total = sum(n for _, n in sizes)
        self.buf = torch.zeros(total, dtype=torch.int32,
                               pin_memory=device.type == "cuda")
        self.spans = {}
        flat = self.buf.numpy()
        off = 0
        for name, n in sizes:
            self.spans[name] = (off, n)
            view = flat[off:off + n]
            if name in F32_LEAVES:
                view = view.view(np.float32)
            setattr(self, name, view)  # numpy view the packer writes
            off += n
        self.copied = None  # CUDA event: the last copy out of this arena

    def leaves(self, dev_buf: torch.Tensor) -> dict:
        """Typed slices of a (device copy of the) arena buffer."""
        out = {}
        for name, (off, n) in self.spans.items():
            t = dev_buf[off:off + n]
            out[name] = t.view(torch.float32) if name in F32_LEAVES else t
        return out


class ScoringIterator:
    """Packs streams of sparse request rows into bucketed device batches.

    ``pack(rows)`` accepts a list of ``(index, value)`` or ``(index,
    value, field)`` tuples (one per scoring row) and returns a
    :class:`PaddedBatch` on ``device`` on the row/nnz bucket grid, plus the
    real row count.  Pad rows carry weight 0 and empty spans, pad lanes
    value 0.  With ``with_field=True`` the batch carries the libffm field
    lane (a row without fields, or a pad lane, has field 0), as a
    field-aware model needs; without it, fields are ignored.

    On the CPU the batch aliases the arena, so it is valid until the next
    ``pack()`` on this iterator (score it before packing again); on a CUDA
    device the batch is a fresh device copy.
    """

    def __init__(self, max_batch: int = 512, min_nnz: int = 8,
                 with_field: bool = False, device="cuda"):
        self.max_batch = int(max_batch)
        self.min_nnz = int(min_nnz)
        self.with_field = bool(with_field)
        self.device = resolve_device(device)
        self._arenas: Dict[Tuple[int, int], _Arena] = {}
        self.packs = 0

    def geometry(self, rows: int, nnz: int) -> Tuple[int, int]:
        """(row_bucket, nnz_bucket) a request of this size packs into."""
        return (bucket_pow2(rows, 1, self.max_batch),
                bucket_pow2(nnz, self.min_nnz))

    def pack(self, rows: List[Request]) -> Tuple[PaddedBatch, int]:
        if not rows:
            raise ValueError("pack() of an empty request list")
        if len(rows) > self.max_batch:
            raise ValueError(f"{len(rows)} rows exceed max_batch="
                             f"{self.max_batch}")
        t0 = time.monotonic_ns()
        total_nnz = sum(len(r[0]) for r in rows)
        key = self.geometry(len(rows), total_nnz)
        arena = self._arenas.get(key)
        if arena is None:
            arena = self._arenas[key] = _Arena(*key, self.with_field,
                                               self.device)
            telemetry.counter_add("serve.arena_alloc", 1)
        if arena.copied is not None:
            arena.copied.synchronize()  # the previous copy has left
        # overwrite the live region, zero the pad tails (a recycled arena
        # holds the previous pack's data)
        arena.label[:] = 0.0
        arena.weight[:len(rows)] = 1.0
        arena.weight[len(rows):] = 0.0
        k = 0
        for r, req in enumerate(rows):
            idx, val = req[0], req[1]
            n = len(idx)
            if n != len(val):
                raise ValueError(f"row {r}: {n} indices vs "
                                 f"{len(val)} values")
            arena.row_ptr[r] = k
            arena.index[k:k + n] = idx
            arena.value[k:k + n] = val
            if arena.field is not None:
                arena.field[k:k + n] = (req[2] if len(req) > 2 and
                                        req[2] is not None else 0)
            k += n
        arena.row_ptr[len(rows):] = k
        arena.index[k:] = 0
        arena.value[k:] = 0.0
        if arena.field is not None:
            arena.field[k:] = 0
        dev_buf = to_device_async(arena.buf, self.device)
        if self.device.type == "cuda":
            arena.copied = torch.cuda.Event()
            arena.copied.record(torch.cuda.current_stream(self.device))
        batch = PaddedBatch(num_rows=len(rows), **arena.leaves(dev_buf))
        self.packs += 1
        telemetry.counter_add("serve.pack_us",
                              (time.monotonic_ns() - t0) // 1000)
        return batch, len(rows)
