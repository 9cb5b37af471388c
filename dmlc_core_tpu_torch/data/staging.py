"""Static-shape sparse batches, their pow-2 bucket geometry, and
``DeviceStagingIter``, which stages a dataset file onto the card.

The port of ``PaddedBatch``, ``bucket_pow2``, ``pad_batch_to_bucket`` and
single-host ``DeviceStagingIter`` from ``dmlc_core_tpu.data.staging``,
over torch tensors.

``DeviceStagingIter`` runs the same pipeline as the JAX package's:

* the native StagedBatcher (``cpp/src/data/staged_batcher.h``) parses and
  packs rows straight into pooled arenas, one fixed-shape padded CSR batch
  each (``num_workers > 1`` fans the parse over the native pool, and the
  batches stay bit-identical to one worker's);
* a pack-driver thread drains it into a host queue (``prefetch_depth``);
* a stager thread copies each arena's leaves into one pinned host buffer
  from a ring of ``prefetch_depth + 2`` (every leaf a 4-byte slice, so a
  batch is one host-to-device copy), hands the arena back to the native
  pool at once, and issues the copy on the iterator's own CUDA stream with
  an event after it;
* the consumer's stream waits on that event before the batch is yielded,
  and every leaf is recorded on the consumer's stream (the caching
  allocator would otherwise hand the side stream's memory out again
  early); a pinned buffer is written again only after its copy's event
  has completed.

On the CPU the stager copies the leaves into a fresh tensor and the batch
owns it.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import logging
import os
import queue
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import telemetry
from .._device import resolve_device
from .._native import NO_FIELD, StagedBatchOwnedC, check, lib

LOGGER = logging.getLogger("dmlc_core_tpu_torch.staging")


@dataclass
class PaddedBatch:
    """Static-shape CSR batch.

    Row r's nonzeros span ``index/value[row_ptr[r]:row_ptr[r+1]]``.  Padding
    rows have ``weight == 0`` and empty spans; padding nonzero lanes (k >=
    row_ptr[batch_size]) have ``value == 0``.  ``num_rows`` is the true
    (unpadded) row count.
    """

    label: torch.Tensor    # f32 [batch]
    weight: torch.Tensor   # f32 [batch]
    row_ptr: torch.Tensor  # i32 [batch + 1] CSR row pointer
    index: torch.Tensor    # i32 [nnz_pad] column ids
    value: torch.Tensor    # f32 [nnz_pad]
    num_rows: int
    field: Optional[torch.Tensor] = None  # i32 [nnz_pad] (libfm)
    qid: Optional[torch.Tensor] = None    # i32 [batch] query ids (ranking)

    @property
    def batch_size(self) -> int:
        return self.label.shape[0]

    def row_ids(self) -> torch.Tensor:
        """COO row id per nonzero (i32).  Padding lanes map to row
        ``batch_size - 1`` (their value is 0, so reductions are
        unaffected)."""
        k = torch.arange(self.index.shape[0], dtype=self.row_ptr.dtype,
                         device=self.row_ptr.device)
        r = torch.searchsorted(self.row_ptr, k, right=True,
                               out_int32=True) - 1
        return torch.clamp(r, max=self.batch_size - 1)


def bucket_pow2(n: int, lo: int = 1, hi: Optional[int] = None) -> int:
    """Smallest power of two >= max(n, lo), clamped to ``hi`` — but never
    below ``n`` itself (a ceiling must not truncate real data)."""
    n = int(n)
    b = 1 << max(0, max(n, int(lo)) - 1).bit_length()
    if hi is not None:
        b = min(b, int(hi))
    return max(b, n)


def pad_batch_to_bucket(batch: PaddedBatch, row_bucket: Optional[int] = None,
                        nnz_bucket: Optional[int] = None,
                        min_rows: int = 1, min_nnz: int = 8) -> PaddedBatch:
    """Pad ``batch`` up to a pow-2 (rows, nnz) bucket geometry, keeping
    every padding invariant: added rows carry ``weight == 0`` and empty
    spans (``row_ptr`` repeats its last value), added lanes ``value == 0``.
    Explicit buckets override the pow-2 rule (clamped up to the real
    extent, never down).  Returns ``batch`` itself when already on-bucket.
    """
    rows = batch.batch_size
    nnz = int(batch.index.shape[0])
    rb = (bucket_pow2(rows, min_rows) if row_bucket is None
          else max(int(row_bucket), rows))
    nb = (bucket_pow2(nnz, min_nnz) if nnz_bucket is None
          else max(int(nnz_bucket), nnz))
    if rb == rows and nb == nnz:
        return batch
    pr, pn = rb - rows, nb - nnz
    kw = {}
    if pr:
        kw["label"] = F.pad(batch.label, (0, pr))
        kw["weight"] = F.pad(batch.weight, (0, pr))
        kw["row_ptr"] = torch.cat(
            [batch.row_ptr, batch.row_ptr[-1:].expand(pr)])
        if batch.qid is not None:
            kw["qid"] = F.pad(batch.qid, (0, pr))
    if pn:
        kw["index"] = F.pad(batch.index, (0, pn))
        kw["value"] = F.pad(batch.value, (0, pn))
        if batch.field is not None:
            kw["field"] = F.pad(batch.field, (0, pn))
    return dataclasses.replace(batch, **kw)


def to_device_async(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Copy a (pinned) host tensor to ``device`` without blocking the host.

    Stands in for the JAX package's donated ``device_put``: the caller must
    not overwrite ``host`` until the copy is done — record a CUDA event
    after this call and wait on it first.  On a CPU ``device`` the tensor
    itself comes back (no copy)."""
    if device.type == "cpu":
        return host
    return host.to(device, non_blocking=True)


# ---- DeviceStagingIter ------------------------------------------------------

def _observability_scope():
    """Arm the env-configured time-series sampler and stall watchdog for an
    epoch (no-ops without ``DMLCTPU_TIMESERIES`` /
    ``DMLCTPU_WATCHDOG_DEADLINE_S``).  The JAX package also starts the
    tracker's metrics pusher here; that comes with the tracker (ROADMAP
    A6), and the JAX package runs without it too."""
    scope = contextlib.ExitStack()
    scope.enter_context(telemetry.timeseries_from_env())
    scope.enter_context(telemetry.watchdog_from_env())
    return scope


def _staged_iter(produce, prefetch: int, depth_gauge: Optional[str] = None):
    """Drive ``produce(emit)`` on a background thread, yielding emitted items
    up to ``prefetch`` ahead of the consumer.

    ``emit(item) -> bool`` returns False once the consumer has gone away
    (break / generator close): the producer must then return promptly,
    releasing any native cursor lock (a blocking put would deadlock an
    abandoned iterator).  Producer exceptions are re-raised in the
    consumer.  ``depth_gauge`` names a telemetry gauge kept at the queue's
    occupancy."""
    q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
    sentinel = object()
    stop = threading.Event()
    error: list = []

    def emit(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                if depth_gauge is not None:
                    telemetry.gauge_set(depth_gauge, q.qsize())
                return True
            except queue.Full:
                continue
        return False

    def runner():
        try:
            produce(emit)
        except BaseException as e:  # relayed to the consumer
            error.append(e)
        finally:
            while True:
                try:
                    q.put(sentinel, timeout=0.1)
                    break
                except queue.Full:
                    # drop queued items only once the consumer is gone; a
                    # full queue at a normal end means it has not caught up
                    if stop.is_set():
                        try:
                            q.get_nowait()
                        except queue.Empty:
                            pass

    t = threading.Thread(target=runner, daemon=True)
    t.start()
    reached_end = False
    try:
        while True:
            item = q.get()
            if depth_gauge is not None:
                telemetry.gauge_set(depth_gauge, q.qsize())
            if item is sentinel:
                reached_end = True
                break
            yield item
        if error:
            raise error[0]
    finally:
        stop.set()
        t.join(timeout=10.0)
        if error and not reached_end:
            LOGGER.warning("staging producer failed after consumer break: %r",
                           error[0])


def _autotune_armed() -> bool:
    """``DMLCTPU_AUTOTUNE`` as the JAX package's autotuner reads it."""
    return os.environ.get("DMLCTPU_AUTOTUNE", "0").lower() in (
        "1", "true", "yes", "on")


# the staged leaves in their order in a host buffer; all are 4 bytes a value
_LEAVES = ("label", "weight", "row_ptr", "index", "value", "field", "qid")
F32_LEAVES = ("label", "weight", "value")  # the rest are int32


class _PinnedRing:
    """The stager's recycled pinned host buffers (int32 words), each with
    the CUDA event of the last copy out of it."""

    def __init__(self, slots: int):
        self.bufs = [None] * slots
        self.events = [None] * slots
        self.next = 0

    def take(self, words: int):
        """(slot, buffer of at least ``words``) once the slot's last copy
        has left it."""
        i = self.next
        self.next = (i + 1) % len(self.bufs)
        if self.events[i] is not None:
            self.events[i].synchronize()
            self.events[i] = None
        if self.bufs[i] is None or self.bufs[i].numel() < words:
            self.bufs[i] = torch.empty(words, dtype=torch.int32,
                                       pin_memory=True)
        return i, self.bufs[i]


class DeviceStagingIter:
    """Iterate ``PaddedBatch``es of a dataset file staged onto ``device``,
    a few batches ahead of the consumer.

    Parameters are the JAX package's (``uri``, ``batch_size``,
    ``nnz_bucket``, ``part``/``num_parts``, ``format``, ``with_field``,
    ``with_qid``, ``prefetch``/``prefetch_depth``, ``nnz_max``,
    ``log_every``, ``num_workers``, ``reorder``, ``buffer_mb``), plus
    ``device`` (the card unless the caller asks for the CPU).  A batch has
    ``batch_size`` rows (the last one zero-padded: weight 0, empty spans)
    and its nonzeros padded to a multiple of ``nnz_bucket`` (value 0);
    ``num_rows`` is a Python int.  Each batch carries its lineage id
    (``telemetry.lineage``).

    Not ported yet, and refused: ``sharding=`` and multi-process assembly
    (ROADMAP A6), ``bin_cache=`` (A5) and ``autotune`` (A12, including
    ``DMLCTPU_AUTOTUNE`` arming it).
    """

    def __init__(self, uri: str, batch_size: int = 4096,
                 nnz_bucket: int = 1 << 16, part: int = 0,
                 num_parts: int = 1, format: str = "auto",  # noqa: A002
                 sharding=None, with_field: bool = False, prefetch: int = 2,
                 nnz_max: int = 0, log_every: int = 0,
                 with_qid: bool = False, num_workers: int = 1,
                 reorder: bool = True, buffer_mb: int = 64,
                 prefetch_depth: Optional[int] = None,
                 autotune: Optional[bool] = None,
                 bin_cache=None, binner=None,
                 bin_cache_codec: Optional[str] = None,
                 device="cuda"):
        self._device = resolve_device(device)
        if self._device.type == "cuda" and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        if sharding is not None:
            raise NotImplementedError(
                "DeviceStagingIter(sharding=...) (multi-device and "
                "multi-process staging) is not ported yet: ROADMAP A6")
        if bin_cache is not None:
            raise NotImplementedError(
                "DeviceStagingIter(bin_cache=...) (the binned epoch cache) "
                "is not ported yet: ROADMAP A5")
        if autotune or (autotune is None and _autotune_armed()):
            raise NotImplementedError(
                "DeviceStagingIter autotune (autotune=True or "
                "DMLCTPU_AUTOTUNE) is not ported yet: ROADMAP A12")
        del binner, bin_cache_codec  # only the bin cache reads them
        self._lib = lib()
        self._handle = ctypes.c_void_p()
        check(self._lib.DmlcTpuStagedBatcherCreateEx(
            uri.encode(), part, num_parts, format.encode(),
            batch_size, nnz_bucket, nnz_max, int(with_field), int(with_qid),
            int(num_workers), int(reorder), int(buffer_mb) << 20,
            ctypes.byref(self._handle)))
        self._batch_size = batch_size
        self._prefetch = max(prefetch_depth if prefetch_depth is not None
                             else prefetch, 1)
        self._num_workers = max(int(num_workers), 1)
        self._buffer_mb = int(buffer_mb)
        self._chunk_bytes = 0  # 0 = the input split's default read size
        self._reorder = reorder
        self._with_field = with_field
        self._with_qid = with_qid
        self._max_index = -1
        self.batches_staged = 0
        self.profile = None  # per-epoch stage breakdown; set by __iter__
        self._log_every = log_every
        self._epoch_t0 = 0.0
        self._epoch_bytes0 = 0
        self._epoch_batches0 = 0
        self._lock = threading.Lock()  # one native cursor per handle
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._ring = None  # the pinned buffers, made on the first epoch

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def bytes_read(self) -> int:
        return self._lib.DmlcTpuStagedBatcherBytesRead(self._handle)

    @property
    def max_index(self) -> int:
        """Largest column id seen so far (after a full epoch:
        num_features - 1)."""
        return self._max_index

    def close(self) -> None:
        # serialize with the producer thread, which holds the cursor lock
        if not self._lock.acquire(timeout=30.0):
            LOGGER.warning("DeviceStagingIter.close: producer still busy; "
                           "leaking native handle")
            return
        try:
            handle, self._handle = self._handle, ctypes.c_void_p()
            if handle:
                try:
                    self._lib.DmlcTpuStagedBatcherFree(handle)
                except (AttributeError, TypeError):
                    pass  # interpreter shutdown already tore down ctypes
        finally:
            self._lock.release()

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter teardown: module globals may be gone
            pass

    @property
    def counters(self) -> dict:
        """Per-stage pipeline counters for the current/last epoch: the
        ``profile`` breakdown plus pipeline configuration and totals."""
        c = dict(self.profile or {})
        c.update(num_workers=self._num_workers, reorder=self._reorder,
                 prefetch_depth=self._prefetch, bytes_read=self.bytes_read,
                 batches_staged=self.batches_staged)
        return c

    @property
    def knobs(self) -> dict:
        return {"num_workers": self._num_workers,
                "buffer_mb": self._buffer_mb,
                "prefetch_depth": self._prefetch,
                "chunk_bytes": self._chunk_bytes}

    def set_knobs(self, num_workers: Optional[int] = None,
                  buffer_mb: Optional[int] = None,
                  prefetch_depth: Optional[int] = None,
                  chunk_bytes: Optional[int] = None) -> dict:
        """Retune pipeline knobs on a live iterator.  ``num_workers`` /
        ``buffer_mb`` / ``chunk_bytes`` reach the native parse pool at once
        when there is one (the stream stays bit-identical); ``prefetch_depth``
        takes effect at the next epoch.  Returns the knobs plus
        ``pool_live`` (False: a single-stream parser, only the Python-side
        knobs moved)."""
        if prefetch_depth is not None:
            self._prefetch = max(int(prefetch_depth), 1)
        nw = int(num_workers) if num_workers is not None else 0
        bb = (int(buffer_mb) << 20) if buffer_mb is not None else 0
        cb = int(chunk_bytes) if chunk_bytes is not None else 0
        live = False
        if nw > 0 or bb > 0 or cb > 0:
            applied = ctypes.c_int(0)
            check(self._lib.DmlcTpuStagedBatcherSetPoolKnobs(
                self._handle, nw, ctypes.c_uint64(bb), ctypes.c_uint64(cb),
                ctypes.byref(applied)))
            live = bool(applied.value)
            if nw > 0:
                self._num_workers = nw
            if bb > 0:
                self._buffer_mb = int(buffer_mb)
            if cb > 0:
                self._chunk_bytes = cb
        return dict(self.knobs, pool_live=live)

    # ---- staging ------------------------------------------------------------

    def _wrap_owned(self, c: StagedBatchOwnedC) -> dict:
        """Numpy views over an owned arena, and ``release`` to hand it back
        to the native pool (also run when the views are collected).
        Host-only: safe on the pack-driver thread."""
        buf = (ctypes.c_uint8 * int(c.arena_bytes)).from_address(c.arena)
        release = weakref.finalize(buf, self._lib.DmlcTpuStagedBatchFree,
                                   ctypes.c_void_p(c.batch))
        B, nnz = self._batch_size, int(c.nnz_pad)

        def arr(off, count):
            return np.frombuffer(buf, dtype=np.int32, count=count,
                                 offset=int(off))

        with_field = self._with_field and c.field_off != NO_FIELD
        with_qid = self._with_qid and c.qid_off != NO_FIELD
        return {
            "label": arr(c.label_off, B),
            "weight": arr(c.weight_off, B),
            "row_ptr": arr(c.row_ptr_off, B + 1),
            "index": arr(c.index_off, nnz),
            "value": arr(c.value_off, nnz),
            "field": arr(c.field_off, nnz) if with_field else None,
            "qid": arr(c.qid_off, B) if with_qid else None,
            "num_rows": int(c.num_rows),
            "max_index": int(c.max_index),
            "lineage": int(c.lineage),
            "release": release,
        }

    def _stage(self, w: dict):
        with telemetry.span("h2d.stage_batch"):
            return self._stage_inner(w)

    def _stage_inner(self, w: dict):
        """One host batch -> (PaddedBatch on the device, the copy's CUDA
        event or None).  The leaves go into one host buffer back to back,
        the arena goes back to the native pool, and the buffer goes to the
        device in one copy on the iterator's stream."""
        present = [k for k in _LEAVES if w[k] is not None]
        words = sum(w[k].size for k in present)
        cuda = self._device.type == "cuda"
        if cuda:
            slot, host = self._ring.take(words)
        else:
            host = torch.empty(words, dtype=torch.int32)
        flat = host.numpy()
        spans, off = {}, 0
        for k in present:
            n = w[k].size
            flat[off:off + n] = w[k]
            spans[k] = (off, n)
            off += n
        w["release"]()  # the arena is copied: back to the native pool
        event = None
        if cuda:
            with torch.cuda.stream(self._stream):
                dev = host[:words].to(self._device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
            self._ring.events[slot] = event
        else:
            dev = host
        leaves = {}
        for k, (o, n) in spans.items():
            t = dev[o:o + n]
            leaves[k] = t.view(torch.float32) if k in F32_LEAVES else t
        batch = PaddedBatch(num_rows=w["num_rows"], **leaves)
        # provenance metadata for telemetry.lineage(), not a tensor
        batch._lineage = w["lineage"]
        self._max_index = max(self._max_index, w["max_index"])
        self._note_staged()
        return batch, event

    def _note_staged(self) -> None:
        self.batches_staged += 1
        epoch_batches = self.batches_staged - self._epoch_batches0
        if self._log_every and epoch_batches % self._log_every == 0:
            secs = max(time.monotonic() - self._epoch_t0, 1e-9)
            epoch_mb = (self.bytes_read - self._epoch_bytes0) / (1 << 20)
            LOGGER.info("staged %d batches, %.2f MB/sec -> device",
                        epoch_batches, epoch_mb / secs)

    def __iter__(self) -> Iterator[PaddedBatch]:
        """Yield batches on the device; parse/pack (native) and the staging
        copy (a background thread) run ahead of the consumer.  The epoch
        runs under the env-configured stall watchdog and time-series
        sampler."""
        with _observability_scope():
            yield from self._iter_epoch()

    def _iter_epoch(self) -> Iterator[PaddedBatch]:
        self._epoch_t0 = time.monotonic()
        self._epoch_bytes0 = self.bytes_read
        self._epoch_batches0 = self.batches_staged
        if self._device.type == "cuda" and self._ring is None:
            self._ring = _PinnedRing(self._prefetch + 2)
        # per-epoch pipeline breakdown (seconds, cumulative), as the JAX
        # package's: native_s blocking in the native parse+pack;
        # host_wait_s the stager starved for host batches; stage_s the
        # host copy and the issue of the device copy; emit_wait_s blocked
        # handing off (the consumer is the limiter)
        prof = {"native_s": 0.0, "host_wait_s": 0.0, "stage_s": 0.0,
                "emit_wait_s": 0.0, "batches": 0}
        self.profile = prof

        def produce_host(emit):
            with self._lock:
                check(self._lib.DmlcTpuStagedBatcherBeforeFirst(self._handle))
                while True:
                    c = StagedBatchOwnedC()
                    t0 = time.monotonic()
                    rc = check(self._lib.DmlcTpuStagedBatcherNextOwned(
                        self._handle, ctypes.byref(c)))
                    prof["native_s"] += time.monotonic() - t0
                    if rc != 1:
                        return
                    if not emit(self._wrap_owned(c)):
                        return

        host_iter = _staged_iter(produce_host, self._prefetch,
                                 depth_gauge="pack.queue_depth")

        def produce_device(emit):
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            try:
                it = iter(host_iter)
                while True:
                    t0 = time.monotonic()
                    w = next(it, None)
                    t1 = time.monotonic()
                    prof["host_wait_s"] += t1 - t0
                    if w is None:
                        return
                    item = self._stage(w)
                    del w
                    t2 = time.monotonic()
                    prof["stage_s"] += t2 - t1
                    ok = emit(item)
                    t3 = time.monotonic()
                    prof["emit_wait_s"] += t3 - t2
                    prof["batches"] += 1
                    telemetry.counter_add("h2d.wait_us", int((t1 - t0) * 1e6))
                    telemetry.counter_add("h2d.busy_us", int((t2 - t1) * 1e6))
                    telemetry.counter_add("h2d.emit_wait_us",
                                          int((t3 - t2) * 1e6))
                    telemetry.counter_add("h2d.batches", 1)
                    if not ok:
                        return
            finally:
                host_iter.close()

        for batch, event in _staged_iter(produce_device, 2,
                                         depth_gauge="h2d.queue_depth"):
            if event is not None:
                consumer = torch.cuda.current_stream(self._device)
                consumer.wait_event(event)
                for k in _LEAVES:
                    t = getattr(batch, k)
                    if t is not None:
                        t.record_stream(consumer)
            yield batch
