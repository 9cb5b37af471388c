"""Static-shape sparse batches, their pow-2 bucket geometry,
``DeviceStagingIter``, which stages a dataset file onto the card, and
``RecordStagingIter``, which stages a RecordIO file's raw records.

The port of ``PaddedBatch``, ``bucket_pow2``, ``pad_batch_to_bucket``,
``DeviceStagingIter``, ``RecordBatch`` and ``RecordStagingIter`` from
``dmlc_core_tpu.data.staging``, over torch tensors.

Multi-process staging (``sharding=`` a ``parallel.MeshPlan``, a row
sharding or a ``DeviceMesh``, in a ``torch.distributed`` job of more than
one process): each process stages its own part of the file
(``part``/``num_parts``) and yields its own local batches, and every batch
is coordinated by one tiny host all-gather on a gloo group, on the
consumer thread (never a prefetch thread: collectives must run in program
order on every process), which carries the global facts the JAX package
keeps in its global arrays: the total rows, the global row pointer and
the global ``max_index``.  A process that runs out of rows keeps sending
all-padding batches until every process is done, so batch counts match
and every row is delivered exactly once; a process whose parse fails
sends status -1 and its peers raise instead of hanging.

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

``RecordStagingIter`` runs the same ring over the native RecordBatcher
(``cpp/src/data/record_batcher.h``): a batch is the offsets and the
concatenated payloads of up to ``records_cap`` records, zero-padded to
``bytes_cap`` bytes, in one pinned buffer and one copy.  ``num_workers >
1`` reads virtual parts of the file on a pool of threads, one native
cursor each.

On the CPU the stager copies the leaves into a fresh tensor and the batch
owns it.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import logging
import queue
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import autotune as _autotune
from .. import telemetry
from .._device import resolve_device
from ..tracker import metrics as _tracker_metrics
from .._native import NO_FIELD, RecordBatchC, StagedBatchOwnedC, check, lib

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
    # a process's batch of a multi-process epoch (None otherwise): the
    # plan its rows are sharded over, the rows of every process together,
    # and the global CSR row pointer (i32 [processes * batch + 1]: each
    # process's rows shifted into its fixed nnz_max segment of the
    # processes' concatenated entries, as the JAX package's global batch)
    plan: Optional[object] = None
    global_num_rows: Optional[int] = None
    global_row_ptr: Optional[torch.Tensor] = None

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
    """Start the tracker's metrics pusher (once a process) and arm the
    env-configured time-series sampler and stall watchdog for an epoch:
    no-ops without ``DMLC_TRACKER_METRICS_PORT``, ``DMLCTPU_TIMESERIES``
    and ``DMLCTPU_WATCHDOG_DEADLINE_S``.  A worker launched under a tracker
    then reports without touching user code."""
    _tracker_metrics.ensure_pusher()
    scope = contextlib.ExitStack()
    scope.enter_context(telemetry.timeseries_from_env())
    scope.enter_context(telemetry.watchdog_from_env())
    return scope


def _tuned_epoch(it, epoch):
    """One epoch of ``epoch()``'s batches under the observability scope and,
    when ``it`` is armed, its autotuner: the epoch is one measured window
    (and, with a window size, each run of that many batches one more)."""
    with _observability_scope():
        tuner = _autotune.maybe_attach(it)
        if tuner is None:
            yield from epoch()
            return
        with tuner.epoch():
            for batch in epoch():
                yield batch
                tuner.on_batch()


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


def _device_feed(device: torch.device, host_iter, stage, prof=None):
    """The stager half of a staging pipeline: a thread takes host batches
    from ``host_iter`` and calls ``stage(w) -> (batch, CUDA event or
    None)``, which issues the copy on the iterator's stream; the consumer
    gets each batch after its stream waited on the event, every tensor of
    the batch recorded on that stream (the caching allocator would hand
    the side stream's memory out again early otherwise).  ``prof``, when
    given, accumulates host_wait_s / stage_s / emit_wait_s / batches."""
    prof = {} if prof is None else prof
    for k in ("host_wait_s", "stage_s", "emit_wait_s"):
        prof.setdefault(k, 0.0)
    prof.setdefault("batches", 0)

    def produce_device(emit):
        if device.type == "cuda":
            torch.cuda.set_device(device)
        try:
            it = iter(host_iter)
            while True:
                t0 = time.monotonic()
                w = next(it, None)
                t1 = time.monotonic()
                prof["host_wait_s"] += t1 - t0
                if w is None:
                    return
                item = stage(w)
                del w  # the host arena goes back to its pool
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
        yield _consume(device, batch, event)


def _consume(device: torch.device, batch, event):
    """``batch`` ready for the consumer: its stream waits on the copy's
    ``event``, and every tensor of the batch is recorded on that stream
    (the caching allocator would hand the side stream's memory out again
    early otherwise)."""
    if event is not None:
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(event)
        for t in vars(batch).values():
            if isinstance(t, torch.Tensor):
                t.record_stream(consumer)
    return batch


def staging_plan(sharding):
    """The ``parallel.MeshPlan`` of a ``sharding=`` argument when it shards
    rows over more than one process, else None (one process stages as
    without one)."""
    if sharding is None:
        return None
    from ..parallel.meshplan import MeshPlan
    plan = MeshPlan.from_spec(sharding)
    return plan if plan.num_shards > 1 else None


def require_fixed_shapes(nnz_max: int) -> None:
    """Multi-process staging's precondition: every process contributes
    batches of one shape, so the entry lanes are ``nnz_max`` wide."""
    if int(nnz_max) == 0:
        raise ValueError(
            "multi-process staging needs fixed shapes: pass nnz_max=... "
            "so every process contributes identically-shaped shards")


def multiprocess_rounds(host_iter, payload_len: int, pack, plan):
    """Coordinate one epoch of multi-process staging: yield (local,
    gathered) per global batch, where ``local`` is this process's host
    batch (None once it is exhausted) and ``gathered`` the int64
    [processes, payload_len + 1] all-gather of every process's ``[status,
    payload...]``.

    Status 1 = has data (``pack(local, out)`` fills the payload), 0 =
    exhausted (it keeps taking part, so collective counts stay matched),
    -1 = this process's producer failed (its peers raise instead of
    waiting in their next collective; it re-raises its own error).  Ends
    when every process reports exhausted.  Runs on the consumer thread:
    collectives issued from a prefetch thread would race the consumer's
    own (the order of collectives must be the same on every process)."""
    local_end = False
    try:
        while True:
            local, local_err = None, None
            if not local_end:
                try:
                    local = next(host_iter, None)
                    local_end = local is None
                except Exception as e:  # the parse failed on this process
                    local_err, local_end = e, True
            packed = np.zeros(payload_len + 1, np.int64)
            if local_err is not None:
                packed[0] = -1
            elif local is not None:
                packed[0] = 1
                pack(local, packed[1:])
            gathered = plan.all_gather(torch.from_numpy(packed)).numpy()
            if local_err is not None:
                raise local_err
            failed = np.nonzero(gathered[:, 0] < 0)[0]
            if failed.size:
                raise RuntimeError(
                    "multi-process staging failed on process(es) "
                    f"{failed.tolist()}; aborting the epoch on every "
                    "process")
            if gathered[:, 0].sum() == 0:
                return  # every process is done; collective counts matched
            yield local, gathered
    finally:
        host_iter.close()


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

    With ``bin_cache=`` (a cache path, or True for ``<uri>.bincache``) and
    ``binner=`` (a ``QuantileBinner``), epochs yield pre-binned
    ``BinnedBatch``es served from the binned epoch cache
    (``binned_cache.BinnedStagingIter``, built on first use) instead of
    parsing text.

    ``autotune=True`` (or ``DMLCTPU_AUTOTUNE`` when ``autotune`` is None)
    attaches the stall-attribution tuner (``dmlc_core_tpu_torch.autotune``),
    which moves :attr:`knobs` through :meth:`set_knobs` between batches;
    the native pool keeps the stream, so every batch stays an untuned
    epoch's.

    ``sharding=`` (a ``parallel.MeshPlan``, ``parallel.data_sharding(mesh)``
    or a ``DeviceMesh``) in a job of more than one process stages this
    process's ``part`` and coordinates every batch with the other
    processes (see the module docstring); it needs ``nnz_max`` (fixed
    shapes) and the same ``batch_size`` on every process.  Its batches
    carry ``plan``, ``global_num_rows`` and ``global_row_ptr``.
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
        self._plan = staging_plan(sharding)
        if bin_cache is not None and binner is None:
            raise ValueError("bin_cache= needs binner= (a QuantileBinner)")
        self._autotune = bool(_autotune.armed() if autotune is None
                              else autotune)
        self._tuner = None  # the AutoTuner, attached on the first epoch
        nw = int(num_workers)
        if self._autotune and nw <= 1:
            # a one-worker pool emits the single reader's stream and stays
            # retunable; a negative count forces the pool
            nw = -1
        self._lib = lib()
        self._handle = ctypes.c_void_p()
        check(self._lib.DmlcTpuStagedBatcherCreateEx(
            uri.encode(), part, num_parts, format.encode(),
            batch_size, nnz_bucket, nnz_max, int(with_field), int(with_qid),
            nw, int(reorder), int(buffer_mb) << 20,
            ctypes.byref(self._handle)))
        self._uri = uri
        self._part = part
        self._num_parts = num_parts
        self._format = format
        self._batch_size = batch_size
        self._nnz_bucket = nnz_bucket
        self._nnz_max = nnz_max
        self._bin_cache = bin_cache
        self._binner = binner
        self._bin_cache_codec = bin_cache_codec
        self._binned = None  # the BinnedStagingIter, made on first use
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
        sampler, and the tuner when armed.  With ``bin_cache=`` set,
        yields ``BinnedBatch``es from the binned epoch cache instead."""
        if self._bin_cache is not None:
            yield from self._binned_delegate()
            return
        yield from _tuned_epoch(self, self._iter_epoch)

    def _binned_delegate(self):
        """Every epoch from the binned epoch cache, through one
        ``BinnedStagingIter`` over the same file and settings (its first
        epoch builds the cache)."""
        if self._binned is None:
            from .binned_cache import BinnedStagingIter
            cache = None if self._bin_cache is True else self._bin_cache
            self._binned = BinnedStagingIter(
                self._uri, self._binner, cache=cache,
                batch_size=self._batch_size, nnz_bucket=self._nnz_bucket,
                nnz_max=self._nnz_max, part=self._part,
                num_parts=self._num_parts, format=self._format,
                sharding=self._plan, prefetch_depth=self._prefetch,
                with_qid=self._with_qid, buffer_mb=self._buffer_mb,
                codec=self._bin_cache_codec, device=self._device)
        yield from self._binned

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

        if self._plan is not None:
            yield from self._iter_multiprocess(host_iter)
            return
        yield from _device_feed(self._device, host_iter, self._stage, prof)

    def _iter_multiprocess(self, host_iter) -> Iterator[PaddedBatch]:
        """A multi-process epoch: the pack thread parses this process's
        part; here, on the consumer thread, each batch's coordination
        all-gather of ``[status, num_rows, max_index, row_ptr]`` and its
        staging run in program order."""
        require_fixed_shapes(self._nnz_max)
        B, nnz, plan = self._batch_size, self._nnz_max, self._plan
        nprocs = plan.num_shards

        def pack(local, out):
            out[0] = local["num_rows"]
            out[1] = local["max_index"]
            out[2:] = local["row_ptr"]

        for local, gathered in multiprocess_rounds(host_iter, B + 3, pack,
                                                   plan):
            # the JAX package's global CSR: each process's row boundaries
            # shifted into its fixed nnz_max segment of the concatenated
            # entries
            shifts = np.arange(nprocs, dtype=np.int64) * nnz
            shifted = gathered[:, 3:] + shifts[:, None]
            global_rp = np.concatenate(
                [shifted[:, :-1].reshape(-1),
                 [np.int64(nnz) * nprocs]]).astype(np.int32)
            has_data = gathered[:, 0] == 1
            self._max_index = max(
                self._max_index, int(gathered[has_data, 2].max(initial=-1)))
            if local is None:
                local = self._padding_batch()
            batch = _consume(self._device, *self._stage(local))
            batch.plan = plan
            batch.global_num_rows = int(gathered[:, 1].sum())
            batch.global_row_ptr = torch.from_numpy(global_rp).to(
                self._device)
            yield batch

    def _padding_batch(self) -> dict:
        """The host batch of a process that is out of rows: ``batch_size``
        padding rows (weight 0, empty spans) and ``nnz_max`` zero lanes."""
        B, nnz = self._batch_size, self._nnz_max
        zeros = lambda k: np.zeros(k, np.int32)  # noqa: E731
        return {"label": zeros(B), "weight": zeros(B),
                "row_ptr": zeros(B + 1), "index": zeros(nnz),
                "value": zeros(nnz),
                "field": zeros(nnz) if self._with_field else None,
                "qid": zeros(B) if self._with_qid else None,
                "num_rows": 0, "max_index": -1, "lineage": -1,
                "release": lambda: None}


# ---- RecordStagingIter ------------------------------------------------------

def _parallel_parts_iter(open_part, num_virtual: int, num_workers: int,
                         reorder: bool, max_buffered: int):
    """A pool of ``num_workers`` threads over ``num_virtual`` parts, for
    cursors that exist only per part (the RecordBatcher).

    ``open_part(j)`` yields the items of virtual part ``j``; workers claim
    parts from a shared cursor and buffer their items per part.
    reorder=True yields strictly in part order (the part being drained may
    always buffer, so the in-order drain never stalls the pool);
    reorder=False yields in arrival order.  Worker exceptions re-raise in
    the consumer; closing the generator stops the workers."""
    cond = threading.Condition()
    parts: dict = {}
    done: set = set()
    state = {"next_claim": 0, "emit": 0, "buffered": 0, "stop": False,
             "error": None}

    def worker():
        try:
            while True:
                with cond:
                    if (state["stop"] or state["error"] is not None
                            or state["next_claim"] >= num_virtual):
                        return
                    j = state["next_claim"]
                    state["next_claim"] += 1
                    parts.setdefault(j, [])
                    cond.notify_all()
                it = open_part(j)
                try:
                    for item in it:
                        with cond:
                            while not (state["stop"]
                                       or state["error"] is not None
                                       or state["buffered"] < max_buffered
                                       or (reorder and j == state["emit"])):
                                cond.wait()
                            if state["stop"] or state["error"] is not None:
                                return
                            parts[j].append(item)
                            state["buffered"] += 1
                            cond.notify_all()
                finally:
                    it.close()
                with cond:
                    done.add(j)
                    cond.notify_all()
        except BaseException as e:  # relayed to the consumer
            with cond:
                if state["error"] is None:
                    state["error"] = e
                cond.notify_all()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(num_workers, 1))]
    for t in threads:
        t.start()
    try:
        while True:
            with cond:
                while True:
                    if state["error"] is not None:
                        raise state["error"]
                    if reorder:
                        j = state["emit"]
                        if j >= num_virtual:
                            return
                        q = parts.get(j)
                        if q:
                            item = q.pop(0)
                            state["buffered"] -= 1
                            cond.notify_all()
                            break
                        if q is not None and j in done:
                            del parts[j]
                            done.discard(j)
                            state["emit"] += 1
                            # a worker parked on the full-buffer wait may
                            # have just become the emit part: wake it
                            cond.notify_all()
                            continue
                    else:
                        got = next((j for j, q in parts.items() if q), None)
                        if got is not None:
                            item = parts[got].pop(0)
                            state["buffered"] -= 1
                            cond.notify_all()
                            break
                        drained = [j for j in parts if j in done]
                        for j in drained:
                            del parts[j]
                            done.discard(j)
                        if drained:
                            cond.notify_all()
                        if state["next_claim"] >= num_virtual and not parts:
                            return
                    cond.wait()
            yield item
    finally:
        with cond:
            state["stop"] = True
            cond.notify_all()
        for t in threads:
            t.join(timeout=10.0)


def _pick_virtual_parts(total_bytes: int, num_parts: int,
                        target_bytes: int = 8 << 20,
                        lo: int = 8, hi: int = 1024) -> int:
    """Virtual part count for a Python-level worker pool, the native
    ShardedParser's formula: a function of the file's size and
    ``num_parts`` only, never of the worker count, so every worker count
    covers the file exactly once."""
    per_part = total_bytes // max(num_parts, 1)
    return int(min(max((per_part + target_bytes - 1) // target_bytes, lo),
                   hi))


def source_total_bytes(uri: str, split_type: str = "text") -> int:
    """Bytes of the whole file set a dataset URI names (its input split's
    total size)."""
    L = lib()
    h = ctypes.c_void_p()
    check(L.DmlcTpuInputSplitCreate(uri.split("#", 1)[0].encode(), b"", 0, 1,
                                    split_type.encode(), 0, 0, 0,
                                    ctypes.byref(h)))
    try:
        return int(L.DmlcTpuInputSplitTotalSize(h))
    finally:
        L.DmlcTpuInputSplitFree(h)


@dataclass
class RecordBatch:
    """Static-shape packed RecordIO batch on the device.

    ``bytes`` is the concatenated payloads of the batch's records,
    zero-padded to ``bytes_cap``; record k spans
    ``bytes[offsets[k]:offsets[k + 1]]`` (a payload the writer split at a
    magic word comes back whole).  Padding records have empty spans;
    :meth:`record_mask` marks the real ones.  ``num_records`` is a Python
    int; ``blocks`` is 1.  A process's batch of a multi-process epoch holds
    its own block and carries the global facts of the JAX package's
    global batch (one block a process): ``global_offsets`` (i32
    [processes * (records_cap + 1)], each block's offsets shifted by
    ``bytes_cap`` times its process), ``global_block_num_records`` (i32
    [processes]) and ``global_num_records``."""

    bytes: torch.Tensor              # u8 [bytes_cap]
    offsets: torch.Tensor            # i32 [records_cap + 1]
    num_records: int
    block_num_records: torch.Tensor  # i32 [blocks]
    blocks: int = 1
    global_offsets: Optional[torch.Tensor] = None
    global_block_num_records: Optional[torch.Tensor] = None
    global_num_records: Optional[int] = None

    @property
    def records_cap(self) -> int:
        return self.offsets.shape[0] // self.blocks - 1

    def spans(self):
        """(starts, ends) i32 of shape [blocks * records_cap]: record k
        spans bytes[starts[k]:ends[k]]."""
        per = self.offsets.reshape(self.blocks, self.records_cap + 1)
        return per[:, :-1].reshape(-1), per[:, 1:].reshape(-1)

    def record_mask(self) -> torch.Tensor:
        """bool [blocks * records_cap]: True on real (non-padding) lanes."""
        lane = torch.arange(self.records_cap, dtype=torch.int32,
                            device=self.offsets.device)
        return (lane[None, :]
                < self.block_num_records[:, None]).reshape(-1)


class RecordStagingIter:
    """Stage a RecordIO file onto ``device`` as fixed-shape packed byte
    batches (``RecordBatch``), a few batches ahead of the consumer.

    The parameters are the JAX package's: ``uri`` (the same URI sugar and
    sharding as ``InputSplit``; ``part``/``num_parts``), ``records_cap``
    (records a batch), ``bytes_cap`` (bytes a batch), ``num_workers`` (> 1:
    a pool of per-virtual-part native cursors; ``reorder=True`` keeps
    record order, though batches near a part's end may be packed
    differently from one worker's: compare the record streams),
    ``prefetch``/``prefetch_depth``, ``recover`` (skip corrupt spans,
    counted in ``record.corrupt_skipped``) and ``autotune`` (the tuner,
    armed by ``DMLCTPU_AUTOTUNE`` when None; it moves ``num_workers`` and
    ``prefetch_depth``, both from the next epoch), plus ``device`` (the
    card unless the caller asks for the CPU).

    ``sharding=`` in a job of more than one process stages this
    process's ``part`` and coordinates every batch with the other
    processes, as ``DeviceStagingIter`` does; :meth:`host_batches_coordinated`
    serves host batches under the tracker's shard ownership.
    """

    def __init__(self, uri: str, records_cap: int = 4096,
                 bytes_cap: int = 1 << 22, part: int = 0, num_parts: int = 1,
                 sharding=None, prefetch: int = 2, num_workers: int = 1,
                 reorder: bool = True, prefetch_depth: Optional[int] = None,
                 recover: bool = False, autotune: Optional[bool] = None,
                 device="cuda"):
        self._device = resolve_device(device)
        if self._device.type == "cuda" and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._plan = staging_plan(sharding)
        self._autotune = bool(_autotune.armed() if autotune is None
                              else autotune)
        self._tuner = None  # the AutoTuner, attached on the first epoch
        self._lib = lib()
        self._handle = ctypes.c_void_p()
        self._recover = bool(recover)
        check(self._lib.DmlcTpuRecordBatcherCreateEx(
            uri.encode(), part, num_parts, records_cap, bytes_cap,
            int(self._recover), ctypes.byref(self._handle)))
        self._uri = uri
        self._part = part
        self._num_parts = num_parts
        self._prefetch = max(prefetch_depth if prefetch_depth is not None
                             else prefetch, 1)
        self._records_cap = int(records_cap)
        self._bytes_cap = int(bytes_cap)
        self._num_workers = max(int(num_workers), 1)
        self._reorder = reorder
        self._virtual_parts = 0  # resolved on the first parallel epoch
        # every native RecordBatcher (the main cursor and each part's)
        # counts its reads into the process-wide "record.bytes" counter
        self._bytes_base = telemetry.counter_get("record.bytes")
        self._lock = threading.Lock()  # one native cursor per handle
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._ring = None  # the pinned buffers, made on the first epoch
        self.batches_staged = 0

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def bytes_read(self) -> int:
        """Bytes read since construction, counted process-wide (other
        RecordStagingIters in the process count too)."""
        return telemetry.counter_get("record.bytes") - self._bytes_base

    def close(self) -> None:
        # serialize with the producer thread, which holds the cursor lock
        if not self._lock.acquire(timeout=30.0):
            LOGGER.warning("RecordStagingIter.close: producer still busy; "
                           "leaking native handle")
            return
        try:
            handle, self._handle = self._handle, ctypes.c_void_p()
            if handle:
                try:
                    self._lib.DmlcTpuRecordBatcherFree(handle)
                except (AttributeError, TypeError):
                    pass  # interpreter shutdown already tore down ctypes
        finally:
            self._lock.release()

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter teardown: module globals may be gone
            pass

    @staticmethod
    def _wrap_host(c: RecordBatchC) -> dict:
        """Host copies of one packed batch (the native buffers are borrowed
        until the next Next call): the used payload bytes and the
        offsets."""
        used = int(c.bytes_used)
        return {
            "bytes": np.frombuffer(ctypes.string_at(c.bytes, used),
                                   dtype=np.uint8),
            "offsets": np.ctypeslib.as_array(
                c.offsets, shape=(int(c.records_cap) + 1,)).copy(),
            "num_records": int(c.num_records),
        }

    def _resolve_virtual_parts(self) -> int:
        if self._virtual_parts == 0:
            self._virtual_parts = _pick_virtual_parts(
                source_total_bytes(self._uri, "recordio"), self._num_parts)
        return self._virtual_parts

    def _open_part(self, j: int):
        """Virtual part ``j`` of this worker's share, on a pool thread,
        through a native cursor of its own."""
        V = self._resolve_virtual_parts()
        yield from self._open_global_part(self._part * V + j)

    def _open_global_part(self, g: int):
        """GLOBAL virtual part ``g`` of the file (any worker's), through a
        native cursor of its own."""
        V = self._resolve_virtual_parts()
        h = ctypes.c_void_p()
        check(self._lib.DmlcTpuRecordBatcherCreateEx(
            self._uri.encode(), int(g), self._num_parts * V,
            self._records_cap, self._bytes_cap, int(self._recover),
            ctypes.byref(h)))
        try:
            c = RecordBatchC()
            while check(self._lib.DmlcTpuRecordBatcherNext(
                    h, ctypes.byref(c))) == 1:
                yield self._wrap_host(c)
        finally:
            self._lib.DmlcTpuRecordBatcherFree(h)

    def host_batches_coordinated(self, epoch: int = 0, client=None,
                                 steal: bool = True) -> Iterator[dict]:
        """Host batches under tracker-coordinated shard ownership.

        Registers this worker's virtual parts on the tracker's shard board,
        claims each before reading it and, once its own list is drained,
        steals pending parts from hosts the tracker flagged, keeping the
        job's exactly-once visitation
        (``tracker.metrics.coordinated_parts``).  ``client`` defaults to
        the env contract (``DMLC_TRACKER_METRICS_PORT``); without a tracker
        this is plain in-order part iteration."""
        V = self._resolve_virtual_parts()
        if client is None:
            client = _tracker_metrics.shard_client_from_env(rank=self._part)
        shards = list(range(self._part * V, (self._part + 1) * V))
        yield from _tracker_metrics.coordinated_parts(
            int(epoch), shards, self._open_global_part, client, steal=steal)

    def _produce_host(self, emit) -> None:
        """Drive the native read and pack, emitting host batch dicts."""
        if self._num_workers > 1:
            it = _parallel_parts_iter(
                self._open_part, self._resolve_virtual_parts(),
                self._num_workers, self._reorder,
                max_buffered=self._prefetch + self._num_workers)
            try:
                for w in it:
                    if not emit(w):
                        return
            finally:
                it.close()
            return
        with self._lock:
            check(self._lib.DmlcTpuRecordBatcherBeforeFirst(self._handle))
            c = RecordBatchC()
            while check(self._lib.DmlcTpuRecordBatcherNext(
                    self._handle, ctypes.byref(c))) == 1:
                if not emit(self._wrap_host(c)):
                    return

    def _stage(self, w: dict):
        """One host batch -> (RecordBatch on the device, the copy's CUDA
        event or None).  The offsets, the record count and the payload
        bytes (zero-padded to ``bytes_cap``) go into one host buffer, then
        to the device in one copy on the iterator's stream."""
        with telemetry.span("h2d.stage_records"):
            R, nb = self._records_cap, self._bytes_cap
            words = R + 2 + (nb + 3) // 4
            cuda = self._device.type == "cuda"
            if cuda:
                slot, host = self._ring.take(words)
            else:
                host = torch.empty(words, dtype=torch.int32)
            flat = host.numpy()
            flat[:R + 1] = w["offsets"]
            flat[R + 1] = w["num_records"]
            raw = flat[R + 2:words].view(np.uint8)
            used = w["bytes"].shape[0]
            raw[:used] = w["bytes"]
            raw[used:] = 0
            event = None
            if cuda:
                with torch.cuda.stream(self._stream):
                    dev = host[:words].to(self._device, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(self._stream)
                self._ring.events[slot] = event
            else:
                dev = host
            batch = RecordBatch(
                bytes=dev[R + 2:words].view(torch.uint8)[:nb],
                offsets=dev[:R + 1], num_records=int(w["num_records"]),
                block_num_records=dev[R + 1:R + 2])
            self.batches_staged += 1
            return batch, event

    @property
    def knobs(self) -> dict:
        """Current pipeline knobs (the tuner's view of this iterator)."""
        return {"num_workers": self._num_workers,
                "prefetch_depth": self._prefetch}

    def set_knobs(self, num_workers: Optional[int] = None,
                  prefetch_depth: Optional[int] = None,
                  **_ignored) -> dict:
        """Retune the pipeline from the next epoch (the part pool and the
        staging queues are built per epoch).  The parse-side knobs
        (``buffer_mb``, ``chunk_bytes``) are accepted and ignored, so one
        tuner policy drives every iterator.  ``pool_live`` is False: no
        native pool moves at once."""
        if num_workers is not None:
            self._num_workers = max(int(num_workers), 1)
        if prefetch_depth is not None:
            self._prefetch = max(int(prefetch_depth), 1)
        return dict(self.knobs, pool_live=False)

    def __iter__(self) -> Iterator[RecordBatch]:
        """Yield batches on the device; the native read and pack and the
        staging copy run ahead of the consumer on background threads."""
        yield from _tuned_epoch(self, self._iter_epoch)

    def _iter_epoch(self) -> Iterator[RecordBatch]:
        if self._device.type == "cuda" and self._ring is None:
            self._ring = _PinnedRing(self._prefetch + 2)
        host_iter = _staged_iter(self._produce_host, self._prefetch,
                                 depth_gauge="record.queue_depth")

        if self._plan is not None:
            yield from self._iter_multiprocess(host_iter)
            return
        yield from _device_feed(self._device, host_iter, self._stage)

    def _iter_multiprocess(self, host_iter) -> Iterator[RecordBatch]:
        """A multi-process epoch: each process stages its own block; the
        blocks' exact offsets ride the coordination all-gather."""
        plan, R, cap_b = self._plan, self._records_cap, self._bytes_cap
        nprocs = plan.num_shards
        if nprocs * cap_b > np.iinfo(np.int32).max:
            raise ValueError(
                f"global byte offsets overflow int32: {nprocs} processes x "
                f"bytes_cap={cap_b}; lower bytes_cap below "
                f"{np.iinfo(np.int32).max // nprocs}")

        def pack(local, out):
            out[0] = local["num_records"]
            out[1:] = local["offsets"]

        for local, gathered in multiprocess_rounds(host_iter, R + 2, pack,
                                                   plan):
            shifts = np.arange(nprocs, dtype=np.int64) * cap_b
            global_offs = (gathered[:, 2:] + shifts[:, None]).reshape(-1)
            counts = gathered[:, 1].astype(np.int32)
            if local is None:  # out of records: an empty block
                local = {"bytes": np.zeros(0, np.uint8),
                         "offsets": np.zeros(R + 1, np.int32),
                         "num_records": 0}
            batch = _consume(self._device, *self._stage(local))
            batch.global_offsets = torch.from_numpy(
                global_offs.astype(np.int32)).to(self._device)
            batch.global_block_num_records = torch.from_numpy(counts).to(
                self._device)
            batch.global_num_records = int(counts.sum())
            yield batch
