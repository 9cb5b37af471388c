"""The binned epoch cache: parse text once, stream uint8 bins after.

The port of ``dmlc_core_tpu.data.binned_cache``.  A GBDT trainer consumes
bin codes, yet a text epoch pays the parse every time.  The first epoch
(``build_bin_cache``) runs the native parser, fits the binner's cuts with
the streaming sketch when they are not fitted yet, and writes a quantized
columnar cache: uint8 bin codes, presence bits, CSR row pointers, labels
and weights, one RecordIO block record per batch of each virtual part,
behind a self-describing header (binner settings, cuts digest, parser
settings, part map).  Every later epoch (``BinnedStagingIter``) streams the
cache's blocks, repacked into the text epoch's batch shapes, onto the card
as ``BinnedBatch``es, with no parse and no binning.

The native side (``cpp/src/data/binned_cache.h``) owns the framing, the
crash-safe header, per-part seeks, the recover-mode resync, the block codec
and the per-entry binning of the build (bit for bit
``QuantileBinner.transform_entries``).  This module owns the block layout,
the invalidation rules, the build and the repack.  Cache files are the JAX
package's byte for byte (the same native writer, the same metadata JSON),
so either package opens the other's cache without a rebuild.

Invalidation: a change of num_bins, sketch seed or size, parser settings,
the source's byte length, the codec or the cuts digest costs exactly one
counted rebuild (``cache.rebuilds``).  A build that fails is retried once;
failing again, the epoch is served from the text path, binned on the host,
with the same batches (the JAX package's semantics).  The ``cache.hit_bytes``
and ``cache.build_bytes`` counters say which path served.
"""
from __future__ import annotations

import base64
import ctypes
import hashlib
import json
import logging
import os
import sys
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Iterator, Optional, Union

import numpy as np
import torch

from .. import autotune as _autotune
from .. import telemetry
from .._device import resolve_device
from .._native import NativeError, StagedBatchOwnedC, check, lib
from ..tracker import metrics as _tracker_metrics
from .staging import (DeviceStagingIter, _consume, _device_feed,
                      _pick_virtual_parts, multiprocess_rounds, staging_plan,
                      _PinnedRing, _staged_iter, _tuned_epoch,
                      source_total_bytes)

LOGGER = logging.getLogger("dmlc_core_tpu_torch.binned_cache")

#: bumped when the block layout or the meta contract changes; a cache of
#: another version is rebuilt rather than misread
CACHE_META_VERSION = 1

# a block payload's prefix, BinnedBlockHeader (binned_cache.h), in native
# byte order (meta["byte_order"] guards a foreign open); cflag names the
# block codec, and every decoded payload has it cleared back to 0
_HDR_DTYPE = np.dtype([("part_id", np.uint32), ("seq", np.uint32),
                       ("num_rows", np.uint64), ("nnz", np.uint64),
                       ("flags", np.uint32), ("cflag", np.uint32)])
_HDR_BYTES = _HDR_DTYPE.itemsize


# ---- block codec ------------------------------------------------------------

def codec_from_env() -> str:
    """The build codec ``DMLCTPU_BINCACHE_CODEC`` selects (default
    ``raw``)."""
    return os.environ.get("DMLCTPU_BINCACHE_CODEC", "raw") or "raw"


def resolve_codec(codec: Optional[str]) -> str:
    """A codec request (``None``: the environment's) as the canonical name
    the native side takes.  An unknown name raises; a compressing codec on
    a library built without codecs warns and writes ``raw``."""
    L = lib()
    name = (codec_from_env() if codec is None else codec).strip().lower()
    name = name or "raw"
    cid = int(L.DmlcTpuBlockCodecFromName(name.encode()))
    if cid < 0:
        raise ValueError(f"unknown bin-cache codec {name!r} "
                         f"(supported: raw, lz4)")
    if cid != 0 and not int(L.DmlcTpuBlockCodecEnabled()):
        LOGGER.warning("bin-cache codec %r requested but libdmlctpu was "
                       "built with DMLCTPU_CODEC=0; writing raw", name)
        return "raw"
    return "raw" if cid == 0 else name


def _arena_release(L, addr: int) -> None:
    try:
        L.DmlcTpuCacheArenaRelease(ctypes.c_void_p(addr))
    except (AttributeError, TypeError):
        pass  # interpreter teardown


def decode_block_payload(buf: Union[bytes, np.ndarray]):
    """One maybe-compressed block record payload in the raw layout
    :func:`unpack_block` reads.  A raw payload comes back unchanged; a
    compressed one is decoded into a pooled native arena and comes back as
    a uint8 view whose collection recycles the arena."""
    L = lib()
    a = buf if isinstance(buf, np.ndarray) else np.frombuffer(buf, np.uint8)
    arena, out_size = ctypes.c_void_p(), ctypes.c_uint64()
    check(L.DmlcTpuBinnedBlockDecode(
        a.ctypes.data_as(ctypes.c_void_p), a.shape[0],
        ctypes.byref(arena), ctypes.byref(out_size)))
    if not arena.value:
        return buf
    n = int(out_size.value)
    cbuf = (ctypes.c_uint8 * n).from_address(arena.value)
    weakref.finalize(cbuf, _arena_release, L, int(arena.value))
    return np.frombuffer(cbuf, np.uint8, n)


# ---- digests and meta -------------------------------------------------------

def cuts_digest_of(cuts) -> str:
    """Short content digest of a cuts matrix (shape-sensitive), as
    ``QuantileBinner.cuts_digest`` gives it."""
    if isinstance(cuts, torch.Tensor):
        cuts = cuts.cpu().numpy()
    a = np.ascontiguousarray(np.asarray(cuts, np.float32))
    h = hashlib.sha256(a.tobytes())
    h.update(repr(a.shape).encode())
    return h.hexdigest()[:16]


#: meta fields compared verbatim on open; a mismatch in any is a rebuild
_INVALIDATION_FIELDS = (
    "version", "byte_order", "num_bins", "missing_aware", "sketch_size",
    "sketch_seed", "source_bytes", "num_parts", "virtual_parts", "format",
    "with_qid", "codec",
)


def _compose_meta(uri: str, binner, *, source_bytes: int, num_parts: int,
                  virtual_parts: int, format: str,  # noqa: A002
                  with_qid: bool, cuts: np.ndarray,
                  codec: str = "raw") -> dict:
    pad_bin = int(np.searchsorted(cuts[0], np.float32(0.0), side="right") + 1
                  ) if cuts.size else 1
    return {
        "version": CACHE_META_VERSION,
        "byte_order": sys.byteorder,
        "source": uri,
        "source_bytes": int(source_bytes),
        "num_parts": int(num_parts),
        "virtual_parts": int(virtual_parts),
        "format": str(format),
        "with_qid": bool(with_qid),
        "codec": str(codec),
        "num_bins": int(binner.num_bins),
        "missing_aware": bool(binner.missing_aware),
        "sketch_size": int(binner.sketch_size),
        "sketch_seed": int(binner.sketch_seed),
        "cuts_digest": cuts_digest_of(cuts),
        "cuts_shape": [int(s) for s in cuts.shape],
        "cuts_b64": base64.b64encode(cuts.tobytes()).decode(),
        # the code a padding lane (index 0, value 0.0) takes under these
        # cuts, so every layer pads ebin alike
        "pad_bin": pad_bin,
    }


def _meta_matches(meta: dict, expect: dict,
                  expect_cuts_digest: Optional[str]) -> tuple:
    for k in _INVALIDATION_FIELDS:
        if meta.get(k) != expect.get(k):
            return False, (f"{k} mismatch (cache {meta.get(k)!r} != "
                           f"expected {expect.get(k)!r})")
    if expect_cuts_digest is not None and \
            meta.get("cuts_digest") != expect_cuts_digest:
        return False, (f"cuts_digest mismatch (cache "
                       f"{meta.get('cuts_digest')!r} != binner "
                       f"{expect_cuts_digest!r})")
    return True, ""


def _cuts_from_meta(meta: dict) -> np.ndarray:
    cuts = np.frombuffer(base64.b64decode(meta["cuts_b64"]),
                         np.float32).reshape(meta["cuts_shape"])
    if cuts_digest_of(cuts) != meta["cuts_digest"]:
        raise ValueError("bin cache cuts payload does not match its own "
                         "digest; refusing to adopt")
    return cuts


# ---- native handles ---------------------------------------------------------

class _NativeWriter:
    def __init__(self, path: str, meta_json: str):
        self._lib = lib()
        self._handle = ctypes.c_void_p()
        check(self._lib.DmlcTpuBinnedCacheWriterCreate(
            path.encode(), meta_json.encode(), ctypes.byref(self._handle)))

    def set_codec(self, codec: str) -> None:
        cid = int(self._lib.DmlcTpuBlockCodecFromName(codec.encode()))
        if cid < 0:
            raise ValueError(f"unknown bin-cache codec {codec!r}")
        check(self._lib.DmlcTpuBinnedCacheWriterSetCodec(self._handle, cid))

    def set_cuts(self, cuts: np.ndarray) -> None:
        cuts = np.ascontiguousarray(cuts, np.float32)
        self._keep_cuts = cuts  # the pointer outlives the call
        check(self._lib.DmlcTpuBinnedCacheWriterSetCuts(
            self._handle, cuts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            cuts.shape[0], cuts.shape[1]))

    def write_raw(self, part_id: int, seq: int, num_rows: int,
                  label: np.ndarray, weight: np.ndarray, row_ptr: np.ndarray,
                  index: np.ndarray, value: np.ndarray,
                  qid: Optional[np.ndarray]) -> None:
        """One block of parsed rows; the native writer bins the entries."""
        P = ctypes.POINTER
        nnz = int(row_ptr[num_rows])
        f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
        i32 = lambda a: np.ascontiguousarray(a, np.int32)  # noqa: E731
        lab, wgt = f32(label[:num_rows]), f32(weight[:num_rows])
        rp, idx = i32(row_ptr[:num_rows + 1]), i32(index[:nnz])
        val = f32(value[:nnz])
        q = i32(qid[:num_rows]) if qid is not None else None
        check(self._lib.DmlcTpuBinnedCacheWriterWriteRaw(
            self._handle, part_id, seq, num_rows, nnz,
            lab.ctypes.data_as(P(ctypes.c_float)),
            wgt.ctypes.data_as(P(ctypes.c_float)),
            rp.ctypes.data_as(P(ctypes.c_int32)),
            idx.ctypes.data_as(P(ctypes.c_int32)),
            val.ctypes.data_as(P(ctypes.c_float)),
            q.ctypes.data_as(P(ctypes.c_int32)) if q is not None else None))

    def close(self) -> None:
        if self._handle:
            check(self._lib.DmlcTpuBinnedCacheWriterClose(self._handle))
            self.free()

    def free(self) -> None:
        handle, self._handle = self._handle, ctypes.c_void_p()
        if handle:
            try:
                self._lib.DmlcTpuBinnedCacheWriterFree(handle)
            except (AttributeError, TypeError):
                pass  # interpreter teardown

    def __del__(self):
        try:
            self.free()
        except Exception:  # interpreter teardown: module globals may be gone
            pass


def _reader_handle_free(L, handle_value: int) -> None:
    try:
        L.DmlcTpuBinnedCacheReaderFree(ctypes.c_void_p(handle_value))
    except (AttributeError, TypeError):
        pass  # interpreter teardown: the process is about to unmap anyway


class _ReaderHandleOwner:
    """Owns the native reader handle.  It is freed (and the cache's mapping
    unmapped) only once the :class:`_NativeReader` and every borrowed block
    view, each of which pins this object through its buffer's base chain,
    are garbage, so ``close()`` never invalidates a view still queued in
    the repacker or in flight to the device."""

    def __init__(self, L, handle_value: int):
        self._finalize = weakref.finalize(self, _reader_handle_free, L,
                                          handle_value)


class _NativeReader:
    """Validating cache reader; constructing it never raises on a bad cache
    (``valid`` turns False and ``error`` says why)."""

    def __init__(self, path: str, recover: bool = False):
        self._lib = lib()
        self._handle = ctypes.c_void_p()
        self._keep: Optional[_ReaderHandleOwner] = None
        check(self._lib.DmlcTpuBinnedCacheReaderCreate(
            path.encode(), int(recover), ctypes.byref(self._handle)))
        self._keep = _ReaderHandleOwner(self._lib, int(self._handle.value))
        flag = ctypes.c_int()
        check(self._lib.DmlcTpuBinnedCacheReaderValid(self._handle,
                                                      ctypes.byref(flag)))
        self.valid = bool(flag.value)
        check(self._lib.DmlcTpuBinnedCacheReaderMissing(self._handle,
                                                        ctypes.byref(flag)))
        self.missing = bool(flag.value)
        s = ctypes.c_char_p()
        check(self._lib.DmlcTpuBinnedCacheReaderError(self._handle,
                                                      ctypes.byref(s)))
        self.error = (s.value or b"").decode()
        self.meta: dict = {}
        self.part_map: dict = {}
        if self.valid:
            check(self._lib.DmlcTpuBinnedCacheReaderMetaJson(
                self._handle, ctypes.byref(s)))
            self.meta = json.loads((s.value or b"{}").decode())
            # a cache older than the codec has no codec key and is raw
            self.meta.setdefault("codec", "raw")
            check(self._lib.DmlcTpuBinnedCacheReaderPartMapJson(
                self._handle, ctypes.byref(s)))
            self.part_map = {int(p["id"]): p for p in
                             json.loads((s.value or b"{}").decode()
                                        ).get("parts", [])}

    def next_block(self) -> Optional[bytes]:
        """The next block payload copied out as bytes (counted in
        ``cache.bytes_copied``), or None at the end."""
        data, size = ctypes.c_void_p(), ctypes.c_uint64()
        rc = check(self._lib.DmlcTpuBinnedCacheReaderNextBlock(
            self._handle, ctypes.byref(data), ctypes.byref(size)))
        if rc != 1:
            return None
        telemetry.counter_add("cache.bytes_copied", int(size.value))
        return ctypes.string_at(data, size.value)

    def next_block_view(self) -> Optional[np.ndarray]:
        """The next block payload as a uint8 numpy view, or None at the
        end.  A borrowed view points into the reader's mapping and pins the
        reader; a decoded (compressed) block rides a pooled arena the view
        owns; scratch valid only until the next call is copied (counted in
        ``cache.bytes_copied``)."""
        data, size = ctypes.c_void_p(), ctypes.c_uint64()
        borrowed = ctypes.c_int()
        rc = check(self._lib.DmlcTpuBinnedCacheReaderNextBlockView(
            self._handle, ctypes.byref(data), ctypes.byref(size),
            ctypes.byref(borrowed)))
        if rc != 1:
            return None
        n = int(size.value)
        if n == 0 or not data.value:
            return np.empty(0, np.uint8)
        arena = ctypes.c_void_p()
        check(self._lib.DmlcTpuBinnedCacheReaderTakeArena(
            self._handle, ctypes.byref(arena)))
        cbuf = (ctypes.c_uint8 * n).from_address(data.value)
        if arena.value:
            weakref.finalize(cbuf, _arena_release, self._lib,
                             int(arena.value))
            return np.frombuffer(cbuf, np.uint8, n)
        cbuf._owner = self._keep  # view -> handle keepalive, never the reverse
        a = np.frombuffer(cbuf, np.uint8, n)
        if not borrowed.value:
            a = a.copy()  # scratch is valid only until the next call
            telemetry.counter_add("cache.bytes_copied", n)
        return a

    @property
    def backend(self) -> int:
        """The read backend this open resolved to: 0 streaming, 1 mmap,
        2 O_DIRECT arena."""
        out = ctypes.c_int()
        check(self._lib.DmlcTpuBinnedCacheReaderBackend(self._handle,
                                                        ctypes.byref(out)))
        return int(out.value)

    def set_decode(self, decode: bool) -> None:
        """Toggle inline decode.  False serves records exactly as stored,
        compressed payloads included (the data-service worker's mode: the
        client decodes)."""
        check(self._lib.DmlcTpuBinnedCacheReaderSetDecode(self._handle,
                                                          int(decode)))

    def seek_to(self, offset: int) -> None:
        check(self._lib.DmlcTpuBinnedCacheReaderSeekTo(self._handle, offset))

    def before_first(self) -> None:
        check(self._lib.DmlcTpuBinnedCacheReaderBeforeFirst(self._handle))

    @property
    def corrupt_skipped(self) -> int:
        """Records a recover-mode open skipped as corrupt."""
        return int(self._lib.DmlcTpuBinnedCacheReaderCorruptSkipped(
            self._handle))

    def close(self) -> None:
        # drops this wrapper's reference; the native free waits for every
        # borrowed view still alive (_ReaderHandleOwner)
        self._handle = ctypes.c_void_p()
        self._keep = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter teardown: module globals may be gone
            pass


def unpack_block(buf: Union[bytes, np.ndarray]) -> dict:
    """One cache block payload as host arrays, views over ``buf`` (its
    columns stay borrowed from the cache mapping when ``buf`` is a
    borrowed view)."""
    hdr = np.frombuffer(buf, _HDR_DTYPE, count=1)[0]
    nr, nnz = int(hdr["num_rows"]), int(hdr["nnz"])
    with_qid = bool(hdr["flags"] & 1)
    off = _HDR_BYTES

    def take(dtype, count):
        nonlocal off
        a = np.frombuffer(buf, dtype, count, off)
        off += a.nbytes
        return a

    label = take(np.float32, nr)
    weight = take(np.float32, nr)
    row_ptr = take(np.int32, nr + 1)
    qid = take(np.int32, nr) if with_qid else None
    index = take(np.int32, nnz)
    ebin = take(np.uint8, nnz)
    mask_bits = take(np.uint8, (nnz + 7) // 8)
    emask = np.unpackbits(mask_bits, count=nnz,
                          bitorder="little").astype(bool)
    return {
        "part_id": int(hdr["part_id"]), "seq": int(hdr["seq"]),
        "num_rows": nr, "nnz": nnz, "label": label, "weight": weight,
        "row_ptr": row_ptr, "qid": qid, "index": index, "ebin": ebin,
        "emask": emask,
    }


def _le_keys(a: np.ndarray) -> np.ndarray:
    """uint32 keys in the order of f32 ``<=``: -0.0 and 0.0 one key, every
    NaN the largest key (a NaN cut is never ``<=`` a value; NaN values
    are coded apart)."""
    a = np.asarray(a, np.float32) + np.float32(0.0)  # -0.0 -> +0.0
    u = a.view(np.uint32)
    k = np.where(u >> 31, ~u, u | np.uint32(0x80000000))
    return np.where(np.isnan(a), np.uint32(0xFFFFFFFF), k)


def bin_entries_np(cuts: np.ndarray, index: np.ndarray,
                   value: np.ndarray, chunk: int = 1 << 20) -> np.ndarray:
    """``QuantileBinner.transform_entries`` (and the native writer's
    binning) on the host: uint8 codes, ``1 + #(cuts[f] <= v)``, NaN -> 0,
    an index past the cuts binned against feature 0.

    One ``searchsorted`` over every feature's cuts at once: each cut and
    value becomes a uint64 ``feature << 32 | key`` (``_le_keys``), each
    feature's cut keys sorted, so the insertion point of a value's key,
    less the cuts of the features before it, counts its cuts ``<=`` it."""
    cuts = np.asarray(cuts, np.float32)
    F, K = cuts.shape
    fshift = np.arange(F, dtype=np.uint64)[:, None] << np.uint64(32)
    table = (fshift | np.sort(_le_keys(cuts), axis=1).astype(np.uint64)
             ).ravel()
    index = np.asarray(index)
    value = np.asarray(value, np.float32)
    out = np.empty(index.shape[0], np.uint8)
    for s in range(0, index.shape[0], chunk):
        fi = index[s:s + chunk].astype(np.int64)
        v = value[s:s + chunk]
        fi = np.where((fi >= 0) & (fi < F), fi, 0)
        q = (fi.astype(np.uint64) << np.uint64(32)) | \
            _le_keys(v).astype(np.uint64)
        code = np.searchsorted(table, q, side="right") - fi * K + 1
        out[s:s + chunk] = np.where(np.isnan(v), 0, code).astype(np.uint8)
    return out


# ---- the staged batch -------------------------------------------------------

@dataclass
class BinnedBatch:
    """Static-shape pre-binned CSR batch on the device.

    The binned counterpart of ``PaddedBatch``: ``ebin`` holds each entry's
    uint8 bin code (what ``QuantileBinner.transform_entries`` computes from
    its value) and ``emask`` its presence (``value != 0 and not
    isnan(value)``, the trainer's rule), in place of the value column.
    Padding rows have ``weight == 0`` and empty spans; padding lanes have
    ``emask`` False and ``ebin == pad_bin`` (the code a value-0 lane takes
    on the text path).  ``num_rows`` is a Python int.  ``cuts_digest``
    names the cuts behind the codes; the trainer refuses a binner whose
    cuts differ."""

    label: torch.Tensor    # f32 [batch]
    weight: torch.Tensor   # f32 [batch]
    row_ptr: torch.Tensor  # i32 [batch + 1]
    index: torch.Tensor    # i32 [nnz_pad]
    ebin: torch.Tensor     # u8 [nnz_pad]
    emask: torch.Tensor    # bool [nnz_pad]
    num_rows: int
    qid: Optional[torch.Tensor] = None  # i32 [batch]
    cuts_digest: str = ""
    # a process's batch of a multi-process epoch (as PaddedBatch's)
    plan: Optional[object] = None
    global_num_rows: Optional[int] = None
    global_row_ptr: Optional[torch.Tensor] = None

    @property
    def batch_size(self) -> int:
        return self.label.shape[0]

    def row_ids(self) -> torch.Tensor:
        """COO row id per entry (i32); padding lanes map to row
        ``batch_size - 1`` (their emask is False)."""
        k = torch.arange(self.index.shape[0], dtype=self.row_ptr.dtype,
                         device=self.row_ptr.device)
        r = torch.searchsorted(self.row_ptr, k, right=True,
                               out_int32=True) - 1
        return torch.clamp(r, max=self.batch_size - 1)


# ---- repacking blocks into static-shape batches -----------------------------

def _acquire_arena_views(specs) -> dict:
    """One pooled native arena carved into named numpy views.  ``specs`` is
    ``[(name, count, dtype), ...]``; each lane starts on a 64-byte
    boundary.  The arena goes back to the pool (``cache.arena_reuse``)
    once every view is garbage."""
    L = lib()
    lanes, total = [], 0
    for name, count, dtype in specs:
        total = (total + 63) & ~63
        lanes.append((name, total, int(count), np.dtype(dtype)))
        total += np.dtype(dtype).itemsize * int(count)
    ptr = ctypes.c_void_p()
    check(L.DmlcTpuCacheArenaAcquire(max(total, 1), ctypes.byref(ptr)))
    buf = (ctypes.c_uint8 * total).from_address(ptr.value)
    weakref.finalize(buf, _arena_release, L, int(ptr.value))
    return {name: np.frombuffer(buf, dt, count, off)
            for name, off, count, dt in lanes}


def _fill(out: np.ndarray, a: np.ndarray, fill) -> None:
    out[:a.shape[0]] = a
    out[a.shape[0]:] = fill


class _Repacker:
    """Repack cache blocks into fixed-shape host batches with the
    StagedBatcher's padding rules (rows to ``batch_size``, entries to a
    multiple of ``nnz_bucket``, or exactly ``nnz_max`` with rows spilling
    to the next batch), so a cache epoch's batches are the text epoch's.

    The per-entry columns (index, ebin, emask: the bulk of a block) stay
    borrowed block views in a queue and are gathered once, into a pooled
    arena, when a batch is emitted; the per-row columns are a few bytes a
    row and are concatenated."""

    def __init__(self, batch_size: int, nnz_bucket: int, nnz_max: int,
                 pad_bin: int, with_qid: bool):
        self._B = int(batch_size)
        self._bucket = max(int(nnz_bucket), 1)
        self._nnz_max = int(nnz_max)
        self._pad_bin = int(pad_bin)
        self._with_qid = bool(with_qid)
        z = lambda dt: np.empty(0, dt)  # noqa: E731
        self._lab, self._wgt = z(np.float32), z(np.float32)
        self._qid = z(np.int32)
        self._len = z(np.int64)
        self._segs: deque = deque()  # queued entry views, consumed FIFO

    def feed(self, blk: dict) -> Iterator[dict]:
        self._lab = np.concatenate([self._lab, blk["label"]])
        self._wgt = np.concatenate([self._wgt, blk["weight"]])
        if self._with_qid:
            q = blk["qid"] if blk["qid"] is not None else \
                np.zeros(blk["num_rows"], np.int32)
            self._qid = np.concatenate([self._qid, q])
        self._len = np.concatenate(
            [self._len, np.diff(blk["row_ptr"]).astype(np.int64)])
        if blk["nnz"]:
            self._segs.append({"idx": blk["index"], "ebin": blk["ebin"],
                               "emask": blk["emask"], "start": 0})
        yield from self._pump(final=False)

    def flush(self) -> Iterator[dict]:
        yield from self._pump(final=True)

    def _gather_entries(self, n: int, idx_out: np.ndarray,
                        ebin_out: np.ndarray, emask_out: np.ndarray) -> None:
        got = 0
        while got < n:
            seg = self._segs[0]
            s = seg["start"]
            take = min(n - got, seg["idx"].shape[0] - s)
            idx_out[got:got + take] = seg["idx"][s:s + take]
            ebin_out[got:got + take] = seg["ebin"][s:s + take]
            emask_out[got:got + take] = seg["emask"][s:s + take]
            seg["start"] = s + take
            got += take
            if seg["start"] == seg["idx"].shape[0]:
                self._segs.popleft()

    def _take_rows(self) -> Optional[int]:
        """Rows of the next full batch, or None if not enough are
        buffered."""
        n = self._len.shape[0]
        if self._nnz_max == 0:
            return self._B if n >= self._B else None
        # spill rule: close the batch when the next row would overflow the
        # fixed entry budget, or at batch_size rows
        csum = np.cumsum(self._len[:self._B + 1])
        fit = int(np.searchsorted(csum, self._nnz_max, side="right"))
        take = min(fit, self._B)
        if take == 0:
            raise ValueError(f"a single row has more than nnz_max="
                             f"{self._nnz_max} nonzeros; raise nnz_max")
        if take >= self._B:
            return self._B if n >= self._B else None
        # a budget-limited close needs the overflowing row buffered
        return take if n > take else None

    def _pump(self, final: bool) -> Iterator[dict]:
        while True:
            take = self._take_rows()
            if take is None:
                break
            yield self._emit(take)
        if final and self._len.shape[0]:
            yield self._emit(self._len.shape[0])

    def _emit(self, nr: int) -> dict:
        B = self._B
        lens = self._len[:nr]
        nnz = int(lens.sum())
        if self._nnz_max:
            nnz_pad = self._nnz_max
        else:
            nnz_pad = max(-(-nnz // self._bucket) * self._bucket,
                          self._bucket)
        specs = [("label", B, np.float32), ("weight", B, np.float32),
                 ("row_ptr", B + 1, np.int32)]
        if self._with_qid:
            specs.append(("qid", B, np.int32))
        specs += [("index", nnz_pad, np.int32), ("ebin", nnz_pad, np.uint8),
                  ("emask", nnz_pad, np.bool_)]
        out = _acquire_arena_views(specs)
        # arenas are recycled: every lane byte is written (data, then pad)
        _fill(out["label"], self._lab[:nr], 0)
        _fill(out["weight"], self._wgt[:nr], 0)
        rp = out["row_ptr"]
        rp[0] = 0
        rp[1:nr + 1] = np.cumsum(lens)
        rp[nr + 1:] = rp[nr]
        if self._with_qid:
            _fill(out["qid"], self._qid[:nr], 0)
        self._gather_entries(nnz, out["index"], out["ebin"], out["emask"])
        out["index"][nnz:] = 0
        out["ebin"][nnz:] = self._pad_bin
        out["emask"][nnz:] = False
        batch = {
            "num_rows": nr,
            "label": out["label"],
            "weight": out["weight"],
            "qid": out["qid"] if self._with_qid else None,
            "row_ptr": rp,
            "index": out["index"],
            "ebin": out["ebin"],
            "emask": out["emask"],
        }
        self._lab, self._wgt = self._lab[nr:], self._wgt[nr:]
        if self._with_qid:
            self._qid = self._qid[nr:]
        self._len = self._len[nr:]
        return batch


# ---- build ------------------------------------------------------------------

def _drain_host(it: DeviceStagingIter) -> Iterator[dict]:
    """Host batches of a DeviceStagingIter, never staged (the build and
    sketch passes need no device): numpy views with label, weight and
    value as f32."""
    L = it._lib
    with it._lock:
        check(L.DmlcTpuStagedBatcherBeforeFirst(it._handle))
        while True:
            c = StagedBatchOwnedC()
            if check(L.DmlcTpuStagedBatcherNextOwned(
                    it._handle, ctypes.byref(c))) != 1:
                return
            w = it._wrap_owned(c)
            for k in ("label", "weight", "value"):
                w[k] = w[k].view(np.float32)
            yield w


def build_bin_cache(uri: str, cache_path: str, binner, *,
                    num_parts: int = 1, format: str = "auto",  # noqa: A002
                    batch_size: int = 4096, nnz_bucket: int = 1 << 16,
                    with_qid: bool = False, buffer_mb: int = 64,
                    codec: Optional[str] = None) -> dict:
    """Build the binned cache of ``uri`` at ``cache_path``; returns its
    meta.

    ``codec`` (``"raw"`` / ``"lz4"``; ``None``: ``DMLCTPU_BINCACHE_CODEC``)
    selects the block codec.  An unfitted ``binner`` (``cuts is None``)
    gets a sketch pass first (one parse feeding ``partial_fit_sparse``,
    then ``finalize``); a fitted one builds in one parse.  Each global
    virtual part is read by its own parser cursor and written as blocks by
    the native binning writer, to a temporary file renamed into place, so
    a failure leaves no cache (or one the reader rejects)."""
    total = source_total_bytes(uri, "recordio" if format == "recordio"
                               else "text")
    V = _pick_virtual_parts(total, num_parts)
    opts = dict(batch_size=batch_size, nnz_bucket=nnz_bucket, format=format,
                with_qid=with_qid, buffer_mb=buffer_mb, autotune=False,
                device="cpu")

    if binner.cuts is None:
        it = DeviceStagingIter(uri, part=0, num_parts=1, **opts)
        try:
            for w in _drain_host(it):
                nr = w["num_rows"]
                if nr == 0:
                    continue
                nnz = int(w["row_ptr"][nr])
                idx = np.asarray(w["index"][:nnz], np.int64)
                val = np.asarray(w["value"][:nnz], np.float32)
                binner.partial_fit_sparse(idx, val,
                                          int(idx.max(initial=-1)) + 1)
        finally:
            it.close()
        binner.finalize()

    codec = resolve_codec(codec)
    cuts = np.ascontiguousarray(binner.cuts.cpu().numpy(), np.float32)
    meta = _compose_meta(uri, binner, source_bytes=total, num_parts=num_parts,
                         virtual_parts=V, format=format, with_qid=with_qid,
                         cuts=cuts, codec=codec)
    tmp = f"{cache_path}.tmp.{os.getpid()}"
    writer = _NativeWriter(tmp, json.dumps(meta))
    t0 = time.monotonic()
    try:
        writer.set_codec(codec)
        writer.set_cuts(cuts)
        for g in range(num_parts * V):
            it = DeviceStagingIter(uri, part=g, num_parts=num_parts * V,
                                   **opts)
            seq = 0
            try:
                for w in _drain_host(it):
                    nr = w["num_rows"]
                    if nr == 0:
                        continue
                    writer.write_raw(g, seq, nr, w["label"], w["weight"],
                                     w["row_ptr"], w["index"], w["value"],
                                     w["qid"])
                    seq += 1
            finally:
                it.close()
        writer.close()
    except BaseException:
        writer.free()
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, cache_path)
    LOGGER.info("built bin cache %s (%d virtual parts) in %.2fs",
                cache_path, num_parts * V, time.monotonic() - t0)
    return meta


# ---- host-level reading -----------------------------------------------------

class BinnedRowIter:
    """Host-level iterator over a binned cache's blocks: yields unpacked
    block dicts in part order.  ``parts`` restricts it to some virtual part
    ids (default: all)."""

    def __init__(self, cache_path: str, parts=None, recover: bool = False):
        self._path = cache_path
        self._recover = bool(recover)
        r = _NativeReader(cache_path, recover)
        if not r.valid:
            err = r.error
            r.close()
            raise ValueError(f"invalid bin cache {cache_path}: {err}")
        self.meta, self.part_map = r.meta, r.part_map
        r.close()
        self._parts = (sorted(self.part_map) if parts is None
                       else [int(p) for p in parts])

    def __iter__(self) -> Iterator[dict]:
        r = _NativeReader(self._path, self._recover)
        try:
            for p in self._parts:
                ent = self.part_map.get(p)
                if ent is None:
                    continue  # the part had no rows at build time
                r.seek_to(int(ent["offset"]))
                for _ in range(int(ent["records"])):
                    buf = r.next_block_view()
                    if buf is None:
                        break  # recover mode skipped a corrupt tail
                    yield unpack_block(buf)
        finally:
            r.close()


# ---- the staging iterator ---------------------------------------------------

# the staged leaves in their order in a host buffer: the 4-byte ones, then
# the 1-byte ones (each starting on a word)
_WORD_LEAVES = ("label", "weight", "row_ptr", "qid", "index")
_BYTE_LEAVES = ("ebin", "emask")
_BYTE_DTYPES = {"ebin": torch.uint8, "emask": torch.bool}


class _BinnedStager:
    """The device half of a binned epoch, shared by ``BinnedStagingIter``
    and the data service's ``DataServiceIter`` (a service epoch's batches
    are a local cache hit's bit for bit because both stage here): each
    repacked host batch goes into one host buffer of a pinned ring (the
    4-byte leaves, then the 1-byte lanes each from a word boundary) and to
    ``device`` in one copy on the stager's own stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self.ring = None  # the pinned buffers, made on the first epoch
        self.batches = 0

    def stage(self, w: dict, digest: str):
        """One host batch -> (BinnedBatch on the device, the copy's CUDA
        event or None)."""
        with telemetry.span("h2d.stage_binned"):
            present = [k for k in _WORD_LEAVES if w[k] is not None]
            spans, off = {}, 0
            for k in present:
                spans[k] = (off, w[k].size)
                off += w[k].size
            for k in _BYTE_LEAVES:
                spans[k] = (off, w[k].size)
                off += (w[k].size + 3) // 4
            words = off
            cuda = self.device.type == "cuda"
            if cuda:
                slot, host = self.ring.take(words)
            else:
                host = torch.empty(words, dtype=torch.int32)
            flat = host.numpy()
            for k in present:
                o, n = spans[k]
                flat[o:o + n] = w[k].view(np.int32)
            for k in _BYTE_LEAVES:
                o, n = spans[k]
                flat[o:o + (n + 3) // 4].view(np.uint8)[:n] = \
                    w[k].view(np.uint8)
            event = None
            if cuda:
                with torch.cuda.stream(self.stream):
                    dev = host[:words].to(self.device, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(self.stream)
                self.ring.events[slot] = event
            else:
                dev = host
            leaves = {}
            for k, (o, n) in spans.items():
                if k in _BYTE_LEAVES:
                    t = dev[o:o + (n + 3) // 4].view(torch.uint8)[:n]
                    leaves[k] = t.view(_BYTE_DTYPES[k])
                else:
                    t = dev[o:o + n]
                    leaves[k] = (t.view(torch.float32)
                                 if k in ("label", "weight") else t)
            batch = BinnedBatch(num_rows=int(w["num_rows"]),
                                cuts_digest=digest, **leaves)
            self.batches += 1
            return batch, event

    def host_iter(self, produce, prefetch: int):
        """``produce(emit)``'s host batches, up to ``prefetch`` ahead, on a
        producer thread (the ring is sized on the first epoch)."""
        if self.device.type == "cuda" and self.ring is None:
            self.ring = _PinnedRing(prefetch + 2)
        return _staged_iter(produce, prefetch,
                            depth_gauge="cache.queue_depth")

    def feed(self, host_iter, digest: str, prof: dict
             ) -> Iterator[BinnedBatch]:
        """The epoch's batches on the device, staged on a thread of their
        own (``_device_feed``)."""
        yield from _device_feed(self.device, host_iter,
                                lambda w: self.stage(w, digest), prof)


class BinnedStagingIter:
    """Stage pre-binned batches (``BinnedBatch``) from the epoch cache onto
    ``device`` (the card unless the caller asks for the CPU).

    ``__iter__`` first makes sure a valid cache that matches the contract
    exists, building or rebuilding it (a rebuild is counted in
    ``cache.rebuilds``), then streams the cache's blocks through the
    repacker and a pinned host ring (as ``DeviceStagingIter``'s: one host
    buffer and one copy a batch, on the iterator's own stream) onto the
    device, with no parse and no binning.

    ``binner``: a missing-aware ``QuantileBinner``.  Fitted, its cuts
    digest is part of the contract (a stale cache is rebuilt).  Unfitted,
    the first build runs the streaming sketch, and a later open adopts the
    cache's cuts into the binner (digest-checked), so a fresh process skips
    the sketch.

    ``autotune=True`` (or ``DMLCTPU_AUTOTUNE`` when None) attaches the
    tuner; a cache epoch has no parse stage, so it moves
    ``prefetch_depth`` only, from the next epoch.  (The JAX package's
    ``BinnedStagingIter`` takes no ``autotune`` argument and never arms
    its tuner hook.)

    ``sharding=`` in a job of more than one process serves this
    process's ``part`` of the cache and coordinates every batch with the
    other processes, as ``DeviceStagingIter`` does (it needs ``nnz_max``);
    :meth:`host_blocks_coordinated` serves cache blocks under the tracker's
    shard ownership.
    """

    def __init__(self, uri: str, binner, cache: Optional[str] = None,
                 batch_size: int = 4096, nnz_bucket: int = 1 << 16,
                 nnz_max: int = 0, part: int = 0, num_parts: int = 1,
                 format: str = "auto", sharding=None,  # noqa: A002
                 prefetch: int = 2, prefetch_depth: Optional[int] = None,
                 with_qid: bool = False, buffer_mb: int = 64,
                 recover: bool = False, codec: Optional[str] = None,
                 autotune: Optional[bool] = None, device="cuda"):
        self._device = resolve_device(device)
        if self._device.type == "cuda" and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._plan = staging_plan(sharding)
        self._autotune = bool(_autotune.armed() if autotune is None
                              else autotune)
        self._tuner = None  # the AutoTuner, attached on the first epoch
        self._uri = uri
        self._binner = binner
        self._cache_path = cache or uri.split("#", 1)[0] + ".bincache"
        self._codec = resolve_codec(codec)
        self._batch_size = int(batch_size)
        self._nnz_bucket = int(nnz_bucket)
        self._nnz_max = int(nnz_max)
        self._part = int(part)
        self._num_parts = int(num_parts)
        self._format = format
        self._prefetch = max(prefetch_depth if prefetch_depth is not None
                             else prefetch, 1)
        self._with_qid = bool(with_qid)
        self._buffer_mb = int(buffer_mb)
        self._recover = bool(recover)
        self._meta: Optional[dict] = None
        self._part_map: dict = {}
        self._fallback_text = False
        self._lock = threading.Lock()
        self._stager = _BinnedStager(self._device)
        self.profile = None

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def batches_staged(self) -> int:
        return self._stager.batches

    @property
    def cache_path(self) -> str:
        return self._cache_path

    @property
    def served_from_text(self) -> bool:
        """True when the last ``ensure_cache`` could not build the cache
        and epochs are served from the text path."""
        return self._fallback_text

    # -- cache lifecycle ------------------------------------------------------
    def _expected_meta(self) -> dict:
        total = source_total_bytes(self._uri, "recordio"
                                   if self._format == "recordio" else "text")
        return {
            "version": CACHE_META_VERSION,
            "byte_order": sys.byteorder,
            "source_bytes": total,
            "num_parts": self._num_parts,
            "virtual_parts": _pick_virtual_parts(total, self._num_parts),
            "format": str(self._format),
            "with_qid": self._with_qid,
            "codec": self._codec,
            "num_bins": int(self._binner.num_bins),
            "missing_aware": bool(self._binner.missing_aware),
            "sketch_size": int(self._binner.sketch_size),
            "sketch_seed": int(self._binner.sketch_seed),
        }

    def _adopt_or_check(self, meta: dict) -> bool:
        if self._binner.cuts is None:
            self._binner._set_cuts(_cuts_from_meta(meta))
            return True
        return self._binner.cuts_digest() == meta["cuts_digest"]

    def ensure_cache(self) -> None:
        """Open, or (re)build, until a valid cache that matches the
        contract exists.

        Counts ``cache.rebuilds`` once for each invalidation (a missing
        file is a first build, not a rebuild).  A build that fails is
        retried once; failing again, the iterator serves its epochs from
        the text path (the same batches) and the next ``ensure_cache``
        tries to build again."""
        self._fallback_text = False
        expect = self._expected_meta()
        digest = (self._binner.cuts_digest()
                  if self._binner.cuts is not None else None)
        r = _NativeReader(self._cache_path, self._recover)
        reason, first_build = None, False
        if r.valid:
            ok, why = _meta_matches(r.meta, expect, digest)
            if ok and self._adopt_or_check(r.meta):
                self._meta, self._part_map = r.meta, r.part_map
                r.close()
                return
            reason = why or "cuts_digest mismatch vs fitted binner"
        else:
            reason, first_build = r.error, r.missing
        r.close()
        if not first_build:
            telemetry.counter_add("cache.rebuilds", 1)
            LOGGER.warning("bin cache %s invalid (%s); rebuilding",
                           self._cache_path, reason)
        for attempt in (1, 2):
            try:
                self._build()
                break
            except Exception as e:  # noqa: BLE001  retried, then degraded
                telemetry.counter_add("cache.build_failed", 1)
                LOGGER.warning("bin cache build attempt %d failed: %s",
                               attempt, e)
                if attempt == 2:
                    LOGGER.warning(
                        "bin cache unavailable; serving this epoch from the"
                        " text-parse path (the same batches, uncached)")
                    self._fallback_text = True
                    return
        r = _NativeReader(self._cache_path, self._recover)
        try:
            if not r.valid:
                raise RuntimeError(f"freshly built bin cache invalid: "
                                   f"{r.error}")
            ok, why = _meta_matches(r.meta, expect, digest)
            if not ok or not self._adopt_or_check(r.meta):
                raise RuntimeError(f"freshly built bin cache mismatched: "
                                   f"{why}")
            self._meta, self._part_map = r.meta, r.part_map
        finally:
            r.close()

    def _build(self) -> None:
        build_bin_cache(self._uri, self._cache_path, self._binner,
                        num_parts=self._num_parts, format=self._format,
                        batch_size=self._batch_size,
                        nnz_bucket=self._nnz_bucket, with_qid=self._with_qid,
                        buffer_mb=self._buffer_mb, codec=self._codec)

    @property
    def meta(self) -> Optional[dict]:
        return self._meta

    # -- host-side block production -------------------------------------------
    def _my_parts(self) -> list:
        V = int(self._meta["virtual_parts"])
        return list(range(self._part * V, (self._part + 1) * V))

    def _open_global_part(self, g: int) -> Iterator[dict]:
        """One GLOBAL virtual part's unpacked blocks through a cache cursor
        of its own (what a shard handed off by the tracker reads)."""
        ent = self._part_map.get(int(g))
        if ent is None:
            return
        r = _NativeReader(self._cache_path, self._recover)
        try:
            r.seek_to(int(ent["offset"]))
            for _ in range(int(ent["records"])):
                buf = r.next_block_view()
                if buf is None:
                    break
                yield unpack_block(buf)
        finally:
            r.close()

    def host_blocks_coordinated(self, epoch: int = 0, client=None,
                                steal: bool = True) -> Iterator[dict]:
        """Unpacked cache blocks under tracker-coordinated shard ownership
        (claim and steal through the shard board), as
        ``RecordStagingIter.host_batches_coordinated`` on the cache's read
        path.  Builds or opens the cache first."""
        if self._meta is None:
            self.ensure_cache()
        if self._fallback_text:
            raise RuntimeError("bin cache unavailable (build failed); "
                               "coordinated cache reads need a cache")
        if client is None:
            client = _tracker_metrics.shard_client_from_env(rank=self._part)
        yield from _tracker_metrics.coordinated_parts(
            int(epoch), self._my_parts(), self._open_global_part, client,
            steal=steal)

    def _produce_host(self, emit) -> None:
        pad_bin = int(self._meta.get("pad_bin", 1))
        rp = _Repacker(self._batch_size, self._nnz_bucket, self._nnz_max,
                       pad_bin, self._with_qid)
        emitted = 0
        r = _NativeReader(self._cache_path, self._recover)
        try:
            def send(batch) -> bool:
                nonlocal emitted
                t2 = time.monotonic()
                ok = emit(batch)
                emitted += 1
                telemetry.counter_add("cache.wait_us",
                                      int((time.monotonic() - t2) * 1e6))
                return ok

            try:
                for g in self._my_parts():
                    ent = self._part_map.get(g)
                    if ent is None:
                        continue
                    t0 = time.monotonic()
                    r.seek_to(int(ent["offset"]))
                    for _ in range(int(ent["records"])):
                        buf = r.next_block_view()
                        if buf is None:
                            break
                        outs = list(rp.feed(unpack_block(buf)))
                        telemetry.counter_add(
                            "cache.busy_us",
                            int((time.monotonic() - t0) * 1e6))
                        for b in outs:
                            if not send(b):
                                return
                        t0 = time.monotonic()
                    telemetry.counter_add("cache.busy_us",
                                          int((time.monotonic() - t0) * 1e6))
                for b in rp.flush():
                    if not send(b):
                        return
            except NativeError as e:
                # a corrupt read in strict mode (torn framing, or a
                # compressed record that fails to decode).  Before the first
                # batch: invalidate the cache (one counted rebuild; the next
                # ensure_cache finds no file, an uncounted first build) and
                # serve this epoch from the text path.  Mid-epoch a restart
                # would tear the batch stream: re-raise.
                if emitted:
                    raise
                LOGGER.warning(
                    "bin cache %s unreadable (%s); invalidating and serving"
                    " this epoch from the text-parse path", self._cache_path,
                    e)
                telemetry.counter_add("cache.rebuilds", 1)
                try:
                    os.remove(self._cache_path)
                except OSError:
                    pass
                self._produce_host_text(emit)
        finally:
            r.close()

    def _produce_host_text(self, emit) -> None:
        """The degraded path (no cache): parse text and bin on the host,
        emitting the batches the cache would have served."""
        cuts = np.ascontiguousarray(self._binner.cuts.cpu().numpy(),
                                    np.float32)
        it = DeviceStagingIter(
            self._uri, batch_size=self._batch_size,
            nnz_bucket=self._nnz_bucket, nnz_max=self._nnz_max,
            part=self._part, num_parts=self._num_parts, format=self._format,
            with_qid=self._with_qid, buffer_mb=self._buffer_mb,
            autotune=False, device="cpu")
        try:
            for w in _drain_host(it):
                v = np.asarray(w["value"], np.float32)
                out = {
                    "num_rows": w["num_rows"],
                    "label": w["label"],
                    "weight": w["weight"],
                    "qid": w["qid"],
                    "row_ptr": w["row_ptr"],
                    "index": w["index"],
                    "ebin": bin_entries_np(cuts, w["index"], v),
                    "emask": (v != 0) & ~np.isnan(v),
                }
                if not emit(out):
                    return
        finally:
            it.close()

    def _digest(self) -> str:
        """The cuts digest the epoch's batches carry."""
        return (self._binner.cuts_digest() if self._fallback_text
                else self._meta["cuts_digest"])

    @property
    def knobs(self) -> dict:
        return {"prefetch_depth": self._prefetch}

    def set_knobs(self, prefetch_depth: Optional[int] = None,
                  **_ignored) -> dict:
        """Retune the prefetch depth from the next epoch; the parse-side
        knobs are accepted and ignored (a cache epoch parses nothing)."""
        if prefetch_depth is not None:
            self._prefetch = max(int(prefetch_depth), 1)
        return dict(self.knobs, pool_live=False)

    def __iter__(self) -> Iterator[BinnedBatch]:
        yield from _tuned_epoch(self, self._iter_epoch)

    def _iter_epoch(self) -> Iterator[BinnedBatch]:
        with self._lock:
            self.ensure_cache()
        produce = (self._produce_host_text if self._fallback_text
                   else self._produce_host)
        prof = {"host_wait_s": 0.0, "stage_s": 0.0, "emit_wait_s": 0.0,
                "batches": 0}
        self.profile = prof
        host_iter = self._stager.host_iter(produce, self._prefetch)
        if self._plan is not None:
            yield from self._iter_multiprocess(host_iter)
            return
        yield from self._stager.feed(host_iter, self._digest(), prof)

    def _iter_multiprocess(self, host_iter) -> Iterator[BinnedBatch]:
        """A multi-process epoch, coordinated batch by batch as
        ``DeviceStagingIter``'s (``[status, num_rows, row_ptr]`` on the
        consumer thread)."""
        if self._nnz_max == 0:
            raise ValueError(
                "multi-process staging needs fixed shapes: pass nnz_max=... "
                "so every process contributes identically-shaped shards")
        B, nnz, plan = self._batch_size, self._nnz_max, self._plan
        nprocs = plan.num_shards

        def pack(local, out):
            out[0] = local["num_rows"]
            out[1:] = local["row_ptr"]

        for local, gathered in multiprocess_rounds(host_iter, B + 2, pack,
                                                   plan):
            shifts = np.arange(nprocs, dtype=np.int64) * nnz
            shifted = gathered[:, 2:] + shifts[:, None]
            global_rp = np.concatenate(
                [shifted[:, :-1].reshape(-1),
                 [np.int64(nnz) * nprocs]]).astype(np.int32)
            if local is None:  # out of rows: padding rows and lanes
                pad_bin = int(self._meta.get("pad_bin", 1)) if self._meta \
                    else 1
                z32 = lambda k: np.zeros(k, np.int32)  # noqa: E731
                local = {"num_rows": 0, "label": z32(B), "weight": z32(B),
                         "row_ptr": z32(B + 1), "index": z32(nnz),
                         "qid": z32(B) if self._with_qid else None,
                         "ebin": np.full(nnz, pad_bin, np.uint8),
                         "emask": np.zeros(nnz, np.bool_)}
            batch = _consume(self._device,
                             *self._stager.stage(local, self._digest()))
            batch.plan = plan
            batch.global_num_rows = int(gathered[:, 1].sum())
            batch.global_row_ptr = torch.from_numpy(global_rp).to(
                self._device)
            yield batch
