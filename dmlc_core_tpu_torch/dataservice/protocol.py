"""The 0xff9a data channel: client <-> staging worker, and model snapshots.

Native-endian int32 scalars, ``[len]+utf8`` JSON strings, a magic word
exchanged both ways before anything else, one request per connection (the
0xff98 metrics channel's discipline on its own magic).  Bulk bytes travel
as payload frames: a kind tag, an int64 length, then the raw payload:

  ``FRAME_BLOCK``    one binned-cache block exactly as stored on disk
                     (``binned_cache.unpack_block`` reads it), sent from the
                     worker's mmap view with no copy
  ``FRAME_STAGED``   one packed text-parse batch: the 112-byte native wire
                     header (``DmlcTpuStagedBatchWireHeader``), then the
                     owned arena verbatim
  ``FRAME_END``      JSON trailer ``{"blocks": n}`` closing a fetch; a
                     count that disagrees means the stream died mid-part
  ``FRAME_SNAPSHOT`` one packed model snapshot pushed to a ScoringServer
  ``FRAME_ERROR``    JSON ``{"error": msg}``

Byte-compatible with ``dmlc_core_tpu.dataservice.protocol``, so a worker,
client or pusher of either package talks to a peer of either package.
"""
from __future__ import annotations

import ctypes
import json
import socket
import struct

import numpy as np

from .._native import NO_FIELD, StagedBatchOwnedC, check, lib

DATA_MAGIC = 0xFF9A
FRAME_END = 0
FRAME_BLOCK = 1
FRAME_STAGED = 2
FRAME_SNAPSHOT = 3
FRAME_ERROR = -1

WIRE_HEADER_BYTES = 112  # == DMLCTPU_STAGED_WIRE_HEADER_BYTES (wire v2)

_I64 = struct.Struct("@q")


def _read_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 65536))
        if not chunk:
            raise ConnectionError("peer closed during read")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _read_int(sock: socket.socket) -> int:
    return struct.unpack("@i", _read_exact(sock, 4))[0]


def _write_int(sock: socket.socket, value: int) -> None:
    sock.sendall(struct.pack("@i", value))


def client_handshake(sock: socket.socket) -> None:
    _write_int(sock, DATA_MAGIC)
    got = _read_int(sock)
    if got != DATA_MAGIC:
        raise ConnectionError(f"data channel handshake failed (got {got:#x})")


def server_handshake(sock: socket.socket) -> None:
    got = _read_int(sock)
    if got != DATA_MAGIC:
        raise ConnectionError(f"bad data channel magic {got:#x}")
    _write_int(sock, DATA_MAGIC)


def send_req(sock: socket.socket, req: dict) -> None:
    data = json.dumps(req).encode()
    sock.sendall(struct.pack("@i", len(data)) + data)


def read_req(sock: socket.socket) -> dict:
    return json.loads(_read_exact(sock, _read_int(sock)).decode())


def write_frame(sock: socket.socket, kind: int, *payloads) -> None:
    """One payload frame: kind, total length, then the pieces back to back
    (the staged header and the borrowed arena go out unjoined)."""
    total = sum(len(p) for p in payloads)
    sock.sendall(struct.pack("@i", kind) + _I64.pack(total))
    for p in payloads:
        sock.sendall(p)


def write_json_frame(sock: socket.socket, kind: int, obj: dict) -> None:
    write_frame(sock, kind, json.dumps(obj).encode())


def read_frame(sock: socket.socket) -> tuple:
    """Read one frame -> ``(kind, payload)``.  END/ERROR payloads come back
    as parsed JSON; bulk frames as a writable bytearray (the arrays
    ``unwrap_staged_wire`` makes alias it)."""
    kind = _read_int(sock)
    n = _I64.unpack(_read_exact(sock, _I64.size))[0]
    if n < 0 or n > (1 << 40):
        raise ConnectionError(f"insane frame length {n}")
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("data channel closed mid-frame")
        got += r
    if kind in (FRAME_END, FRAME_ERROR):
        return kind, json.loads(bytes(buf).decode())
    return kind, buf


def pack_staged_wire(c: StagedBatchOwnedC) -> tuple:
    """(header bytes, arena memoryview) of one owned batch: the view
    borrows the native arena, so nothing is copied until the send."""
    hdr = (ctypes.c_char * WIRE_HEADER_BYTES)()
    out_len = ctypes.c_uint64()
    check(lib().DmlcTpuStagedBatchWireHeader(
        ctypes.byref(c), hdr, WIRE_HEADER_BYTES, ctypes.byref(out_len)))
    arena = (ctypes.c_uint8 * int(c.arena_bytes)).from_address(c.arena)
    return bytes(hdr[:out_len.value]), memoryview(arena)


def unwrap_staged_wire(buf: bytearray) -> dict:
    """One received STAGED frame as host arrays, views over ``buf`` with
    no copy (the native codec checks the magic, the version and every
    column's bounds).  The keys are a staged host batch's (label, weight
    and value f32; row_ptr, index, field and qid int32)."""
    if len(buf) < WIRE_HEADER_BYTES:
        raise ConnectionError("staged frame shorter than its header")
    c = StagedBatchOwnedC()
    raw = (ctypes.c_char * len(buf)).from_buffer(buf)
    check(lib().DmlcTpuStagedBatchFromWire(
        raw, WIRE_HEADER_BYTES, ctypes.byref(raw, WIRE_HEADER_BYTES),
        len(buf) - WIRE_HEADER_BYTES, ctypes.byref(c)))
    B, nnz = int(c.batch_size), int(c.nnz_pad)

    def arr(off, count, dtype):
        return np.frombuffer(buf, dtype, count,
                             offset=WIRE_HEADER_BYTES + int(off))

    return {
        "label": arr(c.label_off, B, np.float32),
        "weight": arr(c.weight_off, B, np.float32),
        "row_ptr": arr(c.row_ptr_off, B + 1, np.int32),
        "index": arr(c.index_off, nnz, np.int32),
        "value": arr(c.value_off, nnz, np.float32),
        "field": (arr(c.field_off, nnz, np.int32)
                  if c.field_off != NO_FIELD else None),
        "qid": (arr(c.qid_off, B, np.int32)
                if c.qid_off != NO_FIELD else None),
        "num_rows": int(c.num_rows),
        "max_index": int(c.max_index),
        "lineage": int(c.lineage),
    }
