"""The 0xff9a data-channel framing, as the snapshot channel uses it.

Native-endian int32 scalars, ``[len]+utf8`` JSON strings, a magic word
exchanged both ways before anything else, one request per connection; bulk
bytes travel as payload frames (a kind tag, an int64 length, the raw
payload).  Wire-compatible with ``dmlc_core_tpu.dataservice.protocol``, so
a pusher of either package talks to a server of either package.
"""
from __future__ import annotations

import json
import socket
import struct

DATA_MAGIC = 0xFF9A
FRAME_END = 0
FRAME_SNAPSHOT = 3
FRAME_ERROR = -1

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
    _write_int(sock, len(data))
    sock.sendall(data)


def read_req(sock: socket.socket) -> dict:
    return json.loads(_read_exact(sock, _read_int(sock)).decode())


def write_frame(sock: socket.socket, kind: int, *payloads) -> None:
    """One payload frame: kind, total length, then the pieces back-to-back."""
    total = sum(len(p) for p in payloads)
    _write_int(sock, kind)
    sock.sendall(_I64.pack(total))
    for p in payloads:
        sock.sendall(p)


def read_frame(sock: socket.socket) -> tuple:
    """Read one frame -> ``(kind, payload)``.  END/ERROR payloads come back
    as parsed JSON; bulk frames as a bytearray."""
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
