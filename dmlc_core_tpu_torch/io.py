"""Python wrappers over the native IO substrate: the port's own copy of
``dmlc_core_tpu.io``, which depends on no framework.

``InputSplit`` (sharded record iteration), ``RecordIOWriter`` and
``RecordIOReader`` (the splittable RecordIO container), ``Stream`` with
``open_stream`` / ``open_seek_stream`` (any registered backend URI), and
``listdir`` / ``path_info``.  Records cross the boundary as ``bytes``; the
same native library writes and reads them for both packages, so a file
written by either reads back in the other byte for byte.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, NamedTuple, Optional

from ._native import check, lib


class InputSplit:
    """Shard `part` of `num_parts` of a dataset URI, record-aligned.

    Parameters mirror ``dmlc::InputSplit::Create`` (dmlc-core
    include/dmlc/io.h:261-301): URI sugar supports ``;`` lists, trailing
    regex, directories, ``?k=v`` args and ``#cachefile``.
    """

    def __init__(self, uri: str, part: int = 0, num_parts: int = 1,
                 split_type: str = "text", index_uri: Optional[str] = None,
                 shuffle: bool = False, seed: int = 0, batch_size: int = 256):
        self._handle = ctypes.c_void_p()
        check(lib().DmlcTpuInputSplitCreate(
            uri.encode(), index_uri.encode() if index_uri else None,
            part, num_parts, split_type.encode(), int(shuffle), seed,
            batch_size,
            ctypes.byref(self._handle)))

    def __iter__(self) -> Iterator[bytes]:
        data = ctypes.c_void_p()
        size = ctypes.c_uint64()
        while check(lib().DmlcTpuInputSplitNextRecord(
                self._handle, ctypes.byref(data), ctypes.byref(size))) == 1:
            yield ctypes.string_at(data, size.value)

    def next_chunk(self) -> Optional[bytes]:
        """Next multi-record chunk, or None at end of partition."""
        data = ctypes.c_void_p()
        size = ctypes.c_uint64()
        if check(lib().DmlcTpuInputSplitNextChunk(
                self._handle, ctypes.byref(data), ctypes.byref(size))) == 0:
            return None
        return ctypes.string_at(data, size.value)

    def before_first(self) -> None:
        check(lib().DmlcTpuInputSplitBeforeFirst(self._handle))

    def reset_partition(self, part: int, num_parts: int) -> None:
        check(lib().DmlcTpuInputSplitResetPartition(self._handle, part,
                                                    num_parts))

    @property
    def total_size(self) -> int:
        return lib().DmlcTpuInputSplitTotalSize(self._handle)

    def close(self) -> None:
        if self._handle:
            lib().DmlcTpuInputSplitFree(self._handle)
            self._handle = ctypes.c_void_p()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass  # interpreter teardown: module globals may be gone


class RecordIOWriter:
    """Write records into the splittable RecordIO container format."""

    def __init__(self, uri: str):
        self._handle = ctypes.c_void_p()
        check(lib().DmlcTpuRecordIOWriterCreate(uri.encode(),
                                                ctypes.byref(self._handle)))

    def write(self, record: bytes) -> None:
        check(lib().DmlcTpuRecordIOWriterWrite(self._handle, record,
                                               len(record)))

    def close(self) -> None:
        """Finalize and free; raises if the final flush/upload failed."""
        if self._handle:
            handle, self._handle = self._handle, ctypes.c_void_p()
            try:
                check(lib().DmlcTpuRecordIOWriterClose(handle))
            finally:
                lib().DmlcTpuRecordIOWriterFree(handle)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass  # interpreter teardown: errors already logged natively

class RecordIOReader:
    """Stream logical records back out of a RecordIO container.

    ``recover=True`` turns corrupt spans (bad magic, truncated tails) into
    skips instead of hard errors: the reader resynchronizes to the next
    record boundary and counts what it dropped in :attr:`corrupt_skipped`
    (also the ``record.corrupt_skipped`` telemetry counter).  See
    ``doc/robustness.md``.
    """

    def __init__(self, uri: str, recover: bool = False):
        self._handle = ctypes.c_void_p()
        check(lib().DmlcTpuRecordIOReaderCreateEx(
            uri.encode(), 1 if recover else 0, ctypes.byref(self._handle)))

    @property
    def corrupt_skipped(self) -> int:
        """Corrupt record spans skipped so far (0 unless ``recover=True``)."""
        if not self._handle:
            return 0
        return int(lib().DmlcTpuRecordIOReaderCorruptSkipped(self._handle))

    def __iter__(self) -> Iterator[bytes]:
        data = ctypes.c_void_p()
        size = ctypes.c_uint64()
        while check(lib().DmlcTpuRecordIOReaderNext(
                self._handle, ctypes.byref(data), ctypes.byref(size))) == 1:
            yield ctypes.string_at(data, size.value)

    def close(self) -> None:
        if self._handle:
            lib().DmlcTpuRecordIOReaderFree(self._handle)
            self._handle = ctypes.c_void_p()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass  # interpreter teardown: module globals may be gone


class FileInfo(NamedTuple):
    """One filesystem entry (FileSystem::GetPathInfo / ListDirectory)."""
    path: str
    size: int
    is_dir: bool


class Stream:
    """Generic byte stream over any registered backend URI — the
    ``dmlc::Stream::Create`` surface (dmlc-core src/io.cc:132-144):
    file://, s3://, azure://, hdfs://, http(s)://, or a bare path.

    mode: "r" (read), "w" (write), "a" (append where the backend allows).
    File-like: read/write/close, iteration-free by design (wrap in
    RecordIOReader or text-decode on the caller side as needed).
    """

    def __init__(self, uri: str, mode: str = "r", _seekable: bool = False):
        self._handle = ctypes.c_void_p()
        self._seekable = _seekable
        enc = uri.encode("utf-8", "surrogateescape")  # os.fsdecode'd names
        if _seekable:
            check(lib().DmlcTpuSeekStreamCreate(enc,
                                                ctypes.byref(self._handle)))
        else:
            check(lib().DmlcTpuStreamCreate(enc, mode.encode(),
                                            ctypes.byref(self._handle)))

    def _require_open(self) -> ctypes.c_void_p:
        # a NULL handle would segfault in the C shim, not raise
        if not self._handle:
            raise ValueError("I/O operation on closed stream")
        return self._handle

    def seek(self, pos: int) -> None:
        """Reposition the read cursor (seekable read streams only)."""
        check(lib().DmlcTpuStreamSeek(self._require_open(), pos))

    def tell(self) -> int:
        pos = lib().DmlcTpuStreamTell(self._require_open())
        if pos < 0:
            check(-1)
        return pos

    def seekable(self) -> bool:
        return self._seekable

    def read(self, n: int = -1) -> bytes:
        """Read up to n bytes (all remaining when n < 0)."""
        if n < 0:
            chunks = []
            while True:
                chunk = self.read(1 << 20)
                if not chunk:
                    return b"".join(chunks)
                chunks.append(chunk)
        buf = ctypes.create_string_buffer(n)
        got = lib().DmlcTpuStreamRead(self._require_open(), buf, n)
        if got < 0:
            check(-1)
        return buf.raw[:got]

    def write(self, data: bytes) -> int:
        check(lib().DmlcTpuStreamWrite(self._require_open(), data,
                                       len(data)))
        return len(data)

    def close(self) -> None:
        """Flush and close; remote upload/flush errors raise HERE."""
        if self._handle:
            handle, self._handle = self._handle, ctypes.c_void_p()
            try:
                check(lib().DmlcTpuStreamClose(handle))
            finally:
                lib().DmlcTpuStreamFree(handle)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001  (interpreter teardown best-effort)
            pass


def open_stream(uri: str, mode: str = "r") -> Stream:
    """Open a byte stream on any backend (the Stream::Create factory)."""
    return Stream(uri, mode)


def open_seek_stream(uri: str) -> Stream:
    """Open a seekable read stream (SeekStream::CreateForRead): random
    access via ``seek``/``tell`` — range-GET on remote backends."""
    return Stream(uri, "r", _seekable=True)


def _unescape_path(path: str) -> str:
    # inverse of the C side's AppendFileInfo escaping (\\, \n, \t)
    if "\\" not in path:
        return path
    out, i = [], 0
    while i < len(path):
        c = path[i]
        if c == "\\" and i + 1 < len(path):
            nxt = path[i + 1]
            out.append({"n": "\n", "t": "\t", "\\": "\\"}.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_infos(raw: bytes) -> list:
    out = []
    # surrogateescape (os.fsdecode semantics): non-UTF-8 filenames round-trip
    # back through the surrogateescape encode in Stream/listdir/path_info
    for line in raw.decode("utf-8", "surrogateescape").split("\n"):
        if not line:
            continue
        kind, size, path = line.split("\t", 2)
        out.append(FileInfo(path=_unescape_path(path), size=int(size),
                            is_dir=kind == "d"))
    return out


def listdir(uri: str, recursive: bool = False) -> list:
    """List a directory on any backend
    (FileSystem::ListDirectory[Recursive])."""
    out = ctypes.c_char_p()
    check(lib().DmlcTpuFsListDirectory(
        uri.encode("utf-8", "surrogateescape"), int(recursive),
        ctypes.byref(out)))
    return _parse_infos(out.value or b"")


def path_info(uri: str) -> FileInfo:
    """Stat one path on any backend (FileSystem::GetPathInfo)."""
    out = ctypes.c_char_p()
    check(lib().DmlcTpuFsPathInfo(uri.encode("utf-8", "surrogateescape"),
                                  ctypes.byref(out)))
    infos = _parse_infos(out.value or b"")
    if not infos:
        raise FileNotFoundError(uri)
    return infos[0]
