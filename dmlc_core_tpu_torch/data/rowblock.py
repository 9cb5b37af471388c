"""RowBlock: numpy view of a parsed sparse batch, and the Parser iterator.

The port's own copy of ``dmlc_core_tpu.data.rowblock`` (framework-free:
numpy over the port's binding of the native parser).  Parity: reference
include/dmlc/data.h RowBlock (:74-236) / Parser (:307).
The native parser runs its own read-prefetch and parse-ahead threads
(ThreadedIter pipeline); each block that crosses into Python is copied into
numpy arrays because the native buffers are recycled on the next call.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from .._native import RowBlockC, check, lib


@dataclass
class RowBlock:
    """A CSR batch: offset[size+1], per-row label/weight/qid, per-nnz index/value."""

    offset: np.ndarray          # uint64 [size+1]
    label: np.ndarray           # float32 [size]
    index: np.ndarray           # uint64 [nnz]
    weight: Optional[np.ndarray] = None   # float32 [size]
    qid: Optional[np.ndarray] = None      # uint64 [size]
    field: Optional[np.ndarray] = None    # uint64 [nnz]
    value: Optional[np.ndarray] = None    # float32 [nnz] (None => implicit 1.0)

    @property
    def size(self) -> int:
        return len(self.label)

    @property
    def num_nonzero(self) -> int:
        return len(self.index)

    def row_ids(self) -> np.ndarray:
        """Per-nonzero row id (CSR → COO segment ids)."""
        counts = np.diff(self.offset).astype(np.int64)
        return np.repeat(np.arange(self.size, dtype=np.int64), counts)

    def values_or_ones(self) -> np.ndarray:
        if self.value is not None:
            return self.value
        return np.ones(self.num_nonzero, dtype=np.float32)

    @staticmethod
    def _from_c(c: RowBlockC) -> "RowBlock":
        n = c.size
        nnz = c.offset[n] if n else 0

        def arr(ptr, count, dtype):
            if not ptr or count == 0:
                return None
            return np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype, copy=True)

        return RowBlock(
            offset=np.ctypeslib.as_array(c.offset, shape=(n + 1,)).copy(),
            label=np.ctypeslib.as_array(c.label, shape=(n,)).copy() if n else
            np.zeros(0, np.float32),
            index=arr(c.index, nnz, np.uint64) if nnz else np.zeros(0, np.uint64),
            weight=arr(c.weight, n, np.float32),
            qid=arr(c.qid, n, np.uint64),
            field=arr(c.field, nnz, np.uint64),
            value=arr(c.value, nnz, np.float32),
        )


class Parser:
    """Stream RowBlocks from shard `part` of `num_parts` of a dataset URI.

    format: "libsvm" | "csv" | "libfm" | "auto" (reads '?format=' URI arg).
    num_workers > 1 fans the parse over a native sharded worker pool
    (cpp/src/data/sharded_parser.h); with reorder=True (default) the block
    stream is bit-identical to the single-worker stream, with reorder=False
    blocks arrive in completion order (faster first block, order not
    reproducible).  buffer_mb caps parsed-but-unconsumed bytes.
    """

    def __init__(self, uri: str, part: int = 0, num_parts: int = 1,
                 format: str = "auto",  # noqa: A002 - dmlc name
                 num_workers: int = 1, reorder: bool = True,
                 buffer_mb: int = 64):
        self._handle = ctypes.c_void_p()
        check(lib().DmlcTpuParserCreateEx(
            uri.encode(), part, num_parts, format.encode(),
            int(num_workers), int(reorder), int(buffer_mb) << 20,
            ctypes.byref(self._handle)))

    def __iter__(self) -> Iterator[RowBlock]:
        c = RowBlockC()
        while check(lib().DmlcTpuParserNext(self._handle, ctypes.byref(c))) == 1:
            yield RowBlock._from_c(c)

    def before_first(self) -> None:
        check(lib().DmlcTpuParserBeforeFirst(self._handle))

    @property
    def bytes_read(self) -> int:
        return lib().DmlcTpuParserBytesRead(self._handle)

    def close(self) -> None:
        if self._handle:
            lib().DmlcTpuParserFree(self._handle)
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
