"""ctypes binding to the shared native runtime (``build/libdmlctpu.so``).

The C++ runtime under ``cpp/`` depends on no framework; both Python
packages bind the same library through its C API
(``cpp/include/dmlctpu/c_api.h``).  This loader declares only the
functions the port calls: the runtime's version, its parse-thread default
and its log entry point, telemetry (the registry, the trace buffer,
flight records, the log sink), the stall watchdog and time-series
sampler, fault injection, the row parser (``data.rowblock``), the staged
and record batchers (``data.staging``) with the staged batch's wire codec
(``dataservice.protocol``), the input split, RecordIO, streams and file
system calls (``io``), and the binned epoch cache with its block codec and
arena pool (``data.binned_cache``).

Resolution order for the library path:
  1. ``$DMLCTPU_LIBRARY_PATH``
  2. ``<repo>/build/libdmlctpu.so``
If absent, it is built on first use with cmake+ninja, or with one direct
``g++`` invocation where those are missing, in either case by the C++
compiler on ``PATH``, whatever ``$CXX`` names: the library is loaded into
this interpreter, whose C++ runtime is the system's, and a library built
by another toolchain (a ``$CXX`` with its own runtime) crashes the process
on its first native exception instead of raising ``NativeError``.
Nothing is loaded or built at import time: the first :func:`lib` call
does it.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
BUILD_DIR = REPO_ROOT / "build"
_SO = BUILD_DIR / "libdmlctpu.so"

_LIB = None
_LIB_LOCK = threading.Lock()


class NativeError(RuntimeError):
    """Error raised by the native dmlctpu runtime."""


class RowBlockC(ctypes.Structure):
    """Mirror of DmlcTpuRowBlockC (cpp/include/dmlctpu/c_api.h)."""

    _fields_ = [
        ("size", ctypes.c_uint64),
        ("offset", ctypes.POINTER(ctypes.c_uint64)),
        ("label", ctypes.POINTER(ctypes.c_float)),
        ("weight", ctypes.POINTER(ctypes.c_float)),
        ("qid", ctypes.POINTER(ctypes.c_uint64)),
        ("field", ctypes.POINTER(ctypes.c_uint64)),
        ("index", ctypes.POINTER(ctypes.c_uint64)),
        ("value", ctypes.POINTER(ctypes.c_float)),
    ]


class StagedBatchOwnedC(ctypes.Structure):
    """Mirror of DmlcTpuStagedBatchOwnedC: one packed batch in one owned
    arena, each leaf at a 64-byte-aligned offset."""

    _fields_ = [
        ("num_rows", ctypes.c_uint32),
        ("batch_size", ctypes.c_uint64),
        ("nnz_pad", ctypes.c_uint64),
        ("max_index", ctypes.c_int64),
        ("batch", ctypes.c_void_p),
        ("arena", ctypes.c_void_p),
        ("arena_bytes", ctypes.c_uint64),
        ("label_off", ctypes.c_uint64),
        ("weight_off", ctypes.c_uint64),
        ("row_ptr_off", ctypes.c_uint64),
        ("index_off", ctypes.c_uint64),
        ("value_off", ctypes.c_uint64),
        ("field_off", ctypes.c_uint64),
        ("qid_off", ctypes.c_uint64),
        ("lineage", ctypes.c_int64),
    ]


class RecordBatchC(ctypes.Structure):
    """Mirror of DmlcTpuRecordBatchC: a borrowed view of one packed record
    batch, valid until the next ``DmlcTpuRecordBatcherNext``."""

    _fields_ = [
        ("num_records", ctypes.c_uint32),
        ("records_cap", ctypes.c_uint64),
        ("bytes_cap", ctypes.c_uint64),
        ("bytes_used", ctypes.c_uint64),
        ("bytes", ctypes.POINTER(ctypes.c_char)),
        ("offsets", ctypes.POINTER(ctypes.c_int32)),
    ]


#: the native log sink's signature: (severity, where, message)
LOG_CALLBACK_TYPE = ctypes.CFUNCTYPE(
    None, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p)

NO_FIELD = (1 << 64) - 1  # field_off / qid_off when the batch lacks the lane


def _lock_handle():
    """Open the cross-process build lock (the same file the JAX package
    uses, so the two never configure or relink one tree at once).
    A build takes LOCK_EX, a load LOCK_SH."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return open(BUILD_DIR / ".dmlctpu_build_lock", "w")


def _run(cmd) -> None:
    proc = subprocess.run(cmd, cwd=REPO_ROOT, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed ({' '.join(cmd[:2])}, "
                           f"rc={proc.returncode}):\n{proc.stderr[-2000:]}")


def _cxx() -> str:
    """The C++ compiler on ``PATH`` (see the module docstring)."""
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        raise RuntimeError("native build failed: no C++ compiler "
                           "(g++/c++/clang++) on PATH")
    return cxx


def _build_direct() -> None:
    """cmake-less build: one compiler invocation over every .cc."""
    cxx = _cxx()
    sources = sorted(
        str(p) for sub in ("cpp/src", "cpp/src/io", "cpp/src/data")
        for p in (REPO_ROOT / sub).glob("*.cc"))
    _run([cxx, "-O3", "-g", "-std=c++20", "-fPIC", "-shared", "-pthread",
          "-fvisibility-inlines-hidden", "-I", str(REPO_ROOT / "cpp/include"),
          *sources, "-o", str(_SO)])


def build() -> Path:
    """Build ``build/libdmlctpu.so`` unless it exists; returns its path."""
    with _lock_handle() as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _SO.exists():  # another process built it while we waited
            return _SO
        if shutil.which("cmake") is None or shutil.which("ninja") is None:
            _build_direct()
        else:
            _run(["cmake", "-B", str(BUILD_DIR), "-G", "Ninja",
                  "-DCMAKE_BUILD_TYPE=Release",
                  f"-DCMAKE_CXX_COMPILER={_cxx()}"])
            _run(["ninja", "-C", str(BUILD_DIR), "dmlctpu"])
    return _SO


def _load() -> ctypes.CDLL:
    env = os.environ.get("DMLCTPU_LIBRARY_PATH")
    if env:
        return ctypes.CDLL(env)
    # shared lock around exists+dlopen: a concurrent relink is not atomic
    with _lock_handle() as lock:
        fcntl.flock(lock, fcntl.LOCK_SH)
        if _SO.exists():
            return ctypes.CDLL(str(_SO))
    build()
    with _lock_handle() as lock:
        fcntl.flock(lock, fcntl.LOCK_SH)
        return ctypes.CDLL(str(_SO))


def _declare(L: ctypes.CDLL) -> None:
    c_char_pp = ctypes.POINTER(ctypes.c_char_p)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    intp = ctypes.POINTER(ctypes.c_int)
    vpp = ctypes.POINTER(ctypes.c_void_p)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    handle, u64, cstr = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p
    sigs = {
        "DmlcTpuGetLastError": ([], ctypes.c_char_p),
        "DmlcTpuVersion": ([], ctypes.c_char_p),
        "DmlcTpuSetDefaultParseThreads": ([ctypes.c_int], ctypes.c_int),
        "DmlcTpuGetDefaultParseThreads": ([intp], ctypes.c_int),
        "DmlcTpuLogEmit": ([ctypes.c_int, cstr], ctypes.c_int),
        "DmlcTpuTelemetrySnapshotJson": ([c_char_pp], ctypes.c_int),
        "DmlcTpuTelemetryCounterAdd": ([ctypes.c_char_p, ctypes.c_int64],
                                       ctypes.c_int),
        "DmlcTpuTelemetryCounterGet": ([ctypes.c_char_p, i64p], ctypes.c_int),
        "DmlcTpuTelemetryGaugeSet": ([ctypes.c_char_p, ctypes.c_int64],
                                     ctypes.c_int),
        "DmlcTpuTelemetryRecordSpan": ([ctypes.c_char_p, ctypes.c_int64,
                                        ctypes.c_int64], ctypes.c_int),
        "DmlcTpuTelemetrySetTraceContext": ([ctypes.c_uint64, ctypes.c_uint64,
                                             ctypes.c_int64], ctypes.c_int),
        "DmlcTpuTelemetryGetTraceContext": ([u64p, u64p, i64p], ctypes.c_int),
        "DmlcTpuFaultArm": ([ctypes.c_char_p], ctypes.c_int),
        "DmlcTpuFaultDisarm": ([], ctypes.c_int),
        "DmlcTpuFaultFire": ([ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)],
                             ctypes.c_int),
        "DmlcTpuWatchdogStart": ([ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int, cstr], ctypes.c_int),
        "DmlcTpuWatchdogStop": ([], ctypes.c_int),
        "DmlcTpuWatchdogRunning": ([intp], ctypes.c_int),
        "DmlcTpuWatchdogStallCount": ([i64p], ctypes.c_int),
        "DmlcTpuTimeseriesStart": ([ctypes.c_int64] * 4, ctypes.c_int),
        "DmlcTpuTimeseriesStop": ([], ctypes.c_int),
        "DmlcTpuTimeseriesActive": ([intp], ctypes.c_int),
        # the rest of the telemetry surface (telemetry, faultinject)
        "DmlcTpuTelemetryEnabled": ([intp], ctypes.c_int),
        "DmlcTpuTelemetryReset": ([], ctypes.c_int),
        "DmlcTpuTelemetryGaugeAdd": ([ctypes.c_char_p, ctypes.c_int64],
                                     ctypes.c_int),
        "DmlcTpuTelemetryGaugeGet": ([ctypes.c_char_p, i64p], ctypes.c_int),
        "DmlcTpuTelemetryTraceStart": ([], ctypes.c_int),
        "DmlcTpuTelemetryTraceStop": ([], ctypes.c_int),
        "DmlcTpuTelemetryTraceDumpJson": ([c_char_pp], ctypes.c_int),
        "DmlcTpuJsonValidate": ([cstr, intp], ctypes.c_int),
        "DmlcTpuFlightRecordJson": ([cstr, c_char_pp], ctypes.c_int),
        "DmlcTpuWatchdogLastRecordJson": ([c_char_pp], ctypes.c_int),
        "DmlcTpuTimeseriesSample": ([], ctypes.c_int),
        "DmlcTpuTimeseriesJson": ([c_char_pp], ctypes.c_int),
        "DmlcTpuTimeseriesTailJson": ([ctypes.c_int, c_char_pp],
                                      ctypes.c_int),
        "DmlcTpuLogSetCallback": ([LOG_CALLBACK_TYPE], ctypes.c_int),
        "DmlcTpuFaultCompiledIn": ([intp], ctypes.c_int),
        "DmlcTpuFaultSnapshotJson": ([c_char_pp], ctypes.c_int),
        "DmlcTpuFaultInjectedTotal": ([i64p], ctypes.c_int),
        # the row parser (data.rowblock.Parser)
        "DmlcTpuParserCreateEx": ([cstr, ctypes.c_uint, ctypes.c_uint, cstr,
                                   ctypes.c_int, ctypes.c_int, u64, vpp],
                                  ctypes.c_int),
        "DmlcTpuParserNext": ([handle, ctypes.POINTER(RowBlockC)],
                              ctypes.c_int),
        "DmlcTpuParserBeforeFirst": ([handle], ctypes.c_int),
        "DmlcTpuParserBytesRead": ([handle], ctypes.c_int64),
        "DmlcTpuParserFree": ([handle], None),
        # the staged batcher (data.staging.DeviceStagingIter)
        "DmlcTpuStagedBatcherCreateEx": ([cstr, ctypes.c_uint, ctypes.c_uint,
                                          cstr, u64, u64, u64, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, u64, vpp],
                                         ctypes.c_int),
        "DmlcTpuStagedBatcherNextOwned": (
            [handle, ctypes.POINTER(StagedBatchOwnedC)], ctypes.c_int),
        "DmlcTpuStagedBatcherBeforeFirst": ([handle], ctypes.c_int),
        "DmlcTpuStagedBatcherBytesRead": ([handle], ctypes.c_int64),
        "DmlcTpuStagedBatcherSetPoolKnobs": ([handle, ctypes.c_int, u64, u64,
                                              intp], ctypes.c_int),
        "DmlcTpuStagedBatcherFree": ([handle], None),
        "DmlcTpuStagedBatchFree": ([handle], None),
        # the staged batch's wire codec (dataservice.protocol)
        "DmlcTpuStagedBatchWireHeader": (
            [ctypes.POINTER(StagedBatchOwnedC), handle, u64, u64p],
            ctypes.c_int),
        "DmlcTpuStagedBatchFromWire": (
            [handle, u64, handle, u64, ctypes.POINTER(StagedBatchOwnedC)],
            ctypes.c_int),
        # the record batcher (data.staging.RecordStagingIter)
        "DmlcTpuRecordBatcherCreateEx": ([cstr, ctypes.c_uint, ctypes.c_uint,
                                          u64, u64, ctypes.c_int, vpp],
                                         ctypes.c_int),
        "DmlcTpuRecordBatcherNext": ([handle, ctypes.POINTER(RecordBatchC)],
                                     ctypes.c_int),
        "DmlcTpuRecordBatcherBeforeFirst": ([handle], ctypes.c_int),
        "DmlcTpuRecordBatcherBytesRead": ([handle], ctypes.c_int64),
        "DmlcTpuRecordBatcherFree": ([handle], None),
        # the input split, RecordIO, streams and file systems (io)
        "DmlcTpuInputSplitCreate": ([cstr, cstr, ctypes.c_uint, ctypes.c_uint,
                                     cstr, ctypes.c_int, ctypes.c_int, u64,
                                     vpp], ctypes.c_int),
        "DmlcTpuInputSplitNextRecord": ([handle, vpp, u64p], ctypes.c_int),
        "DmlcTpuInputSplitNextChunk": ([handle, vpp, u64p], ctypes.c_int),
        "DmlcTpuInputSplitBeforeFirst": ([handle], ctypes.c_int),
        "DmlcTpuInputSplitResetPartition": ([handle, ctypes.c_uint,
                                             ctypes.c_uint], ctypes.c_int),
        "DmlcTpuInputSplitTotalSize": ([handle], ctypes.c_int64),
        "DmlcTpuInputSplitFree": ([handle], None),
        "DmlcTpuRecordIOWriterCreate": ([cstr, vpp], ctypes.c_int),
        "DmlcTpuRecordIOWriterWrite": ([handle, cstr, u64], ctypes.c_int),
        "DmlcTpuRecordIOWriterClose": ([handle], ctypes.c_int),
        "DmlcTpuRecordIOWriterFree": ([handle], None),
        "DmlcTpuRecordIOReaderCreateEx": ([cstr, ctypes.c_int, vpp],
                                          ctypes.c_int),
        "DmlcTpuRecordIOReaderNext": ([handle, vpp, u64p], ctypes.c_int),
        "DmlcTpuRecordIOReaderCorruptSkipped": ([handle], ctypes.c_int64),
        "DmlcTpuRecordIOReaderFree": ([handle], None),
        "DmlcTpuStreamCreate": ([cstr, cstr, vpp], ctypes.c_int),
        "DmlcTpuSeekStreamCreate": ([cstr, vpp], ctypes.c_int),
        "DmlcTpuStreamRead": ([handle, handle, u64], ctypes.c_int64),
        "DmlcTpuStreamWrite": ([handle, cstr, u64], ctypes.c_int),
        "DmlcTpuStreamSeek": ([handle, u64], ctypes.c_int),
        "DmlcTpuStreamTell": ([handle], ctypes.c_int64),
        "DmlcTpuStreamClose": ([handle], ctypes.c_int),
        "DmlcTpuStreamFree": ([handle], None),
        "DmlcTpuFsListDirectory": ([cstr, ctypes.c_int, c_char_pp],
                                   ctypes.c_int),
        "DmlcTpuFsPathInfo": ([cstr, c_char_pp], ctypes.c_int),
        # the binned epoch cache (data.binned_cache)
        "DmlcTpuBinnedCacheWriterCreate": ([cstr, cstr, vpp], ctypes.c_int),
        "DmlcTpuBinnedCacheWriterSetCuts": ([handle, f32p, u64, u64],
                                            ctypes.c_int),
        "DmlcTpuBinnedCacheWriterSetCodec": ([handle, ctypes.c_int],
                                             ctypes.c_int),
        "DmlcTpuBinnedCacheWriterWriteRaw": (
            [handle, ctypes.c_uint32, ctypes.c_uint32, u64, u64, f32p, f32p,
             i32p, i32p, f32p, i32p], ctypes.c_int),
        "DmlcTpuBinnedCacheWriterClose": ([handle], ctypes.c_int),
        "DmlcTpuBinnedCacheWriterFree": ([handle], None),
        "DmlcTpuBinnedCacheReaderCreate": ([cstr, ctypes.c_int, vpp],
                                           ctypes.c_int),
        "DmlcTpuBinnedCacheReaderValid": ([handle, intp], ctypes.c_int),
        "DmlcTpuBinnedCacheReaderMissing": ([handle, intp], ctypes.c_int),
        "DmlcTpuBinnedCacheReaderError": ([handle, c_char_pp], ctypes.c_int),
        "DmlcTpuBinnedCacheReaderMetaJson": ([handle, c_char_pp],
                                             ctypes.c_int),
        "DmlcTpuBinnedCacheReaderPartMapJson": ([handle, c_char_pp],
                                                ctypes.c_int),
        "DmlcTpuBinnedCacheReaderNextBlockView": ([handle, vpp, u64p, intp],
                                                  ctypes.c_int),
        "DmlcTpuBinnedCacheReaderTakeArena": ([handle, vpp], ctypes.c_int),
        "DmlcTpuBinnedCacheReaderNextBlock": ([handle, vpp, u64p],
                                              ctypes.c_int),
        "DmlcTpuBinnedCacheReaderSeekTo": ([handle, u64], ctypes.c_int),
        "DmlcTpuBinnedCacheReaderSetDecode": ([handle, ctypes.c_int],
                                              ctypes.c_int),
        "DmlcTpuBinnedCacheReaderBackend": ([handle, intp], ctypes.c_int),
        "DmlcTpuBinnedCacheReaderBeforeFirst": ([handle], ctypes.c_int),
        "DmlcTpuBinnedCacheReaderCorruptSkipped": ([handle], ctypes.c_int64),
        "DmlcTpuBinnedCacheReaderFree": ([handle], None),
        "DmlcTpuBinnedBlockDecode": ([handle, u64, vpp, u64p], ctypes.c_int),
        "DmlcTpuBlockCodecEnabled": ([], ctypes.c_int),
        "DmlcTpuBlockCodecFromName": ([cstr], ctypes.c_int),
        "DmlcTpuCacheArenaAcquire": ([u64, vpp], ctypes.c_int),
        "DmlcTpuCacheArenaRelease": ([handle], ctypes.c_int),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(L, name)
        fn.argtypes = argtypes
        fn.restype = restype


def lib() -> ctypes.CDLL:
    """The loaded runtime, built and bound on first call."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            L = _load()
            _declare(L)
            _LIB = L
        return _LIB


def check(status: int) -> int:
    """Raise NativeError on -1; pass through 0/1 returns."""
    if status == -1:
        msg = lib().DmlcTpuGetLastError()
        raise NativeError((msg or b"").decode(errors="replace"))
    return status


def version() -> str:
    """The native runtime's version string."""
    return lib().DmlcTpuVersion().decode()


def set_default_parse_threads(nthread: int) -> None:
    """Pin the parse-thread pool size of parsers created without an
    explicit ``?nthread=`` URI argument; 0 restores the per-parser
    heuristic."""
    check(lib().DmlcTpuSetDefaultParseThreads(int(nthread)))


def get_default_parse_threads() -> int:
    out = ctypes.c_int()
    check(lib().DmlcTpuGetDefaultParseThreads(ctypes.byref(out)))
    return out.value


def log_emit(severity: int, message: str) -> None:
    """Send one message through the native logging pipeline (0=DEBUG
    1=INFO 2=WARNING 3=ERROR; honours ``DMLCTPU_LOG_LEVEL``)."""
    check(lib().DmlcTpuLogEmit(int(severity), str(message).encode()))


# Keeps the installed ctypes callback alive: native threads call it long
# after set_log_callback returns, and collecting the CFUNCTYPE wrapper
# while the native side holds its address is a use-after-free.
_log_callback_keepalive = None


def set_log_callback(fn) -> None:
    """Install ``fn(severity, where, message)`` as the process-wide native
    log sink (replacing the stderr sink), or restore stderr with ``None``.
    Called from native threads; a sink that raises is ignored."""
    global _log_callback_keepalive
    if fn is None:
        check(lib().DmlcTpuLogSetCallback(
            ctypes.cast(None, LOG_CALLBACK_TYPE)))
        _log_callback_keepalive = None
        return

    def _trampoline(severity, where, message):
        try:
            fn(int(severity), (where or b"").decode(errors="replace"),
               (message or b"").decode(errors="replace"))
        except Exception:
            pass  # a raising sink must never take down a native worker

    cb = LOG_CALLBACK_TYPE(_trampoline)
    check(lib().DmlcTpuLogSetCallback(cb))
    _log_callback_keepalive = cb  # replace after install: the old may be live
