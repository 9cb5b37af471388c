"""ctypes binding to the shared native runtime (``build/libdmlctpu.so``).

The C++ runtime under ``cpp/`` depends on no framework; both Python
packages bind the same library through its C API
(``cpp/include/dmlctpu/c_api.h``).  This loader declares only the
functions the port calls: telemetry, the stall watchdog and time-series
sampler, fault injection, the row parser (``data.rowblock``) and the
staged batcher (``data.staging``).

Resolution order for the library path:
  1. ``$DMLCTPU_LIBRARY_PATH``
  2. ``<repo>/build/libdmlctpu.so``
If absent, it is built on first use with cmake+ninja, or with one direct
``g++`` invocation where those are missing.  Nothing is loaded or built at
import time: the first :func:`lib` call does it.
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


def _build_direct() -> None:
    """cmake-less build: one compiler invocation over every .cc."""
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        raise RuntimeError("native build failed: no cmake and no C++ "
                           "compiler (g++/c++/clang++) on PATH")
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
                  "-DCMAKE_BUILD_TYPE=Release"])
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
    handle, u64, cstr = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p
    sigs = {
        "DmlcTpuGetLastError": ([], ctypes.c_char_p),
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
