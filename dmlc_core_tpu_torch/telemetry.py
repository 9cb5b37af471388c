"""Counters, gauges and trace spans in the native process-wide registry.

The subset of ``dmlc_core_tpu.telemetry`` the serving path uses.  Both
packages write the same registry in ``libdmlctpu.so`` under the same
metric names (``serve.*``), so ``/metrics`` reads the same either way.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import threading
import time
from typing import Iterator, Optional, Tuple

from . import _native


def snapshot() -> dict:
    """Parsed JSON snapshot: ``{"enabled", "counters", "gauges",
    "histograms"}``."""
    out = ctypes.c_char_p()
    _native.check(
        _native.lib().DmlcTpuTelemetrySnapshotJson(ctypes.byref(out)))
    return json.loads((out.value or b"{}").decode())


def counter_add(name: str, delta: int) -> None:
    """Add ``delta`` (>=0) to the named counter, creating it on first use."""
    _native.check(
        _native.lib().DmlcTpuTelemetryCounterAdd(name.encode(), int(delta)))


def counter_get(name: str) -> int:
    out = ctypes.c_int64()
    _native.check(_native.lib().DmlcTpuTelemetryCounterGet(
        name.encode(), ctypes.byref(out)))
    return int(out.value)


def gauge_set(name: str, value: int) -> None:
    _native.check(
        _native.lib().DmlcTpuTelemetryGaugeSet(name.encode(), int(value)))


# ---- spans ------------------------------------------------------------------

def now_us() -> int:
    """Steady-clock microseconds, the epoch of the native span timeline."""
    return time.monotonic_ns() // 1000


def record_span(name: str, ts_us: int, dur_us: int) -> None:
    """Record one complete span into the active trace."""
    _native.check(_native.lib().DmlcTpuTelemetryRecordSpan(
        name.encode(), int(ts_us), int(dur_us)))


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """Context manager recording its body as a span when tracing is on."""
    t0 = now_us()
    try:
        yield
    finally:
        record_span(name, t0, now_us() - t0)


# ---- trace context ----------------------------------------------------------
#
# (trace_id, parent_span, lineage): the ambient context the native span
# recorder stamps onto every span.  trace_id 0 means "no context".  Wire
# form: {"id": "<16-hex>", "span": "<16-hex>", "lineage": int}.

_trace_id_lock = threading.Lock()
_trace_id_counter = 0


def new_trace_id() -> int:
    """A fresh nonzero 64-bit id: 32 bits of pid-seeded entropy over a
    32-bit process-local counter."""
    global _trace_id_counter
    with _trace_id_lock:
        _trace_id_counter += 1
        low = _trace_id_counter & 0xFFFFFFFF
    high = (os.getpid() ^ int.from_bytes(os.urandom(4), "little")) & 0xFFFFFFFF
    return ((high << 32) | low) or 1


def set_trace_context(trace_id: int, parent_span: int = 0,
                      lineage_id: int = -1) -> None:
    _native.check(_native.lib().DmlcTpuTelemetrySetTraceContext(
        int(trace_id) & 0xFFFFFFFFFFFFFFFF,
        int(parent_span) & 0xFFFFFFFFFFFFFFFF, int(lineage_id)))


def get_trace_context() -> Tuple[int, int, int]:
    """Current ambient ``(trace_id, parent_span, lineage)``."""
    tid = ctypes.c_uint64()
    parent = ctypes.c_uint64()
    lin = ctypes.c_int64()
    _native.check(_native.lib().DmlcTpuTelemetryGetTraceContext(
        ctypes.byref(tid), ctypes.byref(parent), ctypes.byref(lin)))
    return int(tid.value), int(parent.value), int(lin.value)


def clear_trace_context() -> None:
    set_trace_context(0, 0, -1)


def trace_context_wire() -> Optional[dict]:
    """The ambient context as its wire dict, or ``None`` when unset."""
    tid, parent, lin = get_trace_context()
    if not tid:
        return None
    return {"id": format(tid, "016x"), "span": format(parent, "016x"),
            "lineage": lin}


def adopt_trace_context(wire: Optional[dict]) -> bool:
    """Install a context received off the wire (malformed or absent input
    is ignored); bumps ``trace.ctx_propagated`` on success."""
    if not isinstance(wire, dict):
        return False
    try:
        tid = int(str(wire.get("id", "0")), 16)
        parent = int(str(wire.get("span", "0")), 16)
        lin = int(wire.get("lineage", -1))
    except (TypeError, ValueError):
        return False
    if not tid:
        return False
    set_trace_context(tid, parent, lin)
    counter_add("trace.ctx_propagated", 1)
    return True
