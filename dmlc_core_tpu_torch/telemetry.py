"""Counters, gauges and trace spans in the native process-wide registry.

The subset of ``dmlc_core_tpu.telemetry`` the serving and staging paths
use: counters, gauges, spans, trace context, batch lineage, the stall
watchdog and the time-series sampler.  Both packages write the same
registry in ``libdmlctpu.so`` under the same metric names (``serve.*``,
``h2d.*``, ``pack.*``) and read the same environment knobs, so
``/metrics`` and a flight record read the same either way.
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


def lineage(batch) -> int:
    """Lineage id of a staged batch: ``(global virtual part << 32) | chunk
    index``, minted by the sharded parser at the split chunk and carried
    through the staged batcher into H2D staging.  ``-1`` when the batch
    came off a single-stream source.  Accepts a ``PaddedBatch`` (plain
    ``_lineage`` attribute) or the raw staged dict (``"lineage"`` key)."""
    if isinstance(batch, dict):
        return int(batch.get("lineage", -1))
    return int(getattr(batch, "_lineage", -1))


# ---- stall watchdog ---------------------------------------------------------

_watchdog_lock = threading.Lock()
_watchdog_depth = 0


@contextlib.contextmanager
def watchdog(deadline_s: float = 30.0, poll_s: Optional[float] = None,
             policy: str = "warn", dump_path: Optional[str] = None,
             ) -> Iterator[None]:
    """Arm the native stall watchdog for the duration of the body.

    When no pipeline progress counter (split/parse/shard/pack/record/h2d)
    moves for ``deadline_s``, the watchdog dumps a flight record to
    ``dump_path`` (when given) and the log sink, then keeps running
    (``policy="warn"``) or aborts the process (``policy="abort"``).
    Nesting refcounts: the outermost ``watchdog()`` arms (its options win)
    and the last exit disarms, so a staging iterator can arm it per epoch
    while a caller holds a longer-lived one."""
    if policy not in ("warn", "abort"):
        raise ValueError(f"watchdog policy must be 'warn' or 'abort', "
                         f"got {policy!r}")
    global _watchdog_depth
    with _watchdog_lock:
        _watchdog_depth += 1
        if _watchdog_depth == 1:
            _native.check(_native.lib().DmlcTpuWatchdogStart(
                max(int(deadline_s * 1000), 1),
                0 if poll_s is None else max(int(poll_s * 1000), 1),
                1 if policy == "abort" else 0,
                (dump_path or "").encode()))
    try:
        yield
    finally:
        with _watchdog_lock:
            _watchdog_depth -= 1
            if _watchdog_depth == 0:
                _native.check(_native.lib().DmlcTpuWatchdogStop())


def watchdog_from_env() -> contextlib.AbstractContextManager:
    """The watchdog configured from the environment, or a no-op context
    when ``DMLCTPU_WATCHDOG_DEADLINE_S`` is unset.  Knobs:
    ``DMLCTPU_WATCHDOG_DEADLINE_S`` (seconds, required),
    ``DMLCTPU_WATCHDOG_POLICY`` (``warn`` or ``abort``) and
    ``DMLCTPU_WATCHDOG_DUMP`` (flight-record file path)."""
    deadline = os.environ.get("DMLCTPU_WATCHDOG_DEADLINE_S")
    if not deadline:
        return contextlib.nullcontext()
    return watchdog(
        deadline_s=float(deadline),
        policy=os.environ.get("DMLCTPU_WATCHDOG_POLICY", "warn"),
        dump_path=os.environ.get("DMLCTPU_WATCHDOG_DUMP") or None)


def watchdog_running() -> bool:
    out = ctypes.c_int()
    _native.check(_native.lib().DmlcTpuWatchdogRunning(ctypes.byref(out)))
    return bool(out.value)


def watchdog_stall_count() -> int:
    """Stalls detected since process start (across arm/disarm cycles)."""
    out = ctypes.c_int64()
    _native.check(
        _native.lib().DmlcTpuWatchdogStallCount(ctypes.byref(out)))
    return int(out.value)


# ---- time-series sampler ----------------------------------------------------

_timeseries_lock = threading.Lock()
_timeseries_depth = 0


def timeseries_start(tick_ms: int = 0, fine_slots: int = 0,
                     coarse_every: int = 0, coarse_slots: int = 0) -> None:
    """Start (or restart with new options) the native background sampler:
    every ``tick_ms`` it snapshots each counter and gauge into bounded
    fine and coarse rings.  Args <= 0 fall back to ``DMLCTPU_TS_TICK_MS``
    (1000), ``DMLCTPU_TS_FINE_SLOTS`` (600), 30 and
    ``DMLCTPU_TS_COARSE_SLOTS`` (960)."""
    _native.check(_native.lib().DmlcTpuTimeseriesStart(
        int(tick_ms), int(fine_slots), int(coarse_every), int(coarse_slots)))


def timeseries_stop() -> None:
    """Stop the sampler thread; its rings are kept."""
    _native.check(_native.lib().DmlcTpuTimeseriesStop())


def timeseries_active() -> bool:
    out = ctypes.c_int()
    _native.check(_native.lib().DmlcTpuTimeseriesActive(ctypes.byref(out)))
    return bool(out.value)


@contextlib.contextmanager
def timeseries_from_env() -> Iterator[None]:
    """Run the sampler for the duration of the body when
    ``DMLCTPU_TIMESERIES`` is set to anything but ``0``, else a no-op.
    Nesting refcounts like :func:`watchdog`.  (The JAX package also
    publishes device-memory gauges here; that sampler is not ported.)"""
    armed = os.environ.get("DMLCTPU_TIMESERIES", "")
    if not armed or armed == "0":
        yield
        return
    global _timeseries_depth
    with _timeseries_lock:
        _timeseries_depth += 1
        if _timeseries_depth == 1:
            timeseries_start()
    try:
        yield
    finally:
        with _timeseries_lock:
            _timeseries_depth -= 1
            if _timeseries_depth == 0:
                timeseries_stop()
