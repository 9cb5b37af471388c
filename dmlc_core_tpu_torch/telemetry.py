"""Counters, gauges, trace spans and stall attribution in the native
process-wide registry.

The port of ``dmlc_core_tpu.telemetry``.  Both packages write the same
registry in ``libdmlctpu.so`` under the same metric names (``serve.*``,
``h2d.*``, ``pack.*``, ``autotune.*``) and read the same environment
knobs, so ``/metrics``, a trace, a flight record and a tracker push read
the same either way.  The registry is process-wide: in a process that
loads both packages, a :func:`reset` from either zeroes both.

It reads snapshots, drives trace recording, arms the stall watchdog and
the time-series sampler, and turns two snapshots plus a wall-clock
interval into a stall-attribution table ("parse-bound 71%, h2d-bound
22%").  The device-memory gauges of :func:`resource_sample` come from
``torch.cuda``.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import sys
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from . import _native

__all__ = [
    "enabled", "snapshot", "reset", "counter_add", "counter_get",
    "gauge_set", "gauge_add", "gauge_get",
    "counters_delta", "snapshot_restarted", "merge_snapshots",
    "histogram_quantile", "trace_start", "trace_stop", "trace_dump_json",
    "trace_dump", "record_span", "span", "now_us", "trace_armed",
    "new_trace_id",
    "set_trace_context", "get_trace_context", "clear_trace_context",
    "trace_context_wire", "adopt_trace_context", "lineage", "json_validate",
    "stall_attribution",
    "format_stall_table", "window", "Window", "capture_logs",
    "watchdog", "watchdog_from_env", "watchdog_running",
    "watchdog_stall_count", "flight_record", "last_flight_record",
    "timeseries_start", "timeseries_stop", "timeseries_active",
    "timeseries_sample", "timeseries_json", "timeseries_tail_json",
    "timeseries", "timeseries_from_env", "resource_sample",
]


def enabled() -> bool:
    """True when the native library was built with telemetry compiled in."""
    out = ctypes.c_int()
    _native.check(_native.lib().DmlcTpuTelemetryEnabled(ctypes.byref(out)))
    return bool(out.value)


def snapshot() -> dict:
    """Parsed JSON snapshot: ``{"enabled", "counters", "gauges",
    "histograms"}`` (the latter three absent when telemetry is compiled
    out)."""
    out = ctypes.c_char_p()
    _native.check(
        _native.lib().DmlcTpuTelemetrySnapshotJson(ctypes.byref(out)))
    return json.loads((out.value or b"{}").decode())


def reset() -> None:
    """Zero every registered metric (they stay registered)."""
    _native.check(_native.lib().DmlcTpuTelemetryReset())


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


def gauge_add(name: str, delta: int) -> None:
    _native.check(
        _native.lib().DmlcTpuTelemetryGaugeAdd(name.encode(), int(delta)))


def gauge_get(name: str) -> int:
    out = ctypes.c_int64()
    _native.check(_native.lib().DmlcTpuTelemetryGaugeGet(
        name.encode(), ctypes.byref(out)))
    return int(out.value)


def counters_delta(before: dict, after: dict) -> Dict[str, int]:
    """Per-counter difference between two :func:`snapshot` results.  A
    counter that went backwards (a process restarted and re-registered
    from zero) is clamped to 0; :func:`snapshot_restarted` detects that
    case."""
    b = before.get("counters", {})
    return {k: max(v - b.get(k, 0), 0)
            for k, v in after.get("counters", {}).items()}


def snapshot_restarted(before: dict, after: dict) -> bool:
    """True when any counter moved backwards between the snapshots, the
    signature of a process restart."""
    b = before.get("counters", {})
    return any(v < b.get(k, 0)
               for k, v in after.get("counters", {}).items())


def merge_snapshots(snaps: List[dict]) -> dict:
    """Fold per-process :func:`snapshot` dicts into one job-wide view:
    counters, gauges and histogram buckets add.  Every bucket keeps its
    upper bound, so quantiles read off the merged buckets never understate
    the pooled events'."""
    merged: dict = {"enabled": any(s.get("enabled") for s in snaps),
                    "counters": {}, "gauges": {}, "histograms": {}}
    for s in snaps:
        for k, v in s.get("counters", {}).items():
            merged["counters"][k] = merged["counters"].get(k, 0) + v
        for k, v in s.get("gauges", {}).items():
            merged["gauges"][k] = merged["gauges"].get(k, 0) + v
        for k, h in s.get("histograms", {}).items():
            m = merged["histograms"].setdefault(
                k, {"count": 0, "sum": 0, "buckets": [0] * len(h["buckets"])})
            m["count"] += h["count"]
            m["sum"] += h["sum"]
            m["buckets"] = [a + b for a, b in zip(m["buckets"], h["buckets"])]
    return merged


def histogram_quantile(hist: dict, q: float) -> Optional[float]:
    """Upper bound of the ``q``-quantile of a snapshot histogram
    (``{"count", "sum", "buckets"}``): the bucket bound ``2**i`` where the
    cumulative count crosses ``q * count``; ``inf`` in the overflow
    bucket, ``None`` for an empty histogram."""
    count = hist.get("count", 0)
    if count <= 0:
        return None
    buckets = hist["buckets"]
    target = max(q * count, 1.0)  # >=1: even q=0 points at a real event
    cum = 0
    for i, n in enumerate(buckets):
        cum += n
        if cum >= target:
            return float("inf") if i == len(buckets) - 1 else float(2 ** i)
    return float("inf")


# ---- spans and the trace buffer ---------------------------------------------

# Test hook: DMLCTPU_CLOCK_SKEW_US shifts every Python-side steady-clock
# read (spans recorded through span()/now_us() and the clock probes a
# metrics pusher answers) by a fixed amount, faking a host whose clock runs
# ahead or behind.  Native spans are not shifted; a skewed child runs its
# whole traced pipeline, so the tracker's merge corrects its dump as one.
_CLOCK_SKEW_US = int(os.environ.get("DMLCTPU_CLOCK_SKEW_US", "0") or "0")


def now_us() -> int:
    """Steady-clock microseconds on the span timeline (the native
    ``NowUs()`` epoch), plus the ``DMLCTPU_CLOCK_SKEW_US`` test skew."""
    return time.monotonic_ns() // 1000 + _CLOCK_SKEW_US


# True once trace_start() ran in this process: the metrics pusher then
# ships the trace buffers with each push (it stays True after trace_stop()
# so the final push carries the finished trace)
_trace_armed = False


def trace_armed() -> bool:
    """True when this process recorded (or is recording) a trace worth
    shipping to the tracker's job-trace merge."""
    return _trace_armed


# True between trace_start() and trace_stop(): the Python mirror of the
# native trace flag, so that span() decides without a ctypes call
_tracing = False


def trace_start() -> None:
    """Start buffering spans (clears the spans of an earlier trace)."""
    global _trace_armed, _tracing
    _native.check(_native.lib().DmlcTpuTelemetryTraceStart())
    _trace_armed = _tracing = True


def trace_stop() -> None:
    global _tracing
    _tracing = False
    _native.check(_native.lib().DmlcTpuTelemetryTraceStop())


def trace_dump_json() -> str:
    """Chrome trace-event JSON (chrome://tracing or Perfetto)."""
    out = ctypes.c_char_p()
    _native.check(
        _native.lib().DmlcTpuTelemetryTraceDumpJson(ctypes.byref(out)))
    return (out.value or b"{}").decode()


def trace_dump() -> dict:
    return json.loads(trace_dump_json())


def record_span(name: str, ts_us: int, dur_us: int) -> None:
    """Record one complete span into the active trace."""
    _native.check(_native.lib().DmlcTpuTelemetryRecordSpan(
        name.encode(), int(ts_us), int(dur_us)))


class _NoSpan:
    """The context :func:`span` returns when no sink records."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class _Span:
    """A span open in the native ring (``ring``) and in the torch
    profiler's timeline (``profiled``: a ``record_function``)."""
    __slots__ = ("name", "ring", "rf", "t0")

    def __init__(self, name: str, ring: bool, profiled):
        self.name, self.ring, self.t0 = name, ring, 0
        self.rf = profiled.record_function(name) if profiled else None

    def __enter__(self) -> None:
        if self.rf is not None:
            self.rf.__enter__()
        if self.ring:
            self.t0 = now_us()

    def __exit__(self, *exc) -> bool:
        try:
            if self.ring:
                record_span(self.name, self.t0, now_us() - self.t0)
        finally:
            if self.rf is not None:
                self.rf.__exit__(*exc)
        return False


def _torch_profiler():
    """``torch.autograd.profiler`` while a torch profiler records, else
    None; torch is never imported for it (a process that has not loaded
    torch runs no profiler)."""
    mod = sys.modules.get("torch.autograd.profiler")
    return mod if mod is not None and mod._is_profiler_enabled else None


def span(name: str):
    """Context manager recording its body as a span named ``name``.

    Two sinks: the native trace ring while this package's
    :func:`trace_start` has armed it (a trace armed through the JAX
    package in the same process is not seen), and, while a
    ``torch.profiler`` records, the profiler's timeline as a
    ``record_function`` user annotation, on kineto's clock beside the
    device work the body launches.  With neither on it returns one shared
    no-op context: no clock read, no native call."""
    profiled = _torch_profiler()
    if not (_tracing or profiled):
        return _NO_SPAN
    return _Span(name, _tracing, profiled)


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


def json_validate(text: str) -> bool:
    """True when ``text`` is one complete JSON value to the native
    ``JSONReader``, the parser the C++ side loads snapshots with."""
    ok = ctypes.c_int()
    _native.check(_native.lib().DmlcTpuJsonValidate(
        text.encode(), ctypes.byref(ok)))
    return bool(ok.value)


# ---- stall attribution ------------------------------------------------------

# (stage, busy counter, wait counter): the native instrumentation's names
_STAGES: Tuple[Tuple[str, str, str], ...] = (
    ("parse", "parse.busy_us", "parse.input_wait_us"),
    ("shard", "shard.part_us", "shard.producer_wait_us"),
    ("pack", "pack.busy_us", "pack.input_wait_us"),
    ("h2d", "h2d.busy_us", "h2d.wait_us"),
)


def stall_attribution(before: dict, after: dict,
                      wall_s: Optional[float] = None) -> dict:
    """Per-stage busy and wait seconds and a bottleneck ranking from two
    snapshots: ``{"stages": {name: {"busy_s", "wait_s"}}, "bound",
    "bound_stage", "table", "wall_s", "restarted", "io"}``.

    ``bound`` is each candidate stage's share of the busy total; ``parse``
    is no candidate when the sharded pool ran (its workers' parse time is
    inside ``shard`` busy, which is part wall time minus producer stalls).
    ``restarted``: a counter moved backwards, so the clamped deltas
    under-count.  An ``io`` stage joins when retries slept in the interval,
    a ``cache`` stage when the binned epoch cache served, and a ``serve``
    stage when ``/score`` traffic ran."""
    d = counters_delta(before, after)
    us = lambda k: d.get(k, 0) / 1e6  # noqa: E731

    stages: Dict[str, Dict[str, float]] = {}
    for name, busy_key, wait_key in _STAGES:
        busy, wait = us(busy_key), us(wait_key)
        if name == "shard":
            busy = max(busy - wait, 0.0)
        stages[name] = {"busy_s": round(busy, 6), "wait_s": round(wait, 6)}

    io = {
        "retry": d.get("io.retry", 0),
        "giveup": d.get("io.giveup", 0),
        "retry_wait_s": round(us("io.retry_wait_us"), 6),
        "corrupt_skipped": d.get("record.corrupt_skipped", 0),
        "part_retries": d.get("shard.part_retries", 0),
    }
    if io["retry"] or io["giveup"] or io["retry_wait_s"]:
        stages["io"] = {"busy_s": io["retry_wait_s"], "wait_s": 0.0}

    # copy_ratio: bytes copied on the host per byte served (~0 when the
    # mmap reader lends views); codec_ratio and decode_s break down the
    # block decode, which runs inside the cache stage's busy time
    cache_busy, cache_wait = us("cache.busy_us"), us("cache.wait_us")
    cache_hit = d.get("cache.hit_bytes", 0)
    if cache_busy or cache_wait or cache_hit:
        cache_stage = {"busy_s": round(cache_busy, 6),
                       "wait_s": round(cache_wait, 6),
                       "copy_ratio": round(
                           d.get("cache.bytes_copied", 0) / cache_hit, 4)
                       if cache_hit else 0.0}
        codec_in = d.get("cache.codec.bytes_in", 0)
        if codec_in:
            cache_stage["codec_ratio"] = round(
                d.get("cache.codec.bytes_out", 0) / codec_in, 4)
            cache_stage["decode_s"] = round(us("cache.codec.decode_us"), 6)
        stages["cache"] = cache_stage

    serve_busy, serve_wait = us("serve.score_busy_us"), us("serve.queue_wait_us")
    if serve_busy or serve_wait or d.get("serve.rows", 0):
        stages["serve"] = {"busy_s": round(serve_busy, 6),
                           "wait_s": round(serve_wait, 6)}

    sharded = d.get("shard.parts", 0) > 0
    candidates = [n for n in stages if not (sharded and n == "parse")]
    total_busy = sum(stages[n]["busy_s"] for n in candidates)
    bound = {
        n: round(100.0 * stages[n]["busy_s"] / total_busy, 1)
        for n in candidates
    } if total_busy > 0 else {}
    bound_stage = max(bound, key=bound.get) if bound else None
    table = ", ".join(f"{n}-bound {bound[n]:.0f}%"
                      for n in sorted(bound, key=bound.get, reverse=True)
                      if bound[n] >= 0.5)
    return {
        "stages": stages,
        "bound": bound,
        "bound_stage": bound_stage,
        "table": table,
        "wall_s": None if wall_s is None else round(wall_s, 6),
        "restarted": snapshot_restarted(before, after),
        "io": io,
    }


class Window:
    """One measured telemetry interval (see :func:`window`).

    Inside the ``with`` body only ``before`` is set; on exit the window
    carries ``after``, ``wall_s``, the clamped counter ``delta``, the
    :func:`stall_attribution` result and ``restarted`` (a counter moved
    backwards: the deltas are a lower bound and drive no tuning)."""

    __slots__ = ("before", "after", "wall_s", "delta", "attribution",
                 "restarted", "_t0")

    def __init__(self) -> None:
        self._t0 = time.monotonic()
        self.before: dict = {}
        self.after: Optional[dict] = None
        self.wall_s: Optional[float] = None
        self.delta: Dict[str, int] = {}
        self.attribution: Optional[dict] = None
        self.restarted = False

    @property
    def closed(self) -> bool:
        return self.after is not None

    @property
    def bound_stage(self) -> Optional[str]:
        return self.attribution["bound_stage"] if self.attribution else None

    def bytes_processed(self) -> int:
        """Pipeline bytes moved in the window: the largest of the per-path
        byte counters (the sharded pool's parsers count the same bytes
        into ``shard.bytes`` and ``parse.bytes``)."""
        return max(self.delta.get("shard.bytes", 0),
                   self.delta.get("parse.bytes", 0),
                   self.delta.get("record.bytes", 0))

    def mb_per_s(self) -> float:
        """Window throughput in MB/s (0.0 for an open or instant window)."""
        if not self.wall_s or self.wall_s <= 0:
            return 0.0
        return self.bytes_processed() / (1 << 20) / self.wall_s

    def close(self) -> None:
        """Close the window now (idempotent)."""
        if self.after is not None:
            return
        self.wall_s = time.monotonic() - self._t0
        self.after = snapshot()
        self.delta = counters_delta(self.before, self.after)
        self.attribution = stall_attribution(self.before, self.after,
                                             wall_s=self.wall_s)
        self.restarted = self.attribution["restarted"]

    def open(self) -> "Window":
        self.before = snapshot()
        self._t0 = time.monotonic()
        return self


@contextlib.contextmanager
def window() -> Iterator[Window]:
    """One :class:`Window` measuring the body::

        with telemetry.window() as w:
            run_epoch()
        print(w.mb_per_s(), w.attribution["table"])
    """
    w = Window().open()
    try:
        yield w
    finally:
        w.close()


def format_stall_table(attr: dict) -> str:
    """A :func:`stall_attribution` result as an aligned text table."""
    lines = ["stage     busy_s    wait_s   bound%"]
    for name, st in attr["stages"].items():
        pct = attr["bound"].get(name)
        lines.append(f"{name:<8}{st['busy_s']:>9.3f}{st['wait_s']:>10.3f}"
                     f"{'' if pct is None else f'{pct:>8.1f}'}")
    cache = attr["stages"].get("cache", {})
    if "codec_ratio" in cache:
        lines.append(f"codec   {cache['codec_ratio']:.2f}x expansion, "
                     f"{cache['decode_s']:.3f}s decode (inside cache busy)")
    if attr["table"]:
        lines.append(attr["table"])
    return "\n".join(lines)


# ---- stall watchdog and flight recorder -------------------------------------

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


def flight_record(reason: str = "manual") -> dict:
    """A flight record built now (the JSON the watchdog dumps): the stalled
    stage and per-stage progress ages (when armed), the registry snapshot
    and the trace buffers."""
    out = ctypes.c_char_p()
    _native.check(_native.lib().DmlcTpuFlightRecordJson(
        reason.encode(), ctypes.byref(out)))
    return json.loads((out.value or b"{}").decode())


def last_flight_record() -> Optional[dict]:
    """The record of the most recent watchdog stall, or None."""
    out = ctypes.c_char_p()
    _native.check(
        _native.lib().DmlcTpuWatchdogLastRecordJson(ctypes.byref(out)))
    raw = (out.value or b"").decode()
    return json.loads(raw) if raw else None


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


def timeseries_sample() -> None:
    """Force one synchronous sampler tick."""
    _native.check(_native.lib().DmlcTpuTimeseriesSample())


def timeseries_json() -> str:
    """Raw JSON with every series' full fine and coarse rings."""
    out = ctypes.c_char_p()
    _native.check(_native.lib().DmlcTpuTimeseriesJson(ctypes.byref(out)))
    return (out.value or b"{}").decode()


def timeseries_tail_json(points: int = 60) -> str:
    """Raw JSON with the newest ``points`` fine points of each series: the
    bounded tail that rides metric pushes and flight records."""
    out = ctypes.c_char_p()
    _native.check(_native.lib().DmlcTpuTimeseriesTailJson(
        int(points), ctypes.byref(out)))
    return (out.value or b"{}").decode()


def timeseries(points: int = 0) -> dict:
    """Parsed time-series document: ``{"enabled", "active", "tick_ms",
    "series": {name: {"kind", "rate_per_s"?, "fine": [[t_us, v], ...],
    "coarse": [...]}}}``; ``points > 0`` keeps the newest ``points`` of
    each ring."""
    raw = timeseries_tail_json(points) if points > 0 else timeseries_json()
    return json.loads(raw)


@contextlib.contextmanager
def timeseries_from_env() -> Iterator[None]:
    """Run the sampler for the duration of the body when
    ``DMLCTPU_TIMESERIES`` is set to anything but ``0``, else a no-op; the
    device-memory gauges are published as it starts.  Nesting refcounts
    like :func:`watchdog`."""
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
        resource_sample()
        yield
    finally:
        with _timeseries_lock:
            _timeseries_depth -= 1
            if _timeseries_depth == 0:
                timeseries_stop()


def resource_sample() -> dict:
    """Publish the card's memory gauges and return what was set:
    ``resource.hbm_bytes_in_use`` is ``torch.cuda.memory_allocated`` and
    ``resource.hbm_bytes_limit`` the card's total memory
    (``torch.cuda.mem_get_info``), of the current card.
    Without a card nothing is published, as the JAX package publishes
    nothing on the CPU.  The host gauges (``resource.rss_bytes``,
    ``resource.fd_count``, ``resource.cpu_ms``) come from the native
    sampler's own ticks."""
    import torch
    if not torch.cuda.is_available():
        return {}
    dev = torch.device("cuda", torch.cuda.current_device())
    published = {
        "resource.hbm_bytes_in_use": int(torch.cuda.memory_allocated(dev)),
        "resource.hbm_bytes_limit": int(torch.cuda.mem_get_info(dev)[1]),
    }
    for name, value in published.items():
        gauge_set(name, value)
    return published


# ---- log capture ------------------------------------------------------------

@contextlib.contextmanager
def capture_logs(min_severity: int = 2,
                 forward: Optional[Callable[[int, str, str], None]] = None,
                 ) -> Iterator[List[Tuple[int, str, str]]]:
    """Capture native log lines at or above ``min_severity`` (0=DEBUG
    1=INFO 2=WARNING 3=ERROR) as ``(severity, where, message)`` tuples
    instead of letting them reach stderr; ``forward`` sees every line.  The
    stderr sink is restored on exit.  The sink is process-wide: the
    capture installed last sees the lines."""
    records: List[Tuple[int, str, str]] = []

    def sink(severity: int, where: str, message: str) -> None:
        if severity >= min_severity:
            records.append((severity, where, message))
        if forward is not None:
            forward(severity, where, message)

    _native.set_log_callback(sink)
    try:
        yield records
    finally:
        _native.set_log_callback(None)
