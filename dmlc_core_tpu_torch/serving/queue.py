"""MicroBatchQueue — trade <= ``max_delay_us`` of queueing for occupancy.

Requests (each a small list of sparse rows) enqueue into one dispatcher
thread that collects up to ``max_batch`` rows or ``max_delay_us``
microseconds — whichever comes first — packs the collected rows through a
:class:`~dmlc_core_tpu_torch.serving.bucketing.ScoringIterator`, scores
them as ONE bucketed device batch, and resolves each request's future
with its slice.  The engine reference is captured once per micro-batch,
so a hot swap mid-stream lets in-flight batches finish on the old model.

With ``adaptive=True`` a settle/propose/hold controller
(:class:`MicroBatchTuner`) doubles (max_batch, max_delay_us) while QPS
improves and reverts a step that regressed.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, List, Optional, Tuple

import numpy as np

from .. import telemetry
from .bucketing import ScoringIterator

_PCTL_WINDOW = 2048  # rolling latency window for the p50/p99 gauges


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


class MicroBatchTuner:
    """Settle/propose/hold over (max_batch, max_delay_us), QPS objective.

    Each window first SETTLES the in-flight step against the pre-step QPS
    baseline (revert on a regression beyond ``margin``, and that knob is
    blocked), then PROPOSES the next doubling, else HOLDS.  Two
    consecutive holds = converged.
    """

    def __init__(self, target: "MicroBatchQueue", margin: float = 0.05,
                 max_max_batch: int = 1024, max_delay_cap_us: int = 20000):
        self._target = target
        self.margin = margin
        self.max_max_batch = max_max_batch
        self.max_delay_cap_us = max_delay_cap_us
        self._baseline_qps: Optional[float] = None
        self._pending: Optional[dict] = None
        self._blocked: set = set()
        self.steps = 0
        self.accepts = 0
        self.reverts = 0
        self.holds = 0

    @property
    def converged(self) -> bool:
        return self.holds >= 2

    def decide(self, qps: float) -> dict:
        tgt = self._target
        rec = {"qps": round(qps, 1), "knobs": dict(tgt.knobs)}
        if self._pending is not None:
            p, self._pending = self._pending, None
            if (self._baseline_qps is not None
                    and qps < self._baseline_qps * (1.0 - self.margin)):
                tgt.set_knobs(**{p["knob"]: p["old"]})
                self._blocked.add(p["knob"])
                self.reverts += 1
                telemetry.counter_add("serve.tune.reverts", 1)
                rec.update(action="revert", knob=p["knob"],
                           frm=p["new"], to=p["old"])
                return rec
            self.accepts += 1
            telemetry.counter_add("serve.tune.accepts", 1)
            self._baseline_qps = max(self._baseline_qps or 0.0, qps)
            rec.update(action="accept", knob=p["knob"],
                       frm=p["old"], to=p["new"])
        else:
            self._baseline_qps = qps
        step = self._propose(tgt.knobs)
        if step is None:
            self.holds += 1
            telemetry.counter_add("serve.tune.holds", 1)
            if "action" not in rec:
                rec["action"] = "hold"
            return rec
        self.holds = 0
        knob, old, new = step
        tgt.set_knobs(**{knob: new})
        self._pending = {"knob": knob, "old": old, "new": new}
        self.steps += 1
        telemetry.counter_add("serve.tune.steps", 1)
        rec.update(action="step", knob=knob, frm=old, to=new)
        return rec

    def _propose(self, knobs: dict) -> Optional[Tuple[str, int, int]]:
        mb = int(knobs["max_batch"])
        dl = int(knobs["max_delay_us"])
        if "max_batch" not in self._blocked and mb < self.max_max_batch:
            return ("max_batch", mb, min(mb * 2, self.max_max_batch))
        if "max_delay_us" not in self._blocked and dl < self.max_delay_cap_us:
            return ("max_delay_us", dl, min(max(dl * 2, 100),
                                            self.max_delay_cap_us))
        return None


class MicroBatchQueue:
    """Future-returning micro-batching front of a ScoringEngine.

    ``engine_provider`` is read once per micro-batch (the hot-swap seam);
    ``submit(rows)`` returns a Future resolving to ``(scores, digest,
    seq)`` for that request's rows.  Batches are packed for ``device``,
    which must be the engines' device.
    """

    def __init__(self, engine_provider: Callable[[], object],
                 max_batch: Optional[int] = None,
                 max_delay_us: Optional[int] = None,
                 adaptive: Optional[bool] = None,
                 tune_window_batches: int = 64,
                 device="cuda"):
        self._engine_provider = engine_provider
        self.max_batch = (max_batch if max_batch is not None
                          else _env_int("DMLCTPU_SERVE_MAX_BATCH", 64))
        self.max_delay_us = (
            max_delay_us if max_delay_us is not None
            else _env_int("DMLCTPU_SERVE_MAX_DELAY_US", 1000))
        if adaptive is None:
            adaptive = os.environ.get("DMLCTPU_SERVE_ADAPTIVE", "0") \
                not in ("0", "", "false")
        self._iter = ScoringIterator(max_batch=4096, device=device)
        self._lock = threading.Condition()
        self._pending: deque = deque()  # (rows, future, t_enqueue_ns, ctx)
        self._pending_rows = 0
        self._closed = False
        self._lat_us: deque = deque(maxlen=_PCTL_WINDOW)
        self.tuner = MicroBatchTuner(self) if adaptive else None
        self._tune_window_batches = tune_window_batches
        self._win_rows = 0
        self._win_batches = 0
        self._win_t0 = time.monotonic()
        self.batches = 0
        self._thread = threading.Thread(target=self._run,
                                        name="dmlctpu-serve-mb",
                                        daemon=True)
        self._thread.start()

    # ---- tuner target surface -------------------------------------------
    @property
    def knobs(self) -> dict:
        return {"max_batch": self.max_batch,
                "max_delay_us": self.max_delay_us}

    def set_knobs(self, **kw) -> dict:
        with self._lock:
            if "max_batch" in kw:
                self.max_batch = max(1, int(kw["max_batch"]))
            if "max_delay_us" in kw:
                self.max_delay_us = max(0, int(kw["max_delay_us"]))
            self._lock.notify_all()
        return self.knobs

    # ---- request side ----------------------------------------------------
    def submit(self, rows: List) -> Future:
        """Enqueue one request (a list of sparse rows); resolves to
        ``(np.ndarray scores, model_digest, model_seq)``.  The submitting
        thread's trace context rides with the request, so the dispatcher
        labels the micro-batch's spans with the first request's trace."""
        fut: Future = Future()
        ctx = telemetry.get_trace_context()
        with self._lock:
            if self._closed:
                raise RuntimeError("queue is closed")
            self._pending.append((rows, fut, time.monotonic_ns(),
                                  ctx if ctx[0] else None))
            self._pending_rows += len(rows)
            telemetry.gauge_set("serve.queue_depth", len(self._pending))
            self._lock.notify_all()
        telemetry.counter_add("serve.requests", 1)
        return fut

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._thread.join(timeout=5)

    # ---- dispatcher ------------------------------------------------------
    def _collect(self) -> List[Tuple]:
        """Block for the first request, then linger up to max_delay_us or
        until max_batch rows are pending; drain up to max_batch rows."""
        with self._lock:
            while not self._pending and not self._closed:
                self._lock.wait(0.1)
            if not self._pending:
                return []
            deadline = self._pending[0][2] + self.max_delay_us * 1000
            while (self._pending_rows < self.max_batch
                   and not self._closed):
                rest = (deadline - time.monotonic_ns()) / 1e9
                if rest <= 0:
                    break
                self._lock.wait(rest)
            out = []
            n = 0
            while self._pending:
                rows = self._pending[0][0]
                if out and n + len(rows) > self.max_batch:
                    break
                item = self._pending.popleft()
                out.append(item)
                n += len(rows)
            self._pending_rows -= n
            telemetry.gauge_set("serve.queue_depth", len(self._pending))
            return out

    def _run(self) -> None:
        while True:
            items = self._collect()
            if not items:
                if self._closed:
                    return
                continue
            t_deq = time.monotonic_ns()
            # the micro-batch adopts the FIRST context-carrying request's
            # trace and mints its lineage from the batch sequence number
            ctx = next((c for _, _, _, c in items if c is not None), None)
            if ctx is not None:
                telemetry.set_trace_context(ctx[0], ctx[1], self.batches)
            now = telemetry.now_us()
            for _, _, t_enq, _ in items:
                wait_us = (t_deq - t_enq) // 1000
                telemetry.counter_add("serve.queue_wait_us", wait_us)
                telemetry.record_span("serve.queue_wait", now - wait_us,
                                      wait_us)
            engine = self._engine_provider()  # hot-swap seam: one read
            flat: List = []
            for rows, _, _, _ in items:
                flat.extend(rows)
            try:
                if engine is None:
                    raise RuntimeError("no model loaded")
                with telemetry.span("serve.pack"):
                    batch, _ = self._iter.pack(flat)
                with telemetry.span("serve.device"):
                    scores = engine.score(batch)
            except Exception as exc:  # the dispatcher must keep running
                for _, fut, _, _ in items:
                    if not fut.cancelled():
                        fut.set_exception(exc)
                if ctx is not None:
                    telemetry.clear_trace_context()
                continue
            t_done = time.monotonic_ns()
            with telemetry.span("serve.respond"):
                off = 0
                for rows, fut, t_enq, _ in items:
                    part = scores[off:off + len(rows)]
                    off += len(rows)
                    self._lat_us.append((t_done - t_enq) // 1000)
                    if not fut.cancelled():
                        fut.set_result((part, engine.digest, engine.seq))
            if ctx is not None:
                telemetry.clear_trace_context()
            self.batches += 1
            telemetry.counter_add("serve.batches", 1)
            telemetry.counter_add("serve.rows", len(flat))
            self._win_rows += len(flat)
            self._win_batches += 1
            self._publish_latency()
            if (self.tuner is not None
                    and self._win_batches >= self._tune_window_batches):
                wall = max(time.monotonic() - self._win_t0, 1e-9)
                self.tuner.decide(self._win_rows / wall)
                self._win_rows = 0
                self._win_batches = 0
                self._win_t0 = time.monotonic()

    def _publish_latency(self) -> None:
        if not self._lat_us:
            return
        lat = np.fromiter(self._lat_us, np.int64)
        telemetry.gauge_set("serve.p50_us", int(np.percentile(lat, 50)))
        telemetry.gauge_set("serve.p99_us", int(np.percentile(lat, 99)))
        wall = max(time.monotonic() - self._win_t0, 1e-9)
        if self._win_rows:
            telemetry.gauge_set("serve.qps", int(self._win_rows / wall))
