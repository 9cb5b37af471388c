"""Stall-attribution-driven online autotuner for the staging pipeline.

The port of ``dmlc_core_tpu.autotune``, with its policy, its env toggles,
its ``autotune.*`` counters and gauges and its ``autotune.decision`` span.
The telemetry substrate names the bottleneck stage of every measured
interval (:func:`telemetry.stall_attribution`); this module turns that
name into a knob movement.  An :class:`AutoTuner` rides a staging iterator
(``DeviceStagingIter``, ``RecordStagingIter``, ``BinnedStagingIter``),
measures epochs (and, optionally, fixed-size mid-epoch batch windows)
through :class:`telemetry.Window`, and hill-climbs the pipeline knobs:

========  =====================================  =========================
bound     meaning                                knob moved (in order)
========  =====================================  =========================
shard /   the parse side starves the pipeline    num_workers x2, then
parse                                            buffer_mb x2, then
                                                 chunk_bytes x2
io        retry backoff dominates                buffer_mb x2
pack      native packing is the limiter          prefetch_depth +1
h2d       host-to-device staging dominates       prefetch_depth +1
========  =====================================  =========================

One step at a time, judged against the previous window's throughput: a
step that loses more than ``margin`` (default 5%) of MB/s is reverted and
that (knob, bound stage) pair is blocked until the bottleneck moves.
Windows flagged ``restarted`` never drive a decision.  Every knob is
stream-invariant on the native side, so retuning mid-epoch leaves every
staged batch as an untuned epoch's.

Every decision is observable: the ``autotune.*`` counters and gauges, an
``autotune.decision`` span in the trace, and a structured decision log
served at ``/autotune`` by :mod:`dmlc_core_tpu_torch.telemetry_http`.

Env toggles (all read at attach time):

- ``DMLCTPU_AUTOTUNE=1``: arm the tuner on every staging iterator built
  without an explicit ``autotune=`` argument.
- ``DMLCTPU_AUTOTUNE_WINDOW=N``: decide every N batches mid-epoch (0, the
  default, decides at epoch boundaries only).
- ``DMLCTPU_AUTOTUNE_MAX_WORKERS`` / ``DMLCTPU_AUTOTUNE_MAX_BUFFER_MB`` /
  ``DMLCTPU_AUTOTUNE_MAX_PREFETCH`` / ``DMLCTPU_AUTOTUNE_MAX_CHUNK_MB``:
  knob ceilings (defaults: max(4, cpu_count), 256, 8, 16; a chunk ceiling
  of 0 freezes the chunk knob).
- ``DMLCTPU_AUTOTUNE_MARGIN``: the fractional regression that triggers a
  revert (default 0.05).
- ``DMLCTPU_AUTOTUNE_LOG``: entries kept in the decision log (256).
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
import weakref
from typing import Deque, Dict, Iterator, Optional, Set, Tuple

from . import telemetry

__all__ = [
    "AutoTuner",
    "armed",
    "maybe_attach",
    "decision_log",
    "state",
]

# bytes below this in a window = no signal; holding still beats tuning on
# noise (also keeps armed-but-idle iterators from thrashing knobs)
_MIN_WINDOW_BYTES = 1 << 16
_MIN_WINDOW_WALL_S = 0.02
_CHUNK_FLOOR = 1 << 20  # first chunk_bytes step (grow-only at the split)
_CHUNK_CEIL = 16 << 20

_LOCK = threading.Lock()
_DECISIONS: Deque[dict] = collections.deque(
    maxlen=int(os.environ.get("DMLCTPU_AUTOTUNE_LOG", "256") or "256"))
_TUNERS: "weakref.WeakSet[AutoTuner]" = weakref.WeakSet()


def armed() -> bool:
    """True when DMLCTPU_AUTOTUNE asks staging iterators to self-tune."""
    return os.environ.get("DMLCTPU_AUTOTUNE", "0").lower() in (
        "1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def maybe_attach(target) -> Optional["AutoTuner"]:
    """The staging iterators' hook: return the iterator's tuner when it is
    armed (``autotune=True`` or DMLCTPU_AUTOTUNE at construction), creating
    and registering one on first use; None when unarmed."""
    if not getattr(target, "_autotune", False):
        return None
    tuner = getattr(target, "_tuner", None)
    if tuner is None:
        tuner = AutoTuner(target)
        try:
            target._tuner = tuner
        except AttributeError:
            pass
    return tuner


def decision_log() -> list:
    """The process-wide structured decision log (newest last, bounded by
    DMLCTPU_AUTOTUNE_LOG entries, shared by every tuner)."""
    with _LOCK:
        return list(_DECISIONS)


def state() -> dict:
    """JSON-ready autotuner state for the /autotune telemetry endpoint."""
    tuners = [t.summary() for t in list(_TUNERS)]
    return {
        "armed": armed(),
        "window_batches_env": _env_int("DMLCTPU_AUTOTUNE_WINDOW", 0),
        "tuners": tuners,
        "decisions": decision_log(),
    }


def _log_decision(rec: dict) -> None:
    with _LOCK:
        _DECISIONS.append(rec)


class AutoTuner:
    """Hill-climbing knob controller for one staging iterator.

    ``target`` must expose ``knobs`` (dict of current values) and
    ``set_knobs(**kw) -> dict``; the three staging iterators do.  The tuner holds
    only a weak reference — it never keeps an iterator (and its native
    handle) alive.

    Lifecycle: the iterator wraps each epoch in :meth:`epoch` and calls
    :meth:`on_batch` per yielded batch; decisions fire when a measurement
    window closes (every ``window_batches`` batches when > 0, and always at
    the epoch boundary).  :meth:`decide` is the pure-ish policy core — tests
    drive it directly with synthetic :class:`telemetry.Window` objects.
    """

    def __init__(self, target, window_batches: Optional[int] = None,
                 max_workers: Optional[int] = None,
                 max_buffer_mb: Optional[int] = None,
                 max_prefetch: Optional[int] = None,
                 max_chunk_mb: Optional[int] = None,
                 margin: Optional[float] = None):
        self._target = weakref.ref(target)
        self.window_batches = (window_batches if window_batches is not None
                               else _env_int("DMLCTPU_AUTOTUNE_WINDOW", 0))
        self.max_workers = (max_workers if max_workers is not None
                            else _env_int("DMLCTPU_AUTOTUNE_MAX_WORKERS",
                                          max(4, os.cpu_count() or 1)))
        self.max_buffer_mb = (max_buffer_mb if max_buffer_mb is not None
                              else _env_int("DMLCTPU_AUTOTUNE_MAX_BUFFER_MB",
                                            256))
        self.max_prefetch = (max_prefetch if max_prefetch is not None
                             else _env_int("DMLCTPU_AUTOTUNE_MAX_PREFETCH", 8))
        # 0 freezes the chunk knob entirely
        self.max_chunk_bytes = (
            max_chunk_mb if max_chunk_mb is not None
            else _env_int("DMLCTPU_AUTOTUNE_MAX_CHUNK_MB",
                          _CHUNK_CEIL >> 20)) << 20
        self.margin = (margin if margin is not None
                       else _env_float("DMLCTPU_AUTOTUNE_MARGIN", 0.05))
        self.epochs = 0
        self.windows = 0
        self.steps = 0
        self.accepts = 0
        self.reverts = 0
        self.holds = 0
        self.skipped_restart = 0
        # throughput of the last clean window BEFORE the pending step
        self._baseline_mb_s: Optional[float] = None
        # one in-flight step awaiting its evaluation window
        self._pending: Optional[dict] = None
        # (knob, bound_stage) pairs that regressed; cleared when the
        # bottleneck moves somewhere else
        self._blocked: Set[Tuple[str, str]] = set()
        self._blocked_stage: Optional[str] = None
        self._win: Optional[telemetry.Window] = None
        self._batch_in_window = 0
        _TUNERS.add(self)
        self._publish_gauges()

    # ---- iterator-facing lifecycle --------------------------------------
    @contextlib.contextmanager
    def epoch(self) -> Iterator["AutoTuner"]:
        """Measure one epoch; always decide at the boundary."""
        self.epochs += 1
        self._batch_in_window = 0
        self._win = telemetry.Window().open()
        try:
            yield self
        finally:
            w, self._win = self._win, None
            if w is not None:
                w.close()
                self.decide(w, boundary="epoch")

    def on_batch(self) -> None:
        """Per-batch tick; closes+reopens the window every
        ``window_batches`` batches when mid-epoch tuning is on."""
        if self.window_batches <= 0 or self._win is None:
            return
        self._batch_in_window += 1
        if self._batch_in_window < self.window_batches:
            return
        self._batch_in_window = 0
        w = self._win
        w.close()
        self.decide(w, boundary="window")
        self._win = telemetry.Window().open()

    @property
    def converged(self) -> bool:
        """Two consecutive hold decisions with nothing to try = settled."""
        return self.holds >= 2

    def summary(self) -> dict:
        tgt = self._target()
        return {
            "knobs": dict(tgt.knobs) if tgt is not None else None,
            "epochs": self.epochs,
            "windows": self.windows,
            "steps": self.steps,
            "accepts": self.accepts,
            "reverts": self.reverts,
            "holds": self.holds,
            "skipped_restart": self.skipped_restart,
            "converged": self.converged,
            "baseline_mb_s": (None if self._baseline_mb_s is None
                              else round(self._baseline_mb_s, 3)),
            "pending": dict(self._pending) if self._pending else None,
        }

    # ---- policy core ----------------------------------------------------
    def decide(self, win: telemetry.Window, boundary: str = "window") -> dict:
        """One decision from one closed window.  Returns the decision
        record (also appended to the shared log)."""
        with telemetry.span("autotune.decision"):
            rec = self._decide_inner(win, boundary)
        rec["t"] = time.time()
        _log_decision(rec)
        self._publish_gauges()
        return rec

    def _decide_inner(self, win: telemetry.Window, boundary: str) -> dict:
        self.windows += 1
        telemetry.counter_add("autotune.windows", 1)
        tgt = self._target()
        mb_s = win.mb_per_s()
        base = {
            "boundary": boundary,
            "epoch": self.epochs,
            "window": self.windows,
            "mb_s": round(mb_s, 3),
            "bound_stage": win.bound_stage,
            "table": win.attribution["table"] if win.attribution else "",
            "knobs": dict(tgt.knobs) if tgt is not None else None,
        }
        if tgt is None:
            return dict(base, action="hold", reason="target gone")
        if win.restarted:
            # a worker restart clamped the deltas: the measurement is a
            # lower bound, not a signal.  Keep any pending step in flight
            # and re-evaluate it on the next clean window.
            self.skipped_restart += 1
            telemetry.counter_add("autotune.skipped_restart", 1)
            return dict(base, action="skip_restart")
        if (win.bytes_processed() < _MIN_WINDOW_BYTES
                or not win.wall_s or win.wall_s < _MIN_WINDOW_WALL_S):
            return dict(base, action="skip_short")

        # 1) settle the in-flight step against the pre-step baseline
        verdict = None
        if self._pending is not None:
            p, self._pending = self._pending, None
            if (self._baseline_mb_s is not None
                    and mb_s < self._baseline_mb_s * (1.0 - self.margin)):
                tgt.set_knobs(**{p["knob"]: p["old"]})
                self._blocked.add((p["knob"], p["stage"]))
                self._blocked_stage = p["stage"]
                self.reverts += 1
                telemetry.counter_add("autotune.reverts", 1)
                verdict = dict(base, action="revert", knob=p["knob"],
                               frm=p["new"], to=p["old"],
                               baseline_mb_s=round(self._baseline_mb_s, 3))
            else:
                self.accepts += 1
                telemetry.counter_add("autotune.accepts", 1)
                # an accepted step never LOWERS the baseline: each step may
                # sit up to `margin` below it, and refreshing downward would
                # let a chain of individually-tolerable steps ratchet
                # throughput down without ever triggering a revert
                self._baseline_mb_s = max(self._baseline_mb_s or 0.0, mb_s)
                verdict = dict(base, action="accept", knob=p["knob"],
                               frm=p["old"], to=p["new"])
        else:
            self._baseline_mb_s = mb_s

        # 2) propose the next step from the bottleneck
        stage = win.bound_stage
        if stage is not None and stage != self._blocked_stage:
            # bottleneck moved: past regressions no longer apply
            self._blocked.clear()
            self._blocked_stage = None
        step = self._propose(stage, tgt.knobs)
        if step is None:
            if verdict is not None:
                return verdict  # settled a step but nothing new to try
            self.holds += 1
            telemetry.counter_add("autotune.holds", 1)
            return dict(base, action="hold")
        self.holds = 0
        knob, old, new = step
        applied = tgt.set_knobs(**{knob: new})
        self._pending = {"knob": knob, "old": old, "new": new,
                         "stage": stage or ""}
        self.steps += 1
        telemetry.counter_add("autotune.decisions", 1)
        rec = dict(base, action="step", knob=knob, frm=old, to=new,
                   pool_live=bool(applied.get("pool_live")))
        if verdict is not None:
            rec["settled"] = {k: verdict[k] for k in ("action", "knob",
                                                      "frm", "to")}
        return rec

    def _propose(self, stage: Optional[str],
                 knobs: Dict[str, int]) -> Optional[Tuple[str, int, int]]:
        """(knob, old, new) for the given bottleneck, or None to hold."""
        if stage is None:
            return None
        ok = lambda knob: (knob, stage) not in self._blocked  # noqa: E731
        nw = int(knobs.get("num_workers", 1))
        buf = int(knobs.get("buffer_mb", 0))
        pf = int(knobs.get("prefetch_depth", 1))
        cb = int(knobs.get("chunk_bytes", 0))
        if stage in ("shard", "parse"):
            if ok("num_workers") and nw < self.max_workers:
                return ("num_workers", nw, min(nw * 2, self.max_workers))
            if ok("buffer_mb") and 0 < buf < self.max_buffer_mb:
                return ("buffer_mb", buf, min(buf * 2, self.max_buffer_mb))
            if ok("chunk_bytes") and "chunk_bytes" in knobs \
                    and cb < self.max_chunk_bytes:
                return ("chunk_bytes", cb,
                        min(max(cb * 2, _CHUNK_FLOOR), self.max_chunk_bytes))
            return None
        if stage == "io":
            if ok("buffer_mb") and 0 < buf < self.max_buffer_mb:
                return ("buffer_mb", buf, min(buf * 2, self.max_buffer_mb))
            return None
        if stage in ("pack", "h2d"):
            if ok("prefetch_depth") and pf < self.max_prefetch:
                return ("prefetch_depth", pf, pf + 1)
            return None
        return None

    def _publish_gauges(self) -> None:
        tgt = self._target()
        if tgt is None:
            return
        k = tgt.knobs
        telemetry.gauge_set("autotune.num_workers",
                            int(k.get("num_workers", 0)))
        telemetry.gauge_set("autotune.buffer_mb", int(k.get("buffer_mb", 0)))
        telemetry.gauge_set("autotune.prefetch_depth",
                            int(k.get("prefetch_depth", 0)))
        telemetry.gauge_set("autotune.chunk_bytes",
                            int(k.get("chunk_bytes", 0)))
