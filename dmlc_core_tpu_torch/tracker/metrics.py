"""Tracker-side telemetry aggregation: the job-wide observability plane.

The port of ``dmlc_core_tpu.tracker.metrics``, on the same wire, so a
pusher of either package reports to an aggregator of either package.

Workers periodically push compact telemetry snapshots (counters, gauges,
histogram buckets, plus a restart flag) to a lightweight TCP side channel
owned by the tracker; the tracker merges them into a job view answering
"which host is the straggler?" without attaching to any process.

The channel is negotiated at rendezvous: :class:`MetricsAggregator` binds
next to the rabit socket and its port rides the env contract as
``DMLC_TRACKER_METRICS_PORT`` (see ``RabitTracker.worker_envs``), so every
launcher ships it to workers for free.  The wire format mirrors the rabit
framing (native-endian int32 + [len]+utf8) with its own magic, one push per
connection:

    worker -> MAGIC, json payload      tracker -> MAGIC, int ack (0)

Payload: ``{"rank", "host", "pid", "restarted", "snapshot"}`` where
``snapshot`` is ``telemetry.snapshot()``.  Pushes are cumulative (counters
are monotonic), so the tracker can lose any number of them and the next one
heals the view; a worker restart shows up as counters moving backwards and
tags the host ``restarted``.

The same channel closes the loop at the job level: a payload may carry an
optional ``shard_req`` (register / claim / steal / done against the
tracker's :class:`ShardBoard`), answered with one JSON reply AFTER the int
ack — old workers never send one and never read one, so the extension is
wire-compatible both ways.  The board serializes shard ownership for an
epoch's virtual parts, and ``steal`` hands pending shards of flagged hosts
(persistent stragglers by the ``format_job_table`` median rule, restarted
hosts, stale hosts) to healthy claimants — work stealing driven by the
stall-attribution flags, with exactly-once job-wide visitation because
every shard start goes through one claim point.
"""
from __future__ import annotations

import json
import logging
import os
import random
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import telemetry

LOGGER = logging.getLogger("dmlc_tpu.tracker.metrics")

METRICS_MAGIC = 0xFF98
METRICS_PORT_ENV = "DMLC_TRACKER_METRICS_PORT"

__all__ = [
    "MetricsAggregator", "MetricsPusher", "push_once", "ensure_pusher",
    "stop_pusher", "METRICS_MAGIC", "METRICS_PORT_ENV",
    "ShardBoard", "ShardClient", "shard_client_from_env",
    "coordinated_parts", "RegressionSentinel",
]


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


def _read_str(sock: socket.socket) -> str:
    return _read_exact(sock, _read_int(sock)).decode()


def _write_str(sock: socket.socket, value: str) -> None:
    data = value.encode()
    _write_int(sock, len(data))
    sock.sendall(data)


# ---- tracker side -----------------------------------------------------------

def _stage_medians(attrs: List[dict]) -> Dict[str, float]:
    """Fleet median busy share per stage, over hosts' attribution dicts."""
    by_stage: Dict[str, List[float]] = {}
    for a in attrs:
        for stage, share in a["bound"].items():
            by_stage.setdefault(stage, []).append(share)
    median: Dict[str, float] = {}
    for stage, shares in by_stage.items():
        s = sorted(shares)
        mid = len(s) // 2
        median[stage] = s[mid] if len(s) % 2 else (s[mid - 1] + s[mid]) / 2
    return median


class ShardBoard:
    """Job-wide shard ownership ledger: the tracker-side half of mid-epoch
    work stealing.

    Shards are opaque ints (the staging layer uses GLOBAL virtual-part ids,
    ``rank * V + j``).  Per epoch the board records who *owns* each shard,
    who *started* it, and who finished it.  The visitation guarantee is
    structural: a shard is parsed only after a successful ``claim`` or a
    ``steal``, both of which are serialized here, and a started shard is
    never reassigned — so across the whole job every shard is started by
    exactly one live lineage.  (A restarted owner may re-claim a shard it
    itself started — deterministic re-parse of its own lost work, the same
    replay contract as the pool's part retry.)  Only the newest few epochs
    are retained.
    """

    def __init__(self, keep_epochs: int = 4):
        self._lock = threading.Lock()
        self._keep = max(int(keep_epochs), 1)
        # epoch -> {"owners": {shard: rank}, "started": {shard: rank},
        #           "done": {shard: rank}, "stolen": [handoff records]}
        self._epochs: Dict[int, dict] = {}

    def _epoch(self, epoch: int) -> dict:
        st = self._epochs.get(epoch)
        if st is None:
            st = {"owners": {}, "started": {}, "done": {}, "stolen": []}
            self._epochs[epoch] = st
            while len(self._epochs) > self._keep:
                del self._epochs[min(self._epochs)]
        return st

    @staticmethod
    def _pending(st: dict) -> int:
        return sum(1 for s in st["owners"] if s not in st["started"])

    def register(self, rank: int, epoch: int, shards: List[int]) -> dict:
        """Declare this rank's shard set for an epoch (idempotent; first
        registrant of a shard becomes its owner)."""
        with self._lock:
            st = self._epoch(epoch)
            for s in shards:
                st["owners"].setdefault(int(s), int(rank))
            return {"ok": True, "pending": self._pending(st)}

    def claim(self, rank: int, epoch: int, shard: int) -> dict:
        """Ask to start a shard.  ``ok=False`` means it was handed to
        someone else while this owner lagged — skip it, the thief parses
        it."""
        with self._lock:
            st = self._epoch(epoch)
            owner = st["owners"].get(shard)
            started = st["started"].get(shard)
            if (owner is not None and owner != rank) or \
                    (started is not None and started != rank):
                return {"ok": False, "pending": self._pending(st)}
            st["owners"][shard] = int(rank)
            st["started"][shard] = int(rank)
            return {"ok": True, "pending": self._pending(st)}

    def steal(self, rank: int, epoch: int, flagged) -> dict:
        """Hand one pending shard of a flagged host to ``rank`` (claimed
        atomically).  ``shard=None`` when nothing is stealable; ``pending``
        lets the caller decide whether to poll again or end the epoch."""
        with self._lock:
            st = self._epoch(epoch)
            for s in sorted(st["owners"]):
                owner = st["owners"][s]
                if owner == rank or owner not in flagged:
                    continue
                if s in st["started"]:
                    continue
                st["owners"][s] = int(rank)
                st["started"][s] = int(rank)
                st["stolen"].append({"shard": int(s), "from": int(owner),
                                     "to": int(rank), "t": time.time()})
                return {"shard": int(s), "from": int(owner),
                        "pending": self._pending(st)}
            return {"shard": None, "pending": self._pending(st)}

    def done(self, rank: int, epoch: int, shard: int) -> dict:
        with self._lock:
            st = self._epoch(epoch)
            st["done"][shard] = int(rank)
            return {"ok": True, "pending": self._pending(st)}

    def state(self) -> dict:
        """JSON-ready per-epoch progress + handoff history (job_snapshot)."""
        with self._lock:
            out: Dict[str, dict] = {}
            for e, st in sorted(self._epochs.items()):
                out[str(e)] = {
                    "shards": len(st["owners"]),
                    "started": len(st["started"]),
                    "done": len(st["done"]),
                    "pending": self._pending(st),
                    "stolen": list(st["stolen"]),
                    "owners": {str(s): r
                               for s, r in sorted(st["owners"].items())},
                }
            return out


class LeaseBoard:
    """Dispatcher-side ledger for the data-service fleet (doc/dataservice.md).

    Two registries under one lock: the staging-**worker** fleet (elastic
    join/leave via register/heartbeat/leave; a worker a client reported
    failing is dead until its next heartbeat proves otherwise) and the
    per-``(client, epoch)`` **lease** ledgers.  A lease is the data-service
    analogue of a ShardBoard claim, but per *consumer*: every trainer client
    must see every shard of its epoch exactly once, independent of which
    worker serves it or how many clients share the fleet.  Exactly-once is
    structural, like ShardBoard's: ``lease_assign`` on an already-done shard
    answers ``done`` (so a client replay skips it), a completed shard is
    recorded once, and a failed fetch requeues the SAME shard — the client
    discards the partial stream and re-fetches whole, so worker death never
    duplicates or drops rows.
    """

    def __init__(self, keep_epochs: int = 4, dead_after_s: float = 15.0):
        self._lock = threading.Lock()
        self._dead_after = float(dead_after_s)
        self._keep = max(int(keep_epochs), 1)
        # worker id -> {"host","port","last_seen","dead","served","failed"}
        self._workers: Dict[str, dict] = {}
        # (client, epoch) -> {"parts": {part: worker-or-None},
        #                     "done": {part: worker}, "failovers": [records]}
        self._ledgers: Dict[Tuple[str, int], dict] = {}

    # ---- worker fleet -------------------------------------------------------

    def _alive(self, now: float) -> Dict[str, dict]:
        return {w: st for w, st in self._workers.items()
                if not st["dead"] and now - st["last_seen"] <= self._dead_after}

    def worker_register(self, worker: str, host: str, port: int) -> dict:
        with self._lock:
            self._workers[worker] = {
                "host": str(host), "port": int(port), "last_seen": time.time(),
                "dead": False, "served": 0, "failed": 0,
            }
            alive = len(self._alive(time.time()))
        telemetry.gauge_set("dataservice.workers_alive", alive)
        LOGGER.info("data-service worker %s joined at %s:%d (%d alive)",
                    worker, host, port, alive)
        return {"ok": True, "workers": alive}

    def worker_heartbeat(self, worker: str) -> dict:
        with self._lock:
            st = self._workers.get(worker)
            if st is None:
                return {"ok": False}  # tracker restarted: re-register
            st["last_seen"] = time.time()
            st["dead"] = False  # a live heartbeat clears a client's report
            return {"ok": True}

    def worker_leave(self, worker: str) -> dict:
        """Graceful drain: stop assigning, requeue this worker's leases."""
        with self._lock:
            st = self._workers.get(worker)
            if st is not None:
                st["dead"] = True
            requeued = self._requeue_locked(worker)
        return {"ok": True, "requeued": requeued}

    def _requeue_locked(self, worker: str) -> int:
        requeued = 0
        for ledger in self._ledgers.values():
            for part, w in ledger["parts"].items():
                if w == worker and part not in ledger["done"]:
                    ledger["parts"][part] = None
                    requeued += 1
        return requeued

    # ---- per-client epoch leases --------------------------------------------

    def _ledger(self, client: str, epoch: int) -> dict:
        key = (client, epoch)
        ledger = self._ledgers.get(key)
        if ledger is None:
            ledger = {"parts": {}, "done": {}, "failovers": []}
            self._ledgers[key] = ledger
            mine = sorted(e for c, e in self._ledgers if c == client)
            while len(mine) > self._keep:
                del self._ledgers[(client, mine.pop(0))]
        return ledger

    def lease_register(self, client: str, epoch: int, parts) -> dict:
        """Declare the client's shard set for an epoch (idempotent)."""
        with self._lock:
            ledger = self._ledger(client, epoch)
            for p in parts:
                ledger["parts"].setdefault(int(p), None)
            pending = sum(1 for p in ledger["parts"]
                          if p not in ledger["done"])
            return {"ok": True, "pending": pending}

    def lease_assign(self, client: str, epoch: int, part: int) -> dict:
        """Lease one shard to the calling client: pick the serving worker.

        ``done`` — this client already finished the shard (replay skips);
        ``worker`` — fetch from there; ``wait`` — no live workers, poll.
        The pick is a rendezvous hash of (worker, part) so a given shard
        lands on the same worker while the fleet is stable (cache-warm
        affinity) and redistributes minimally when it grows or shrinks.
        """
        with self._lock:
            ledger = self._ledger(client, epoch)
            if part in ledger["done"]:
                return {"done": True}
            alive = self._alive(time.time())
            if not alive:
                return {"wait": True}
            wid = max(alive, key=lambda w: hash((w, int(part))))
            ledger["parts"][int(part)] = wid
            alive[wid]["served"] += 1
            st = alive[wid]
        telemetry.counter_add("dataservice.leases", 1)
        return {"worker": {"id": wid, "host": st["host"], "port": st["port"]}}

    def lease_done(self, client: str, epoch: int, part: int,
                   worker: str) -> dict:
        with self._lock:
            ledger = self._ledger(client, epoch)
            first = int(part) not in ledger["done"]
            ledger["done"].setdefault(int(part), str(worker))
            pending = sum(1 for p in ledger["parts"]
                          if p not in ledger["done"])
            return {"ok": True, "first": first, "pending": pending}

    def lease_fail(self, client: str, epoch: int, part: int,
                   worker: str) -> dict:
        """A client's fetch from ``worker`` died: mark it dead (its next
        heartbeat revives it), requeue every undone shard it held, and
        record the failover for the observability plane."""
        with self._lock:
            st = self._workers.get(worker)
            if st is not None:
                st["dead"] = True
                st["failed"] += 1
            requeued = self._requeue_locked(worker)
            ledger = self._ledger(client, epoch)
            ledger["failovers"].append({
                "part": int(part), "worker": str(worker), "t": time.time()})
            alive = len(self._alive(time.time()))
        telemetry.counter_add("dataservice.failovers", 1)
        telemetry.gauge_set("dataservice.workers_alive", alive)
        LOGGER.warning("data-service worker %s reported dead by client %s "
                       "(shard %d requeued, %d total, %d workers alive)",
                       worker, client, part, requeued, alive)
        return {"ok": True, "requeued": requeued, "workers": alive}

    def state(self) -> dict:
        """JSON-ready fleet + lease view (job_snapshot, /dataservice)."""
        now = time.time()
        with self._lock:
            workers = {
                w: {"host": st["host"], "port": st["port"],
                    "age_s": round(now - st["last_seen"], 3),
                    "dead": bool(st["dead"]) or
                    now - st["last_seen"] > self._dead_after,
                    "served": st["served"], "failed": st["failed"]}
                for w, st in sorted(self._workers.items())}
            leases = {}
            for (client, epoch), ledger in sorted(self._ledgers.items()):
                leases.setdefault(client, {})[str(epoch)] = {
                    "shards": len(ledger["parts"]),
                    "done": len(ledger["done"]),
                    "pending": sum(1 for p in ledger["parts"]
                                   if p not in ledger["done"]),
                    "assigned": {str(p): w for p, w in
                                 sorted(ledger["parts"].items())
                                 if w is not None},
                    "failovers": list(ledger["failovers"]),
                }
        return {"workers": workers, "leases": leases}


class RegressionSentinel:
    """Rolling-baseline throughput watch over the pushed counter stream.

    For each (rank, stage) the sentinel turns successive snapshot pushes
    into windowed rates (counter delta / wall-clock dt, clamped at zero so
    a worker restart reads as "no progress this window", the same clamp as
    ``telemetry.counters_delta``) and tracks an EWMA baseline that only
    absorbs *healthy* windows.  A stage is **degraded** when its rate drops
    below ``threshold`` (default 0.35) of its established baseline for
    ``consecutive`` windows in a row — a persistent regression, not a
    single hiccup — and recovers the moment one window clears the bar.
    Baselines need ``warmup`` healthy windows before they can flag anything,
    so ramp-up never reads as regression.  Degraded (rank, stage) pairs
    feed ``MetricsAggregator.flagged_ranks`` (their pending shards become
    stealable) and the ``format_job_table`` flags column.
    """

    # stage -> its progress counter; mirrors the watchdog's kStages table
    STAGES = (("split", "split.bytes"), ("parse", "parse.rows"),
              ("shard", "shard.chunks"), ("pack", "pack.batches"),
              ("record", "record.batches"), ("h2d", "h2d.batches"))

    def __init__(self, threshold: float = 0.35, warmup: int = 3,
                 consecutive: int = 2, ewma_alpha: float = 0.3,
                 min_dt_s: float = 0.05):
        self.threshold = float(threshold)
        self.warmup = max(int(warmup), 1)
        self.consecutive = max(int(consecutive), 1)
        self.alpha = float(ewma_alpha)
        self.min_dt_s = float(min_dt_s)
        # (rank, stage) -> {"value","t","ewma","healthy","low","rate"}
        self._tracks: Dict[Tuple[int, str], dict] = {}

    def reset_rank(self, rank: int) -> None:
        """Forget a restarted worker's history: its counters restarted from
        zero, so old baselines would read the fresh ramp as regression."""
        for key in [k for k in self._tracks if k[0] == rank]:
            del self._tracks[key]

    def observe(self, rank: int, snapshot: dict,
                now: Optional[float] = None) -> None:
        """Fold one pushed snapshot into the per-stage rate tracks."""
        now = time.time() if now is None else float(now)
        counters = snapshot.get("counters", {})
        for stage, counter in self.STAGES:
            if counter not in counters:
                continue
            value = int(counters[counter])
            key = (rank, stage)
            tr = self._tracks.get(key)
            if tr is None:
                self._tracks[key] = {"value": value, "t": now, "ewma": 0.0,
                                     "healthy": 0, "low": 0, "rate": 0.0}
                continue
            dt = now - tr["t"]
            if dt < self.min_dt_s:
                continue  # duplicate push; a rate from ~0 dt is noise
            delta = max(value - tr["value"], 0)  # counters_delta clamp
            rate = delta / dt
            tr["value"], tr["t"], tr["rate"] = value, now, rate
            baselined = tr["healthy"] >= self.warmup
            if baselined and rate < self.threshold * tr["ewma"]:
                tr["low"] += 1
                continue  # regression window: baseline must not absorb it
            tr["low"] = 0
            if delta > 0:  # idle stages neither build nor decay baselines
                tr["ewma"] = (rate if tr["healthy"] == 0 else
                              (1 - self.alpha) * tr["ewma"]
                              + self.alpha * rate)
                tr["healthy"] += 1

    def degraded(self) -> Dict[int, Dict[str, dict]]:
        """``{rank: {stage: {"rate", "baseline", "windows"}}}`` for every
        (rank, stage) currently below threshold long enough to flag."""
        out: Dict[int, Dict[str, dict]] = {}
        for (rank, stage), tr in sorted(self._tracks.items()):
            if tr["low"] >= self.consecutive:
                out.setdefault(rank, {})[stage] = {
                    "rate": round(tr["rate"], 3),
                    "baseline": round(tr["ewma"], 3),
                    "windows": tr["low"],
                }
        return out


class MetricsAggregator:
    """Accepts worker snapshot pushes and merges them into a job view."""

    # a clock-offset estimate older than this (the host's
    # telemetry.clock_probe_age_s gauge) makes its trace/time-series
    # alignment suspect; job_snapshot/job_trace/job_timeseries flag it
    CLOCK_STALE_S = 60.0

    def __init__(self, host_ip: str = "127.0.0.1", port: int = 0):
        family = socket.getaddrinfo(host_ip, None)[0][0]
        sock = socket.socket(family, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host_ip, port))
        sock.listen(64)
        self.sock = sock
        self.host_ip = host_ip
        self.port = sock.getsockname()[1]
        self._lock = threading.Lock()
        # rank -> {"host","pid","snapshot","restarted","last_update"}
        self._hosts: Dict[int, dict] = {}
        self.board = ShardBoard()
        self.leases = LeaseBoard()
        self.sentinel = RegressionSentinel()
        self._closed = False
        self._thread = threading.Thread(
            target=self._serve, name="dmlctpu-metrics-aggregator", daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        while True:
            try:
                fd, _addr = self.sock.accept()
            except OSError:
                return  # closed
            try:
                self._handle(fd)
            except (ConnectionError, OSError, ValueError, KeyError) as e:
                LOGGER.debug("dropped metrics push: %s", e)
            finally:
                try:
                    fd.close()
                except OSError:
                    pass

    def _handle(self, fd: socket.socket) -> None:
        fd.settimeout(10.0)
        magic = _read_int(fd)
        if magic != METRICS_MAGIC:
            raise ConnectionError(f"bad metrics magic {magic:#x}")
        _write_int(fd, METRICS_MAGIC)
        payload = json.loads(_read_str(fd))
        rank = int(payload["rank"])
        with self._lock:
            prev = self._hosts.get(rank)
            restarted = bool(payload.get("restarted", False))
            if prev is not None:
                # counters moving backwards across pushes = the worker
                # process restarted and re-registered from zero
                restarted = restarted or prev["restarted"] or \
                    telemetry.snapshot_restarted(prev["snapshot"],
                                                 payload["snapshot"])
            self._hosts[rank] = {
                "host": str(payload.get("host", "?")),
                "pid": int(payload.get("pid", -1)),
                "snapshot": payload["snapshot"],
                "restarted": restarted,
                "last_update": time.time(),
                # newest trace dump wins; a push without one keeps the
                # last dump the host shipped (cumulative, like counters)
                "trace": payload.get("trace") or (
                    prev.get("trace") if prev else None),
                # same carry-forward for the sampler's time-series tail
                "timeseries": payload.get("timeseries") or (
                    prev.get("timeseries") if prev else None),
            }
            if restarted and (prev is None or not prev["restarted"]):
                self.sentinel.reset_rank(rank)
            self.sentinel.observe(rank, payload["snapshot"])
        _write_int(fd, 0)
        # optional shard-board RPC: one JSON reply after the ack (absent
        # for plain pushes, so the classic protocol is untouched)
        req = payload.get("shard_req")
        if req is not None:
            _write_str(fd, json.dumps(self._handle_shard_req(rank, req)))
        # optional data-service dispatcher RPC: same one-reply-after-ack
        # discipline, so staging workers and trainer clients ride the
        # existing channel instead of a second tracker port
        dreq = payload.get("dataservice_req")
        if dreq is not None:
            _write_str(fd, json.dumps(self._handle_dataservice_req(dreq)))
        # optional clock probe: the worker sends one ping AFTER reading the
        # ack and we answer with this process's steady clock in
        # microseconds.  The worker brackets the ping with its own clock
        # reads (t0, t1) and estimates offset = t_tracker - (t0+t1)/2 —
        # classic NTP, min-RTT filtered on the worker side.  Kept as the
        # LAST exchange so the reply rides right behind the ack and the
        # RTT stays a socket round trip, not a JSON-merge round trip.
        if payload.get("clock"):
            _read_str(fd)  # the ping; content irrelevant, timing is all
            _write_str(fd, str(telemetry.now_us()))

    def _handle_shard_req(self, rank: int, req: dict) -> dict:
        op = req.get("op")
        epoch = int(req.get("epoch", 0))
        if op == "register":
            return self.board.register(rank, epoch, req.get("shards", []))
        if op == "claim":
            return self.board.claim(rank, epoch, int(req["shard"]))
        if op == "steal":
            reply = self.board.steal(rank, epoch, self.flagged_ranks())
            if reply.get("shard") is not None:
                telemetry.counter_add("tracker.shards_stolen", 1)
                LOGGER.info("epoch %d: shard %d handed off rank %d -> %d",
                            epoch, reply["shard"], reply["from"], rank)
            return reply
        if op == "done":
            return self.board.done(rank, epoch, int(req["shard"]))
        return {"error": f"unknown shard op {op!r}"}

    def _handle_dataservice_req(self, req: dict) -> dict:
        op = req.get("op")
        b = self.leases
        if op == "worker_register":
            return b.worker_register(str(req["worker"]), str(req["host"]),
                                     int(req["port"]))
        if op == "worker_heartbeat":
            return b.worker_heartbeat(str(req["worker"]))
        if op == "worker_leave":
            return b.worker_leave(str(req["worker"]))
        if op == "lease_register":
            return b.lease_register(str(req["client"]), int(req["epoch"]),
                                    req.get("parts", []))
        if op == "lease_assign":
            return b.lease_assign(str(req["client"]), int(req["epoch"]),
                                  int(req["part"]))
        if op == "lease_done":
            return b.lease_done(str(req["client"]), int(req["epoch"]),
                                int(req["part"]), str(req.get("worker", "")))
        if op == "lease_fail":
            return b.lease_fail(str(req["client"]), int(req["epoch"]),
                                int(req["part"]), str(req.get("worker", "")))
        if op == "state":
            return b.state()
        return {"error": f"unknown dataservice op {op!r}"}

    def flagged_ranks(self, stale_s: float = 30.0) -> set:
        """Ranks whose pending shards are up for grabs: persistent
        stragglers (the format_job_table median rule over lifetime
        counters), hosts the regression sentinel holds degraded, restarted
        hosts, and hosts whose last push went stale."""
        now = time.time()
        with self._lock:
            hosts = {r: dict(h) for r, h in self._hosts.items()}
            degraded = self.sentinel.degraded()
        empty: dict = {"counters": {}}
        attrs = {r: telemetry.stall_attribution(empty, h["snapshot"])
                 for r, h in hosts.items()}
        median = _stage_medians(list(attrs.values()))
        flagged = set(degraded)
        for r, h in hosts.items():
            if h["restarted"] or (now - h["last_update"]) > stale_s:
                flagged.add(r)
                continue
            st = attrs[r]["bound_stage"]
            if st is not None:
                share = attrs[r]["bound"].get(st, 0.0)
                med = median.get(st, 0.0)
                if share >= 1.5 * med and share - med >= 10.0:
                    flagged.add(r)
        return flagged

    # ---- job view -----------------------------------------------------------

    def job_snapshot(self) -> dict:
        """Merged job view: per-host snapshots plus a fleet roll-up.

        ``hosts`` maps rank -> ``{"host", "pid", "age_s", "restarted",
        "snapshot", "attribution"}`` (attribution over the host's lifetime
        counters); ``fleet`` is ``telemetry.merge_snapshots`` over every
        host — counters add exactly, so per-host byte counters sum to the
        totals a single process would have seen.
        """
        now = time.time()
        with self._lock:
            hosts = {r: dict(h) for r, h in self._hosts.items()}
        empty: dict = {"counters": {}}
        view: Dict[str, object] = {"hosts": {}, "num_hosts": len(hosts)}
        for rank, h in sorted(hosts.items()):
            attr = telemetry.stall_attribution(empty, h["snapshot"])
            view["hosts"][rank] = {
                "host": h["host"],
                "pid": h["pid"],
                "age_s": round(now - h["last_update"], 3),
                "restarted": h["restarted"],
                "snapshot": h["snapshot"],
                "attribution": attr,
            }
        view["fleet"] = telemetry.merge_snapshots(
            [h["snapshot"] for h in hosts.values()]) if hosts else {
                "enabled": False, "counters": {}, "gauges": {},
                "histograms": {}}
        view["restarted"] = any(h["restarted"] for h in hosts.values())
        view["shards"] = self.board.state()
        view["dataservice"] = self.leases.state()
        with self._lock:
            view["degraded"] = self.sentinel.degraded()
        # hosts whose clock-offset estimate went stale (probe age gauge over
        # threshold): their job_trace/job_timeseries alignment is suspect.
        # Hosts not publishing the gauge (older workers) are NOT flagged.
        view["clock_stale"] = [
            r for r, h in sorted(hosts.items())
            if h["snapshot"].get("gauges", {})
            .get("telemetry.clock_probe_age_s", 0) > self.CLOCK_STALE_S]
        return view

    def format_job_table(self, stale_s: float = 30.0) -> str:
        """Per-host bottleneck table, worst first, flagging stragglers.

        A host is flagged when its bound-stage busy share exceeds the fleet
        median for that stage by 1.5x and at least 10 points ("host 3
        shard-bound 91% vs fleet median 44%"), or when its last push is
        older than ``stale_s`` seconds.
        """
        view = self.job_snapshot()
        hosts: Dict[int, dict] = view["hosts"]  # type: ignore[assignment]
        if not hosts:
            return "(no worker telemetry yet)"
        # fleet median busy share per stage (same rule drives shard
        # handoff eligibility — see flagged_ranks)
        median = _stage_medians([h["attribution"] for h in hosts.values()])

        def share_of(item):
            attr = item[1]["attribution"]
            st = attr["bound_stage"]
            return attr["bound"].get(st, 0.0) if st else 0.0

        degraded = view.get("degraded", {})
        clock_stale = set(view.get("clock_stale", []))
        lines = ["rank  host             bound           busy_s   flags"]
        for rank, h in sorted(hosts.items(), key=share_of, reverse=True):
            attr = h["attribution"]
            st = attr["bound_stage"]
            share = attr["bound"].get(st, 0.0) if st else 0.0
            busy = sum(x["busy_s"] for x in attr["stages"].values())
            flags = []
            if st is not None:
                med = median.get(st, 0.0)
                if share >= 1.5 * med and share - med >= 10.0:
                    flags.append(f"straggler ({st}-bound {share:.0f}% vs "
                                 f"fleet median {med:.0f}%)")
            for stage, d in sorted(degraded.get(rank, {}).items()):
                flags.append(f"degraded ({stage} {d['rate']:.0f}/s vs "
                             f"baseline {d['baseline']:.0f}/s)")
            if rank in clock_stale:
                flags.append("clock-stale")
            if h["age_s"] > stale_s:
                flags.append(f"stale {h['age_s']:.0f}s")
            if h["restarted"]:
                flags.append("restarted")
            # retry-substrate health: a host fighting a flaky source shows
            # its lifetime retry/giveup/corruption totals here (.get —
            # pushes from older workers carry no "io" block)
            io = attr.get("io", {})
            if io.get("giveup"):
                flags.append(f"io-giveup {io['giveup']}")
            elif io.get("retry"):
                flags.append(f"io-retry {io['retry']}")
            if io.get("corrupt_skipped"):
                flags.append(f"corrupt {io['corrupt_skipped']}")
            bound = f"{st}-bound {share:.0f}%" if st else "-"
            lines.append(f"{rank:<6}{h['host']:<17}{bound:<16}"
                         f"{busy:>7.2f}   {'; '.join(flags)}".rstrip())
        # shard-board + data-service dispatch progress, newest epochs last,
        # so the table answers "where is the work" as well as "who is slow"
        for e, st in sorted(view["shards"].items(), key=lambda kv: int(kv[0])):
            lines.append(
                f"shards e{e}: {st['done']}/{st['shards']} done, "
                f"{st['pending']} pending, {len(st['stolen'])} stolen")
        ds = view["dataservice"]
        if ds["workers"]:
            alive = sum(1 for w in ds["workers"].values() if not w["dead"])
            lines.append(f"data-service: {alive}/{len(ds['workers'])} "
                         f"workers alive")
            for client, epochs in sorted(ds["leases"].items()):
                for e, lease in sorted(epochs.items(),
                                       key=lambda kv: int(kv[0])):
                    lines.append(
                        f"  lease {client} e{e}: {lease['done']}/"
                        f"{lease['shards']} done, {lease['pending']} pending,"
                        f" {len(lease['failovers'])} failovers")
        return "\n".join(lines)

    def provider(self) -> List[Tuple[Dict[str, str], dict]]:
        """``telemetry_http.serve`` provider: one labeled source per host."""
        with self._lock:
            hosts = {r: dict(h) for r, h in self._hosts.items()}
        return [({"rank": str(r), "host": h["host"]}, h["snapshot"])
                for r, h in sorted(hosts.items())]

    def board_provider(self) -> dict:
        """``telemetry_http.serve`` board_provider: lights up the tracker's
        ``/shards`` and ``/dataservice`` endpoints."""
        return {"shards": self.board.state(),
                "dataservice": self.leases.state()}

    def job_trace(self) -> dict:
        """Merge every host's shipped trace dump into one clock-aligned
        Chrome trace (the tracker's ``/jobtrace`` endpoint).

        Each host's spans keep their names/tids but get (a) ``pid`` set to
        the host's rank plus a ``process_name`` metadata event labeling it
        ``rank R host:pid``, and (b) timestamps shifted onto the tracker's
        steady clock by the host's NTP-style offset estimate (the
        ``telemetry.clock_offset_us`` gauge riding its snapshot:
        ``t_tracker = t_host + offset``).  Steady clocks of different
        processes have arbitrary epochs, so without the shift same-machine
        hosts land milliseconds-to-hours apart; with it a send span on one
        host orders before its receive span on another.  The tracker's own
        spans (when it traced anything) join as pid -1 with offset 0 —
        they already live on the reference clock.

        ``otherData`` carries the merge health row: per-rank span counts
        and offsets, and the largest absolute offset applied.
        """
        with self._lock:
            hosts = {r: dict(h) for r, h in self._hosts.items()}
        events: List[dict] = []
        offsets: Dict[str, int] = {}
        spans: Dict[str, int] = {}

        def add_process(pid: int, label: str, dump: dict, off: int) -> int:
            evs = dump.get("traceEvents", [])
            if not evs:
                return 0
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "args": {"name": label}})
            for ev in evs:
                e = dict(ev)
                e["pid"] = pid
                if "ts" in e:
                    e["ts"] = int(e["ts"]) + off
                events.append(e)
            return len(evs)

        for rank, h in sorted(hosts.items()):
            trace = h.get("trace")
            if not trace:
                continue
            off = int(h["snapshot"].get("gauges", {})
                      .get("telemetry.clock_offset_us", 0))
            n = add_process(rank, f"rank {rank} {h['host']}:{h['pid']}",
                            trace, off)
            if n:
                offsets[str(rank)] = off
                spans[str(rank)] = n
        n = add_process(-1, "tracker", telemetry.trace_dump(), 0)
        if n:
            offsets["tracker"] = 0
            spans["tracker"] = n
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "hosts": len(spans),
                "spans": sum(spans.values()),
                "spans_per_host": spans,
                "offsets_us": offsets,
                "max_abs_offset_us": max(
                    (abs(o) for o in offsets.values()), default=0),
                # ranks whose offset estimate went stale (probe age gauge
                # over CLOCK_STALE_S): their alignment is suspect
                "stale_clock_ranks": self._stale_clock_ranks(hosts),
            },
        }

    def _stale_clock_ranks(self, hosts: Dict[int, dict]) -> List[int]:
        return [r for r, h in sorted(hosts.items())
                if h["snapshot"].get("gauges", {})
                .get("telemetry.clock_probe_age_s", 0) > self.CLOCK_STALE_S]

    def job_timeseries(self) -> dict:
        """Merge every host's pushed time-series tail into one clock-aligned
        fleet view (the tracker's ``/jobtimeseries`` endpoint).

        Each host's series keep their fine/coarse point lists but every
        timestamp is shifted onto the tracker's steady clock by the host's
        NTP-style offset estimate (the ``telemetry.clock_offset_us`` gauge
        riding its snapshot), the same alignment as :meth:`job_trace` — so
        "rank 3's parse rate collapsed 400 ms before rank 0's h2d gauge
        spiked" reads off one time axis.  ``hosts`` maps rank -> the host's
        shifted document; ``offsets_us``/``stale_clock_ranks`` carry the
        merge-health row."""
        with self._lock:
            hosts = {r: dict(h) for r, h in self._hosts.items()}
        out_hosts: Dict[str, dict] = {}
        offsets: Dict[str, int] = {}
        for rank, h in sorted(hosts.items()):
            doc = h.get("timeseries")
            if not doc or not doc.get("series"):
                continue
            off = int(h["snapshot"].get("gauges", {})
                      .get("telemetry.clock_offset_us", 0))
            shifted = dict(doc)
            shifted["series"] = {
                name: {**s, **{ring: [[int(t) + off, v]
                                      for t, v in s.get(ring, [])]
                               for ring in ("fine", "coarse") if ring in s}}
                for name, s in doc["series"].items()}
            shifted["host"] = f"rank {rank} {h['host']}:{h['pid']}"
            out_hosts[str(rank)] = shifted
            offsets[str(rank)] = off
        return {
            "hosts": out_hosts,
            "num_hosts": len(out_hosts),
            "offsets_us": offsets,
            "max_abs_offset_us": max(
                (abs(o) for o in offsets.values()), default=0),
            "stale_clock_ranks": self._stale_clock_ranks(hosts),
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            # wakes the serve thread's accept(), which a close alone does
            # not on Linux
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self._thread.join(timeout=5)


# ---- worker side ------------------------------------------------------------

def push_once(tracker_uri: str, metrics_port: int, rank: int,
              restarted: bool = False, timeout: float = 10.0,
              clock: bool = False, trace: Optional[dict] = None,
              timeseries: Optional[dict] = None,
              ) -> Optional[Tuple[int, int]]:
    """Push one snapshot to the tracker (raises on connection failure —
    the periodic pusher catches, a deterministic test caller should see).

    With ``trace`` the payload ships that trace dump for the tracker's
    ``job_trace`` merge; with ``timeseries`` it ships the sampler's bounded
    tail for the ``job_timeseries`` merge.  With ``clock=True`` the push
    piggybacks one NTP-style probe after the ack — send a ping at local
    steady time t0, read the tracker's steady time, note local t1 — and
    returns ``(rtt_us, offset_us)`` where ``offset = t_tracker -
    (t0+t1)/2``, i.e. local time + offset = tracker time.  The estimate's
    error is bounded by rtt/2, which is why the pusher keeps the
    minimum-RTT probe."""
    body = {
        "rank": int(rank),
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "restarted": bool(restarted),
        "snapshot": telemetry.snapshot(),
    }
    if trace is not None:
        body["trace"] = trace
    if timeseries is not None:
        body["timeseries"] = timeseries
    if clock:
        body["clock"] = True
    payload = json.dumps(body)
    with socket.create_connection((tracker_uri, metrics_port),
                                  timeout=timeout) as sock:
        sock.settimeout(timeout)
        _write_int(sock, METRICS_MAGIC)
        if _read_int(sock) != METRICS_MAGIC:
            raise ConnectionError("metrics channel handshake failed")
        _write_str(sock, payload)
        if _read_int(sock) != 0:
            raise ConnectionError("tracker rejected metrics push")
        if clock:
            t0 = telemetry.now_us()
            _write_str(sock, "clock")
            t_tracker = int(_read_str(sock))
            t1 = telemetry.now_us()
            return (t1 - t0, t_tracker - (t0 + t1) // 2)
    return None


class ShardClient:
    """Worker-side handle on the tracker's shard board.

    Every call is one metrics push whose payload carries a ``shard_req``
    and reads the board's JSON reply after the ack — so each board
    interaction ALSO refreshes this worker's snapshot on the tracker, and
    the straggler flags that gate stealing are never staler than the last
    claim.
    """

    def __init__(self, tracker_uri: str, metrics_port: int, rank: int,
                 timeout: float = 10.0):
        self.tracker_uri = tracker_uri
        self.metrics_port = int(metrics_port)
        self.rank = int(rank)
        self.timeout = float(timeout)

    def _call(self, req: dict, key: str = "shard_req") -> dict:
        payload = json.dumps({
            "rank": self.rank,
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "restarted": False,
            "snapshot": telemetry.snapshot(),
            key: req,
        })
        with socket.create_connection((self.tracker_uri, self.metrics_port),
                                      timeout=self.timeout) as sock:
            sock.settimeout(self.timeout)
            _write_int(sock, METRICS_MAGIC)
            if _read_int(sock) != METRICS_MAGIC:
                raise ConnectionError("metrics channel handshake failed")
            _write_str(sock, payload)
            if _read_int(sock) != 0:
                raise ConnectionError("tracker rejected metrics push")
            return json.loads(_read_str(sock))

    def register(self, epoch: int, shards: List[int]) -> dict:
        return self._call({"op": "register", "epoch": int(epoch),
                           "shards": [int(s) for s in shards]})

    def claim(self, epoch: int, shard: int) -> bool:
        return bool(self._call({"op": "claim", "epoch": int(epoch),
                                "shard": int(shard)}).get("ok"))

    def steal(self, epoch: int) -> dict:
        return self._call({"op": "steal", "epoch": int(epoch)})

    def done(self, epoch: int, shard: int) -> dict:
        return self._call({"op": "done", "epoch": int(epoch),
                           "shard": int(shard)})

    def data_req(self, req: dict) -> dict:
        """One dispatcher RPC on the tracker's data-service LeaseBoard —
        same push+reply discipline as the shard ops, different ledger."""
        return self._call(req, key="dataservice_req")


def shard_client_from_env(rank: Optional[int] = None) -> Optional[ShardClient]:
    """A :class:`ShardClient` from the tracker env contract, or None when
    no metrics channel was negotiated (standalone runs)."""
    port = os.environ.get(METRICS_PORT_ENV)
    if not port:
        return None
    return ShardClient(
        tracker_uri=os.environ.get("DMLC_TRACKER_URI", "127.0.0.1"),
        metrics_port=int(port),
        rank=_env_rank() if rank is None else int(rank))


def coordinated_parts(epoch: int, shards: List[int], open_part,
                      client: Optional[ShardClient], steal: bool = True,
                      poll_s: float = 0.2):
    """Drive one worker's epoch through the tracker shard board.

    Yields whatever ``open_part(shard)`` yields, for (a) every owned shard
    the board confirms, then (b) shards stolen from flagged hosts until the
    epoch has no pending shards left.  With ``client=None`` (standalone)
    it degrades to plain in-order iteration.  The epoch's job-wide
    visitation is exactly-once by construction: every ``open_part`` call
    here follows a successful serialized claim/steal (see ShardBoard).
    """
    if client is None:
        for s in shards:
            yield from open_part(int(s))
        return
    client.register(epoch, shards)
    for s in shards:
        if not client.claim(epoch, int(s)):
            # handed off while this worker lagged; the thief parses it
            telemetry.counter_add("shard.claim_denied", 1)
            continue
        yield from open_part(int(s))
        client.done(epoch, int(s))
    if not steal:
        return
    while True:
        r = client.steal(epoch)
        s = r.get("shard")
        if s is not None:
            telemetry.counter_add("shard.steal_gained", 1)
            yield from open_part(int(s))
            client.done(epoch, int(s))
            continue
        if int(r.get("pending", 0)) <= 0:
            return  # every shard started somewhere; epoch complete
        time.sleep(poll_s)  # owners still mid-claim; poll for flags


class MetricsPusher:
    """Daemon thread pushing this process's snapshot every ``interval_s``.

    Push failures are tolerated (the tracker may not be up yet or may
    already be gone) but accounted: each one bumps :attr:`pushes_dropped`
    (mirrored into the ``tracker.pushes_dropped`` telemetry counter so the
    NEXT successful push reports the gap), and consecutive failures widen
    the loop's sleep with jitter — capped at 8 intervals — so a dead
    tracker costs a few connect attempts per minute, not a reconnect spin.
    A success snaps the cadence back to ``interval_s``.  Snapshots are
    cumulative, so any successful push repairs the tracker's view.

    A failure streak also re-reads the tracker address from the env
    contract: a tracker restarted by the launcher (restart-flags path)
    binds a NEW ephemeral metrics port and republishes it, and an address
    resolved once at construction would spin on the dead one forever.

    Every successful push also runs one NTP-style clock probe (see
    ``push_once``).  The pusher keeps a sliding window of recent probes and
    publishes the offset of the minimum-RTT one — the estimate whose error
    bound (rtt/2) is tightest — as :attr:`clock_offset_us` and the
    ``telemetry.clock_offset_us`` gauge.  The gauge rides the next
    snapshot push, which is how the tracker's ``job_trace`` merge learns
    each host's offset without a second channel.  When this process
    recorded a trace (``telemetry.trace_armed``), pushes also ship the
    trace dump for the merge.
    """

    # sliding probe window: long enough to ride out transient queueing
    # spikes, short enough that a real drift re-estimates within ~30s at
    # the default cadence
    CLOCK_WINDOW = 16

    # how many fine points of the sampler's rings ride each push: enough
    # tail for the tracker's merge to show the last ~half minute at the
    # default 1 s tick while keeping the payload bounded
    TIMESERIES_TAIL_POINTS = 30

    def __init__(self, tracker_uri: str, metrics_port: int, rank: int,
                 interval_s: float = 2.0):
        self.tracker_uri = tracker_uri
        self.metrics_port = int(metrics_port)
        self.rank = int(rank)
        self.interval_s = max(float(interval_s), 0.05)
        self.pushes_dropped = 0
        self.clock_offset_us: Optional[int] = None
        self._last_probe_wall: Optional[float] = None
        self._clock_probes: List[Tuple[int, int]] = []  # (rtt_us, offset_us)
        self._failure_streak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="dmlctpu-metrics-pusher", daemon=True)
        self._thread.start()

    def _next_delay(self) -> float:
        streak = self._failure_streak
        if streak <= 0:
            return self.interval_s
        backoff = min(self.interval_s * (2 ** min(streak, 3)),
                      8.0 * self.interval_s)
        return backoff * (0.75 + random.random() * 0.5)

    def _loop(self) -> None:
        while not self._stop.wait(self._next_delay()):
            self.push()

    def push(self) -> bool:
        """One immediate push (with clock probe + trace dump + time-series
        tail); True on success."""
        # publish the probe's age BEFORE the snapshot is captured so the
        # gauge rides THIS push — the tracker flags hosts whose offset
        # estimate went stale (tracker unreachable, probes failing)
        if self._last_probe_wall is not None:
            try:
                telemetry.gauge_set(
                    "telemetry.clock_probe_age_s",
                    int(time.time() - self._last_probe_wall))
            except Exception:  # telemetry compiled out or lib torn down
                pass
        try:
            ts_tail = None
            if telemetry.timeseries_active():
                ts_tail = telemetry.timeseries(self.TIMESERIES_TAIL_POINTS)
        except Exception:
            ts_tail = None
        try:
            probe = push_once(
                self.tracker_uri, self.metrics_port, self.rank, clock=True,
                trace=telemetry.trace_dump()
                if telemetry.trace_armed() else None,
                timeseries=ts_tail)
            if probe is not None:
                self._clock_update(probe)
                self._last_probe_wall = time.time()
            self._failure_streak = 0
            return True
        except (OSError, ConnectionError, ValueError):
            self._failure_streak += 1
            self.pushes_dropped += 1
            try:
                telemetry.counter_add("tracker.pushes_dropped", 1)
            except Exception:  # telemetry compiled out or lib torn down
                pass
            if self._failure_streak >= 2:
                self._re_resolve()
            return False

    def _clock_update(self, probe: Tuple[int, int]) -> None:
        """Fold one (rtt, offset) probe into the min-RTT estimate and
        publish it as the ``telemetry.clock_offset_us`` gauge."""
        self._clock_probes.append((int(probe[0]), int(probe[1])))
        if len(self._clock_probes) > self.CLOCK_WINDOW:
            self._clock_probes.pop(0)
        self.clock_offset_us = min(self._clock_probes)[1]
        try:
            telemetry.gauge_set("telemetry.clock_offset_us",
                                self.clock_offset_us)
        except Exception:  # telemetry compiled out or lib torn down
            pass

    def _re_resolve(self) -> None:
        """Pick up a restarted tracker's republished address from the env
        (no-op while the env still names the address we already use, or in
        standalone runs where the contract was never set)."""
        uri = os.environ.get("DMLC_TRACKER_URI")
        port = os.environ.get(METRICS_PORT_ENV, "")
        if uri and uri != self.tracker_uri:
            LOGGER.info("metrics pusher re-resolved tracker %s -> %s",
                        self.tracker_uri, uri)
            self.tracker_uri = uri
        if port.isdigit() and int(port) != self.metrics_port:
            LOGGER.info("metrics pusher re-resolved metrics port %d -> %s",
                        self.metrics_port, port)
            self.metrics_port = int(port)

    def close(self, final_push: bool = True) -> None:
        """Stop the thread; by default push one last snapshot so the tracker
        sees the epoch's final counters even with a long interval."""
        self._stop.set()
        self._thread.join(timeout=5)
        if final_push:
            self.push()


_pusher_lock = threading.Lock()
_pusher: Optional[MetricsPusher] = None


def _env_rank() -> int:
    for key in ("DMLC_WORKER_RANK", "DMLC_TASK_ID"):
        v = os.environ.get(key, "")
        if v.isdigit():
            return int(v)
    return 0


def ensure_pusher() -> Optional[MetricsPusher]:
    """Start (once) the process-wide pusher from the env contract, or None
    when ``DMLC_TRACKER_METRICS_PORT`` is unset.  The staging iterators call
    this so any worker launched under a tracker reports automatically."""
    global _pusher
    port = os.environ.get(METRICS_PORT_ENV)
    if not port:
        return None
    with _pusher_lock:
        if _pusher is None:
            _pusher = MetricsPusher(
                tracker_uri=os.environ.get("DMLC_TRACKER_URI", "127.0.0.1"),
                metrics_port=int(port),
                rank=_env_rank(),
                interval_s=float(
                    os.environ.get("DMLCTPU_METRICS_INTERVAL_S", "2.0")))
        return _pusher


def stop_pusher(final_push: bool = True) -> None:
    """Stop the process-wide pusher (test hygiene)."""
    global _pusher
    with _pusher_lock:
        p, _pusher = _pusher, None
    if p is not None:
        p.close(final_push=final_push)
