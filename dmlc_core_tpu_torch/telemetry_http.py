"""HTTP endpoint of a process's telemetry, a scoring server or a tracker
(stdlib only).

The port of ``dmlc_core_tpu.telemetry_http``, with the same paths, status
codes, content types and 404 text:

* ``/metrics`` — the registry in Prometheus text format: counters become
  ``dmlctpu_<name>_total``, gauges keep the bare name, histograms emit
  cumulative ``_bucket{le="2^i"}`` series plus ``_sum``/``_count``.
* ``/trace`` — the Chrome trace-event JSON buffered since ``trace_start()``.
* ``/flight`` — the most recent watchdog flight record, or a fresh one
  (``?fresh=1`` forces a fresh one).
* ``/snapshot`` — the raw registry snapshot JSON (what a pusher sends).
* ``/autotune`` — the tuner's state: armed flag, each tuner's knobs and
  progress, the bounded decision log.
* ``/timeseries`` — the sampler's bounded history rings; ``?points=N``
  keeps the newest N points of each ring.
* ``/healthz`` — cheap liveness: ``ok`` with no native call and no health
  gate consulted.
* ``/jobtrace``, ``/jobtimeseries`` — the tracker's clock-aligned merges
  of every worker's trace and time-series tail; tracker endpoints only
  (a ``trace_provider`` / ``timeseries_provider`` must be attached).
* ``/shards``, ``/dataservice`` — the tracker's shard board and lease
  board; tracker endpoints only (a ``board_provider``).
* ``POST /score`` — online scoring through the attached ``score_provider``
  (a ``ScoringServer``'s).  With a ``health_gate`` attached, ``/score``
  and ``/metrics`` answer 503 + Retry-After while a snapshot swap is
  mid-flight or before the first model loads, instead of hanging.

A tracker passes a ``provider`` returning ``(labels, snapshot)`` pairs so
job-wide metrics come out as one exposition with a label per worker.  Bind
with ``port=0`` to let the OS pick (the port is on the returned handle).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import urlparse

from . import telemetry

__all__ = ["serve", "TelemetryServer", "prometheus_text"]

# provider: () -> [(labels, snapshot_dict), ...]
Provider = Callable[[], List[Tuple[Dict[str, str], dict]]]
# board provider: () -> {"shards": {...}, "dataservice": {...}}
BoardProvider = Callable[[], dict]
# score provider: (request body) -> (status, body, content type); serving
# endpoints attach one to light up POST /score
ScoreProvider = Callable[[bytes], Tuple[int, str, str]]
# health gate: () -> None when healthy, else a reason string; /score and
# /metrics answer 503 + Retry-After with the reason instead of hanging
# (snapshot swap mid-flight, no model loaded yet)
HealthGate = Callable[[], Optional[str]]
# trace provider: () -> merged Chrome-trace dict; tracker endpoints attach
# MetricsAggregator.job_trace to light up /jobtrace
TraceProvider = Callable[[], dict]
# timeseries provider: () -> merged clock-aligned time-series dict; tracker
# endpoints attach MetricsAggregator.job_timeseries to light up
# /jobtimeseries
TimeseriesProvider = Callable[[], dict]


def _sanitize(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    base = "".join(out)
    return base if not base or not base[0].isdigit() else "_" + base


def _labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (_sanitize(k),
                     str(v).replace("\\", "\\\\").replace('"', '\\"')
                     .replace("\n", "\\n"))
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _merge_label(labels: Dict[str, str], extra: Dict[str, str]) -> Dict[str, str]:
    out = dict(labels)
    out.update(extra)
    return out


def prometheus_text(sources: List[Tuple[Dict[str, str], dict]]) -> str:
    """Render ``(labels, snapshot)`` pairs as one Prometheus exposition.

    Every metric name is prefixed ``dmlctpu_``; a ``# HELP``/``# TYPE``
    header is emitted once per family even when several label sets share
    it (the format requires families to be contiguous)."""
    families: Dict[str, List[str]] = {}
    types: Dict[str, str] = {}

    def add(family: str, mtype: str, line: str) -> None:
        families.setdefault(family, []).append(line)
        types[family] = mtype

    for labels, snap in sources:
        for name, v in sorted(snap.get("counters", {}).items()):
            fam = "dmlctpu_" + _sanitize(name) + "_total"
            add(fam, "counter", f"{fam}{_labels(labels)} {v}")
        for name, v in sorted(snap.get("gauges", {}).items()):
            fam = "dmlctpu_" + _sanitize(name)
            add(fam, "gauge", f"{fam}{_labels(labels)} {v}")
        for name, h in sorted(snap.get("histograms", {}).items()):
            fam = "dmlctpu_" + _sanitize(name)
            buckets = h.get("buckets", [])
            cum = 0
            lines = []
            for i, n in enumerate(buckets):
                cum += n
                le = "+Inf" if i == len(buckets) - 1 else str(2 ** i)
                lab = _labels(_merge_label(labels, {"le": le}))
                lines.append(f"{fam}_bucket{lab} {cum}")
            lines.append(f"{fam}_sum{_labels(labels)} {h.get('sum', 0)}")
            # _count must equal the +Inf bucket exactly; the snapshot's own
            # count field is a separate atomic that can race the bucket
            # reads, so derive the count from the buckets we just rendered
            lines.append(f"{fam}_count{_labels(labels)} {cum}")
            for line in lines:
                add(fam, "histogram", line)

    out = []
    for fam in sorted(families):
        # classic text format: the TYPE name matches the sample name for
        # counters/gauges (counters keep _total) and the family base for
        # histograms (samples append _bucket/_sum/_count)
        out.append(f"# HELP {fam} dmlctpu pipeline metric "
                   f"(see doc/observability.md)")
        out.append(f"# TYPE {fam} {types[fam]}")
        out.extend(families[fam])
    return "\n".join(out) + "\n"


def _local_provider() -> List[Tuple[Dict[str, str], dict]]:
    return [({}, telemetry.snapshot())]


class _Handler(BaseHTTPRequestHandler):
    server_version = "dmlctpu-torch-telemetry/0.1"

    def log_message(self, *args):  # no stderr chatter from the scrape loop
        pass

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    # bounded per-write chunk for large bodies (a long trace runs to
    # hundreds of MB; one giant sendall both doubles peak memory in the
    # socket layer and starves the other handler threads)
    _CHUNK = 1 << 20

    def _send_large(self, code: int, body: str, ctype: str) -> None:
        """Like ``_send`` but streams the body out in bounded chunks."""
        data = memoryview(body.encode())
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        for off in range(0, len(data), self._CHUNK):
            self.wfile.write(data[off:off + self._CHUNK])

    def _gated(self) -> bool:
        """503 the request when the server's health gate objects (swap in
        flight / no model loaded).  Returns True when the 503 was sent."""
        gate = getattr(self.server, "health_gate", None)
        reason = gate() if gate is not None else None
        if reason is None:
            return False
        self.send_response(503)
        self.send_header("Retry-After", "1")
        body = f"unavailable: {reason}\n".encode()
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        return True

    def do_POST(self):  # noqa: N802 (http.server contract)
        try:
            url = urlparse(self.path)
            if url.path != "/score":
                self._send(404, "not found: POST /score\n", "text/plain")
                return
            sp = getattr(self.server, "score_provider", None)
            if sp is None:
                self._send(404, "no scoring engine on this endpoint "
                           "(telemetry-only server? a ScoringServer "
                           "serves /score)\n", "text/plain")
                return
            if self._gated():
                return
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b""
            code, text, ctype = sp(body)
            self._send(code, text, ctype)
        except Exception as exc:  # a request must never kill the server
            try:
                self._send(500, f"error: {exc}\n", "text/plain")
            except OSError:
                pass

    def do_GET(self):  # noqa: N802 (http.server contract)
        try:
            url = urlparse(self.path)
            if url.path in ("/metrics", "/metrics/"):
                if self._gated():
                    return
                text = prometheus_text(self.server.provider())
                self._send(200, text, "text/plain; version=0.0.4")
            elif url.path == "/healthz":
                # liveness must stay cheap and ungated: no registry lock,
                # no native call, no health gate — it answers "is the
                # process serving" even while /metrics answers 503
                self._send(200, "ok\n", "text/plain")
            elif url.path == "/trace":
                self._send_large(200, telemetry.trace_dump_json(),
                                 "application/json")
            elif url.path == "/jobtrace":
                tp = getattr(self.server, "trace_provider", None)
                if tp is None:
                    self._send(404, "no job-trace merge on this endpoint "
                               "(worker process? the tracker serves "
                               "/jobtrace; per-process spans are at "
                               "/trace)\n", "text/plain")
                else:
                    self._send_large(200, json.dumps(tp()),
                                     "application/json")
            elif url.path == "/timeseries":
                points = 0
                for part in (url.query or "").split("&"):
                    if part.startswith("points="):
                        try:
                            points = int(part[len("points="):])
                        except ValueError:
                            points = 0
                raw = (telemetry.timeseries_tail_json(points) if points > 0
                       else telemetry.timeseries_json())
                self._send_large(200, raw, "application/json")
            elif url.path == "/jobtimeseries":
                tsp = getattr(self.server, "timeseries_provider", None)
                if tsp is None:
                    self._send(404, "no job time-series merge on this "
                               "endpoint (worker process? the tracker "
                               "serves /jobtimeseries; per-process rings "
                               "are at /timeseries)\n", "text/plain")
                else:
                    self._send_large(200, json.dumps(tsp()),
                                     "application/json")
            elif url.path == "/flight":
                rec = None
                if "fresh=1" not in (url.query or ""):
                    rec = telemetry.last_flight_record()
                if rec is None:
                    rec = telemetry.flight_record("http request")
                self._send(200, json.dumps(rec), "application/json")
            elif url.path == "/snapshot":
                self._send(200, json.dumps(telemetry.snapshot()),
                           "application/json")
            elif url.path == "/autotune":
                from . import autotune  # lazy: most servers never need it
                self._send(200, json.dumps(autotune.state()),
                           "application/json")
            elif url.path in ("/shards", "/dataservice"):
                bp = getattr(self.server, "board_provider", None)
                if bp is None:
                    self._send(404, "no dispatch board on this endpoint "
                               "(worker process? the tracker serves "
                               "/shards and /dataservice)\n", "text/plain")
                else:
                    boards = bp()
                    self._send(200, json.dumps(boards.get(url.path[1:], {})),
                               "application/json")
            else:
                self._send(404, "not found: try /metrics /trace /jobtrace "
                           "/timeseries /jobtimeseries /flight /snapshot "
                           "/autotune /shards /dataservice /healthz\n",
                           "text/plain")
        except Exception as exc:  # a scrape must never kill the server
            try:
                self._send(500, f"error: {exc}\n", "text/plain")
            except OSError:
                pass


class TelemetryServer:
    """Handle for a running export endpoint; ``close()`` releases the port."""

    def __init__(self, host: str, port: int,
                 provider: Optional[Provider] = None,
                 board_provider: Optional[BoardProvider] = None,
                 score_provider: Optional[ScoreProvider] = None,
                 health_gate: Optional[HealthGate] = None,
                 trace_provider: Optional[TraceProvider] = None,
                 timeseries_provider: Optional[TimeseriesProvider] = None):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.provider = provider or _local_provider
        self._httpd.board_provider = board_provider
        self._httpd.score_provider = score_provider
        self._httpd.health_gate = health_gate
        self._httpd.trace_provider = trace_provider
        self._httpd.timeseries_provider = timeseries_provider
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="dmlctpu-telemetry-http",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "TelemetryServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve(port: int = 0, host: str = "127.0.0.1",
          provider: Optional[Provider] = None,
          board_provider: Optional[BoardProvider] = None,
          score_provider: Optional[ScoreProvider] = None,
          health_gate: Optional[HealthGate] = None,
          trace_provider: Optional[TraceProvider] = None,
          timeseries_provider: Optional[TimeseriesProvider] = None,
          ) -> TelemetryServer:
    """Start the endpoint on a daemon thread and return its handle.
    ``port=0`` binds an ephemeral port (read it back via ``.port``).
    ``board_provider`` (tracker endpoints) lights up ``/shards`` and
    ``/dataservice`` — pass ``MetricsAggregator.board_provider``.
    ``score_provider``/``health_gate`` (serving endpoints) light up
    ``POST /score`` and the 503-on-swap contract — a ScoringServer
    passes its own.  ``trace_provider`` (tracker
    endpoints) lights up ``/jobtrace`` — pass
    ``MetricsAggregator.job_trace``; ``timeseries_provider`` likewise
    lights up ``/jobtimeseries`` — pass
    ``MetricsAggregator.job_timeseries``."""
    return TelemetryServer(host, port, provider, board_provider,
                           score_provider, health_gate, trace_provider,
                           timeseries_provider)
