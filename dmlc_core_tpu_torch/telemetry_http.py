"""HTTP endpoint of a scoring server (stdlib only).

* ``POST /score`` — online scoring through the attached ``score_provider``.
* ``/metrics`` — the native registry in Prometheus text format: counters
  become ``dmlctpu_<name>_total``, gauges keep the bare name, histograms
  emit cumulative ``_bucket{le="2^i"}`` series plus ``_sum``/``_count``.
* ``/healthz`` — cheap liveness: ``ok`` with no native call and no health
  gate consulted.

With a ``health_gate`` attached, ``/score`` and ``/metrics`` answer 503 +
Retry-After while a snapshot swap is mid-flight or before the first model
loads, instead of hanging.  Bind with ``port=0`` to let the OS pick.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import urlparse

from . import telemetry

# score provider: (request body) -> (status, body, content type)
ScoreProvider = Callable[[bytes], Tuple[int, str, str]]
# health gate: () -> None when healthy, else a reason string
HealthGate = Callable[[], Optional[str]]


def _sanitize(name: str) -> str:
    base = "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in name)
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


def prometheus_text(sources: List[Tuple[Dict[str, str], dict]]) -> str:
    """Render ``(labels, snapshot)`` pairs as one Prometheus exposition
    (every name prefixed ``dmlctpu_``, one HELP/TYPE header a family)."""
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
            cum = 0
            for i, n in enumerate(h.get("buckets", [])):
                cum += n
                le = "+Inf" if i == len(h["buckets"]) - 1 else str(2 ** i)
                add(fam, "histogram",
                    f"{fam}_bucket{_labels({**labels, 'le': le})} {cum}")
            add(fam, "histogram",
                f"{fam}_sum{_labels(labels)} {h.get('sum', 0)}")
            # _count must equal the +Inf bucket exactly: derive it from the
            # buckets just rendered, not from the racing count field
            add(fam, "histogram", f"{fam}_count{_labels(labels)} {cum}")
    out = []
    for fam in sorted(families):
        out.append(f"# HELP {fam} dmlctpu pipeline metric")
        out.append(f"# TYPE {fam} {types[fam]}")
        out.extend(families[fam])
    return "\n".join(out) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "dmlctpu-torch-serving/0.1"

    def log_message(self, *args):  # no stderr chatter from the scrape loop
        pass

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _gated(self) -> bool:
        """503 the request when the health gate objects; True if sent."""
        gate = self.server.health_gate
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
            if urlparse(self.path).path != "/score":
                self._send(404, "not found: POST /score\n", "text/plain")
                return
            sp = self.server.score_provider
            if sp is None:
                self._send(404, "no scoring engine on this endpoint\n",
                           "text/plain")
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
            path = urlparse(self.path).path
            if path in ("/metrics", "/metrics/"):
                if self._gated():
                    return
                text = prometheus_text([({}, telemetry.snapshot())])
                self._send(200, text, "text/plain; version=0.0.4")
            elif path == "/healthz":
                self._send(200, "ok\n", "text/plain")
            else:
                self._send(404, "not found: try /metrics /healthz or "
                           "POST /score\n", "text/plain")
        except Exception as exc:  # a scrape must never kill the server
            try:
                self._send(500, f"error: {exc}\n", "text/plain")
            except OSError:
                pass


class TelemetryServer:
    """Handle for a running endpoint; ``close()`` releases the port."""

    def __init__(self, host: str, port: int,
                 score_provider: Optional[ScoreProvider] = None,
                 health_gate: Optional[HealthGate] = None):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.score_provider = score_provider
        self._httpd.health_gate = health_gate
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="dmlctpu-serve-http",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def serve(port: int = 0, host: str = "127.0.0.1",
          score_provider: Optional[ScoreProvider] = None,
          health_gate: Optional[HealthGate] = None) -> TelemetryServer:
    """Start the endpoint on a daemon thread and return its handle."""
    return TelemetryServer(host, port, score_provider, health_gate)
