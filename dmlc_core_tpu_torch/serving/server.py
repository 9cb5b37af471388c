"""ScoringServer — /score next to /metrics, hot-swapped snapshots.

Two listeners share one process:

* the **snapshot channel** speaks the 0xff9a wire (dataservice/protocol):
  a training job connects, handshakes, sends ``{"op": "push_snapshot",
  "digest": ..., "seq": n}`` and one FRAME_SNAPSHOT payload frame.  The
  server recomputes the digest over the received bytes — a torn or
  corrupted push (``serving.snapshot.drop`` fault point) is rejected with
  the old model still serving — then builds a fresh ScoringEngine on its
  device and swaps ONE pointer.  In-flight micro-batches captured the old
  engine reference and finish on it.
* the **HTTP endpoint** serves ``POST /score`` with a health gate: while a
  swap is mid-flight or before the first snapshot lands, ``/score`` and
  ``/metrics`` answer 503 immediately instead of hanging.

``python -m dmlc_core_tpu_torch.serving.server`` runs a standalone server
and prints ``SCORING_READY <snap_port> <http_port>`` once both listeners
are bound.
"""
from __future__ import annotations

import json
import os
import socket
import threading
from typing import List, Optional, Tuple

from .. import faultinject, telemetry, telemetry_http
from .._device import resolve_device
from ..dataservice import protocol
from .engine import ScoringEngine
from .queue import MicroBatchQueue
from .snapshot import snapshot_digest

#: /score request validation bounds (malformed beyond these -> 400)
MAX_ROWS_PER_REQUEST = 1024
MAX_NNZ_PER_ROW = 1 << 20


def _validate_rows(doc) -> List[Tuple[list, list, Optional[list]]]:
    """Parse+validate a /score JSON body -> packed request rows; raises
    ValueError on anything malformed (the 400 path — the queue is never
    touched)."""
    if not isinstance(doc, dict) or "rows" not in doc:
        raise ValueError("body must be a JSON object with a 'rows' list")
    rows = doc["rows"]
    if not isinstance(rows, list) or not rows:
        raise ValueError("'rows' must be a non-empty list")
    if len(rows) > MAX_ROWS_PER_REQUEST:
        raise ValueError(f"{len(rows)} rows exceed the per-request cap "
                         f"{MAX_ROWS_PER_REQUEST}")
    out = []
    for i, row in enumerate(rows):
        if not isinstance(row, dict):
            raise ValueError(f"rows[{i}] must be an object")
        idx = row.get("index")
        val = row.get("value")
        if not isinstance(idx, list) or not isinstance(val, list):
            raise ValueError(f"rows[{i}] needs 'index' and 'value' lists")
        if len(idx) != len(val):
            raise ValueError(f"rows[{i}]: {len(idx)} indices vs "
                             f"{len(val)} values")
        if len(idx) > MAX_NNZ_PER_ROW:
            raise ValueError(f"rows[{i}]: too many nonzeros")
        if not all(isinstance(j, int) and 0 <= j < 1 << 31 for j in idx):
            raise ValueError(f"rows[{i}]: indices must be ints in "
                             "[0, 2^31)")
        if not all(isinstance(v, (int, float)) for v in val):
            raise ValueError(f"rows[{i}]: values must be numbers")
        fld = row.get("field")
        if fld is not None and (not isinstance(fld, list)
                                or len(fld) != len(idx)):
            raise ValueError(f"rows[{i}]: 'field' must match 'index'")
        out.append((idx, val, fld))
    return out


class ScoringServer:
    """Serve scores over HTTP with hot-swapped model snapshots, scoring on
    ``device`` (the card unless the caller asks for the CPU).  A server for
    ``ffm`` snapshots takes ``with_field=True``: each ``/score`` row then
    carries a ``"field"`` list beside ``"index"`` and ``"value"``."""

    def __init__(self, host: Optional[str] = None,
                 port: Optional[int] = None,
                 http_port: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 max_delay_us: Optional[int] = None,
                 adaptive: Optional[bool] = None,
                 with_field: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        self.host = host if host is not None \
            else os.environ.get("DMLCTPU_SERVE_HOST", "127.0.0.1")
        snap_port = port if port is not None \
            else int(os.environ.get("DMLCTPU_SERVE_PORT", "0"))
        hp = http_port if http_port is not None \
            else int(os.environ.get("DMLCTPU_SERVE_HTTP_PORT", "0"))
        self._engine: Optional[ScoringEngine] = None
        self._swapping = False
        self._swap_lock = threading.Lock()
        self.queue = MicroBatchQueue(lambda: self._engine,
                                     max_batch=max_batch,
                                     max_delay_us=max_delay_us,
                                     adaptive=adaptive,
                                     with_field=with_field,
                                     device=self.device)
        # snapshot channel (0xff9a)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, snap_port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._closing = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="dmlctpu-serve-snap", daemon=True)
        self._accept_thread.start()
        self.http = telemetry_http.serve(
            port=hp, host=self.host,
            score_provider=self._handle_score,
            health_gate=self._health_gate)
        self.http_port = self.http.port

    # ---- health gate (503 contract) -------------------------------------
    def _health_gate(self) -> Optional[str]:
        if self._swapping:
            return "snapshot swap in flight"
        if self._engine is None:
            return "no model loaded yet"
        return None

    # ---- /score ----------------------------------------------------------
    def _handle_score(self, body: bytes) -> Tuple[int, str, str]:
        try:
            mode = faultinject.fire("serving.request.malformed")
            if mode:
                raise ValueError("fault injected: "
                                 f"{faultinject.MODE_NAMES.get(mode)}")
            doc = json.loads(body.decode())
            rows = _validate_rows(doc)
        except Exception as exc:  # anything malformed is the 400 path
            telemetry.counter_add("serve.malformed", 1)
            return (400, json.dumps({"error": f"malformed request: {exc}"}),
                    "application/json")
        # a request may carry its caller's trace context ({"trace": {...}}
        # beside "rows"); restore the previous context on the way out
        prev = telemetry.get_trace_context()
        adopted = telemetry.adopt_trace_context(doc.get("trace"))
        try:
            with telemetry.span("serve.request"):
                fut = self.queue.submit(rows)
                try:
                    scores, digest, seq = fut.result(timeout=30)
                except Exception as exc:  # scoring failed: the 500 path
                    return (500, json.dumps({"error": str(exc)}),
                            "application/json")
            return (200, json.dumps({
                "scores": [float(s) for s in scores.reshape(-1)],
                "model": digest, "seq": seq}), "application/json")
        finally:
            if adopted:
                telemetry.set_trace_context(*prev)

    # ---- snapshot channel ------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                conn.settimeout(30)
                protocol.server_handshake(conn)
                req = protocol.read_req(conn)
                if req.get("op") != "push_snapshot":
                    protocol.send_req(conn, {"ok": False,
                                             "error": "unknown op"})
                    return
                kind, payload = protocol.read_frame(conn)
                if kind != protocol.FRAME_SNAPSHOT:
                    protocol.send_req(conn, {"ok": False,
                                             "error": f"bad frame {kind}"})
                    return
                prev = telemetry.get_trace_context()
                adopted = telemetry.adopt_trace_context(req.get("trace"))
                try:
                    with telemetry.span("serve.snapshot_apply"):
                        verdict = self._apply_snapshot(
                            bytes(payload), req.get("digest", ""),
                            int(req.get("seq", 0)))
                finally:
                    if adopted:
                        telemetry.set_trace_context(*prev)
                protocol.send_req(conn, verdict)
        except (OSError, ValueError, TypeError):
            pass  # a dying or garbled pusher must not take the server down

    def _apply_snapshot(self, payload: bytes, digest: str,
                        seq: int) -> dict:
        if faultinject.fire("serving.snapshot.drop"):
            # simulate the torn push the digest check exists for: flip one
            # byte so the content no longer matches the announced digest
            payload = bytes(payload[:-1]) + bytes([payload[-1] ^ 0xFF])
        got = snapshot_digest(payload)
        if digest and got != digest:
            telemetry.counter_add("serve.swap_rejected", 1)
            return {"ok": False,
                    "error": f"digest mismatch: got {got}, want {digest} "
                             "(torn push?); keeping current model"}
        try:
            with self._swap_lock:
                self._swapping = True
                try:
                    engine = ScoringEngine.from_snapshot_bytes(
                        payload, seq=seq, device=self.device)
                    self._engine = engine  # THE swap: one atomic rebind
                finally:
                    self._swapping = False
        except Exception as exc:  # any bad snapshot keeps the old model
            telemetry.counter_add("serve.swap_rejected", 1)
            return {"ok": False, "error": f"snapshot rejected: {exc}"}
        telemetry.counter_add("serve.swaps", 1)
        telemetry.gauge_set("serve.model_seq", seq)
        return {"ok": True, "digest": got, "seq": seq}

    def close(self) -> None:
        self._closing = True
        try:
            self._sock.close()
        except OSError:
            pass
        self.queue.close()
        self.http.close()

    def __enter__(self) -> "ScoringServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def push_snapshot(host: str, port: int, payload: bytes,
                  digest: Optional[str] = None, seq: int = 0,
                  timeout: float = 30.0) -> dict:
    """Training-side helper: push one packed snapshot to a ScoringServer
    over the 0xff9a channel; returns the server's JSON verdict."""
    if digest is None:
        digest = snapshot_digest(payload)
    req = {"op": "push_snapshot", "digest": digest, "seq": int(seq)}
    ctx = telemetry.trace_context_wire()
    if ctx is not None:
        req["trace"] = ctx
    with socket.create_connection((host, port), timeout=timeout) as sock:
        protocol.client_handshake(sock)
        protocol.send_req(sock, req)
        protocol.write_frame(sock, protocol.FRAME_SNAPSHOT, payload)
        return protocol.read_req(sock)


def main() -> None:
    import argparse
    p = argparse.ArgumentParser(
        description="dmlc_core_tpu_torch scoring server")
    p.add_argument("--host", default=None)
    p.add_argument("--port", type=int, default=None,
                   help="snapshot-push port (0 = ephemeral)")
    p.add_argument("--http-port", type=int, default=None,
                   help="HTTP /score port (0 = ephemeral)")
    p.add_argument("--device", default="cuda",
                   help="torch device to score on (default: cuda)")
    args = p.parse_args()
    srv = ScoringServer(host=args.host, port=args.port,
                        http_port=args.http_port, device=args.device)
    print(f"SCORING_READY {srv.port} {srv.http_port}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.close()


if __name__ == "__main__":
    main()
