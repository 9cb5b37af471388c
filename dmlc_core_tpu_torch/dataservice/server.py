"""Staging worker: the serving half of the data service.

The port of ``dmlc_core_tpu.dataservice.server``, on the same wire.  One
worker holds a registry of **served datasets** keyed by the client's
dataset spec (uri, binner settings, batch geometry).  The first request for
a spec builds its binned epoch cache (text parse, quantile sketch, native
bin and write) exactly once; every later fetch, from any client, streams
the stored blocks straight from the cache's mmap view.  Specs without a
binner are served by the text path: the worker parses and packs one
virtual part a fetch and ships the packed batches through the staged-batch
wire codec.

Workers register with the tracker's lease board over the 0xff98 metrics
channel, send heartbeats, and ``close()`` drains (their leases go back to
the survivors).  A worker killed outright is found by the client's failed
fetch (``lease_fail``); either way the epoch completes on the rest of the
fleet with every part served once.

The worker builds its binner and cache on ``device`` (the card unless the
caller asks for the CPU: a worker host without a card passes
``--device cpu``, or ``DMLCTPU_DATASERVICE_DEVICE=cpu`` in the env a
launcher hands it).  Run one with::

    python -m dmlc_core_tpu_torch.dataservice.server [--device cpu]

under a tracker's env contract (it prints ``DATASERVICE_READY host:port``),
or let ``dmlc_submit --data-service N`` spawn the fleet beside the job.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import logging
import os
import socket
import threading
import time
from pathlib import Path
from typing import Dict, Optional

from .. import telemetry
from .._device import resolve_device
from .._native import StagedBatchOwnedC, check, lib
from ..tracker import metrics as tracker_metrics
from . import protocol

LOGGER = logging.getLogger(__name__)

PORT_ENV = "DMLCTPU_DATASERVICE_PORT"
HOST_ENV = "DMLCTPU_DATASERVICE_HOST"
CACHE_DIR_ENV = "DMLCTPU_DATASERVICE_CACHE_DIR"
DEVICE_ENV = "DMLCTPU_DATASERVICE_DEVICE"


def spec_key(spec: dict) -> str:
    """Stable digest of a dataset spec: the registry key and the cache
    file's name, so equal specs share one cache (the JAX package's digest,
    so workers of both packages sharing a directory share its files).
    ``codec`` (absent: raw) is part of the key: clients asking for caches
    compressed differently must not share one file."""
    canon_dict = {k: spec.get(k) for k in ("uri", "format", "batch_size",
                                           "nnz_bucket", "nnz_max",
                                           "with_qid", "binner")}
    canon_dict["codec"] = spec.get("codec") or "raw"
    canon = json.dumps(canon_dict, sort_keys=True)
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


class _TokenBucket:
    """Outbound bandwidth pacer: every sent payload is charged against one
    MB/s budget (50 ms of burst), so a loopback fetch behaves like a capped
    link.  ``DMLCTPU_DATASERVICE_THROTTLE_MBPS`` turns it on."""

    def __init__(self, mbps: float):
        self._rate = float(mbps) * 1e6
        self._cap = max(self._rate * 0.05, float(1 << 16))
        self._tokens = self._cap
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def charge(self, nbytes: int) -> None:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self._cap,
                               self._tokens + (now - self._t) * self._rate)
            self._t = now
            self._tokens -= nbytes
            if self._tokens < 0:
                # pay the debt before the next send; holding the lock
                # serializes every sender on the one simulated link
                time.sleep(-self._tokens / self._rate)
                self._t = time.monotonic()
                self._tokens = 0.0


_THROTTLES: Dict[str, _TokenBucket] = {}
_THROTTLES_LOCK = threading.Lock()


def _throttle() -> Optional[_TokenBucket]:
    mbps = os.environ.get("DMLCTPU_DATASERVICE_THROTTLE_MBPS", "")
    if not mbps or float(mbps) <= 0:
        return None
    with _THROTTLES_LOCK:
        tb = _THROTTLES.get(mbps)
        if tb is None:
            tb = _THROTTLES[mbps] = _TokenBucket(float(mbps))
        return tb


class _ServedDataset:
    """One spec's serving state: the cache (built at most once, under the
    lock) or the text path's virtual part count."""

    def __init__(self, spec: dict, cache_dir: Path, device):
        self.spec = dict(spec)
        self.device = device
        self.lock = threading.Lock()
        self.binned = spec.get("binner") is not None
        self.cache_path = str(cache_dir / (spec_key(spec) + ".bincache"))
        self._iter = None          # BinnedStagingIter, binned mode
        self._virtual_parts = 0    # staged mode
        # idle cache readers, reused across fetches: opening one validates
        # the file, which costs more than sending a part
        self._readers: list = []
        self._readers_lock = threading.Lock()

    def ensure(self) -> dict:
        """Build once, then describe: the meta reply for this spec (the
        cache's meta and part sizes on the binned path, the virtual part
        count on the staged path)."""
        from ..data.binned_cache import BinnedStagingIter
        from ..data.staging import _pick_virtual_parts, source_total_bytes
        spec = self.spec
        fmt = spec.get("format", "auto")
        with self.lock:
            if self.binned:
                if self._iter is None:
                    from ..models import QuantileBinner
                    b = spec["binner"]
                    binner = QuantileBinner(
                        num_bins=int(b["num_bins"]),
                        missing_aware=bool(b["missing_aware"]),
                        sketch_size=int(b["sketch_size"]),
                        sketch_seed=int(b["sketch_seed"]),
                        device=self.device)
                    it = BinnedStagingIter(
                        spec["uri"], binner, cache=self.cache_path,
                        batch_size=int(spec["batch_size"]),
                        nnz_bucket=int(spec["nnz_bucket"]),
                        nnz_max=int(spec.get("nnz_max", 0)), format=fmt,
                        with_qid=bool(spec.get("with_qid", False)),
                        codec=spec.get("codec", "raw"), device=self.device)
                    it.ensure_cache()
                    if it.served_from_text:
                        raise RuntimeError(
                            "staging worker could not build the bin cache; "
                            "ask for the staged (text) mode instead")
                    self._iter = it
                it = self._iter
                return {"ok": True, "meta": it.meta,
                        "parts": {str(g): int(e["records"])
                                  for g, e in sorted(it._part_map.items())}}
            if not self._virtual_parts:
                total = source_total_bytes(
                    spec["uri"], "recordio" if fmt == "recordio" else "text")
                self._virtual_parts = _pick_virtual_parts(total, 1)
            return {"ok": True, "virtual_parts": self._virtual_parts}

    def serve_fetch(self, sock: socket.socket, part: int) -> None:
        if self.binned:
            self._serve_blocks(sock, part)
        else:
            self._serve_staged(sock, part)

    def _serve_blocks(self, sock: socket.socket, part: int) -> None:
        """Stream one global virtual part's cache blocks exactly as stored,
        from the reader's mmap view into ``sendall`` with no copy.

        ``set_decode(False)``: compressed records stay compressed on the
        wire and the client decodes them, so the codec's saving survives
        the hop and the worker spends no decode time serving."""
        from ..data.binned_cache import _NativeReader
        ent = self._iter._part_map.get(int(part))
        tb = _throttle()
        sent = 0
        if ent is not None:
            with self._readers_lock:
                r = self._readers.pop() if self._readers else None
            if r is None:
                r = _NativeReader(self.cache_path)
                r.set_decode(False)
            try:
                r.seek_to(int(ent["offset"]))
                for _ in range(int(ent["records"])):
                    buf = r.next_block_view()
                    if buf is None:
                        break
                    if tb is not None:
                        tb.charge(int(buf.nbytes) + 12)
                    protocol.write_frame(sock, protocol.FRAME_BLOCK,
                                         memoryview(buf))
                    sent += 1
                    telemetry.counter_add("dataservice.serve_blocks", 1)
                    telemetry.counter_add("dataservice.serve_bytes",
                                          int(buf.nbytes))
            except BaseException:
                # a borrowed view pins the mapping, so closing is safe even
                # while a view is still referenced
                r.close()
                raise
            with self._readers_lock:
                self._readers.append(r)  # the next fetch seeks it again
        protocol.write_json_frame(sock, protocol.FRAME_END, {"blocks": sent})

    def _serve_staged(self, sock: socket.socket, part: int) -> None:
        """The text path: parse and pack one global virtual part with the
        native batcher and ship each owned batch through the wire codec."""
        spec = self.spec
        L = lib()
        h = ctypes.c_void_p()
        fmt = spec.get("format", "auto")
        check(L.DmlcTpuStagedBatcherCreateEx(
            spec["uri"].encode(), int(part), int(self._virtual_parts),
            ("libsvm" if fmt == "auto" else fmt).encode(),
            int(spec["batch_size"]), int(spec["nnz_bucket"]),
            int(spec.get("nnz_max", 0)), 0, int(bool(spec.get("with_qid"))),
            1, 1, 0, ctypes.byref(h)))
        tb = _throttle()
        sent = 0
        try:
            while True:
                c = StagedBatchOwnedC()
                if check(L.DmlcTpuStagedBatcherNextOwned(
                        h, ctypes.byref(c))) != 1:
                    break
                try:
                    hdr, arena = protocol.pack_staged_wire(c)
                    if tb is not None:
                        tb.charge(len(hdr) + len(arena) + 12)
                    protocol.write_frame(sock, protocol.FRAME_STAGED,
                                         hdr, arena)
                finally:
                    L.DmlcTpuStagedBatchFree(ctypes.c_void_p(c.batch))
                sent += 1
                telemetry.counter_add("dataservice.serve_blocks", 1)
                telemetry.counter_add("dataservice.serve_bytes",
                                      len(hdr) + int(c.arena_bytes))
        finally:
            L.DmlcTpuStagedBatcherFree(h)
        protocol.write_json_frame(sock, protocol.FRAME_END, {"blocks": sent})


class StagingWorker:
    """Accept loop and lease-board registration of one staging worker.

    ``device``: where the served datasets' binners and caches are built
    (the card unless the caller asks for the CPU; without a card the
    default raises).  ``register=False`` serves without a tracker."""

    def __init__(self, tracker_uri: Optional[str] = None,
                 metrics_port: Optional[int] = None,
                 host: Optional[str] = None, port: Optional[int] = None,
                 cache_dir: Optional[str] = None,
                 worker_id: Optional[str] = None,
                 heartbeat_s: Optional[float] = None,
                 register: bool = True, device="cuda"):
        self.device = resolve_device(device)
        host = host or os.environ.get(HOST_ENV, "127.0.0.1")
        port = int(os.environ.get(PORT_ENV, "0")) if port is None else port
        self.cache_dir = Path(
            cache_dir or os.environ.get(CACHE_DIR_ENV)
            or (Path.home() / ".cache" / "dmlctpu" / "dataservice"))
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self._heartbeat_s = float(
            heartbeat_s if heartbeat_s is not None
            else os.environ.get("DMLCTPU_DATASERVICE_HEARTBEAT_S", "2.0"))
        self._timeout_s = float(
            os.environ.get("DMLCTPU_DATASERVICE_TIMEOUT_S", "30"))

        family = socket.getaddrinfo(host, None)[0][0]
        sock = socket.socket(family, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host, port))
        sock.listen(64)
        self.sock = sock
        self.host = host
        self.port = sock.getsockname()[1]
        self.worker_id = worker_id or \
            f"w-{socket.gethostname()}:{self.port}-{os.getpid()}"
        self._served: Dict[str, _ServedDataset] = {}
        self._lock = threading.Lock()
        self._closed = threading.Event()

        self._client: Optional[tracker_metrics.ShardClient] = None
        if register:
            mport = metrics_port if metrics_port is not None else \
                os.environ.get(tracker_metrics.METRICS_PORT_ENV)
            if mport:
                self._client = tracker_metrics.ShardClient(
                    tracker_uri or os.environ.get("DMLC_TRACKER_URI",
                                                  "127.0.0.1"),
                    int(mport), rank=tracker_metrics._env_rank())
                self._client.data_req({
                    "op": "worker_register", "worker": self.worker_id,
                    "host": self.host, "port": self.port})
                threading.Thread(
                    target=self._heartbeat_loop,
                    name="dmlctpu-dataservice-heartbeat", daemon=True).start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="dmlctpu-dataservice-worker",
            daemon=True)
        self._accept_thread.start()
        LOGGER.info("staging worker %s serving on %s:%d (%s)",
                    self.worker_id, self.host, self.port, self.device)

    # ---- lease-board liveness -----------------------------------------------

    def _heartbeat_loop(self) -> None:
        while not self._closed.wait(self._heartbeat_s):
            try:
                r = self._client.data_req({"op": "worker_heartbeat",
                                           "worker": self.worker_id})
                if not r.get("ok"):  # the tracker restarted: register again
                    self._client.data_req({
                        "op": "worker_register", "worker": self.worker_id,
                        "host": self.host, "port": self.port})
            except (OSError, ConnectionError, ValueError):
                pass  # tracker briefly away; lease_fail covers a dead worker

    # ---- serving ------------------------------------------------------------

    def _accept_loop(self) -> None:
        while True:
            try:
                fd, _addr = self.sock.accept()
            except OSError:
                return  # closed
            threading.Thread(target=self._handle_conn, args=(fd,),
                             daemon=True).start()

    def _handle_conn(self, fd: socket.socket) -> None:
        try:
            fd.settimeout(self._timeout_s)
            tracker_metrics._no_delay(fd)
            protocol.server_handshake(fd)
            req = protocol.read_req(fd)
            telemetry.counter_add("dataservice.requests", 1)
            self._handle_req(fd, req)
        except (ConnectionError, OSError, ValueError, KeyError) as e:
            telemetry.counter_add("dataservice.errors", 1)
            LOGGER.debug("dropped data-service request: %s", e)
        finally:
            try:
                fd.close()
            except OSError:
                pass

    def _handle_req(self, fd: socket.socket, req: dict) -> None:
        op = req.get("op")
        # adopt the client's trace context (when it sent one), so the
        # native spans this request starts carry the client's trace id.
        # Advisory: concurrent requests race on the ambient context.
        # Restore, not clear, on the way out: an in-process worker must
        # not wipe its client's epoch context.
        prev = telemetry.get_trace_context()
        adopted = telemetry.adopt_trace_context(req.get("trace"))
        try:
            if op == "ping":
                protocol.send_req(fd, {"ok": True, "worker": self.worker_id})
                return
            served = self._dataset(req["spec"])
            if op == "meta":
                try:
                    protocol.send_req(fd, served.ensure())
                except Exception as e:  # noqa: BLE001  the build failed:
                    # tell the client in the reply, not by a dropped socket
                    telemetry.counter_add("dataservice.errors", 1)
                    LOGGER.warning("dataset build failed: %s", e)
                    protocol.send_req(fd, {"ok": False,
                                           "error": str(e)[-500:]})
                return
            if op == "fetch":
                served.ensure()
                try:
                    with telemetry.span("dataservice.serve"):
                        served.serve_fetch(fd, int(req["part"]))
                except (ConnectionError, OSError):
                    raise  # the client went away mid-stream
                except Exception as e:  # noqa: BLE001  report it in-band
                    telemetry.counter_add("dataservice.errors", 1)
                    protocol.write_json_frame(fd, protocol.FRAME_ERROR,
                                              {"error": str(e)[-500:]})
                return
            protocol.send_req(fd, {"ok": False,
                                   "error": f"unknown op {op!r}"})
        finally:
            if adopted:
                telemetry.set_trace_context(*prev)

    def _dataset(self, spec: dict) -> _ServedDataset:
        key = spec_key(spec)
        with self._lock:
            served = self._served.get(key)
            if served is None:
                served = self._served[key] = _ServedDataset(
                    spec, self.cache_dir, self.device)
            return served

    def close(self, leave: bool = True) -> None:
        """Drain: leave the lease board (its leases go back to the
        survivors) and stop accepting.  ``leave=False`` stops as a crash
        would, for failover tests."""
        if self._closed.is_set():
            return
        self._closed.set()
        if leave and self._client is not None:
            try:
                self._client.data_req({"op": "worker_leave",
                                       "worker": self.worker_id})
            except (OSError, ConnectionError, ValueError):
                pass
        try:
            # wakes the accept loop, which a close alone does not on Linux
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=5)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="dmlctpu data-service staging worker (PyTorch/CUDA)")
    parser.add_argument("--host", default=None,
                        help=f"bind/advertise host (or ${HOST_ENV})")
    parser.add_argument("--port", type=int, default=None,
                        help=f"data channel port, 0 = ephemeral "
                             f"(or ${PORT_ENV})")
    parser.add_argument("--cache-dir", default=None,
                        help=f"bin cache directory (or ${CACHE_DIR_ENV})")
    parser.add_argument("--device",
                        default=os.environ.get(DEVICE_ENV, "cuda"),
                        help="where binners and caches are built: cuda, "
                             f"cuda:N or cpu (or ${DEVICE_ENV})")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    worker = StagingWorker(host=args.host, port=args.port,
                           cache_dir=args.cache_dir, device=args.device)
    print(f"DATASERVICE_READY {worker.host}:{worker.port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        worker.close()


if __name__ == "__main__":
    main()
