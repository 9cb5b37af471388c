"""The trainer's side of the staging service: ``DataServiceIter``.

The port of ``dmlc_core_tpu.dataservice.client``, on the same wire.  A
``DataServiceIter`` is a sibling of ``BinnedStagingIter``: it yields the
same ``BinnedBatch``es through the same repacker and the same stager
(``binned_cache._BinnedStager``); only the host blocks arrive off the data
channel instead of a local cache mapping.  On the binned path the worker
ships the cache blocks as stored, the client walks the global virtual
parts in the cache's order with the same ``_Repacker`` geometry, and the
batch stream is a local cache hit's bit for bit (so GBDT forests are too).
The staged (text) mode ships packed parse batches and bins them here with
the binner's cuts: the same rows, with batch edges set by the service's
virtual part split.

Under a plan of n processes (``sharding=``), rank r leases, fetches and
repacks only its share of the V virtual parts, the contiguous global parts
``[r*V // n, (r+1)*V // n)``, and each batch joins one host all-gather
(``binned_cache.binned_rounds``, ``BinnedStagingIter(sharding=...)``'s
rounds), so a rank moves 1/n of the epoch's bytes and the ranks' rows,
concatenated in rank order, are the one-process epoch's.  (The JAX client
moves the whole epoch to every process and ``device_put``s one global
batch.)

Every epoch registers a lease ledger with the tracker's lease board and
walks its parts (``0..V-1`` in one process) in order: assign, fetch, done.
Failover is by whole part: a part's blocks are buffered until its END
trailer checks out and only then fed to the (stateful) repacker, so a
worker dying mid-stream costs a discard, a ``lease_fail`` and a fetch of
the same part from a survivor, never a row twice or not at all.  Both
hops fire the fault points ``dataservice.connect`` and
``dataservice.block.drop``.
"""
from __future__ import annotations

import itertools
import logging
import os
import socket
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional

import numpy as np
import torch

from .. import faultinject, telemetry
from .._device import resolve_device
from .._native import lib
from ..data.binned_cache import (BinnedBatch, _BinnedStager, _cuts_from_meta,
                                 _Repacker, bin_entries_np, binned_rounds,
                                 decode_block_payload, resolve_codec,
                                 unpack_block)
from ..data.staging import require_fixed_shapes, staging_plan
from ..tracker import metrics as tracker_metrics
from . import protocol

LOGGER = logging.getLogger(__name__)

_CLIENT_SEQ = itertools.count()

#: parts in flight at once.  Parts are independent leases, and a part's
#: round trips (two lease calls and a connection, ~1.4 ms each on an H100
#: host's loopback) cost about what its 3.3 MB do: the Bosch-width epoch of
#: ``chip_smoke.py --service-sweep`` (76 parts) took 0.59-0.61 s with one
#: part in flight and 0.39-0.44 s with eight, the best of 1, 2, 4 and 8
_FETCH_AHEAD = 8


def _fire(point: str) -> None:
    mode = faultinject.fire(point)
    if mode:
        raise ConnectionError(
            f"fault injected: {point}={faultinject.MODE_NAMES.get(mode)}")


class DataServiceIter:
    """Stream pre-binned batches from the staging fleet onto ``device``
    (the card unless the caller asks for the CPU; without a card the
    default raises).

    ``binner``: a ``QuantileBinner``.  Unfitted, it adopts the service
    cache's cuts on first contact (digest-checked), as a local cache open
    does; fitted, its digest must be the service's.  ``mode="staged"``
    (the text path) needs a fitted binner: the client bins the shipped
    parse batches itself.

    ``shard_client``: the tracker's 0xff98 connection that carries the
    lease calls; by default the env contract's
    (``tracker.metrics.shard_client_from_env``).

    ``sharding``: None, or a plan (a ``parallel.MeshPlan``, a mesh, a
    ``parallel.data_sharding``).  Over n processes, rank r of n takes the
    contiguous share ``[r*V // n, (r+1)*V // n)`` of the service's V
    virtual parts (shares may be uneven, or empty), registers only those
    with the lease board under its own client id, fetches them (failing
    over inside the share) and repacks them in part order; each batch is
    coordinated with the other ranks (``[status, num_rows, row_ptr]`` a
    round) and carries ``plan``, ``global_num_rows`` and
    ``global_row_ptr``, and a rank out of rows contributes padding
    batches.  It needs ``nnz_max``.  A rank whose producer fails makes
    every rank raise; no rank falls back to a local cache or the whole
    epoch.  A one-process plan is the same as None.
    """

    def __init__(self, uri: str, binner, *, batch_size: int = 4096,
                 nnz_bucket: int = 1 << 16, nnz_max: int = 0,
                 format: str = "auto",  # noqa: A002
                 with_qid: bool = False, sharding=None, prefetch: int = 2,
                 mode: str = "binned", client_id: Optional[str] = None,
                 shard_client: Optional[tracker_metrics.ShardClient] = None,
                 retries: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 codec: Optional[str] = None, device="cuda"):
        if mode not in ("binned", "staged"):
            raise ValueError(
                f"mode must be 'binned' or 'staged', not {mode!r}")
        self._plan = staging_plan(sharding)
        if self._plan is not None:
            require_fixed_shapes(nnz_max)
        if mode == "staged" and binner.cuts is None:
            raise ValueError("staged (text) mode needs a fitted binner; the "
                             "service has no cuts to adopt")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # the requested block codec rides the spec (None: the
        # environment's); the worker builds its cache under it and ships
        # the stored frames, and this side decodes
        self._codec = resolve_codec(codec) if mode == "binned" else "raw"
        self._binner = binner
        self._mode = mode
        self._prefetch = max(int(prefetch), 1)
        self._retries = int(
            retries if retries is not None
            else os.environ.get("DMLCTPU_DATASERVICE_RETRIES", "4"))
        self._timeout_s = float(
            timeout_s if timeout_s is not None
            else os.environ.get("DMLCTPU_DATASERVICE_TIMEOUT_S", "30"))
        # a nonce a process: two iterators in one process (other datasets
        # or modes) must not share an epoch ledger on the board
        self.client_id = client_id or (
            f"c-{socket.gethostname()}-{os.getpid()}-{next(_CLIENT_SEQ)}")
        self._shard_client = shard_client
        self._spec = {
            "uri": uri, "format": format, "batch_size": int(batch_size),
            "nnz_bucket": int(nnz_bucket), "nnz_max": int(nnz_max),
            "with_qid": bool(with_qid), "codec": self._codec,
            "binner": None if mode == "staged" else {
                "num_bins": int(binner.num_bins),
                "missing_aware": bool(binner.missing_aware),
                "sketch_size": int(binner.sketch_size),
                "sketch_seed": int(binner.sketch_seed)},
        }
        self._meta: Optional[dict] = None
        self._virtual_parts = 0
        self._epoch = 0
        self._stager = _BinnedStager(dev)
        self.profile = None

    @property
    def device(self) -> torch.device:
        return self._stager.device

    @property
    def batches_staged(self) -> int:
        return self._stager.batches

    @property
    def spec(self) -> dict:
        """The dataset spec sent to the workers (``server.spec_key`` of it
        names the worker's cache file)."""
        return dict(self._spec)

    # -- the lease board ------------------------------------------------------

    def _data(self) -> tracker_metrics.ShardClient:
        if self._shard_client is None:
            self._shard_client = tracker_metrics.shard_client_from_env()
            if self._shard_client is None:
                raise RuntimeError(
                    "no tracker metrics channel in the environment; pass "
                    "shard_client= or run under a tracker")
        return self._shard_client

    def _any_worker(self) -> dict:
        """Any live worker, for the meta request (fetches go through
        lease_assign's placement)."""
        delay = 0.05
        for attempt in range(self._retries + 1):
            state = self._data().data_req({"op": "state"})
            alive = {w: e for w, e in state.get("workers", {}).items()
                     if not e.get("dead")}
            if alive:
                wid = sorted(alive)[0]
                e = alive[wid]
                return {"id": wid, "host": e["host"], "port": e["port"]}
            if attempt == self._retries:
                break
            time.sleep(delay)
            delay = min(delay * 2, 2.0)
        raise RuntimeError("data service has no alive staging workers")

    def _send(self, worker: dict, req: dict) -> socket.socket:
        """A connection to ``worker`` that has sent ``req``, with the
        epoch's trace context riding it (so the worker's spans land under
        this client's epoch in the job trace)."""
        _fire("dataservice.connect")
        ctx = telemetry.trace_context_wire()
        if ctx is not None:
            req = dict(req, trace=ctx)
        sock = tracker_metrics._no_delay(socket.create_connection(
            (worker["host"], worker["port"]), timeout=self._timeout_s))
        try:
            sock.settimeout(self._timeout_s)
            protocol.client_handshake(sock)
            protocol.send_req(sock, req)
        except BaseException:
            sock.close()
            raise
        return sock

    def _req_reply(self, worker: dict, req: dict) -> dict:
        sock = self._send(worker, req)
        try:
            return protocol.read_req(sock)
        finally:
            sock.close()

    def ensure_meta(self) -> None:
        """The dataset's geometry (and cuts, on the binned path) from the
        service; the first contact builds the worker's cache."""
        if self._virtual_parts:
            return
        reply = self._req_reply(self._any_worker(),
                                {"op": "meta", "spec": self._spec})
        if not reply.get("ok"):
            raise RuntimeError("staging worker could not serve the dataset: "
                               + str(reply.get("error")))
        if self._mode == "staged":
            self._virtual_parts = int(reply["virtual_parts"])
            return
        meta = reply["meta"]
        served_codec = meta.get("codec", "raw")
        if served_codec != "raw" and not int(lib().DmlcTpuBlockCodecEnabled()):
            # fail here, not on the first block that looks corrupt
            raise RuntimeError(
                f"service cache is {served_codec}-compressed but this "
                "client's libdmlctpu was built with DMLCTPU_CODEC=0 and "
                "cannot decode it")
        if self._binner.cuts is None:
            self._binner._set_cuts(_cuts_from_meta(meta))
        elif self._binner.cuts_digest() != meta["cuts_digest"]:
            raise ValueError(
                "fitted binner cuts do not match the service cache (digest "
                f"{meta['cuts_digest']}); pass an unfitted binner to adopt "
                "them, or matching cuts")
        self._meta = meta
        self._virtual_parts = int(meta["virtual_parts"])

    @property
    def meta(self) -> Optional[dict]:
        return self._meta

    @property
    def share(self) -> range:
        """The global virtual parts this process leases each epoch (all
        of them without a plan); after :meth:`ensure_meta`."""
        V = self._virtual_parts
        if self._plan is None:
            return range(V)
        r, n = self._plan.shard_index, self._plan.num_shards
        return range(r * V // n, (r + 1) * V // n)

    # -- leased part fetch ----------------------------------------------------

    def _fetch_from(self, worker: dict, part: int) -> List:
        """One whole part off one worker, buffered; raises on any break so
        the caller can fail the lease and fetch it elsewhere."""
        sock = self._send(worker, {"op": "fetch", "spec": self._spec,
                                   "part": int(part)})
        blocks: List = []
        nbytes = 0
        try:
            while True:
                kind, payload = protocol.read_frame(sock)
                if kind == protocol.FRAME_END:
                    if int(payload.get("blocks", -1)) != len(blocks):
                        raise ConnectionError(
                            f"part {part} trailer says "
                            f"{payload.get('blocks')} blocks, got "
                            f"{len(blocks)}")
                    break
                if kind == protocol.FRAME_ERROR:
                    raise ConnectionError(
                        f"worker error on part {part}: {payload.get('error')}")
                _fire("dataservice.block.drop")
                nbytes += len(payload)
                if kind == protocol.FRAME_BLOCK:
                    # frames carry the stored bytes: a compressed record is
                    # decoded here, never on the worker
                    blocks.append(unpack_block(decode_block_payload(
                        np.frombuffer(payload, np.uint8))))
                elif (kind == protocol.FRAME_STAGED
                      and self._mode == "staged"):
                    blocks.append(protocol.unwrap_staged_wire(payload))
                else:
                    # a text batch answering a binned request included:
                    # the service must not hide a missing cache
                    raise ConnectionError(
                        f"unexpected frame kind {kind} in {self._mode} mode")
        finally:
            sock.close()
        telemetry.counter_add("dataservice.fetch_blocks", len(blocks))
        telemetry.counter_add("dataservice.fetch_bytes", nbytes)
        return blocks

    def _fetch_part(self, epoch: int, part: int) -> List:
        """assign -> fetch -> done, failing over by whole part: a failed
        fetch marks the worker dead on the board (its leases go back) and
        the part is assigned to a survivor."""
        data = self._data()
        base = {"client": self.client_id, "epoch": int(epoch),
                "part": int(part)}
        failures = 0
        delay = 0.05
        while True:
            r = data.data_req(dict(base, op="lease_assign"))
            if r.get("done"):
                return []  # a replay of a part already served
            if r.get("wait"):
                failures += 1
                if failures > self._retries:
                    raise RuntimeError(
                        f"no alive staging workers for part {part} after "
                        f"{self._retries} retries")
                time.sleep(delay)
                delay = min(delay * 2, 2.0)
                continue
            worker = r["worker"]
            try:
                with telemetry.span("dataservice.fetch"):
                    blocks = self._fetch_from(worker, part)
            except (ConnectionError, OSError, ValueError) as e:
                telemetry.counter_add("dataservice.errors", 1)
                LOGGER.warning("fetch of part %d from %s failed (%s); "
                               "failing the lease", part, worker["id"], e)
                data.data_req(dict(base, op="lease_fail",
                                   worker=worker["id"]))
                failures += 1
                if failures > self._retries:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 2.0)
                continue
            data.data_req(dict(base, op="lease_done", worker=worker["id"]))
            return blocks

    # -- host batches ---------------------------------------------------------

    def _parts(self, epoch: int) -> Iterator[List]:
        """Each part of the share's blocks, in part order, with up to
        ``_FETCH_AHEAD`` parts fetched at once on a pool (each a whole
        lease: assign, fetch, done)."""
        parts = iter(self.share)
        with ThreadPoolExecutor(
                _FETCH_AHEAD,
                thread_name_prefix="dmlctpu-dataservice-fetch") as pool:
            futures = deque(pool.submit(self._fetch_part, epoch, g)
                            for g in itertools.islice(parts, _FETCH_AHEAD))
            try:
                while futures:
                    blocks = futures.popleft().result()
                    g = next(parts, None)
                    if g is not None:
                        futures.append(pool.submit(self._fetch_part, epoch,
                                                   g))
                    yield blocks
            finally:
                for f in futures:
                    f.cancel()

    def _produce_host(self, emit) -> None:
        """The binned path: the service's cache blocks through the local
        repacker, in the cache's part order and geometry."""
        spec = self._spec
        rp = _Repacker(spec["batch_size"], spec["nnz_bucket"],
                       spec["nnz_max"], int(self._meta.get("pad_bin", 1)),
                       spec["with_qid"])
        for blocks in self._parts(self._epoch):
            for blk in blocks:
                for b in rp.feed(blk):
                    if not emit(b):
                        return
        for b in rp.flush():
            if not emit(b):
                return

    def _produce_host_staged(self, emit) -> None:
        """The text path: the workers' packed parse batches, binned here
        with the binner's cuts (``BinnedStagingIter``'s text path, remote)."""
        cuts = np.ascontiguousarray(self._binner.cuts.cpu().numpy(),
                                    np.float32)
        for blocks in self._parts(self._epoch):
            for w in blocks:
                v = w["value"]
                out = {
                    "num_rows": w["num_rows"],
                    "label": w["label"],
                    "weight": w["weight"],
                    "qid": w["qid"],
                    "row_ptr": w["row_ptr"],
                    "index": w["index"],
                    "ebin": bin_entries_np(cuts, w["index"], v),
                    "emask": (v != 0) & ~np.isnan(v),
                }
                if not emit(out):
                    return

    # -- the epoch ------------------------------------------------------------

    def __iter__(self) -> Iterator[BinnedBatch]:
        # mint this epoch's trace context: every request carries it, so
        # the fleet's spans land under one trace id in the job trace
        trace_id = telemetry.new_trace_id()
        telemetry.set_trace_context(trace_id, trace_id)
        try:
            self.ensure_meta()
            self._data().data_req({
                "op": "lease_register", "client": self.client_id,
                "epoch": int(self._epoch), "parts": list(self.share)})
            produce = (self._produce_host if self._mode == "binned"
                       else self._produce_host_staged)
            digest = (self._meta["cuts_digest"] if self._meta is not None
                      else self._binner.cuts_digest())
            prof = {"host_wait_s": 0.0, "stage_s": 0.0, "emit_wait_s": 0.0,
                    "batches": 0}
            self.profile = prof
            host_iter = self._stager.host_iter(produce, self._prefetch)
            with telemetry.span("dataservice.epoch"):
                if self._plan is None:
                    yield from self._stager.feed(host_iter, digest, prof)
                    return
                spec = self._spec
                yield from binned_rounds(
                    host_iter, self._plan, spec["batch_size"],
                    spec["nnz_max"],
                    int(self._meta.get("pad_bin", 1)) if self._meta else 1,
                    spec["with_qid"],
                    lambda w: self._stager.stage(w, digest), self.device)
        finally:
            telemetry.clear_trace_context()
            self._epoch += 1
