"""The port's data service (``dmlc_core_tpu_torch.dataservice``) against
the JAX package's, on the same numpy-made libsvm files, on the CPU.

* The 0xff9a wire: frames are the JAX package's bytes, the handshake
  refuses a foreign magic, a staged batch unwraps array for array as the
  JAX package's ``unwrap_staged_wire`` does, and ``spec_key`` is its
  digest (so workers of both packages share one cache file).
* A port worker and a port client in-process, under the port's
  aggregator: the epoch equals a local port cache hit and the JAX
  package's local epoch bit for bit, with a raw or an lz4 cache and under
  the throttle; the staged (text) mode gives the same rows; fault points,
  a closed worker and a killed worker process fail over with every row
  served once; the epoch's trace context reaches the worker.
* Across packages: a JAX worker feeds the port's client and a port worker
  feeds the JAX client, each to the same batches bit for bit.
* The forest of ``fit_streamed`` over the service equals the JAX
  package's ``fit_streamed`` over its local cache within
  tests/test_torch_streamed.py's tolerances (its gain-gap fixture), and
  the port's local cache fit bit for bit on the kernel route.
* Sharded epochs (gloo ranks as child processes, ``tests/torch_ranks.py``,
  against in-process workers): each rank leases its contiguous share of
  the parts; its batches are a local repack of that share of the worker's
  cache file leaf by leaf, the global facts are the ranks' rows, and the
  ranks' rows in rank order are the JAX package's one-process epoch's, in
  the binned and the staged mode and after a failover inside rank 0's
  share; a 2-rank ``fit_streamed`` over the service is the one-process
  forest bit for bit.
* Refusals: a multi-process ``sharding=`` without ``nnz_max``, the staged
  mode without cuts, fitted cuts that disagree with the service's.
"""
import hashlib
import os
import signal
import socket
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from dmlc_core_tpu.data.binned_cache import BinnedStagingIter as JaxBinnedIter
from dmlc_core_tpu.dataservice import protocol as jprotocol
from dmlc_core_tpu.dataservice.client import DataServiceIter as JaxServiceIter
from dmlc_core_tpu.dataservice.server import StagingWorker as JaxWorker
from dmlc_core_tpu.dataservice.server import spec_key as jax_spec_key
from dmlc_core_tpu.models import QuantileBinner as JaxBinner
from dmlc_core_tpu_torch import faultinject, telemetry
from dmlc_core_tpu_torch._native import StagedBatchOwnedC, check, lib
from dmlc_core_tpu_torch.data import BinnedStagingIter
from dmlc_core_tpu_torch.data.binned_cache import resolve_codec
from dmlc_core_tpu_torch.dataservice import (DATA_MAGIC, DataServiceIter,
                                             StagingWorker, protocol)
from dmlc_core_tpu_torch.dataservice.server import _TokenBucket, spec_key
from dmlc_core_tpu_torch.models import GBDT, QuantileBinner
from dmlc_core_tpu_torch.tracker import metrics as tm
from dmlc_core_tpu_torch.tracker.submit import spawn_data_service

REPO = Path(__file__).resolve().parent.parent
BINNER = dict(num_bins=32, missing_aware=True, sketch_size=64, sketch_seed=3)
GEOM = dict(batch_size=64, nnz_bucket=256)
LANES = ("label", "weight", "row_ptr", "index", "ebin", "emask")


def _write_libsvm(path, rows=600, features=40, seed=0):
    """tests/test_dataservice.py's rows."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            feats = sorted(rng.choice(features, size=rng.integers(3, 10),
                                      replace=False))
            f.write(" ".join([str(rng.integers(0, 2))] +
                             [f"{j}:{rng.normal():.4f}" for j in feats])
                    + "\n")
    return str(path)


def _binner():
    return QuantileBinner(device="cpu", **BINNER)


def _batch_digest(batches) -> str:
    """Every lane's bytes and the row count of each batch (a port batch or
    a JAX one)."""
    h = hashlib.sha256()
    for b in batches:
        for f in LANES:
            h.update(np.asarray(getattr(b, f)).tobytes())
        h.update(str(int(b.num_rows)).encode())
    return h.hexdigest()


def _client(agg, uri, binner=None, **kw):
    kw = {**GEOM, **kw}
    return DataServiceIter(uri, binner or _binner(), device="cpu",
                           shard_client=tm.ShardClient("127.0.0.1", agg.port,
                                                       rank=0), **kw)


@pytest.fixture()
def tracker_env():
    """The port's aggregator and the env contract pointing at it."""
    agg = tm.MetricsAggregator()
    old = {k: os.environ.get(k) for k in ("DMLC_TRACKER_URI",
                                          tm.METRICS_PORT_ENV)}
    os.environ["DMLC_TRACKER_URI"] = "127.0.0.1"
    os.environ[tm.METRICS_PORT_ENV] = str(agg.port)
    yield agg
    agg.close()
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture()
def board_env(tracker_env, tmp_path):
    """The aggregator and one in-process port staging worker."""
    worker = StagingWorker(cache_dir=str(tmp_path / "cache"), device="cpu")
    yield tracker_env, worker
    worker.close()


@pytest.fixture()
def data(tmp_path):
    return _write_libsvm(tmp_path / "train.libsvm")


# ---- the wire ---------------------------------------------------------------

def _sent_bytes(write, *args) -> bytes:
    a, b = socket.socketpair()
    try:
        write(a, *args)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return out
            out += chunk
    finally:
        a.close()
        b.close()


def test_frame_roundtrip_and_jax_bytes():
    a, b = socket.socketpair()
    try:
        protocol.write_frame(a, protocol.FRAME_BLOCK, b"abc", b"defg")
        kind, payload = protocol.read_frame(b)
        assert kind == protocol.FRAME_BLOCK and bytes(payload) == b"abcdefg"
        assert isinstance(payload, bytearray)  # writable: arrays alias it
        protocol.write_json_frame(a, protocol.FRAME_END, {"blocks": 7})
        assert protocol.read_frame(b) == (protocol.FRAME_END, {"blocks": 7})
    finally:
        a.close()
        b.close()
    assert (DATA_MAGIC, protocol.FRAME_BLOCK, protocol.FRAME_STAGED,
            protocol.WIRE_HEADER_BYTES) == (
        jprotocol.DATA_MAGIC, jprotocol.FRAME_BLOCK, jprotocol.FRAME_STAGED,
        jprotocol.WIRE_HEADER_BYTES)
    for write, jwrite, args in (
            (protocol.write_frame, jprotocol.write_frame,
             (protocol.FRAME_STAGED, b"head", b"arena bytes")),
            (protocol.write_json_frame, jprotocol.write_json_frame,
             (protocol.FRAME_ERROR, {"error": "boom"})),
            (protocol.send_req, jprotocol.send_req,
             ({"op": "fetch", "part": 3},))):
        assert _sent_bytes(write, *args) == _sent_bytes(jwrite, *args)


def test_handshake_rejects_wrong_magic():
    a, b = socket.socketpair()
    try:
        a.sendall((0xBEEF).to_bytes(4, sys.byteorder))
        with pytest.raises(ConnectionError, match="magic"):
            protocol.server_handshake(b)
    finally:
        a.close()
        b.close()


def test_staged_wire_roundtrip_equals_jax(data):
    """The port's native batcher packs, ``pack_staged_wire`` frames and
    ``unwrap_staged_wire`` rebinds: the arrays equal the JAX package's
    unwrap of the same bytes, alias the buffer, and a broken header or a
    short frame is refused."""
    import ctypes
    L = lib()
    h = ctypes.c_void_p()
    check(L.DmlcTpuStagedBatcherCreateEx(data.encode(), 0, 1, b"libsvm", 64,
                                         256, 0, 0, 0, 1, 1, 0,
                                         ctypes.byref(h)))
    frames = []
    try:
        while True:
            c = StagedBatchOwnedC()
            if check(L.DmlcTpuStagedBatcherNextOwned(
                    h, ctypes.byref(c))) != 1:
                break
            hdr, arena = protocol.pack_staged_wire(c)
            assert len(hdr) == protocol.WIRE_HEADER_BYTES
            frames.append((bytearray(hdr) + bytearray(arena),
                           int(c.num_rows)))
            L.DmlcTpuStagedBatchFree(ctypes.c_void_p(c.batch))
    finally:
        L.DmlcTpuStagedBatcherFree(h)
    assert sum(n for _, n in frames) == 600
    for buf, rows in frames:
        got = protocol.unwrap_staged_wire(buf)
        want = jprotocol.unwrap_staged_wire(bytearray(buf))
        assert got.keys() == want.keys() and got["num_rows"] == rows
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, k)
            else:
                assert got[k] == v, k
        assert np.shares_memory(got["label"], np.frombuffer(buf, np.uint8))
    bad = bytearray(frames[0][0])
    bad[0] ^= 0xFF  # the magic
    with pytest.raises(Exception, match="(?i)magic|wire"):
        protocol.unwrap_staged_wire(bad)
    with pytest.raises(Exception):
        protocol.unwrap_staged_wire(
            bytearray(frames[0][0][:protocol.WIRE_HEADER_BYTES + 4]))
    with pytest.raises(ConnectionError, match="shorter"):
        protocol.unwrap_staged_wire(bytearray(8))


@pytest.mark.parametrize("codec", [None, "raw", "lz4"])
@pytest.mark.parametrize("binner", [None, BINNER,
                                    dict(BINNER, num_bins=256)])
def test_spec_key_equals_jax(codec, binner):
    for uri in ("/data/a.libsvm", "s3://b/c.libsvm#cache"):
        for geom in (dict(batch_size=64, nnz_bucket=256, nnz_max=0),
                     dict(batch_size=8192, nnz_bucket=1 << 16,
                          nnz_max=1 << 20)):
            spec = {"uri": uri, "format": "auto", "with_qid": False,
                    "binner": binner, **geom}
            if codec is not None:
                spec["codec"] = codec
            assert spec_key(spec) == jax_spec_key(spec)
    assert spec_key({"uri": "a"}) == spec_key({"uri": "a", "codec": "raw"})


def test_fault_points_fire_in_the_native_registry():
    if not faultinject.compiled_in():
        pytest.skip("faults compiled out")
    for point in ("dataservice.connect", "dataservice.block.drop"):
        assert faultinject.fire(point) == 0
        with faultinject.armed(f"{point}=err@1.0"):
            assert faultinject.MODE_NAMES[faultinject.fire(point)] == "err"
        assert faultinject.fire(point) == 0


# ---- a port worker and a port client, in-process ----------------------------

def test_service_epoch_equals_local_hit_and_jax(board_env, data, tmp_path):
    """The service's epoch is a local port cache hit's (over the worker's
    own cache file) and the JAX package's local epoch, bit for bit, in two
    epochs; the ledger, the job table and /dataservice see the fleet."""
    import json
    import urllib.request

    from dmlc_core_tpu_torch import telemetry_http
    agg, worker = board_env
    binner = _binner()
    it = _client(agg, data, binner)
    remote = list(it)
    assert remote and it.batches_staged == len(remote)
    assert binner.cuts is not None  # adopted from the service
    caches = list((tmp_path / "cache").glob("*.bincache"))
    assert [c.name for c in caches] == [spec_key(it.spec) + ".bincache"]

    rebuilds = telemetry.counter_get("cache.rebuilds")
    local = list(BinnedStagingIter(data, _binner(), cache=str(caches[0]),
                                   device="cpu", **GEOM))
    assert telemetry.counter_get("cache.rebuilds") == rebuilds
    assert _batch_digest(remote) == _batch_digest(local)
    assert remote[0].cuts_digest == local[0].cuts_digest == \
        binner.cuts_digest()
    jax_local = list(JaxBinnedIter(data, JaxBinner(**BINNER),
                                   cache=str(tmp_path / "jax.bincache"),
                                   **GEOM))
    assert _batch_digest(remote) == _batch_digest(jax_local)
    # a second epoch leases under a fresh ledger and still matches
    assert _batch_digest(list(it)) == _batch_digest(local)

    led = agg.leases.state()["leases"][it.client_id]
    assert len(led) == 2
    for lease in led.values():
        assert lease["done"] == lease["shards"] and lease["pending"] == 0
        assert not lease["failovers"]
    table = agg.format_job_table()
    assert "data-service" in table and "lease" in table
    with telemetry_http.serve(port=0, provider=agg.provider,
                              board_provider=agg.board_provider) as srv:
        ds = json.loads(urllib.request.urlopen(
            srv.url + "/dataservice", timeout=10).read())
    assert worker.worker_id in ds["workers"] and it.client_id in ds["leases"]


def test_service_codec_compressed(board_env, data, tmp_path):
    """An lz4 cache ships its stored (compressed) frames and the client
    decodes them: the epoch equals raw service, from another cache file
    that is smaller."""
    if resolve_codec("lz4") != "lz4":
        pytest.skip("libdmlctpu built with -DDMLCTPU_CODEC=0")
    agg, _ = board_env
    raw_it = _client(agg, data)
    raw = list(raw_it)
    in0 = telemetry.counter_get("cache.codec.bytes_in")
    it = _client(agg, data, codec="lz4")
    got = list(it)
    assert _batch_digest(got) == _batch_digest(raw)
    assert spec_key(it.spec) != spec_key(raw_it.spec)
    raw_f = tmp_path / "cache" / (spec_key(raw_it.spec) + ".bincache")
    lz4_f = tmp_path / "cache" / (spec_key(it.spec) + ".bincache")
    assert lz4_f.stat().st_size < raw_f.stat().st_size
    if telemetry.enabled():
        assert telemetry.counter_get("cache.codec.bytes_in") > in0
    assert _batch_digest(list(it)) == _batch_digest(raw)


def test_service_throttle(board_env, data, monkeypatch):
    tb = _TokenBucket(1.0)  # 1 MB/s, 64 KiB of burst
    t0 = time.monotonic()
    tb.charge(150_000)
    tb.charge(150_000)
    assert time.monotonic() - t0 >= 0.15  # ~235 KB of debt at 1 MB/s
    agg, _ = board_env
    ref = list(_client(agg, data))
    monkeypatch.setenv("DMLCTPU_DATASERVICE_THROTTLE_MBPS", "8")
    assert _batch_digest(list(_client(agg, data))) == _batch_digest(ref)


def test_abandoned_epoch_then_a_whole_one(board_env, data):
    """A consumer that leaves an epoch after one batch stops its fetches
    (the parts in flight finish) without hanging; the next epoch is whole
    and equal to a clean one."""
    agg, _ = board_env
    ref = list(_client(agg, data))
    it = _client(agg, data)
    for _ in it:
        break
    assert _batch_digest(list(it)) == _batch_digest(ref)
    leases = agg.leases.state()["leases"][it.client_id]
    assert sorted(leases) == ["0", "1"] and leases["1"]["pending"] == 0


def _rows(batches) -> list:
    """Each real row's (label, indices, ebin, emask), in order (a port
    batch, a JAX one, or a rank's batch as a dict)."""
    out = []
    for b in batches:
        get = b.get if isinstance(b, dict) else \
            (lambda k, b=b: getattr(b, k))
        rp, lab = np.asarray(get("row_ptr")), np.asarray(get("label"))
        idx, ebin, emask = (np.asarray(get(k))
                            for k in ("index", "ebin", "emask"))
        for r in range(int(get("num_rows"))):
            s = slice(rp[r], rp[r + 1])
            out.append((float(lab[r]), idx[s].tobytes(), ebin[s].tobytes(),
                        emask[s].tobytes()))
    return out


def test_staged_mode_rows_equal_the_cache_epoch(board_env, data, tmp_path):
    """The text path: the worker ships packed parse batches and the client
    bins them with the adopted cuts; row by row the epoch is the cache
    epoch's."""
    agg, _ = board_env
    binner = _binner()
    local = list(BinnedStagingIter(data, binner,
                                   cache=str(tmp_path / "local.bincache"),
                                   device="cpu", **GEOM))
    it = _client(agg, data, binner, mode="staged")
    staged = list(it)
    assert it.meta is None and staged[0].cuts_digest == binner.cuts_digest()
    assert len(_rows(staged)) == 600
    assert _rows(staged) == _rows(local)


def _served_rows(blocks) -> int:
    return sum(int(b["num_rows"]) for bs in blocks for b in bs)


def test_failover_on_a_closed_worker(board_env, data, tmp_path):
    """A worker stopped without a drain after the epoch leased a part to
    it: the client's failed fetch finds it, every part goes to the
    survivor, and every row is served once."""
    agg, w0 = board_env
    w1 = StagingWorker(cache_dir=str(tmp_path / "cache1"), device="cpu")
    try:
        it = _client(agg, data, retries=8)
        it.ensure_meta()
        V = it._virtual_parts
        assert V >= 2
        data_req = it._data().data_req
        data_req({"op": "lease_register", "client": it.client_id,
                  "epoch": 0, "parts": list(range(V))})
        r = data_req({"op": "lease_assign", "client": it.client_id,
                      "epoch": 0, "part": 0})
        victim = w0 if r["worker"]["id"] == w0.worker_id else w1
        survivor = w1 if victim is w0 else w0
        victim.close(leave=False)
        failovers = telemetry.counter_get("dataservice.failovers")
        blocks = [it._fetch_part(0, g) for g in range(V)]
        assert _served_rows(blocks) == 600
        st = agg.leases.state()
        lease = st["leases"][it.client_id]["0"]
        assert lease["done"] == V and lease["pending"] == 0
        assert lease["failovers"] and all(
            f["worker"] == victim.worker_id for f in lease["failovers"])
        assert st["workers"][victim.worker_id]["dead"]
        assert not st["workers"][survivor.worker_id]["dead"]
        assert telemetry.counter_get("dataservice.failovers") > failovers
    finally:
        w1.close()


@pytest.mark.parametrize("point", ["dataservice.connect",
                                   "dataservice.block.drop"])
def test_failover_on_fault_points(board_env, data, tmp_path, point):
    """A fault at either hop fails the lease over to the other worker; the
    epoch is the clean epoch's bit for bit."""
    if not faultinject.compiled_in():
        pytest.skip("faults compiled out")
    agg, _ = board_env
    w1 = StagingWorker(cache_dir=str(tmp_path / "cache"), device="cpu")
    try:
        ref = list(_client(agg, data))
        it = _client(agg, data, retries=8)
        it.ensure_meta()
        errors = telemetry.counter_get("dataservice.errors")
        with faultinject.armed(f"{point}=err@1.0:n=1;seed=5"):
            got = list(it)
        assert _batch_digest(got) == _batch_digest(ref)
        assert telemetry.counter_get("dataservice.errors") > errors
        lease = agg.leases.state()["leases"][it.client_id]["0"]
        assert len(lease["failovers"]) >= 1
    finally:
        w1.close()


def test_spawned_workers_survive_a_kill(tracker_env, data, tmp_path):
    """``spawn_data_service`` starts ``python -m
    dmlc_core_tpu_torch.dataservice.server`` processes that register on the
    board; the one that part 0 is placed on is SIGKILLed (no drain), and
    the epoch ends on the survivor with the local cache hit's batches, a
    failover on the ledger and the error counted."""
    agg = tracker_env
    envs = {"DMLC_TRACKER_URI": "127.0.0.1",
            tm.METRICS_PORT_ENV: agg.port,
            "DMLCTPU_DATASERVICE_CACHE_DIR": str(tmp_path / "cache"),
            "DMLCTPU_DATASERVICE_DEVICE": "cpu",
            "PYTHONPATH": str(REPO)}
    procs = spawn_data_service(2, envs)
    try:
        deadline = time.monotonic() + 120
        while len(agg.leases.state()["workers"]) < 2:
            assert time.monotonic() < deadline, "the workers never registered"
            assert all(p.poll() is None for p in procs)
            time.sleep(0.1)
        it = _client(agg, data, retries=8)
        it.ensure_meta()
        # placement hashes (worker, part): a probe ledger shows part 0's
        placed = agg.leases.lease_assign("probe", 0, 0)["worker"]["id"]
        victim = next(p for p in procs
                      if placed.endswith(f"-{p.pid}"))
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=10)
        errors = telemetry.counter_get("dataservice.errors")
        got = list(it)
        cache = tmp_path / "cache" / (spec_key(it.spec) + ".bincache")
        want = list(BinnedStagingIter(data, _binner(), cache=str(cache),
                                      device="cpu", **GEOM))
        assert _batch_digest(got) == _batch_digest(want)
        lease = agg.leases.state()["leases"][it.client_id]["0"]
        assert lease["pending"] == 0 and len(lease["failovers"]) >= 1
        assert all(f["worker"] == placed for f in lease["failovers"])
        assert telemetry.counter_get("dataservice.errors") > errors
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)


def test_trace_context_reaches_the_worker(board_env, data):
    if not telemetry.enabled():
        pytest.skip("tracing is compiled out")
    agg, _ = board_env
    before = telemetry.snapshot()
    telemetry.trace_start()
    try:
        batches = list(_client(agg, data))
    finally:
        telemetry.trace_stop()
        telemetry.clear_trace_context()
    assert batches
    delta = telemetry.counters_delta(before, telemetry.snapshot())
    assert delta.get("trace.ctx_propagated", 0) >= 2  # meta + a fetch
    events = [e for e in telemetry.trace_dump()["traceEvents"]
              if e.get("ph") == "X"]
    serve = [e for e in events if e["name"] == "dataservice.serve"]
    assert serve
    tids = {e.get("args", {}).get("trace_id") for e in serve}
    assert len(tids) == 1 and None not in tids and "0" * 16 not in tids
    assert {"dataservice.fetch", "dataservice.epoch"} <= {
        e["name"] for e in events}


# ---- across packages --------------------------------------------------------

def test_jax_worker_feeds_the_port_client(tracker_env, data, tmp_path):
    agg = tracker_env
    worker = JaxWorker(cache_dir=str(tmp_path / "jax-cache"))
    try:
        got = list(_client(agg, data))
        jax_it = JaxServiceIter(data, JaxBinner(**BINNER), **GEOM,
                                shard_client=tm.ShardClient(
                                    "127.0.0.1", agg.port, rank=0))
        want = list(jax_it)
        caches = list((tmp_path / "jax-cache").glob("*.bincache"))
        assert len(caches) == 1  # one spec, one file: the same key
        hit = list(BinnedStagingIter(data, _binner(), cache=str(caches[0]),
                                     device="cpu", **GEOM))
    finally:
        worker.close()
    assert _batch_digest(got) == _batch_digest(want) == _batch_digest(hit)
    assert got[0].cuts_digest == want[0].cuts_digest


def test_port_worker_feeds_the_jax_client(board_env, data, tmp_path):
    agg, _ = board_env
    got = list(JaxServiceIter(data, JaxBinner(**BINNER), **GEOM,
                              shard_client=tm.ShardClient(
                                  "127.0.0.1", agg.port, rank=0)))
    want = list(_client(agg, data))
    assert len(list((tmp_path / "cache").glob("*.bincache"))) == 1
    assert _batch_digest(got) == _batch_digest(want)
    assert got[0].cuts_digest == want[0].cuts_digest


# ---- the forest -------------------------------------------------------------

def test_forest_over_the_service(board_env, tmp_path):
    """tests/test_torch_streamed.py's gain-gap fixture as libsvm: the
    worker's sketch gives the fixture's cuts, the forest over the service
    equals the JAX package's fit_streamed over its local cache within that
    file's tolerances, and the port's local cache fit bit for bit on the
    kernel route (the plain version on the CPU)."""
    from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
    from test_torch_streamed import (KW, ROWS, _assert_close_to_jax,
                                     _binner as fixture_binner, _data,
                                     _jax_streamed)
    idx, val, y, ptr, _ = _data()
    uri = str(tmp_path / "rows.libsvm")
    Path(uri).write_text("".join(
        f"{int(y[r])} " + " ".join(
            f"{i}:{v:.9g}" for i, v in zip(idx[ptr[r]:ptr[r + 1]],
                                           val[ptr[r]:ptr[r + 1]])) + "\n"
        for r in range(ROWS)))
    geom = dict(batch_size=512, nnz_bucket=1024)
    agg, _ = board_env
    binner = QuantileBinner(num_bins=KW["num_bins"], missing_aware=True,
                            device="cpu")
    ds = _client(agg, uri, binner, **geom)
    model = GBDT(histogram="pallas", device="cpu", **KW)
    served = model.fit_streamed(lambda: iter(ds), binner)
    assert binner.cuts_digest() == fixture_binner().cuts_digest()

    jbinner = JaxBinner(num_bins=KW["num_bins"], missing_aware=True)
    jit = JaxBinnedIter(uri, jbinner, cache=str(tmp_path / "jax.bincache"),
                        **geom)
    jax_epoch = list(jit)
    want = {k: np.asarray(v) for k, v in JaxGBDT(histogram="xla", **KW)
            .fit_streamed(jax_epoch, jbinner).items()}
    _assert_close_to_jax(served, want)
    _assert_close_to_jax(served, _jax_streamed())

    lbinner = QuantileBinner(num_bins=KW["num_bins"], missing_aware=True,
                             device="cpu")
    local = BinnedStagingIter(uri, lbinner,
                              cache=str(tmp_path / "local.bincache"),
                              device="cpu", **geom)
    resident = model.fit_streamed(lambda: iter(local), lbinner)
    for k in resident:
        assert torch.equal(served[k], resident[k]), k


# ---- sharded epochs ---------------------------------------------------------

SHARD_V = 7  # virtual parts of the sharded tests' caches: odd, so 3 + 4
SHARD_NNZ = 512  # nnz_max of the sharded epochs (rows have 3-9 entries)


@pytest.fixture()
def odd_parts(monkeypatch):
    """Split every dataset into SHARD_V virtual parts (a small file gets
    the 8-part floor otherwise), so two ranks' shares are uneven."""
    from dmlc_core_tpu_torch.data import binned_cache, staging
    pick = lambda total, num_parts, *a, **k: SHARD_V  # noqa: E731
    monkeypatch.setattr(binned_cache, "_pick_virtual_parts", pick)
    monkeypatch.setattr(staging, "_pick_virtual_parts", pick)


def _local_share(cache: Path, parts, geom, nnz_max) -> list:
    """A local repack of ``parts`` of a cache file in part order, staged as
    a DataServiceIter stages (``_Repacker`` + ``_BinnedStager``)."""
    from dmlc_core_tpu_torch.data.binned_cache import (_BinnedStager,
                                                       _NativeReader,
                                                       _Repacker,
                                                       unpack_block)
    r = _NativeReader(str(cache))
    try:
        meta, part_map = r.meta, r.part_map
        rp = _Repacker(geom["batch_size"], geom["nnz_bucket"], nnz_max,
                       int(meta.get("pad_bin", 1)), False)
        stager = _BinnedStager(torch.device("cpu"))
        out = []
        for g in parts:
            ent = part_map.get(g)
            if ent is None:
                continue
            r.seek_to(int(ent["offset"]))
            for _ in range(int(ent["records"])):
                for w in rp.feed(unpack_block(r.next_block_view())):
                    out.append(stager.stage(w, meta["cuts_digest"])[0])
        for w in rp.flush():
            out.append(stager.stage(w, meta["cuts_digest"])[0])
        return out
    finally:
        r.close()


def _check_rounds(res, nnz_max) -> None:
    """Every rank ran the same rounds; each batch carries the job's plan
    and the round's global facts; a rank out of rows sends padding."""
    rounds = {len(r["batches"]) for r in res}
    assert len(rounds) == 1
    for i in range(rounds.pop()):
        bs = [r["batches"][i] for r in res]
        assert all(b["planned"] for b in bs)
        assert {b["global_num_rows"] for b in bs} == {
            sum(b["num_rows"] for b in bs)}
        want = np.concatenate(
            [b["row_ptr"][:-1] + k * nnz_max for k, b in enumerate(bs)]
            + [[len(bs) * nnz_max]]).astype(np.int32)
        for b in bs:
            np.testing.assert_array_equal(b["global_row_ptr"], want)
            assert b["index"].shape == (nnz_max,)
            if b["num_rows"] == 0:
                assert not b["weight"].any() and not b["emask"].any()


def _jax_epoch_rows(agg, uri) -> list:
    """The JAX package's one-process DataServiceIter epoch, row by row."""
    return _rows(JaxServiceIter(uri, JaxBinner(**BINNER), **GEOM,
                                shard_client=tm.ShardClient(
                                    "127.0.0.1", agg.port, rank=0)))


def _share_of(rank, n, V=SHARD_V) -> list:
    return list(range(rank * V // n, (rank + 1) * V // n))


@pytest.mark.parametrize("mode", ["binned", "staged"])
def test_two_rank_epoch_is_the_local_repack_of_each_share(
        board_env, odd_parts, data, tmp_path, mode):
    """Two ranks over the 7 parts: rank 0 leases parts 0-2 and rank 1
    parts 3-6, each under its own client id; each rank's batches are the
    local repack of its share of the worker's cache file leaf by leaf
    (binned), or its rows (staged: the worker's parse batches binned on
    the rank); the rows of both, in rank order, are the JAX package's
    one-process epoch's, every row once."""
    from torch_ranks import run_ranks
    agg, _ = board_env
    # the binned cache the reference repacks: the ranks' own in the binned
    # mode; in the staged mode a binned client's (its cuts bin the ranks'
    # batches), whose blocks hold the same parts' rows
    probe = _client(agg, data, nnz_max=SHARD_NNZ)
    cuts = None
    if mode == "staged":
        probe.ensure_meta()
        cuts = probe._binner.cuts.numpy()
    res = run_ranks(2, "dataservice_epoch", tmp_path, uri=data,
                    port=agg.port, nnz_max=SHARD_NNZ, geom=GEOM,
                    binner_kw=BINNER, mode=mode, cuts=cuts)
    assert [r["share"] for r in res] == [_share_of(0, 2), _share_of(1, 2)]
    _check_rounds(res, SHARD_NNZ)
    cache = tmp_path / "cache" / (spec_key(probe.spec) + ".bincache")
    state = agg.leases.state()["leases"]
    for r in res:
        lease = state[r["client_id"]]["0"]
        assert lease["shards"] == lease["done"] == len(r["share"])
        assert {int(p) for p in lease["assigned"]} == set(r["share"])
        want = _local_share(cache, r["share"], GEOM, SHARD_NNZ)
        got = [b for b in r["batches"] if b["num_rows"]]
        if mode == "binned":
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g["num_rows"] == w.num_rows
                assert g["cuts_digest"] == w.cuts_digest
                for k in LANES:
                    np.testing.assert_array_equal(g[k],
                                                  getattr(w, k).numpy(), k)
        else:
            assert _rows(got) == _rows(want)
    rows = _rows(b for r in res for b in r["batches"])
    assert len(rows) == 600 and rows == _jax_epoch_rows(agg, data)


@pytest.mark.parametrize("point", ["dataservice.connect",
                                   "dataservice.block.drop"])
def test_two_rank_failover_stays_in_the_share(board_env, odd_parts, data,
                                              tmp_path, point):
    """A fault at either hop of rank 0's first fetch: rank 0 fails the
    lease over to the other worker inside its own share, rank 1's ledger
    holds none of rank 0's parts, and the ranks' rows are the one-process
    epoch's, none lost or doubled."""
    if not faultinject.compiled_in():
        pytest.skip("faults compiled out")
    from torch_ranks import run_ranks
    agg, _ = board_env
    w1 = StagingWorker(cache_dir=str(tmp_path / "cache"), device="cpu")
    try:
        res = run_ranks(2, "dataservice_epoch", tmp_path, uri=data,
                        port=agg.port, nnz_max=SHARD_NNZ, geom=GEOM,
                        binner_kw=BINNER, fault=f"{point}=err@1.0:n=1;seed=5")
        state = agg.leases.state()["leases"]
        jax_rows = _jax_epoch_rows(agg, data)
    finally:
        w1.close()
    _check_rounds(res, SHARD_NNZ)
    l0, l1 = (state[r["client_id"]]["0"] for r in res)
    assert len(l0["failovers"]) >= 1
    assert {f["part"] for f in l0["failovers"]} <= set(_share_of(0, 2))
    assert not l1["failovers"]
    # a ledger's parts are those its client registered or leased
    for lease, r in ((l0, 0), (l1, 1)):
        assert lease["shards"] == lease["done"] == len(_share_of(r, 2))
        assert {int(p) for p in lease["assigned"]} <= set(_share_of(r, 2))
        assert lease["pending"] == 0
    rows = _rows(b for r in res for b in r["batches"])
    assert len(rows) == 600 and rows == jax_rows


def test_two_rank_forest_over_the_service(board_env, tmp_path):
    """tests/test_torch_streamed.py's gain-gap fixture served to two ranks:
    a ``fit_streamed(histogram="pallas", histogram_mesh=plan)`` on each
    rank's share equals the one-process forest over the service (a
    one-process plan: the same exact fixed-point route) bit for bit, on
    every rank."""
    from test_torch_streamed import KW, ROWS, _data
    from torch_ranks import run_ranks

    from dmlc_core_tpu_torch.parallel import MeshPlan
    idx, val, y, ptr, _ = _data()
    uri = str(tmp_path / "rows.libsvm")
    Path(uri).write_text("".join(
        f"{int(y[r])} " + " ".join(
            f"{i}:{v:.9g}" for i, v in zip(idx[ptr[r]:ptr[r + 1]],
                                           val[ptr[r]:ptr[r + 1]])) + "\n"
        for r in range(ROWS)))
    geom = dict(batch_size=512, nnz_bucket=1024)
    agg, _ = board_env
    binner = QuantileBinner(num_bins=KW["num_bins"], missing_aware=True,
                            device="cpu")
    one = GBDT(histogram="pallas", histogram_mesh=MeshPlan.build(),
               device="cpu", **KW).fit_streamed(
        lambda: iter(_client(agg, uri, binner, **geom)), binner)
    res = run_ranks(2, "dataservice_forest", tmp_path, timeout=180,
                    uri=uri, port=agg.port, nnz_max=1024, geom=geom, kw=KW)
    epochs = 1 + KW["num_trees"] * KW["max_depth"]
    for r in res:
        assert r["epochs"] == epochs
        for k, v in one.items():
            np.testing.assert_array_equal(r["forest"][k], v.numpy(),
                                          err_msg=k)


# seed 7: a draw under which no node of the fixture's sampled forest ties
# its two default directions (a node whose kept rows all carry the split
# feature ties them exactly, and the exact route and the JAX package's f32
# sums break such a tie on ulps of the missing mass)
SAMPLED = dict(subsample=0.8, colsample_bytree=0.8, seed=7)


def _fixture_file(tmp_path) -> str:
    """tests/test_torch_streamed.py's gain-gap rows as a libsvm file."""
    from test_torch_streamed import ROWS, _data
    idx, val, y, ptr, _ = _data()
    uri = str(tmp_path / "rows.libsvm")
    Path(uri).write_text("".join(
        f"{int(y[r])} " + " ".join(
            f"{i}:{v:.9g}" for i, v in zip(idx[ptr[r]:ptr[r + 1]],
                                           val[ptr[r]:ptr[r + 1]])) + "\n"
        for r in range(ROWS)))
    return uri


def test_two_rank_sampled_forest_over_the_service(board_env, odd_parts,
                                                  tmp_path):
    """A sampled 2-rank ``fit_streamed`` over the service's 7 parts (rank
    0 leases 3 and rank 1 4, so rank 0 pads its short last batch and then
    a whole batch while rank 1 still has rows) draws each real row at its
    number in the one-process epoch: its forest equals the port's
    one-process sampled forest over the service (a one-process plan, the
    same exact route) bit for bit.  That forest's nodes are the port's
    unsharded ``index_add`` fit's, which equals the JAX package's
    one-process sampled ``fit_streamed`` over a ``DataServiceIter`` epoch
    of the same file within tests/test_torch_streamed.py's tolerances (its
    gain-gap fixture; the exact route's leaves differ from f32 sums in the
    last digits).  Numbering the rows by their padded local positions (each
    rank after the padded rows of the ranks before it) draws other rows
    on rank 1."""
    from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
    from test_torch_streamed import EXACT, KW, _assert_close_to_jax
    from torch_ranks import run_ranks

    from dmlc_core_tpu_torch.parallel import MeshPlan
    kw = {**KW, **SAMPLED}
    uri = _fixture_file(tmp_path)
    geom = dict(batch_size=512, nnz_bucket=1024)
    agg, _ = board_env
    binner = QuantileBinner(num_bins=KW["num_bins"], missing_aware=True,
                            device="cpu")
    one, unsharded = (GBDT(histogram=h, histogram_mesh=plan, device="cpu",
                           **kw).fit_streamed(
        lambda: iter(_client(agg, uri, binner, **geom)), binner)
        for h, plan in (("pallas", MeshPlan.build()), ("xla", None)))
    for k in EXACT:
        assert torch.equal(one[k], unsharded[k]), k
    jbinner = JaxBinner(num_bins=KW["num_bins"], missing_aware=True)
    # its own client id: the packages' default ids count separately, so
    # the first iterator of each in one process would share a ledger
    jax_epoch = list(JaxServiceIter(uri, jbinner, **geom,
                                    client_id="jax-one-process",
                                    shard_client=tm.ShardClient(
                                        "127.0.0.1", agg.port, rank=0)))
    assert [int(b.num_rows) for b in jax_epoch] == [512, 512, 512, 464]
    want = {k: np.asarray(v) for k, v in JaxGBDT(histogram="xla", **kw)
            .fit_streamed(jax_epoch, jbinner).items()}
    _assert_close_to_jax(unsharded, want)
    res = run_ranks(2, "dataservice_forest", tmp_path, timeout=180,
                    uri=uri, port=agg.port, nnz_max=1024, geom=geom, kw=kw)
    for r in res:
        for k, v in one.items():
            np.testing.assert_array_equal(r["forest"][k], v.numpy(),
                                          err_msg=k)


def test_two_rank_sampled_forest_over_the_binned_cache(tmp_path):
    """The same draw through ``BinnedStagingIter(sharding=)``: each rank
    caches and stages its part of the file, and the sampled 2-rank forest
    equals the port's one-process sampled ``fit_streamed`` (a one-process
    plan) over the whole file's cache bit for bit.  (The JAX package
    refuses a multi-process binned cache.)"""
    from test_torch_streamed import KW, _binner as fixture_binner
    from torch_ranks import run_ranks

    from dmlc_core_tpu_torch.parallel import MeshPlan
    kw = {**KW, **SAMPLED}
    uri = _fixture_file(tmp_path)
    geom = dict(batch_size=256, nnz_bucket=512)
    cuts = fixture_binner().cuts.numpy()
    binner = QuantileBinner.from_cuts(cuts, KW["num_bins"],
                                      missing_aware=True, device="cpu")
    local = BinnedStagingIter(uri, binner, cache=str(tmp_path / "one.bc"),
                              device="cpu", **geom)
    one = GBDT(histogram="pallas", histogram_mesh=MeshPlan.build(),
               device="cpu", **kw).fit_streamed(lambda: iter(local), binner)
    res = run_ranks(2, "binned_forest", tmp_path, timeout=180, uri=uri,
                    cuts=cuts, kw=kw, geom=geom, nnz_max=512 * 4)
    counts = [r["rows"] for r in res]
    # rank 0's short last batch is padded, so rank 1's padded positions
    # start past its one-process numbers
    assert sum(map(sum, counts)) == 2000
    assert counts[0][-1] < geom["batch_size"], counts
    for r in res:
        for k, v in one.items():
            np.testing.assert_array_equal(r["forest"][k], v.numpy(),
                                          err_msg=k)


# ---- refusals ---------------------------------------------------------------

def test_refusals(board_env, data, tmp_path):
    """The staged mode without cuts, an unknown mode and cuts that are not
    the service's are refused; a one-process plan is the unsharded stream
    bit for bit; over two ranks a plan without ``nnz_max`` is refused
    before any rank contacts the service (the ranks could not contribute
    batches of one shape)."""
    from dmlc_core_tpu_torch.parallel.meshplan import MeshPlan
    from torch_ranks import run_ranks
    agg, _ = board_env
    with pytest.raises(ValueError, match="fitted binner"):
        _client(agg, data, mode="staged")
    with pytest.raises(ValueError, match="mode"):
        _client(agg, data, mode="text")
    # a one-process plan is the slice
    one = MeshPlan.build()
    assert one.num_shards == 1
    assert _batch_digest(list(_client(agg, data, sharding=one))) == \
        _batch_digest(list(_client(agg, data)))
    # fitted cuts that are not the service's
    other = QuantileBinner(device="cpu", **dict(BINNER, sketch_seed=4))
    other.fit_sparse(np.arange(40), np.linspace(-1, 1, 40), 40)
    with pytest.raises(ValueError, match="do not match the service"):
        list(_client(agg, data, other))
    clients = set(agg.leases.state()["leases"])
    msgs = run_ranks(2, "dataservice_sharding_refused", tmp_path, uri=data)
    assert all("fixed shapes" in m and "nnz_max" in m for m in msgs), msgs
    assert set(agg.leases.state()["leases"]) == clients
