"""The port's serving path (dmlc_core_tpu_torch.serving) against the JAX
package's, on the CPU.

Snapshots must match byte for byte (same numpy params -> same payload and
digest), a snapshot packed by the JAX package must score in the port
within 2e-5 of the JAX engine (f32 sums in another order; the tolerance
of tests/test_pallas.py between the reference's two backends), and the
server keeps the JAX server's HTTP and hot-swap contracts.
"""
import functools
import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest

from dmlc_core_tpu.serving import ScoringEngine as JaxEngine
from dmlc_core_tpu.serving import ScoringIterator as JaxIterator
from dmlc_core_tpu.serving import pack_snapshot as jax_pack
from dmlc_core_tpu.serving import push_snapshot as jax_push
from dmlc_core_tpu.serving import unpack_snapshot as jax_unpack
from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
from dmlc_core_tpu.models.gbdt import QuantileBinner as JaxBinner
from dmlc_core_tpu_torch import faultinject, telemetry
from dmlc_core_tpu_torch.models import QuantileBinner
from dmlc_core_tpu_torch.serving import (MicroBatchQueue, MicroBatchTuner,
                                         ScoringEngine, ScoringIterator,
                                         ScoringServer, pack_snapshot,
                                         push_snapshot, snapshot_digest,
                                         unpack_snapshot)

TOL = dict(rtol=2e-5, atol=2e-5)
F, K = 24, 4


def _params(family, seed):
    rng = np.random.default_rng(seed)
    p = {"w": rng.standard_normal(F).astype(np.float32),
         "b": np.float32(0.25)}
    if family == "fm":
        p["v"] = (0.3 * rng.standard_normal((F, K))).astype(np.float32)
    return p


def _config(family, backend="pallas"):
    cfg = {"num_features": F, "sdot_backend": backend}
    if family == "fm":
        cfg["num_factors"] = K
    return cfg


def _snapshot(family="fm", seed=0, seq=0):
    return pack_snapshot(family, _config(family), _params(family, seed),
                         seq=seq)


def _engine(family="fm", seed=0):
    snap = _snapshot(family, seed)
    return ScoringEngine.from_snapshot_bytes(snap, device="cpu"), snap


def _requests(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = rng.randint(1, 6)
        out.append((rng.randint(0, F, k).tolist(),
                    (rng.rand(k) + 0.1).astype(np.float32).tolist()))
    return out


# ---- snapshots ----------------------------------------------------------------

@pytest.mark.parametrize("family", ["linear", "fm"])
def test_snapshot_bytes_and_digest_match_jax(family):
    params, cfg = _params(family, 1), _config(family)
    ours = pack_snapshot(family, cfg, params, seq=3)
    theirs = jax_pack(family, cfg, params, seq=3)
    assert ours == theirs
    assert snapshot_digest(ours) == snapshot_digest(theirs)
    # each package unpacks the other's bytes to the same leaves
    fam, cfg2, got, binner_t = unpack_snapshot(theirs)
    fam_j, cfg_j, want, binner = jax_unpack(ours)
    assert fam == fam_j == family and cfg2 == cfg_j == cfg
    assert binner is None and binner_t is None
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].shape == np.asarray(want[k]).shape  # 0-d b stays 0-d
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        assert got[k].flags.writeable  # owned copies, not buffer views


def test_state_dict_packs_like_numpy_params():
    eng, snap = _engine("fm", seed=2)
    again = pack_snapshot("fm", _config("fm"), eng.model.state_dict())
    assert again == snap


def test_snapshot_rejects_torn_and_unported():
    snap = _snapshot("linear")
    with pytest.raises(ValueError, match="trailing"):
        unpack_snapshot(snap + b"\0\0")
    with pytest.raises(ValueError, match="ends inside"):
        unpack_snapshot(snap[:-4])
    with pytest.raises(ValueError, match="magic"):
        unpack_snapshot(b"NOTSNAP0" + snap[8:])
    with pytest.raises(ValueError, match="ffm params need keys"):
        ScoringEngine.from_snapshot_bytes(pack_snapshot(
            "ffm", {"num_features": F, "num_fields": 2},
            {"w": np.zeros(F, np.float32)}), device="cpu")
    gbdt = _gbdt_snapshot()
    with pytest.raises(ValueError, match="ends inside the binner"):
        unpack_snapshot(gbdt[:-4])
    with pytest.raises(ValueError, match="fitted"):
        pack_snapshot("gbdt", GBDT_CONFIG, {},
                      binner=QuantileBinner(num_bins=8, missing_aware=True,
                                            device="cpu"))
    with pytest.raises(ValueError, match="unknown model family"):
        pack_snapshot("svm", {}, {})


@pytest.mark.parametrize("family", ["linear", "fm"])
def test_jax_snapshot_scores_in_port_engine(family):
    """A snapshot packed by the JAX package scores in the port's engine
    within 2e-5 of the JAX engine, request for request."""
    snap = jax_pack(family, _config(family), _params(family, 4))
    want_eng = JaxEngine.from_snapshot_bytes(snap)
    eng = ScoringEngine.from_snapshot_bytes(snap, device="cpu")
    assert eng.digest == want_eng.digest == snapshot_digest(snap)
    it, jit = ScoringIterator(device="cpu"), JaxIterator()
    for n, seed in ((1, 0), (5, 1), (33, 2)):
        reqs = _requests(n, seed)
        got = eng.score(it.pack(reqs)[0])
        want = want_eng.score(jit.pack(reqs)[0])
        assert got.shape == (n,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **TOL)


# ---- gbdt snapshots (a forest and its binner) ---------------------------------

GBDT_CONFIG = {"num_features": F, "num_trees": 3, "max_depth": 3,
               "num_bins": 8, "learning_rate": 0.5, "missing_aware": True}


@functools.lru_cache(maxsize=None)
def _gbdt_parts():
    """A JAX-trained sparse forest and its binner over F features, as
    numpy (forest, cuts), from the same COO generator as the requests."""
    from dmlc_core_tpu.data.staging import PaddedBatch as JaxBatch
    reqs = _requests(300, seed=21)
    rid = np.concatenate([[r] * len(i) for r, (i, _) in enumerate(reqs)])
    idx = np.concatenate([i for i, _ in reqs]).astype(np.int32)
    val = np.concatenate([v for _, v in reqs]).astype(np.float32)
    dense = np.full((300, F), np.nan, np.float32)
    dense[rid, idx] = val
    y = np.where(np.isnan(dense[:, 3]), 1.0, dense[:, 3] > 0.6)
    binner = JaxBinner(num_bins=8, missing_aware=True).fit_sparse(idx, val, F)
    row_ptr = np.concatenate([[0], np.cumsum([len(i) for i, _ in reqs])])
    batch = JaxBatch(label=jnp.asarray(y, jnp.float32),
                     weight=jnp.ones(300, jnp.float32),
                     row_ptr=jnp.asarray(row_ptr, jnp.int32),
                     index=jnp.asarray(idx), value=jnp.asarray(val),
                     num_rows=jnp.asarray(np.int32(300)))
    forest = JaxGBDT(histogram="xla", **GBDT_CONFIG).fit_batch(batch, binner)
    return {k: np.asarray(v) for k, v in forest.items()}, np.asarray(
        binner.cuts)


def _gbdt_snapshot(seq=0):
    forest, cuts = _gbdt_parts()
    return jax_pack("gbdt", GBDT_CONFIG, forest,
                    binner=_jax_binner(cuts), seq=seq)


def _jax_binner(cuts):
    b = JaxBinner(num_bins=8, missing_aware=True)
    b.cuts = jnp.asarray(cuts)
    return b


def test_gbdt_snapshot_round_trips_between_packages():
    """A JAX-packed gbdt snapshot unpacks in the port and a port-packed one
    in the JAX package: same bytes, same digest, same cuts_digest."""
    forest, cuts = _gbdt_parts()
    theirs = _gbdt_snapshot(seq=4)
    fam, cfg, params, binner = unpack_snapshot(theirs)
    assert fam == "gbdt" and cfg == GBDT_CONFIG
    assert binner.cuts_digest() == _jax_binner(cuts).cuts_digest()
    assert binner.missing_aware and binner.num_bins == 8
    for k, v in forest.items():
        np.testing.assert_array_equal(params[k], v)
    ours = pack_snapshot("gbdt", cfg, params, binner=binner, seq=4)
    assert ours == theirs and snapshot_digest(ours) == snapshot_digest(theirs)
    fam_j, _, params_j, binner_j = jax_unpack(ours)
    assert fam_j == "gbdt" and binner_j.cuts_digest() == binner.cuts_digest()
    assert sorted(params_j) == sorted(forest)


def test_gbdt_snapshot_scores_in_port_engine_and_server():
    """A CPU engine and ScoringServer serving a JAX-packed gbdt snapshot
    return the JAX engine's scores within 2e-5."""
    snap = _gbdt_snapshot(seq=2)
    want_eng = JaxEngine.from_snapshot_bytes(snap)
    eng = ScoringEngine.from_snapshot_bytes(snap, device="cpu")
    assert eng.digest == want_eng.digest and eng.family == "gbdt"
    it, jit = ScoringIterator(device="cpu"), JaxIterator()
    for n, seed in ((1, 30), (7, 31), (64, 32)):
        reqs = _requests(n, seed)
        got = eng.score(it.pack(reqs)[0])
        want = want_eng.score(jit.pack(reqs)[0])
        assert got.shape == (n,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **TOL)
    with ScoringServer(max_delay_us=200, device="cpu") as srv:
        assert push_snapshot("127.0.0.1", srv.port, snap, seq=2)["ok"]
        url = f"http://127.0.0.1:{srv.http_port}"
        reqs = _requests(9, seed=33)
        doc = _score_http(url, reqs)
        assert doc["model"] == snapshot_digest(snap) and doc["seq"] == 2
        np.testing.assert_allclose(np.asarray(doc["scores"], np.float32),
                                   want_eng.score(jit.pack(reqs)[0]), **TOL)
    fam, cfg, params, _ = jax_unpack(snap)
    with pytest.raises(ValueError, match="binner"):
        ScoringEngine.from_snapshot_bytes(
            jax_pack(fam, cfg, {k: np.asarray(v) for k, v in params.items()}),
            device="cpu")


# ---- request packing ----------------------------------------------------------

def test_scoring_iterator_pack_parity_and_arena_reuse():
    it, jit = ScoringIterator(device="cpu"), JaxIterator()
    reqs = [([1, 5], [1.0, 2.0]), ([2, 3, 7], [0.5, 0.25, 4.0])]
    batch, n = it.pack(reqs)
    want, _ = jit.pack(reqs)
    assert n == 2 and batch.batch_size == 2 and batch.num_rows == 2
    for k in ("label", "weight", "row_ptr", "index", "value"):
        np.testing.assert_array_equal(getattr(batch, k).numpy(),
                                      np.asarray(getattr(want, k)))
    arena = it._arenas[(2, 8)]
    before = telemetry.counter_get("serve.arena_alloc")
    batch2, _ = it.pack([([4], [9.0]), ([6], [8.0])])  # same geometry
    assert telemetry.counter_get("serve.arena_alloc") == before
    assert it._arenas[(2, 8)] is arena
    # on the CPU the batch aliases the recycled arena (one buffer, no copy)
    assert batch2.value.data_ptr() == \
        arena.buf.data_ptr() + 4 * arena.spans["value"][0]
    np.testing.assert_array_equal(batch2.value.numpy(),
                                  [9.0, 8.0, 0, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(batch2.row_ptr.numpy(), [0, 1, 2])
    it.pack([([1], [1.0])] * 3)  # new geometry -> new arena
    assert telemetry.counter_get("serve.arena_alloc") == before + 1


def test_scoring_iterator_rejects_bad_rows():
    it = ScoringIterator(max_batch=4, device="cpu")
    with pytest.raises(ValueError):
        it.pack([])
    with pytest.raises(ValueError):
        it.pack([([1, 2], [1.0])])  # index/value length mismatch
    with pytest.raises(ValueError):
        it.pack([([1], [1.0])] * 5)  # over max_batch


# ---- micro-batch queue --------------------------------------------------------

def test_micro_batch_queue_concurrent_correctness():
    eng, _ = _engine("fm", seed=4)
    q = MicroBatchQueue(lambda: eng, max_batch=64, max_delay_us=2000,
                        device="cpu")
    try:
        reqs = [_requests(np.random.RandomState(i).randint(1, 5),
                          seed=100 + i) for i in range(24)]
        futs, errs = [], []

        def submit(rows):
            try:
                futs.append((rows, q.submit(rows)))
            except Exception as exc:  # pragma: no cover
                errs.append(exc)

        threads = [threading.Thread(target=submit, args=(r,)) for r in reqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errs and len(futs) == len(reqs)
        it = ScoringIterator(device="cpu")
        for rows, fut in futs:
            scores, digest, seq = fut.result(timeout=30)
            assert digest == eng.digest
            np.testing.assert_allclose(scores, eng.score(it.pack(rows)[0]),
                                       **TOL)
        assert q.batches < len(reqs)  # coalesced, not one batch a request
    finally:
        q.close()


def test_micro_batch_tuner_policy():
    q = MicroBatchQueue(lambda: None, max_batch=64, max_delay_us=1000,
                        device="cpu")
    try:
        t = MicroBatchTuner(q, margin=0.05, max_max_batch=128,
                            max_delay_cap_us=1000)
        r1 = t.decide(1000.0)
        assert r1["action"] == "step" and q.max_batch == 128
        r2 = t.decide(500.0)  # regression -> revert and block
        assert r2["action"] == "revert" and q.max_batch == 64
        assert t.decide(1000.0)["action"] == "hold"
        assert t.decide(1000.0)["action"] == "hold" and t.converged
    finally:
        q.close()


# ---- HTTP surface -------------------------------------------------------------

def _post(url, body, timeout=30):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type":
                                          "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _score_http(url, rows):
    body = json.dumps({"rows": [{"index": list(map(int, i)),
                                 "value": list(map(float, v))}
                                for i, v in rows]}).encode()
    return json.loads(_post(url + "/score", body).read())


def test_scoring_server_http_contracts():
    with ScoringServer(max_delay_us=200, device="cpu") as srv:
        url = f"http://127.0.0.1:{srv.http_port}"
        # 503 + Retry-After (not a hang) before the first snapshot
        for path, kw in (("/metrics", {}), ("/score", {"data": b"{}"})):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(
                    url + path, method="POST" if kw else "GET", **kw),
                    timeout=10)
            assert ei.value.code == 503
            assert ei.value.headers.get("Retry-After")
        # liveness stays ungated
        assert urllib.request.urlopen(url + "/healthz",
                                      timeout=10).read() == b"ok\n"
        eng, snap = _engine("fm", seed=7)
        rep = push_snapshot("127.0.0.1", srv.port, snap)
        assert rep["ok"] and rep["digest"] == snapshot_digest(snap)
        rows = _requests(3, seed=42)
        doc = _score_http(url, rows)
        assert doc["model"] == snapshot_digest(snap)
        np.testing.assert_array_equal(
            np.asarray(doc["scores"], np.float32),
            eng.score(ScoringIterator(device="cpu").pack(rows)[0]))
        text = urllib.request.urlopen(url + "/metrics", timeout=10) \
            .read().decode()
        assert "dmlctpu_serve_rows_total" in text


def test_scoring_server_malformed_400_never_touches_queue():
    with ScoringServer(max_delay_us=200, device="cpu") as srv:
        push_snapshot("127.0.0.1", srv.port, _snapshot("linear"))
        url = f"http://127.0.0.1:{srv.http_port}/score"
        before_req = telemetry.counter_get("serve.requests")
        before_mal = telemetry.counter_get("serve.malformed")
        bad = [b"not json", b"{}", b'{"rows": []}', b'{"rows": "x"}',
               b'{"rows": [{"index": [1], "value": [1.0, 2.0]}]}',
               b'{"rows": [{"index": [-1], "value": [1.0]}]}',
               b'{"rows": [{"index": ["a"], "value": [1.0]}]}',
               b'{"rows": [{"index": [2147483648], "value": [1.0]}]}']
        for body in bad:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(url, body, timeout=10)
            assert ei.value.code == 400
        assert telemetry.counter_get("serve.requests") == before_req
        assert telemetry.counter_get("serve.malformed") == \
            before_mal + len(bad)
        # the malformed fault point takes the same 400 path
        good = json.dumps({"rows": [{"index": [1], "value": [1.0]}]}).encode()
        with faultinject.armed("serving.request.malformed=err@1.0;seed=3"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(url, good, timeout=10)
            assert ei.value.code == 400
        assert json.loads(_post(url, good, timeout=10).read())["scores"]


def test_torn_push_rejected_and_hot_swap_changes_digest():
    with ScoringServer(max_delay_us=200, device="cpu") as srv:
        url = f"http://127.0.0.1:{srv.http_port}"
        eng_a, snap_a = _engine("fm", seed=11)
        assert push_snapshot("127.0.0.1", srv.port, snap_a, seq=1)["ok"]
        rows = _requests(2, seed=1)
        _, snap_b = _engine("fm", seed=12)
        before = telemetry.counter_get("serve.swap_rejected")
        with faultinject.armed("serving.snapshot.drop=corrupt@1.0;seed=5"):
            rep = push_snapshot("127.0.0.1", srv.port, snap_b, seq=2)
        assert not rep["ok"] and "digest mismatch" in rep["error"]
        assert telemetry.counter_get("serve.swap_rejected") == before + 1
        doc = _score_http(url, rows)
        assert doc["model"] == snapshot_digest(snap_a)  # old model lives
        # a clean push of B swaps: digest, seq and scores follow it
        rep = push_snapshot("127.0.0.1", srv.port, snap_b, seq=2)
        assert rep["ok"] and rep["digest"] == snapshot_digest(snap_b)
        doc_b = _score_http(url, rows)
        assert doc_b["model"] == snapshot_digest(snap_b)
        assert doc_b["seq"] == 2 and srv._engine.seq == 2
        assert doc_b["scores"] != doc["scores"]
        # a snapshot that cannot build its model (an ffm without its
        # factor table) is rejected and B keeps serving
        bad = jax_pack("ffm", {"num_features": F, "num_fields": 2,
                               "num_factors": 2},
                       {"w": np.zeros(F, np.float32)})
        rep = push_snapshot("127.0.0.1", srv.port, bad, seq=3)
        assert not rep["ok"] and "ffm params need keys" in rep["error"]
        assert _score_http(url, rows)["model"] == snapshot_digest(snap_b)


def test_503_during_swap_and_jax_pusher_interop():
    """While a swap is mid-flight /score and /metrics answer 503 at once;
    the JAX package's pusher speaks the same 0xff9a wire to this server."""
    with ScoringServer(max_delay_us=200, device="cpu") as srv:
        snap = jax_pack("linear", _config("linear"), _params("linear", 3))
        rep = jax_push("127.0.0.1", srv.port, snap, seq=5)
        assert rep["ok"] and rep["digest"] == snapshot_digest(snap)
        url = f"http://127.0.0.1:{srv.http_port}"
        srv._swapping = True  # pin the gate
        t0 = time.monotonic()
        for path in ("/metrics", "/score"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                if path == "/score":
                    _post(url + path, b"{}", timeout=10)
                else:
                    urllib.request.urlopen(url + path, timeout=10)
            assert ei.value.code == 503
        assert time.monotonic() - t0 < 5  # immediate, not a hang
        srv._swapping = False
        doc = _score_http(url, _requests(2, seed=9))
        assert doc["model"] == snapshot_digest(snap) and doc["seq"] == 5


def test_trace_context_rides_score_and_snapshot_push():
    """The pusher's ambient context rides FRAME_SNAPSHOT and a /score body
    may carry one: the server adopts each, so the swap span and the
    micro-batch spans land in the caller's trace (armed through the port's
    switch, which the port's spans see, and read back through the JAX
    package's trace dump: both packages share the native registry)."""
    from dmlc_core_tpu import telemetry as native_trace
    if not native_trace.enabled():
        pytest.skip("tracing is compiled out")
    before = telemetry.counter_get("trace.ctx_propagated")
    telemetry.trace_start()
    try:
        with ScoringServer(max_delay_us=200, device="cpu") as srv:
            tid_push = telemetry.new_trace_id()
            telemetry.set_trace_context(tid_push, tid_push)
            try:
                assert telemetry.trace_context_wire()["id"] == \
                    format(tid_push, "016x")
                assert push_snapshot("127.0.0.1", srv.port,
                                     _snapshot("fm", seed=3))["ok"]
            finally:
                telemetry.clear_trace_context()
            tid_req = telemetry.new_trace_id()
            body = json.dumps({
                "rows": [{"index": i, "value": v}
                         for i, v in _requests(2, seed=11)],
                "trace": {"id": format(tid_req, "016x"),
                          "span": format(tid_req, "016x"), "lineage": -1},
            }).encode()
            url = f"http://127.0.0.1:{srv.http_port}"
            assert len(json.loads(_post(url + "/score", body).read())
                       ["scores"]) == 2
    finally:
        telemetry.trace_stop()
        telemetry.clear_trace_context()
    assert telemetry.counter_get("trace.ctx_propagated") >= before + 2
    by = {}
    for e in native_trace.trace_dump()["traceEvents"]:
        if e.get("ph") == "X":
            by.setdefault(e["name"], []).append(e)
    assert by["serve.snapshot_apply"][0]["args"]["trace_id"] == \
        format(tid_push, "016x")
    for name in ("serve.queue_wait", "serve.pack", "serve.device"):
        assert any(e.get("args", {}).get("trace_id") == format(tid_req, "016x")
                   for e in by.get(name, [])), name
