"""The port's telemetry against the JAX package's: the pure functions on the
same snapshot dicts, a window and a trace over a CPU staging epoch, the
flight record, the log sink and every HTTP path.

Both packages bind one native registry (``build/libdmlctpu.so``), so what
one records the other reads; the pure functions are compared on dicts made
from a numpy seed, and the registry-backed ones on one live registry.
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from dmlc_core_tpu import _native as jnative
from dmlc_core_tpu import telemetry as jtel
from dmlc_core_tpu import telemetry_http as jhttp
from dmlc_core_tpu.tracker import metrics as jmetrics
from dmlc_core_tpu_torch import telemetry, telemetry_http
from dmlc_core_tpu_torch.data import DeviceStagingIter
from dmlc_core_tpu_torch.tracker import metrics

COUNTERS = (
    "parse.busy_us", "parse.input_wait_us", "shard.part_us",
    "shard.producer_wait_us", "pack.busy_us", "pack.input_wait_us",
    "h2d.busy_us", "h2d.wait_us", "shard.bytes", "parse.bytes",
    "record.bytes", "io.retry", "io.giveup", "io.retry_wait_us",
    "record.corrupt_skipped", "shard.part_retries", "cache.busy_us",
    "cache.wait_us", "cache.hit_bytes", "cache.bytes_copied",
    "cache.codec.bytes_in", "cache.codec.bytes_out", "cache.codec.decode_us",
    "serve.score_busy_us", "serve.queue_wait_us", "serve.rows",
    "shard.parts")


def _snapshot_pair(seed: int):
    """(before, after) registry snapshots: random counters (some stages
    idle, on odd seeds one counter moved backwards), gauges, and
    histograms of 24 buckets."""
    rng = np.random.default_rng(seed)
    before = {"enabled": True, "counters": {}, "gauges": {},
              "histograms": {}}
    after = {"enabled": True, "counters": {}, "gauges": {}, "histograms": {}}
    for name in COUNTERS:
        if rng.random() < 0.25:
            continue  # a stage that never ran
        b = int(rng.integers(0, 10**7))
        before["counters"][name] = b
        after["counters"][name] = b + int(rng.integers(0, 10**7))
    if seed % 2:
        after["counters"]["h2d.busy_us"] = 0  # a restart: backwards
    for name in ("pack.queue_depth", "h2d.queue_depth", "resource.rss_bytes"):
        before["gauges"][name] = int(rng.integers(0, 100))
        after["gauges"][name] = int(rng.integers(0, 100))
    for name in ("serve.latency_us", "h2d.batch_us"):
        buckets = [int(x) for x in rng.integers(0, 50, 24)]
        if seed % 3 == 0:
            buckets[-1] = 0
        after["histograms"][name] = {"count": sum(buckets),
                                     "sum": int(rng.integers(0, 10**9)),
                                     "buckets": buckets}
    after["histograms"]["empty"] = {"count": 0, "sum": 0,
                                    "buckets": [0] * 24}
    return before, after


@pytest.mark.parametrize("seed", range(8))
def test_pure_functions_equal_the_jax_package(seed):
    before, after = _snapshot_pair(seed)
    wall = float(np.random.default_rng(seed).random()) * 10
    attr = telemetry.stall_attribution(before, after, wall_s=wall)
    assert attr == jtel.stall_attribution(before, after, wall_s=wall)
    assert telemetry.format_stall_table(attr) == \
        jtel.format_stall_table(attr)
    assert telemetry.counters_delta(before, after) == \
        jtel.counters_delta(before, after)
    assert telemetry.snapshot_restarted(before, after) == \
        jtel.snapshot_restarted(before, after) == bool(seed % 2)
    snaps = [before, after, _snapshot_pair(seed + 100)[1]]
    merged = telemetry.merge_snapshots(snaps)
    assert merged == jtel.merge_snapshots(snaps)
    for hist in merged["histograms"].values():
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert telemetry.histogram_quantile(hist, q) == \
                jtel.histogram_quantile(hist, q)
    sources = [({"rank": "0", "host": 'a"b'}, after), ({}, before)]
    assert telemetry_http.prometheus_text(sources) == \
        jhttp.prometheus_text(sources)


def _libsvm(tmp_path, rows=6000, seed=5):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(rows):
        idx = np.sort(rng.choice(4096, size=8 + i % 8, replace=False))
        lines.append(f"{i % 2} " + " ".join(
            f"{j}:{v:.3f}" for j, v in zip(idx, rng.random(idx.size))))
    p = tmp_path / "telemetry.libsvm"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def test_window_over_a_cpu_epoch_names_a_stage(tmp_path):
    it = DeviceStagingIter(_libsvm(tmp_path), batch_size=512,
                           nnz_bucket=8192, num_workers=2, device="cpu")
    with telemetry.window() as w:
        n = sum(1 for _ in it)
    assert n == 12 and w.closed and w.wall_s > 0
    assert w.bytes_processed() > 0 and w.mb_per_s() > 0
    assert w.bound_stage in ("shard", "pack", "h2d")
    assert w.delta["h2d.batches"] == n
    table = telemetry.format_stall_table(w.attribution)
    assert f"{w.bound_stage}-bound" in table
    # the window's attribution is the JAX package's on the same snapshots
    assert w.attribution == jtel.stall_attribution(w.before, w.after,
                                                   wall_s=w.wall_s)
    it.close()


def test_trace_dump_holds_the_port_spans(tmp_path):
    it = DeviceStagingIter(_libsvm(tmp_path, rows=1500), batch_size=512,
                           nnz_bucket=8192, device="cpu")
    telemetry.trace_start()
    try:
        assert telemetry.trace_armed()
        with telemetry.span("test.torch_span"):
            n = sum(1 for _ in it)
    finally:
        telemetry.trace_stop()
    text = telemetry.trace_dump_json()
    assert telemetry.json_validate(text) and jtel.json_validate(text)
    names = [e["name"] for e in json.loads(text)["traceEvents"]]
    assert names.count("h2d.stage_batch") == n == 3
    assert "test.torch_span" in names
    assert telemetry.trace_dump() == json.loads(text)
    for bad in ("", "{", '{"a": [1, 2}', "[1,"):
        assert telemetry.json_validate(bad) is jtel.json_validate(bad) \
            is False
    it.close()


def test_flight_record_has_the_jax_record_keys():
    mine = telemetry.flight_record("torch test")
    theirs = jtel.flight_record("jax test")
    assert mine.keys() == theirs.keys()
    assert mine["reason"] == "torch test"
    assert mine["registry"].keys() == theirs["registry"].keys()


def test_capture_logs_catches_a_native_warning(tmp_path):
    dump = tmp_path / "flight.json"
    stalls0 = telemetry.watchdog_stall_count()
    seen = []
    with telemetry.capture_logs(min_severity=2,
                                forward=lambda *a: seen.append(a)) as recs:
        with telemetry.watchdog(deadline_s=0.2, poll_s=0.05,
                                dump_path=str(dump)):
            telemetry.counter_add("h2d.batches", 1)
            deadline = time.monotonic() + 10.0
            while (telemetry.watchdog_stall_count() == stalls0
                   and time.monotonic() < deadline):
                time.sleep(0.05)
    assert telemetry.watchdog_stall_count() > stalls0
    assert any(sev >= 2 and where.startswith("watchdog")
               and "pipeline stall" in msg for sev, where, msg in recs)
    assert len(seen) >= len(recs)
    rec = telemetry.last_flight_record()
    assert rec is not None and rec["stalled_stage"] == "h2d"
    assert json.loads(dump.read_text())["stalled_stage"] == "h2d"
    # the sink is restored: a line after the capture is not recorded
    n = len(recs)
    jnative.log_emit(3, "after the capture")
    assert len(recs) == n


def _get(url):
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


PATHS = ("/metrics", "/healthz", "/trace", "/timeseries",
         "/timeseries?points=2", "/flight", "/flight?fresh=1", "/snapshot",
         "/autotune", "/jobtrace", "/jobtimeseries", "/shards",
         "/dataservice", "/nope")


@pytest.mark.parametrize("tracker", [False, True],
                         ids=["worker", "tracker"])
def test_every_http_path_answers_as_the_jax_server(tracker):
    telemetry.counter_add("test.http_counter", 3)
    servers, aggs = [], []
    try:
        for http, mod in ((telemetry_http, metrics), (jhttp, jmetrics)):
            kw = {}
            if tracker:
                agg = mod.MetricsAggregator(host_ip="127.0.0.1", port=0)
                aggs.append(agg)
                kw = dict(provider=agg.provider,
                          board_provider=agg.board_provider,
                          trace_provider=agg.job_trace,
                          timeseries_provider=agg.job_timeseries)
            servers.append(http.serve(**kw))
        for path in PATHS:
            mine = _get(servers[0].url + path)
            theirs = _get(servers[1].url + path)
            assert mine[:2] == theirs[:2], path
            if path in ("/jobtrace", "/shards") and not tracker:
                assert mine[2] == theirs[2]  # the same 404 text
            if mine[1] == "application/json":
                json.loads(mine[2])
        for server in servers:  # no scoring engine: the same 404
            post = urllib.request.Request(server.url + "/score", data=b"{}")
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(post)
            assert err.value.code == 404
    finally:
        for s in servers:
            s.close()
        for a in aggs:
            a.close()
