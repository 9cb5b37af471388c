"""The port's tracker against the JAX package's: the topology maps, the
rabit rendezvous (threads as workers, clients of either package against a
tracker of either package), recovery, the metrics channel both ways, the
two-process clock-skew merge, and the shard and lease boards.

Every tracker and aggregator binds a free port (the tests run in parallel
processes).
"""
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from dmlc_core_tpu import telemetry as jtel
from dmlc_core_tpu.tracker import RabitTracker as JaxTracker
from dmlc_core_tpu.tracker import WorkerClient as JaxClient
from dmlc_core_tpu.tracker import metrics as jmetrics
from dmlc_core_tpu.tracker import rendezvous as jrdv
from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.tracker import RabitTracker, WorkerClient, metrics
from dmlc_core_tpu_torch.tracker import rendezvous

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tracker(cls, world):
    port = _free_port()
    return cls("127.0.0.1", world, port=port, port_end=port + 200)


def test_topology_maps_equal_the_jax_package():
    for world in range(1, 65):
        assert rendezvous.binary_tree(world) == jrdv.binary_tree(world)
        assert rendezvous.link_map(world) == jrdv.link_map(world)
        tree, parent, ring = rendezvous.link_map(world)
        for r in range(world):  # the relabelled ring is 0 -> 1 -> ... -> 0
            assert ring[r] == ((r - 1) % world, (r + 1) % world)


def _worker(client_cls, results, idx, port, world):
    client = client_cls(tracker_uri="127.0.0.1", tracker_port=port,
                        jobid=f"job-{idx}")
    client.start(world_size=world)
    for sock in client.peer_socks.values():
        sock.sendall(bytes([client.rank]))
    seen = {r: s.recv(1)[0] for r, s in client.peer_socks.items()}
    client.tracker_print(f"worker {client.rank} linked to {sorted(seen)}")
    results[idx] = (client.rank, client.world_size, seen)
    client.shutdown()


def _rendezvous(tracker, clients):
    tracker.start()
    results = {}
    threads = [threading.Thread(target=_worker, daemon=True,
                                args=(cls, results, i, tracker.port,
                                      len(clients)))
               for i, cls in enumerate(clients)]
    for t in threads:
        t.start()
    tracker.join(timeout=60)
    for t in threads:
        t.join(timeout=10)
    world = len(clients)
    assert sorted(r for r, _, _ in results.values()) == list(range(world))
    links = {}
    for rank, ws, seen in results.values():
        assert ws == world
        assert all(peer == byte for peer, byte in seen.items())
        links[rank] = set(seen)
    for r, peers in links.items():  # symmetric links
        assert all(r in links[p] for p in peers)
    return results


def test_eight_threaded_workers_rendezvous():
    tracker = _tracker(RabitTracker, 8)
    _rendezvous(tracker, [WorkerClient] * 8)
    assert tracker.start_time is not None and tracker.end_time is not None
    tracker.stop()


@pytest.mark.parametrize("tracker_cls", [RabitTracker, JaxTracker],
                         ids=["port-tracker", "jax-tracker"])
def test_clients_of_both_packages_on_one_tracker(tracker_cls):
    tracker = _tracker(tracker_cls, 6)
    _rendezvous(tracker, [WorkerClient, JaxClient] * 3)
    tracker.stop()


def test_recover_reclaims_rank_and_relinks():
    tracker = _tracker(RabitTracker, 2)
    tracker.start()
    clients = {}

    def start(idx):
        c = WorkerClient(tracker_uri="127.0.0.1", tracker_port=tracker.port,
                         jobid=f"job-{idx}")
        clients[idx] = c.start(world_size=2)

    threads = [threading.Thread(target=start, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    old = {i: c.rank for i, c in clients.items()}
    dead = clients[1]  # dies without a shutdown: its sockets vanish
    for s in dead.peer_socks.values():
        s.close()
    dead._listener.close()
    back = {}

    def recover(idx, cls):
        c = cls(tracker_uri="127.0.0.1", tracker_port=tracker.port,
                jobid=f"job-{idx}")
        back[idx] = c.start(cmd="recover")

    # the dead rank comes back as a JAX-package client: one wire
    t1 = threading.Thread(target=recover, args=(1, JaxClient))
    t0 = threading.Thread(target=recover, args=(0, WorkerClient))
    t1.start()
    t0.start()
    t1.join(timeout=15)
    t0.join(timeout=15)
    assert {i: c.rank for i, c in back.items()} == old
    a, b = back[0], back[1]
    a.peer_socks[b.rank].sendall(b"x")
    assert b.peer_socks[a.rank].recv(1) == b"x"
    a.shutdown()
    b.shutdown()
    tracker.join(timeout=10)
    # a recover the tracker cannot resolve is refused, not stranded
    tracker = _tracker(RabitTracker, 2)
    tracker.start()
    lost = WorkerClient(tracker_uri="127.0.0.1", tracker_port=tracker.port,
                        jobid="never-registered")
    with pytest.raises(Exception):
        lost.start(cmd="recover")
    tracker.stop()


def _fixed_snapshot(seed):
    rng = np.random.default_rng(seed)
    return {"enabled": True,
            "counters": {k: int(rng.integers(1, 10**6)) for k in (
                "parse.busy_us", "pack.busy_us", "h2d.busy_us",
                "h2d.batches", "parse.rows")},
            "gauges": {"telemetry.clock_offset_us": 0},
            "histograms": {"h2d.batch_us": {
                "count": 6, "sum": 99, "buckets": [1, 2, 3] + [0] * 21}}}


def _host_view(view):
    """A job snapshot without the times that differ between two reads."""
    out = dict(view)
    out["hosts"] = {r: {k: v for k, v in h.items() if k != "age_s"}
                    for r, h in view["hosts"].items()}
    return out


def test_pushes_cross_packages_with_equal_job_snapshots(monkeypatch):
    """Rank 0 pushes through the port's pusher, rank 1 through the JAX
    package's push_once, each to both aggregators: the two job views are
    equal."""
    snaps = {0: _fixed_snapshot(0), 1: _fixed_snapshot(1)}
    aggs = [metrics.MetricsAggregator(host_ip="127.0.0.1", port=0),
            jmetrics.MetricsAggregator(host_ip="127.0.0.1", port=0)]
    try:
        monkeypatch.setattr(telemetry, "snapshot", lambda: snaps[0])
        for agg in aggs:
            pusher = metrics.MetricsPusher("127.0.0.1", agg.port, rank=0,
                                           interval_s=3600.0)
            assert pusher.push()
            pusher.close(final_push=False)
        monkeypatch.setattr(jtel, "snapshot", lambda: snaps[1])
        for agg in aggs:
            assert jmetrics.push_once("127.0.0.1", agg.port, rank=1) is None
        views = [_host_view(a.job_snapshot()) for a in aggs]
        assert views[0] == views[1]
        assert views[0]["num_hosts"] == 2
        assert views[0]["hosts"][0]["snapshot"] == snaps[0]
        assert views[0]["fleet"]["counters"]["h2d.batches"] == \
            snaps[0]["counters"]["h2d.batches"] + \
            snaps[1]["counters"]["h2d.batches"]
        assert aggs[0].format_job_table() == aggs[1].format_job_table()
    finally:
        for a in aggs:
            a.close()


_SKEW_CHILD = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.tracker import metrics as tm

port = int(sys.argv[2])
telemetry.trace_start()
telemetry.record_span("clockskew.send", telemetry.now_us(), 50)
time.sleep(0.3)   # a real-time gap far above the probe's error
p = tm.MetricsPusher("127.0.0.1", port, rank=0, interval_s=3600.0)
# the offset gauge set during push N ships in push N+1
ok = all(p.push() for _ in range(3))
print("CHILD", ok, p.clock_offset_us, flush=True)
sys.exit(0 if ok else 1)
"""


@pytest.mark.parametrize("aggregator", ["port", "jax"])
def test_two_process_clock_skew_merge(aggregator):
    """A child whose clock runs 5 s ahead (DMLCTPU_CLOCK_SKEW_US) records a
    send span and pushes probes and its trace; the merge recovers the skew
    and orders the send before the tracker's receive on one axis."""
    mod = metrics if aggregator == "port" else jmetrics
    skew = 5_000_000
    agg = mod.MetricsAggregator(host_ip="127.0.0.1", port=0)
    telemetry.trace_start()
    try:
        env = dict(os.environ, DMLCTPU_CLOCK_SKEW_US=str(skew))
        proc = subprocess.run(
            [sys.executable, "-c", _SKEW_CHILD, REPO, str(agg.port)],
            env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        t_recv = telemetry.now_us()
        telemetry.record_span("clockskew.recv", t_recv, 50)
        merged = agg.job_trace()
    finally:
        telemetry.trace_stop()
        agg.close()
    off = merged["otherData"]["offsets_us"]["0"]
    assert abs(off + skew) < 1_000_000, f"offset {off} vs skew {-skew}"
    send = next(e for e in merged["traceEvents"]
                if e["name"] == "clockskew.send")
    recv = next(e for e in merged["traceEvents"]
                if e["name"] == "clockskew.recv")
    assert send["pid"] == 0 and recv["pid"] == -1
    assert send["ts"] < recv["ts"] < send["ts"] - off


def _timeless(x):
    if isinstance(x, dict):
        return {k: _timeless(v) for k, v in x.items()
                if k not in ("t", "age_s")}
    if isinstance(x, list):
        return [_timeless(v) for v in x]
    return x


def test_shard_and_lease_boards_equal_under_one_sequence():
    rng = np.random.default_rng(11)
    boards = [(metrics.ShardBoard(keep_epochs=3),
               metrics.LeaseBoard(keep_epochs=2)),
              (jmetrics.ShardBoard(keep_epochs=3),
               jmetrics.LeaseBoard(keep_epochs=2))]
    workers = [f"w{i}" for i in range(4)]
    for _ in range(400):
        op = int(rng.integers(11))
        rank, epoch = int(rng.integers(4)), int(rng.integers(5))
        shard, worker = int(rng.integers(12)), workers[int(rng.integers(4))]
        client = f"c{int(rng.integers(2))}"
        flagged = {int(x) for x in rng.integers(0, 4, 2)}
        calls = [
            lambda s, l: s.register(rank, epoch, [shard, shard + 1]),
            lambda s, l: s.claim(rank, epoch, shard),
            lambda s, l: s.steal(rank, epoch, flagged),
            lambda s, l: s.done(rank, epoch, shard),
            lambda s, l: l.worker_register(worker, "10.0.0.1", 7000 + rank),
            lambda s, l: l.worker_heartbeat(worker),
            lambda s, l: l.worker_leave(worker),
            lambda s, l: l.lease_register(client, epoch, range(shard)),
            lambda s, l: l.lease_assign(client, epoch, shard),
            lambda s, l: l.lease_done(client, epoch, shard, worker),
            lambda s, l: l.lease_fail(client, epoch, shard, worker),
        ]
        got = [_timeless(calls[op](s, l)) for s, l in boards]
        assert got[0] == got[1], op
    states = [(_timeless(s.state()), _timeless(l.state())) for s, l in boards]
    assert states[0] == states[1]
    assert states[0][0] and states[0][1]["workers"]


def test_shard_client_roundtrip_through_the_port_aggregator():
    agg = metrics.MetricsAggregator(host_ip="127.0.0.1", port=0)
    try:
        c0 = metrics.ShardClient("127.0.0.1", agg.port, rank=0)
        c1 = jmetrics.ShardClient("127.0.0.1", agg.port, rank=1)
        assert c0.register(0, [0, 1])["ok"] and c1.register(0, [2])["ok"]
        assert c0.claim(0, 0) and not c1.claim(0, 0)
        agg._hosts[0]["restarted"] = True  # flag rank 0 for the steal
        got = c1.steal(0)
        assert got["shard"] == 1 and got["from"] == 0
        c1.done(0, 1)
        deadline = time.monotonic() + 5
        while agg.job_snapshot()["num_hosts"] < 2 and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        assert agg.job_snapshot()["shards"]["0"]["stolen"][0]["to"] == 1
    finally:
        agg.close()
