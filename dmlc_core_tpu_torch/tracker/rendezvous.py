"""Rabit-compatible rendezvous tracker and worker client.

The port of ``dmlc_core_tpu.tracker.rendezvous``, byte for byte on the
wire, so unmodified rabit workers, the JAX package's ``WorkerClient`` and
this one all rendezvous against either package's tracker:

  * framing: native-endian int32 and [len]+utf8 strings over TCP
  * handshake magic 0xff99 both ways
  * worker hello: rank, world_size, jobid, cmd in {start, recover, shutdown,
    print}
  * tracker answer: rank, parent, world, tree neighbours, ring prev/next,
    then the peer-connection brokering loop until all links are up
  * batch rank assignment sorted by host; ``recover`` reclaims a rank by
    jobid

The data plane of a port job is ``torch.distributed`` (a worker joins it
through ``parallel.init_from_env``); this tracker assigns the ranks, hands
out the DMLC_* contract and owns the telemetry side channel
(``tracker/metrics.py``).
"""
from __future__ import annotations

import logging
import os
import random
import socket
import struct
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

LOGGER = logging.getLogger("dmlc_tpu.tracker")

MAGIC = 0xFF99


class Conn:
    """int/str framing over a TCP socket (reference ExSocket parity)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock

    def read_exact(self, n: int) -> bytes:
        chunks = []
        got = 0
        while got < n:
            chunk = self.sock.recv(min(n - got, 65536))
            if not chunk:
                raise ConnectionError("peer closed during read")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def read_int(self) -> int:
        return struct.unpack("@i", self.read_exact(4))[0]

    def write_int(self, value: int) -> None:
        self.sock.sendall(struct.pack("@i", value))

    def read_str(self) -> str:
        return self.read_exact(self.read_int()).decode()

    def write_str(self, value: str) -> None:
        data = value.encode()
        self.write_int(len(data))
        self.sock.sendall(data)


def _resolve_ip(host: str) -> str:
    return socket.getaddrinfo(host, None)[0][4][0]


def get_host_ip(host: Optional[str] = None) -> str:
    """Pick the tracker's reachable IP ('auto'/'ip'/'dns' or explicit)."""
    if host is None or host == "auto":
        host = "ip"
    if host == "dns":
        return socket.getfqdn()
    if host == "ip":
        try:
            ip = socket.gethostbyname(socket.getfqdn())
        except socket.gaierror:
            ip = socket.gethostbyname(socket.gethostname())
        if ip.startswith("127."):
            probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                probe.connect(("10.255.255.255", 1))
                ip = probe.getsockname()[0]
            except OSError:
                ip = "127.0.0.1"
            finally:
                probe.close()
        return ip
    return host


# ---- topology ---------------------------------------------------------------

def binary_tree(world: int) -> Tuple[Dict[int, List[int]], Dict[int, int]]:
    """Heap-shaped binary tree: neighbours and parent per rank (parent of 0 is -1)."""
    neighbours: Dict[int, List[int]] = {}
    parent: Dict[int, int] = {}
    for r in range(world):
        h = r + 1  # 1-based heap index
        ns = []
        if h > 1:
            ns.append(h // 2 - 1)
        if 2 * h - 1 < world:
            ns.append(2 * h - 1)
        if 2 * h < world:
            ns.append(2 * h)
        neighbours[r] = ns
        parent[r] = h // 2 - 1
    return neighbours, parent


def _dfs_ring_order(neighbours, parent, root: int) -> List[int]:
    """DFS order that alternates child direction so the ring shares tree edges."""
    children = [c for c in neighbours[root] if c != parent[root]]
    if not children:
        return [root]
    order = [root]
    for i, child in enumerate(children):
        sub = _dfs_ring_order(neighbours, parent, child)
        if i == len(children) - 1:
            sub.reverse()
        order.extend(sub)
    return order


def link_map(world: int):
    """(tree, parent, ring) maps relabelled so rank i+1 follows i on the ring.

    Same construction as the reference (get_link_map, tracker.py:227-252):
    build the heap tree, derive a tree-hugging ring, then relabel ranks in
    ring order so the allreduce ring is 0→1→…→n-1→0.
    """
    neighbours, parent = binary_tree(world)
    order = _dfs_ring_order(neighbours, parent, 0)
    assert len(order) == world
    ring = {order[i]: (order[(i - 1) % world], order[(i + 1) % world])
            for i in range(world)}
    # relabel: walk the ring from 0 assigning consecutive new ids
    relabel = {0: 0}
    k = 0
    for i in range(world - 1):
        k = ring[k][1]
        relabel[k] = i + 1
    tree2 = {relabel[r]: [relabel[x] for x in ns] for r, ns in neighbours.items()}
    parent2 = {relabel[r]: (relabel[p] if p != -1 else -1) for r, p in parent.items()}
    ring2 = {relabel[r]: (relabel[a], relabel[b]) for r, (a, b) in ring.items()}
    return tree2, parent2, ring2


# ---- tracker ----------------------------------------------------------------

class _Worker:
    """One accepted worker connection, through rank assignment."""

    def __init__(self, sock: socket.socket, addr):
        self.conn = Conn(sock)
        self.host = _resolve_ip(addr[0])
        magic = self.conn.read_int()
        if magic != MAGIC:
            raise ConnectionError(f"bad magic {magic:#x} from {self.host}")
        self.conn.write_int(MAGIC)
        self.rank = self.conn.read_int()
        self.world_size = self.conn.read_int()
        self.jobid = self.conn.read_str()
        self.cmd = self.conn.read_str()
        self.wait_accept = 0
        self.port: Optional[int] = None

    def requested_rank(self, job_map: Dict[str, int]) -> int:
        if self.rank >= 0:
            return self.rank
        if self.jobid != "NULL" and self.jobid in job_map:
            return job_map[self.jobid]
        return -1

    def assign(self, rank: int, wait_conn: Dict[int, "_Worker"], tree, parent, ring):
        """Send the rank bundle, then broker peer connections until linked.

        PROVENANCE: the message sequence here — rank/parent/world, the
        neighbour set, ring prev/next, then rounds of
        (num_good, good_ranks) -> (num_conn, num_accept, host/port/rank
        triples) -> error count -> listen port — IS the rabit tracker wire
        protocol (reference tracker.py:80-135, assign_rank).  Any tracker
        that speaks to rabit C++ clients must emit exactly these fields in
        exactly this order, so the loop structure necessarily mirrors the
        reference even though this implementation (struct-framed Conn,
        heap-shaped binary_tree/link_map, wait_conn bookkeeping) is fresh.
        """
        self.rank = rank
        linkset = set(tree[rank])
        rprev, rnext = ring[rank]
        c = self.conn
        c.write_int(rank)
        c.write_int(parent[rank])
        c.write_int(len(tree))
        c.write_int(len(linkset))
        for r in linkset:
            c.write_int(r)
        for neighbour in (rprev, rnext):
            if neighbour != -1 and neighbour != rank:
                linkset.add(neighbour)
                c.write_int(neighbour)
            else:
                c.write_int(-1)
        rounds_failed = 0
        while True:
            ngood = c.read_int()
            good = {c.read_int() for _ in range(ngood)}
            assert good.issubset(linkset), (good, linkset)
            bad = linkset - good
            connectable = [r for r in bad if r in wait_conn]
            c.write_int(len(connectable))
            c.write_int(len(bad) - len(connectable))
            for r in connectable:
                c.write_str(wait_conn[r].host)
                c.write_int(wait_conn[r].port)
                c.write_int(r)
            if c.read_int() != 0:
                # worker failed some connects; retry the round, but pace the
                # loop — a peer that is down makes the worker report failure
                # instantly, and an unthrottled retry spins the tracker and
                # floods the peer with SYNs.  Jittered, capped backoff keeps
                # recovery prompt without the stampede.
                rounds_failed += 1
                if rounds_failed % 10 == 0:
                    LOGGER.warning(
                        "rank %d: %d peer-connect rounds failed (still "
                        "retrying; unreachable peers among ranks %s)",
                        rank, rounds_failed, sorted(bad))
                time.sleep(min(0.05 * (2 ** min(rounds_failed, 6)), 2.0) *
                           (0.5 + random.random()))
                continue  # retry round
            self.port = c.read_int()
            finished = []
            for r in connectable:
                wait_conn[r].wait_accept -= 1
                if wait_conn[r].wait_accept == 0:
                    finished.append(r)
            for r in finished:
                wait_conn.pop(r, None)
            self.wait_accept = len(bad) - len(connectable)
            return


class RabitTracker:
    """Rendezvous server: assigns ranks, ships topology, brokers peer links.

    Alongside the rendezvous socket the tracker owns a telemetry side
    channel (``tracker/metrics.py``): workers push counter snapshots to it
    and :meth:`job_snapshot` / :meth:`format_job_table` answer job-wide
    questions ("which host is the straggler?").  Its port is negotiated at
    rendezvous via ``DMLC_TRACKER_METRICS_PORT`` in :meth:`worker_envs`.
    """

    def __init__(self, host_ip: str, num_workers: int, port: int = 9091,
                 port_end: int = 9999, extra_envs: Optional[dict] = None,
                 enable_metrics: bool = True):
        family = socket.getaddrinfo(host_ip, None)[0][0]
        sock = socket.socket(family, socket.SOCK_STREAM)
        bound = False
        for p in range(port, port_end):
            try:
                sock.bind((host_ip, p))
                self.port = p
                bound = True
                break
            except OSError:
                continue
        if not bound:
            raise OSError(f"no free tracker port in [{port}, {port_end})")
        sock.listen(256)
        self.sock = sock
        self.host_ip = host_ip
        self.num_workers = num_workers
        self.extra_envs = dict(extra_envs or {})
        self.thread: Optional[threading.Thread] = None
        self.start_time: Optional[float] = None
        self.end_time: Optional[float] = None
        self.metrics = None
        if enable_metrics:
            from . import metrics as _metrics
            self.metrics = _metrics.MetricsAggregator(host_ip=host_ip)

    def worker_envs(self) -> dict:
        """The DMLC_* contract handed to every worker."""
        envs = {"DMLC_TRACKER_URI": self.host_ip, "DMLC_TRACKER_PORT": self.port}
        if self.metrics is not None:
            envs["DMLC_TRACKER_METRICS_PORT"] = self.metrics.port
        envs.update(self.extra_envs)
        return envs

    def job_snapshot(self) -> dict:
        """Merged job telemetry (see MetricsAggregator.job_snapshot):
        per-host snapshots + a fleet roll-up whose counters are exact sums
        over hosts.  Empty view when metrics were disabled."""
        if self.metrics is None:
            return {"hosts": {}, "num_hosts": 0, "restarted": False,
                    "fleet": {"enabled": False, "counters": {}, "gauges": {},
                              "histograms": {}}}
        return self.metrics.job_snapshot()

    def format_job_table(self) -> str:
        """Per-host bottleneck ranking with straggler flags."""
        if self.metrics is None:
            return "(tracker metrics disabled)"
        return self.metrics.format_job_table()

    def job_trace(self) -> dict:
        """Merged, clock-aligned job-wide Chrome trace (see
        MetricsAggregator.job_trace).  Empty trace when metrics were
        disabled."""
        if self.metrics is None:
            return {"traceEvents": [], "displayTimeUnit": "ms",
                    "otherData": {"hosts": 0, "spans": 0,
                                  "spans_per_host": {}, "offsets_us": {},
                                  "max_abs_offset_us": 0}}
        return self.metrics.job_trace()

    def _serve(self) -> None:
        num_workers = self.num_workers
        shutdown: Dict[int, _Worker] = {}
        wait_conn: Dict[int, _Worker] = {}
        job_map: Dict[str, int] = {}
        pending: List[_Worker] = []
        tree = parent = ring = None
        todo: List[int] = []

        while len(shutdown) != num_workers:
            fd, addr = self.sock.accept()
            try:
                w = _Worker(fd, addr)
            except ConnectionError as e:
                LOGGER.warning("rejected connection: %s", e)
                fd.close()
                continue
            if w.cmd == "print":
                LOGGER.info(w.conn.read_str().strip())
                continue
            if w.cmd == "shutdown":
                assert w.rank >= 0 and w.rank not in shutdown
                shutdown[w.rank] = w
                LOGGER.debug("rank %d shutdown", w.rank)
                continue
            assert w.cmd in ("start", "recover"), w.cmd
            if w.cmd == "recover":
                # a recovering worker identifies by prior rank or by jobid
                # (a restarted process has lost its rank but kept its jobid).
                # An unresolvable recover — before any cohort exists, or with
                # no prior rank and an unknown jobid — is REJECTED: falling
                # through to the batch-assignment pending list would strand
                # worker and tracker forever (todo is empty after the
                # initial cohort, and an assert here would kill the serve
                # loop with every connected worker still blocked).
                if tree is None or w.requested_rank(job_map) < 0:
                    LOGGER.warning(
                        "unresolvable recover (jobid %r, before-start=%s); "
                        "rejected", w.jobid, tree is None)
                    w.conn.sock.close()
                    continue
            if tree is None:
                if w.world_size > 0:
                    num_workers = w.world_size
                tree, parent, ring = link_map(num_workers)
                todo = list(range(num_workers))
            rank = w.requested_rank(job_map)
            if rank == -1:
                # batch assignment: wait for the full cohort, sort by host so
                # adjacent ranks land on the same machine (locality)
                pending.append(w)
                if len(pending) == len(todo):
                    pending.sort(key=lambda x: x.host)
                    for p in pending:
                        r = todo.pop(0)
                        if p.jobid != "NULL":
                            job_map[p.jobid] = r
                        p.assign(r, wait_conn, tree, parent, ring)
                        if p.wait_accept > 0:
                            wait_conn[r] = p
                    pending = []
                if not todo:
                    LOGGER.info("@tracker all %d workers started", num_workers)
                    self.start_time = time.time()
            else:
                w.assign(rank, wait_conn, tree, parent, ring)
                if w.wait_accept > 0:
                    wait_conn[rank] = w
        self.end_time = time.time()
        if self.start_time is not None:
            LOGGER.info("@tracker %.3f secs between start and job finish",
                        self.end_time - self.start_time)

    def start(self) -> None:
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        assert self.thread is not None
        deadline = None if timeout is None else time.time() + timeout
        while self.thread.is_alive():
            self.thread.join(0.1)
            if deadline is not None and time.time() > deadline:
                raise TimeoutError("tracker did not finish")

    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def stop(self) -> None:
        """Tear down the rendezvous socket without waiting for workers
        (used by dry-run launchers that never started any)."""
        try:
            self.sock.close()
        except OSError:
            pass
        if self.metrics is not None:
            self.metrics.close()


class PSTracker:
    """Parameter-server scheduler launcher (reference tracker.py:336-386)."""

    def __init__(self, host_ip: str, cmd: Optional[str], port: int = 9091,
                 port_end: int = 9999, envs: Optional[dict] = None):
        self.cmd = cmd
        self.host_ip = host_ip
        if cmd is None:
            return
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        for p in range(port, port_end):
            try:
                sock.bind(("", p))
                self.port = p
                sock.close()
                break
            except OSError:
                continue
        env = os.environ.copy()
        env["DMLC_ROLE"] = "scheduler"
        env["DMLC_PS_ROOT_URI"] = str(host_ip)
        env["DMLC_PS_ROOT_PORT"] = str(self.port)
        for k, v in (envs or {}).items():
            env[k] = str(v)
        self.thread = threading.Thread(
            target=lambda: subprocess.check_call(cmd, env=env, shell=True),
            daemon=True)
        self.thread.start()

    def worker_envs(self) -> dict:
        if self.cmd is None:
            return {}
        return {"DMLC_PS_ROOT_URI": self.host_ip, "DMLC_PS_ROOT_PORT": self.port}

    def join(self) -> None:
        if self.cmd is not None:
            while self.thread.is_alive():
                self.thread.join(0.1)

    def alive(self) -> bool:
        return self.cmd is not None and self.thread.is_alive()

    def stop(self) -> None:
        """No-op (scheduler subprocess is a daemon thread); dry-run symmetry
        with RabitTracker.stop()."""


# ---- worker-side client -----------------------------------------------------

class WorkerClient:
    """Minimal rabit worker: rendezvous + peer TCP links.

    The reference keeps the client in the downstream rabit C++ library; this
    Python client speaks the same protocol, which (a) lets the test suite run
    full multi-worker rendezvous in-process and (b) gives pure-Python workers
    tree/ring peer sockets if they want them.
    """

    def __init__(self, tracker_uri: Optional[str] = None,
                 tracker_port: Optional[int] = None, jobid: Optional[str] = None):
        self.tracker_uri = tracker_uri or os.environ.get("DMLC_TRACKER_URI", "127.0.0.1")
        self.tracker_port = int(tracker_port or os.environ.get("DMLC_TRACKER_PORT", "9091"))
        self.jobid = jobid or os.environ.get("DMLC_TASK_ID", "NULL")
        self.rank = -1
        self.world_size = -1
        self.parent_rank = -1
        self.neighbours: List[int] = []
        self.peer_socks: Dict[int, socket.socket] = {}
        self._listener: Optional[socket.socket] = None

    def _tracker_conn(self, cmd: str, rank: int = -1, world: int = -1) -> Conn:
        sock = socket.create_connection((self.tracker_uri, self.tracker_port))
        conn = Conn(sock)
        conn.write_int(MAGIC)
        assert conn.read_int() == MAGIC
        conn.write_int(rank)
        conn.write_int(world)
        conn.write_str(self.jobid)
        conn.write_str(cmd)
        return conn

    def start(self, world_size: int = -1, cmd: str = "start") -> "WorkerClient":
        """Rendezvous: obtain rank/topology and establish all peer links."""
        conn = self._tracker_conn(cmd, rank=self.rank, world=world_size)
        self.rank = conn.read_int()
        self.parent_rank = conn.read_int()
        self.world_size = conn.read_int()
        num_neighbours = conn.read_int()
        linkset = {conn.read_int() for _ in range(num_neighbours)}
        for _ in range(2):  # ring prev, ring next
            r = conn.read_int()
            if r != -1:
                linkset.add(r)
        self.neighbours = sorted(linkset)
        # accept socket for peers with higher setup order
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.bind(("", 0))
        self._listener.listen(len(linkset) + 1)
        my_port = self._listener.getsockname()[1]
        # brokered connect loop
        good: Dict[int, socket.socket] = {}
        while True:
            conn.write_int(len(good))
            for r in good:
                conn.write_int(r)
            num_conn = conn.read_int()
            num_accept = conn.read_int()
            errors = 0
            for _ in range(num_conn):
                host = conn.read_str()
                port = conn.read_int()
                peer_rank = conn.read_int()
                try:
                    ps = socket.create_connection((host, port), timeout=30)
                    # identify ourselves to the accepting side
                    Conn(ps).write_int(self.rank)
                    good[peer_rank] = ps
                except OSError:
                    errors += 1
            conn.write_int(errors)
            if errors != 0:
                continue
            conn.write_int(my_port)
            # accept from the remaining peers
            for _ in range(num_accept):
                ps, _addr = self._listener.accept()
                peer_rank = Conn(ps).read_int()
                good[peer_rank] = ps
            break
        self.peer_socks = good
        return self

    def tracker_print(self, message: str) -> None:
        conn = self._tracker_conn("print", rank=self.rank)
        conn.write_str(message)
        conn.sock.close()

    def shutdown(self) -> None:
        conn = self._tracker_conn("shutdown", rank=self.rank)
        conn.sock.close()
        for s in self.peer_socks.values():
            s.close()
        if self._listener is not None:
            self._listener.close()
