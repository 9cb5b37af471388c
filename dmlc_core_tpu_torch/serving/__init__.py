"""Low-latency online scoring on the card.

A :class:`ScoringEngine` scores sparse requests against one immutable
model snapshot under bucketed batch geometries, a :class:`MicroBatchQueue`
trades <=1 ms of queueing for batch occupancy, and a
:class:`ScoringServer` exposes ``/score`` next to ``/metrics`` and
hot-swaps DTSNAP01 snapshots pushed over the 0xff9a channel.
"""
from .bucketing import ScoringIterator
from .engine import ScoringEngine
from .queue import MicroBatchQueue, MicroBatchTuner
from .server import ScoringServer, push_snapshot
from .snapshot import pack_snapshot, snapshot_digest, unpack_snapshot

__all__ = [
    "ScoringIterator", "ScoringEngine", "MicroBatchQueue", "MicroBatchTuner",
    "ScoringServer", "push_snapshot", "pack_snapshot", "snapshot_digest",
    "unpack_snapshot",
]
