"""A traced window reduced by program span, and the per-layer numbers that
read the boosting driver's spans.

A program span is a CPU user annotation whose name does not start with
``bench.``: the port's ``telemetry.span`` opens one (a
``torch.profiler.record_function``) while a profiler records.  Spans are
keyed by their path, the names from the outermost span down joined by
``/`` (``gbdt.fit/gbdt.tree/gbdt.route``); kineto's nesting on one thread
gives each span its parent.  :func:`reduce_events` gives, by the path of
the innermost span:

- ``device_s`` and ``launches``: each device operation goes to the span
  that was innermost where its launch started: the runtime call
  (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) whose
  ``correlation_id()`` is the operation's, else the torch operator that
  the operation's ``linked_correlation_id()`` names; to ``unlinked`` when
  the trace holds neither, to ``outside`` when the launch ran under no
  program span;
- ``idle_s``: each interval of the window in which no device operation
  ran goes whole to the innermost span at its midpoint, or to
  ``outside``;
- ``syncs``: the runtime calls that block the host until the device is
  done (:data:`SYNC_CALLS`);
- ``count``: the spans that start in the window.

A device operation is clipped to the window, as ``trace.summarize``
clips it; a program span's shadow on the device timeline (a device-side
user annotation, or a device event named as a program span) is not
device work and is left out.  Only event methods that torch 2.11's
kineto events have are read (no ``activity_type``): a runtime call is a
host event named ``cu...``.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

import torch

from benchmark.trace import merge

#: runtime calls that wait for the device (``cudaMemcpy`` is the blocking
#: copy; ``cudaMemcpyAsync`` is not counted)
SYNC_CALLS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"))
#: the name prefix of the host's calls into the CUDA runtime and driver
RUNTIME_PREFIX = "cu"
OUTSIDE, UNLINKED = "outside", "unlinked"
SEP = "/"


class _Thread:
    """The program spans of one thread, sorted by start, with each one's
    parent: a nested-interval walk that answers "the innermost span
    covering t" exactly."""

    def __init__(self, spans):
        spans.sort(key=lambda sp: (sp[0], -sp[1]))
        self.starts = [sp[0] for sp in spans]
        self.ends = [sp[1] for sp in spans]
        self.parent, self.path, stack = [], [], []
        for i, (s, _e, name) in enumerate(spans):
            while stack and self.ends[stack[-1]] <= s:
                stack.pop()
            p = stack[-1] if stack else -1
            self.parent.append(p)
            self.path.append(name if p < 0 else self.path[p] + SEP + name)
            stack.append(i)

    def innermost(self, t: int) -> int:
        """Index of the innermost span covering ``t`` (start <= t <= end),
        or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ends[i] < t:
            i = self.parent[i]
        return i


def reduce_events(events, wall0: int, wall1: int) -> dict:
    """Reduce kineto events (``prof.profiler.kineto_results.events()``;
    epoch nanoseconds) over the window ``[wall0, wall1]``.  Returns
    ``{"device_s", "launches", "idle_s", "syncs", "count"}``, each a dict
    by span path (``outside``/``unlinked`` included where they occur),
    and ``window_s``, ``busy_s`` and ``device_total_s``."""
    by_thread, calls, ops, dev = defaultdict(list), {}, {}, []
    for e in events:
        name, s = e.name(), e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() != torch.autograd.DeviceType.CPU:
            if e.is_user_annotation() or name.startswith("bench."):
                continue
            s, end = max(s, wall0), min(end, wall1)
            if end > s:
                dev.append((s, end, name, e.correlation_id(),
                            e.linked_correlation_id()))
        elif e.is_user_annotation():
            if not name.startswith("bench."):
                by_thread[e.start_thread_id()].append((s, end, name))
        elif name.startswith(RUNTIME_PREFIX):
            calls[e.correlation_id()] = (e.start_thread_id(), s, name)
        else:
            ops[e.correlation_id()] = (e.start_thread_id(), s)
    span_names = {sp[2] for sps in by_thread.values() for sp in sps}
    dev = [d[:2] + d[3:] for d in dev if d[2] not in span_names]
    threads = {tid: _Thread(sp) for tid, sp in by_thread.items()}

    def label(tid, t: int) -> str:
        th = threads.get(tid)
        i = th.innermost(t) if th is not None else -1
        return th.path[i] if i >= 0 else OUTSIDE

    def label_any(t: int) -> str:
        # the innermost span at t over every thread: the latest-starting
        best, path = None, OUTSIDE
        for th in threads.values():
            i = th.innermost(t)
            if i >= 0 and (best is None or th.starts[i] > best):
                best, path = th.starts[i], th.path[i]
        return path

    out = {k: defaultdict(float) for k in ("device_s", "idle_s")}
    out.update({k: defaultdict(int) for k in ("launches", "syncs",
                                              "count")})
    for tid, s, name in calls.values():
        if name in SYNC_CALLS and wall0 <= s <= wall1:
            out["syncs"][label(tid, s)] += 1
    for s, end, corr, linked in dev:
        launch = calls.get(corr) or ops.get(linked)
        key = label(*launch[:2]) if launch else UNLINKED
        out["device_s"][key] += (end - s) / 1e9
        out["launches"][key] += 1
    busy = merge((s, end) for s, end, _, _ in dev)
    prev = wall0
    for s, end in busy + [[wall1, wall1]]:
        if s > prev:
            out["idle_s"][label_any((prev + s) // 2)] += (s - prev) / 1e9
        prev = max(prev, end)
    for th in threads.values():
        for s, path in zip(th.starts, th.path):
            if wall0 <= s <= wall1:
                out["count"][path] += 1
    res = {k: dict(v) for k, v in out.items()}
    res["window_s"] = (wall1 - wall0) / 1e9
    res["busy_s"] = sum(e - s for s, e in busy) / 1e9
    res["device_total_s"] = sum(d[1] - d[0] for d in dev) / 1e9
    return res


def reduce_profile(prof, wall0: int, wall1: int) -> dict:
    """:func:`reduce_events` over a finished ``torch.profiler.profile``."""
    return reduce_events(prof.profiler.kineto_results.events(), wall0, wall1)


def total(part: dict, name: str, under: bool = False):
    """Sum of ``part`` (one of the reduction's dicts) over the paths whose
    innermost span is ``name``, or with ``under`` over every path that
    passes through ``name``."""
    return sum(v for path, v in part.items()
               if (name in path.split(SEP) if under
                   else path.rsplit(SEP, 1)[-1] == name))


# ---- the boosting driver's per-layer numbers --------------------------------
#
# Each reads ``rec["profile"]["spans"]`` (this module's reduction of the
# traced window) and the runner's ``fits`` and ``trees``; a tree is the
# window's fits x trees.  None where there is nothing to read: no profile,
# no reduction (a program without the spans), or no fit.

LEVEL_SPANS = ("gbdt.hist", "gbdt.split", "gbdt.route")


def _spans(rec):
    prof = rec.get("profile")
    red = prof.get("spans") if prof else None
    if not red or not rec.get("fits") or not red.get("count"):
        return None
    return red


def _per_tree_ms(rec, part: str, names):
    red = _spans(rec)
    if red is None or not any(total(red["count"], n) for n in names):
        return None
    return 1e3 * sum(total(red[part], n) for n in names) / (
        rec["fits"] * rec["trees"])


def route_ms_tree(rec):
    """Device ms a tree of the operations launched under ``gbdt.route``."""
    return _per_tree_ms(rec, "device_s", ("gbdt.route",))


def level_idle_ms_tree(rec):
    """Device idle ms a tree whose innermost span is a level's
    (``gbdt.hist``, ``gbdt.split`` or ``gbdt.route``)."""
    return _per_tree_ms(rec, "idle_s", LEVEL_SPANS)


def draws_ms_tree(rec):
    """Device ms a tree of the operations launched under ``gbdt.draws``."""
    return _per_tree_ms(rec, "device_s", ("gbdt.draws",))


def draws_idle_ms_tree(rec):
    """Device idle ms a tree whose innermost span is ``gbdt.draws``."""
    return _per_tree_ms(rec, "idle_s", ("gbdt.draws",))


def fit_host_syncs(rec):
    """Host syncs (:data:`SYNC_CALLS`) under ``gbdt.fit``, a fit."""
    red = _spans(rec)
    if red is None or not total(red["count"], "gbdt.fit"):
        return None
    return total(red["syncs"], "gbdt.fit", under=True) / rec["fits"]


#: each number under the name a ``per_layer`` entry would give it
METRICS = {
    "route.ms_tree": route_ms_tree,
    "level.idle_ms_tree": level_idle_ms_tree,
    "fit.host_syncs": fit_host_syncs,
    "draws.ms_tree.sampled": draws_ms_tree,
    "draws.idle_ms_tree.sampled": draws_idle_ms_tree,
    "fit.host_syncs.sampled": fit_host_syncs,
}
