"""The measured window, and what a traced window's profile says.

``Window`` brackets the measured part of a run: it synchronizes the card
on entry and exit, takes the host clock, and with ``trace=True`` runs
``torch.profiler`` (CPU and CUDA activities) over exactly that span.  The
profile is reduced here once, to what every per-layer reader and the
result line need: the device's busy time (the union of device-op
intervals), device time and launch count by kernel name, and the idle
gaps between device work by what the host was doing then.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

#: idle gaps shorter than this are launch spacing, not host work
GAP_FLOOR_NS = 20_000
#: entries kept of each breakdown list (the result line allows 10)
TOP = 10


class Window:
    """``with Window(trace, device) as win:`` around the measured loop.

    ``win.seconds`` is the host clock's span of the window (from after the
    entry synchronize to after the exit synchronize); with ``trace`` set,
    ``win.profile`` holds :func:`summarize`'s reduction of the window's
    profile.  ``win.span(name)`` labels host work for the idle-gap
    attribution while tracing and costs nothing otherwise."""

    def __init__(self, trace: bool, device):
        self.trace = trace
        self.device = torch.device(device)
        self.profile = None
        self._prof = None
        self.t0 = self.t1 = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str):
        if self._prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def __enter__(self) -> "Window":
        self._sync()
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        self._wall0 = time.time_ns()
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self._sync()
        self.t1 = time.monotonic()
        wall1 = time.time_ns()
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.__exit__(*exc)
            if exc[0] is None:
                self.profile = summarize(prof, self._wall0, wall1)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def _events(prof):
    """(name, is_device, start_ns, end_ns, user_annotation) of every
    profiled event; kineto's raw events carry epoch nanoseconds."""
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        yield (e.name(), e.device_type() != torch.autograd.DeviceType.CPU,
               start, start + e.duration_ns(), e.is_user_annotation())


def merge(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(prof, wall0: int, wall1: int) -> dict:
    """Reduce a window's profile: ``window_s``; ``busy_s``, the union of
    device-op intervals clipped to the window; ``kernels``, name ->
    [device seconds, launches]; ``device_ops`` and ``idle_gaps``, the top
    entries of the result line's breakdown (idle gaps summed by the
    innermost host span covering each gap's midpoint, a harness span when
    one does)."""
    dev, host = [], []
    kernels = defaultdict(lambda: [0.0, 0])
    for name, is_dev, s, e, user in _events(prof):
        if is_dev and (user or name.startswith("bench.")):
            continue  # a host span's shadow on the device timeline
        if is_dev:
            s, e = max(s, wall0), min(e, wall1)
            if e <= s:
                continue
            dev.append((s, e))
            k = kernels[name]
            k[0] += (e - s) / 1e9
            k[1] += 1
        else:
            host.append((s, e, name, user))
    busy = merge(dev)
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps, prev = [], wall0
    for s, e in busy + [[wall1, wall1]]:
        if s - prev >= GAP_FLOOR_NS:
            gaps.append((prev, s))
        prev = max(prev, e)
    host.sort()
    starts = [h[0] for h in host]
    by_host = defaultdict(float)
    for s, e in gaps:
        by_host[_host_label(host, starts, (s + e) // 2)] += (e - s) / 1e9
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "window_s": (wall1 - wall0) / 1e9,
        "busy_s": busy_s,
        "kernels": {k: v for k, v in kernels.items()},
        "device_ops": [[k, v[0]] for k, v in top],
        "idle_gaps": sorted(([k, v] for k, v in by_host.items()),
                            key=lambda kv: -kv[1])[:TOP],
    }


def _host_label(host, starts, t: int, scan: int = 4000) -> str:
    """The innermost host event covering ``t``: the latest-starting one
    among the ``scan`` events that start last before it, a harness span
    (a user annotation) first."""
    i = bisect.bisect_right(starts, t)
    best = user = None
    for j in range(i - 1, max(-1, i - 1 - scan), -1):
        s, e, name, is_user = host[j]
        if e >= t:
            if is_user and user is None:
                user = name
            if best is None:
                best = name
            if user is not None:
                break
    if user is not None and best is not None and best != user:
        return f"{user} > {best}"
    return best or "host outside any profiled op"


def kernel_seconds(profile: dict, *needles: str) -> tuple:
    """(device seconds, launches) of the kernels whose name holds any of
    ``needles``."""
    secs = n = 0
    for name, (s, c) in profile["kernels"].items():
        if any(x in name for x in needles):
            secs += s
            n += c
    return secs, n


def idle_pct(rec: dict):
    """The share of a traced window in which no operation ran on the
    device, 100 (1 - busy / window); None without a profile that saw
    device work."""
    prof = rec.get("profile")
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
