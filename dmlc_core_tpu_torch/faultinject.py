"""Deterministic fault injection through the native registry.

Arming is one spec string, ``<point>=<mode>@<rate>[:n=<count>]...;seed=N``
(grammar in ``dmlc_core_tpu.faultinject``); the decision stream is the
native registry's, so a Python hop replays exactly under the same spec.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
from typing import Iterator

from . import _native

__all__ = [
    "compiled_in", "arm", "disarm", "snapshot", "injected_total", "armed",
    "fire",
]

#: DmlcTpuFaultFire mode ints -> the spec-grammar mode names
MODE_NAMES = {0: None, 1: "err", 2: "eof", 3: "503", 4: "corrupt"}


def compiled_in() -> bool:
    """True when the native library was built with fault injection
    compiled in (``-DDMLCTPU_FAULTS=0`` stubs it out)."""
    out = ctypes.c_int()
    _native.check(_native.lib().DmlcTpuFaultCompiledIn(ctypes.byref(out)))
    return bool(out.value)


def arm(spec: str) -> None:
    """Arm fault points from a spec string; an empty spec disarms."""
    _native.check(_native.lib().DmlcTpuFaultArm(spec.encode()))


def disarm() -> None:
    _native.check(_native.lib().DmlcTpuFaultDisarm())


def snapshot() -> dict:
    """Parsed JSON state: ``{"enabled", "armed", "seed", "points": [{"name",
    "mode", "armed", "hits", "injected"}, ...]}`` (just ``{"enabled":
    False}`` when compiled out)."""
    out = ctypes.c_char_p()
    _native.check(
        _native.lib().DmlcTpuFaultSnapshotJson(ctypes.byref(out)))
    return json.loads((out.value or b"{}").decode())


def injected_total() -> int:
    """Total faults injected across all points since process start."""
    out = ctypes.c_int64()
    _native.check(
        _native.lib().DmlcTpuFaultInjectedTotal(ctypes.byref(out)))
    return int(out.value)


def fire(point: str) -> int:
    """Fire the named point once and return the armed mode int (0 clean)."""
    out = ctypes.c_int()
    _native.check(
        _native.lib().DmlcTpuFaultFire(point.encode(), ctypes.byref(out)))
    return int(out.value)


@contextlib.contextmanager
def armed(spec: str) -> Iterator[None]:
    """Arm ``spec`` for the body and disarm on exit."""
    arm(spec)
    try:
        yield
    finally:
        disarm()
