"""Deterministic fault injection through the native registry.

Arming is one spec string, ``<point>=<mode>@<rate>[:n=<count>]...;seed=N``
(grammar in ``dmlc_core_tpu.faultinject``); the decision stream is the
native registry's, so a Python hop replays exactly under the same spec.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Iterator

from . import _native

#: DmlcTpuFaultFire mode ints -> the spec-grammar mode names
MODE_NAMES = {0: None, 1: "err", 2: "eof", 3: "503", 4: "corrupt"}


def arm(spec: str) -> None:
    """Arm fault points from a spec string; an empty spec disarms."""
    _native.check(_native.lib().DmlcTpuFaultArm(spec.encode()))


def disarm() -> None:
    _native.check(_native.lib().DmlcTpuFaultDisarm())


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
