"""Monotonic timing (the port of ``dmlc_core_tpu.timer``)."""
from __future__ import annotations

import time


def get_time() -> float:
    """Monotonic seconds."""
    return time.monotonic()


class Stopwatch:
    def __init__(self):
        self._start = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self._start

    def reset(self) -> None:
        self._start = time.monotonic()
