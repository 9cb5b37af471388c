"""Shared rank-thread runner for launchers that spawn one thread per rank.

A bare ``threading.Thread(target=...)`` that raises only kills its own
(daemon) thread: the launcher then sits in ``tracker.join()`` forever while
the job is already dead.  RankThreads collects worker failures and surfaces
the first one out of :meth:`join_tracker`, closing the tracker socket so
the process exits instead of wedging.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable

LOGGER = logging.getLogger("dmlc_tpu.launch")


class RankThreads:
    def __init__(self) -> None:
        self._threads: list = []
        self._errors: list = []
        self._lock = threading.Lock()

    def spawn(self, fn: Callable, *args) -> None:
        def wrapped():
            try:
                fn(*args)
            except BaseException as e:  # noqa: BLE001 — relayed in join_tracker
                with self._lock:
                    self._errors.append(e)

        t = threading.Thread(target=wrapped, daemon=True)
        t.start()
        self._threads.append(t)

    def first_error(self):
        with self._lock:
            return self._errors[0] if self._errors else None

    def join_tracker(self, tracker, poll: float = 0.2,
                     drain_timeout: float = 30.0) -> None:
        """Wait for the tracker to finish; fail fast on any rank failure.

        After the tracker completes, rank threads are joined (bounded) so a
        failure during worker teardown — after the rabit shutdown message but
        before process exit — still fails the job instead of being recorded
        on a thread nobody ever checks again."""
        try:
            all_done_at = None
            while tracker.alive():
                err = self.first_error()
                if err is not None:
                    raise RuntimeError(
                        "worker rank failed; aborting job") from err
                if all(not t.is_alive() for t in self._threads):
                    # every rank exited cleanly but the tracker still waits:
                    # the workers never spoke the rabit shutdown protocol
                    # (e.g. a non-rabit command).  Nothing can complete the
                    # rendezvous anymore — treat ranks-done as job-done
                    # instead of wedging forever.
                    all_done_at = all_done_at or time.monotonic()
                    if time.monotonic() - all_done_at > 5.0:
                        LOGGER.warning("all ranks exited without tracker "
                                       "shutdown; closing tracker")
                        tracker.stop()
                        return
                time.sleep(poll)
            deadline = time.monotonic() + drain_timeout
            for t in self._threads:
                t.join(timeout=max(0.0, deadline - time.monotonic()))
            err = self.first_error()
            if err is not None:
                raise RuntimeError(
                    "worker rank failed after tracker finish") from err
        except BaseException:
            tracker.stop()  # close the rendezvous socket; do not wedge
            raise
