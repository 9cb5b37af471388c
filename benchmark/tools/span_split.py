"""A cell's traced windows split by program span, on the card.

    python3 benchmark/tools/span_split.py --workload higgs.fit \
        --seeds 3100000007,3100007926 --seconds 51 [--plain 1]

Temporary: the benchmark PR that stores ``spans.reduce_profile`` as
``profile["spans"]`` in ``trace.Window.__exit__`` and adds the readers of
``spans.METRICS`` as per-layer metrics deletes this file.

Runs ``harness.run`` with ``--trace 1`` once a seed in this process and
prints its result line with three more keys: ``span_metrics`` (the
numbers of ``spans.METRICS`` that belong to the cell, those whose name
carries the cell's suffix), ``spans`` (the window's reduction by span
path) and ``unlinked_outside_share`` (the device seconds launched under
no program span or linked to no launch, as a share of all).  ``--plain
1`` runs each seed untraced first, for the traced rate's cost.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

_ROOT = str(Path(__file__).resolve().parents[2])
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmark import harness, spans, trace  # noqa: E402

_SUMMARIZE, _RESULT_LINE = trace.summarize, harness.result_line


def cell_span_metrics(cell: str) -> dict:
    """The span metrics of ``spans.METRICS`` that belong to ``cell``: the
    ``.sampled`` ones to the sampled cell, the others to the rest."""
    sampled = cell.endswith("_sampled")
    return {k: f for k, f in spans.METRICS.items()
            if k.endswith(".sampled") == sampled}


def _summarize(prof, wall0: int, wall1: int) -> dict:
    out = _SUMMARIZE(prof, wall0, wall1)
    out["spans"] = spans.reduce_profile(prof, wall0, wall1)
    return out


def _result_line(out, job, *args, **kw) -> dict:
    line = _RESULT_LINE(out, job, *args, **kw)
    prof = out.record.get("profile") if job.trace else None
    if prof is not None:
        red = prof["spans"]
        line["span_metrics"] = {k: f(out.record) for k, f in
                                cell_span_metrics(job.cell).items()}
        line["spans"] = red
        dev = red["device_total_s"]
        line["unlinked_outside_share"] = (
            (red["device_s"].get(spans.UNLINKED, 0.0)
             + red["device_s"].get(spans.OUTSIDE, 0.0)) / dev
            if dev > 0 else None)
    return line


def main(argv=None, device=None, overrides=None,
         root: Path = harness.ROOT) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated, one run a seed")
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--plain", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    trace.summarize, harness.result_line = _summarize, _result_line
    try:
        for seed in a.seeds.split(","):
            for traced in ("01" if a.plain else "1"):
                rc = harness.run(
                    ["--workload", a.workload, "--seed", seed, "--seconds",
                     str(a.seconds), "--trace", traced],
                    time.monotonic(), device, root, overrides)
                if rc:
                    return rc
    finally:
        trace.summarize, harness.result_line = _SUMMARIZE, _RESULT_LINE
    return 0


if __name__ == "__main__":
    sys.exit(main())
