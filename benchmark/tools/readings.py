"""The two readings each compared number's limit is set from, on the card.

    python3 benchmark/tools/readings.py --workload higgs.fit --seeds 12 \
        --control-seeds 3 --seconds 2 [--out out/readings.json]

Lower readings: sound runs of the cell at its own size (a short window),
one a seed, in one process.  Upper readings: the control, the reference put
in the program's place in the nearest precision below the configuration's
(float32 -> bfloat16), on ``--control-seeds`` seeds at the cell's own
size.  Prints one JSON line a
run and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

_ROOT = str(Path(__file__).resolve().parents[2])
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.trace import Window  # noqa: E402

SEED0 = 3_100_000_000


def job_for(cell: str, seed: int, seconds: float, device: str,
            overrides=None, root: Path = harness.ROOT) -> harness.Job:
    spec = harness.read_json(root / "BENCHMARK.json")
    _, config, traffic = harness.find_cell(spec, cell, root)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    return harness.Job(cell=cell, config=config, traffic=traffic, seed=seed,
                       seconds=seconds, trace=False, device=device,
                       t_start=time.monotonic(),
                       window=lambda: Window(False, device))


def main(argv=None, device=None, overrides=None,
         root: Path = harness.ROOT) -> list:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seed0", type=int, default=SEED0)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    harness.pin_caches()
    if device is None:
        harness.require_cards(1)
        device = "cuda"
    out = []

    def emit(kind, seed, numbers, secs):
        line = {"workload": a.workload, "kind": kind, "seed": seed,
                "numbers": numbers, "seconds": round(secs, 2)}
        out.append(line)
        print(json.dumps(line), flush=True)

    for i in range(a.seeds):
        seed = a.seed0 + 7919 * i
        job = job_for(a.workload, seed, a.seconds, device, overrides, root)
        t0 = time.monotonic()
        res = harness.runner_for(job.traffic).run(job)
        emit("sound", seed, {c.name: c.value for c in res.checks}
             | {"correct": res.correct}, time.monotonic() - t0)
        del res
        if device == "cuda":
            torch.cuda.empty_cache()
    for i in range(a.control_seeds):
        seed = a.seed0 + 104729 * (i + 1)
        job = job_for(a.workload, seed, a.seconds, device, overrides, root)
        t0 = time.monotonic()
        for kind, numbers in harness.runner_for(job.traffic).controls(job):
            emit(kind, seed, numbers, time.monotonic() - t0)
        if device == "cuda":
            torch.cuda.empty_cache()
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text("".join(json.dumps(x) + "\n" for x in out))
    return out


if __name__ == "__main__":
    main()
