"""The spread of a cell's end-to-end metrics over repeated runs.

    python3 benchmark/tools/spread.py --workload higgs.fit --seconds 10 \
        --seeds 11,12,13,14,15,16 --sets 2 --out out/spread.jsonl

Runs the command line once a seed, each run its own process as the check
runs them, set after set with the same seeds; a first run (the one that
builds and compiles in a fresh checkout) goes before the sets and is kept
apart.  For each set and metric: the median, the quartiles by
``statistics.quantiles(values, n=4)``, the spread (q3 - q1) / median, and
the spread with the set's run farthest from the median left out.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def one(workload: str, seed: int, seconds: float, trace: int = 0) -> dict:
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    res = {"seed": seed, "rc": proc.returncode, "wall_s": time.monotonic()
           - t0, "trace": trace}
    try:
        res["line"] = json.loads(lines[-1])
        res["phases"] = [ln for ln in proc.stderr.splitlines()
                         if ln.startswith(("setup ", "reference"))]
    except (IndexError, ValueError):
        res["err"] = proc.stderr[-3000:]
    return res


def spread(values: list) -> dict:
    """The median, quartiles and spread of ``values``, and
    ``spread_trimmed``: the spread with the run farthest from the median
    left out."""
    med = statistics.median(values)
    q1, _, q3 = statistics.quantiles(values, n=4)
    rest = sorted(values, key=lambda v: abs(v - med))[:-1]
    t1, _, t3 = statistics.quantiles(rest, n=4)
    return {"median": med, "q1": q1, "q3": q3, "spread": (q3 - q1) / med,
            "spread_trimmed": (t3 - t1) / statistics.median(rest),
            "n": len(values)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--first", type=int, default=1,
                   help="runs kept apart before the sets (0: none)")
    p.add_argument("--traced", default="",
                   help="seeds of traced runs after the sets")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    runs = []

    def log(r, tag):
        r["tag"] = tag
        runs.append(r)
        print(json.dumps(r), flush=True)
    for i in range(a.first):
        log(one(a.workload, seeds[0] + 1000 + i, a.seconds), "first")
    for s in range(a.sets):
        for seed in seeds:
            log(one(a.workload, seed, a.seconds), f"set{s}")
    for seed in [int(x) for x in a.traced.split(",") if x]:
        log(one(a.workload, seed, a.seconds, trace=1), "traced")
    summary = {}
    for s in range(a.sets):
        got = [r["line"] for r in runs if r["tag"] == f"set{s}"
               and "line" in r]
        names = set().union(*(g["metrics"] for g in got)) if got else ()
        summary[f"set{s}"] = {
            m: spread([g["metrics"][m]["value"] for g in got])
            for m in sorted(names) if len(got) >= 2}
        summary[f"set{s}"]["correct"] = sum(g["correct"] for g in got)
    print(json.dumps({"summary": summary}), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text("".join(json.dumps(r) + "\n" for r in runs)
                               + json.dumps({"summary": summary}) + "\n")


if __name__ == "__main__":
    main()
