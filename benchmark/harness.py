"""The command line, the registry and the result line of the benchmark.

A cell is found by name in ``BENCHMARK.json``: its configuration's file,
its traffic mix ``traffic/<mix>.json`` (whose ``runner`` names the general
runner in ``runners/`` that reads it), its end-to-end metrics, and each
per-layer metric whose reader ``metrics/<metric>.py`` applies to it.  A
runner sets up, warms its cell's shapes, measures for ``--seconds`` inside a
:class:`~benchmark.trace.Window`, judges what the window produced against
the plain reference, and returns an :class:`Outcome`.  This module turns
that into the last line of standard output.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Optional

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "dmlc_core_tpu")


@dataclasses.dataclass
class Check:
    """One number compared with the reference, beside its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # NaN fails


class Phases(dict):
    """Seconds of each set-up phase, the first from the process's start;
    printed on standard error beside the result."""

    def __init__(self, t_start: float):
        super().__init__()
        self._t = t_start

    def mark(self, name: str) -> None:
        now = time.monotonic()
        self[name] = now - self._t
        self._t = now


@dataclasses.dataclass
class Job:
    """What a runner is given: the cell, its configuration and mix, the
    run's arguments, the device, the process's start on the host clock,
    and the window factory."""
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    window: Callable


@dataclasses.dataclass
class Outcome:
    """What a runner returns.  ``metrics``: end-to-end values by name;
    ``record``: what the per-layer readers read (shapes, counts, the
    window's profile); ``checks``: every number compared, beside its
    limit."""
    attempted: int
    failed: int
    metrics: dict
    checks: list
    record: dict
    memory_peak_bytes: int

    @property
    def correct(self) -> bool:
        return all(c.ok for c in self.checks)


def parse_args(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(spec: dict, name: str, root: Path = ROOT) -> tuple:
    """(workload entry, configuration, traffic mix) of cell ``name``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    traffic = read_json(root / "benchmark" / "traffic"
                        / f"{cell['traffic']}.json")
    return cell, read_json(root / conf["file"]), traffic


def cell_metrics(spec: dict, cell: str) -> tuple:
    """(end-to-end entries, per-layer entries) that cell ``cell``
    reports: an entry with ``workloads`` where that list names the cell;
    one without it in every cell (per-layer: every cell that reports the
    end-to-end metric it moves)."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def runner_for(traffic: dict, root: Path = ROOT):
    name = traffic["runner"]
    return load_module(root / "benchmark" / "runners" / f"{name}.py",
                       f"benchmark_runner_{name}")


def reader_for(metric: str, root: Path = ROOT):
    return load_module(root / "benchmark" / "metrics" / f"{metric}.py",
                       "benchmark_metric_" + metric.replace(".", "_"))


def pin_caches(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    and libraries kept from loading JAX on their own."""
    cache = root / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole (``dmlc_core_tpu_torch`` is not
    ``dmlc_core_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def require_cards(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"{torch.cuda.device_count()} CUDA device(s), the "
                         f"cell asks for {chips}")


def device_info(device: str, chips: int, peak: int) -> dict:
    import torch
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": int(peak)}


def result_line(out: Outcome, job: Job, e2e: list, layer: list,
                chips: int, root: Path = ROOT) -> dict:
    metrics = {}
    trace = out.record.get("profile") if job.trace else None
    if not job.trace:
        for m in e2e:
            if m["name"] not in out.metrics:
                raise RuntimeError(f"runner gave no {m['name']}")
            metrics[m["name"]] = {"value": out.metrics[m["name"]],
                                  "unit": m["unit"]}
    else:
        rec = dict(out.record, config=job.config, traffic=job.traffic)
        for m in layer:
            v = reader_for(m["name"], root).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": out.correct, "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics,
            "device": device_info(job.device, chips, out.memory_peak_bytes)}
    if trace is not None:
        line["device"]["busy_s"] = trace["busy_s"]
        line["device"]["window_s"] = trace["window_s"]
        line["breakdown"] = {"device_ops": trace["device_ops"],
                             "idle_gaps": trace["idle_gaps"]}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}
    return line


def run(argv, t_start: float, device: Optional[str] = None,
        root: Path = ROOT, overrides: Optional[dict] = None) -> int:
    """Run one cell once.  ``device`` and ``overrides`` (merged into the
    configuration and the mix: ``{"config": {...}, "traffic": {...}}``)
    serve the CPU tests, which skip the look for a card; the command line
    never passes them."""
    args = parse_args(argv)
    pin_caches(root)
    spec = read_json(root / "BENCHMARK.json")
    cell, config, traffic = find_cell(spec, args.workload, root)
    chips = int(cell["chips"])
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    if device is None:
        require_cards(chips)
        device = "cuda"
    e2e, layer = cell_metrics(spec, args.workload)
    from .trace import Window
    job = Job(cell=args.workload, config=config, traffic=traffic,
              seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              device=device, t_start=t_start,
              window=lambda: Window(bool(args.trace), device))
    out = runner_for(traffic, root).run(job)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the run's process: {bad}",
              file=sys.stderr)
        return 3
    line = result_line(out, job, e2e, layer, chips, root)
    for name, secs in out.record.get("setup_phases", {}).items():
        print(f"setup {name}: {secs:.3f} s", file=sys.stderr)
    if "reference_s" in out.record:
        print(f"reference and judging: {out.record['reference_s']:.3f} s",
              file=sys.stderr)
    for name, c in line["checks"].items():
        ok = "ok" if (c["value"] <= c["limit"]) else "FAIL"
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}) {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None, t_start: Optional[float] = None) -> int:
    return run(sys.argv[1:] if argv is None else argv,
               time.monotonic() if t_start is None else t_start)
