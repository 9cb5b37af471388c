"""Boosting fits back to back on binned data resident on the card.

Set-up makes the rows on the device from the seed (``gen.higgs``), fits
the port's ``QuantileBinner`` on the first ``binner_sample_rows`` rows,
bins every row on the card, and runs one warm fit.  The window runs
``GBDT.fit`` on those codes again and again until ``--seconds`` have
passed, each fit ended by a synchronize.  Its rate (named by the mix's
``metric``) is rows x trees of every fit completed, over the span from
the first fit's start to the last fit's end.

Judged after the window (``reference.gbdt``): the port's codes against the
reference's own cuts and codes of the same rows, and the forests of fits
drawn from the seed, every node and leaf against float64.  :func:`controls`
gives the control's readings that the limits were set against.

Mix parameters: ``metric``, the rate's name; ``subsample``,
``colsample_bytree`` (1.0: none); ``limits``, each compared number's
limit.
"""
from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.gen import higgs
from benchmark.reference import gbdt as ref
from benchmark.roofline import gbdt_fit as roof

#: fits drawn from the seed whose forests the reference audits
AUDITED_FITS = 3
FOREST_KEYS = ("feature", "threshold", "split_gain", "split_cover", "leaf",
               "base")


def params(job) -> dict:
    """The fit's settings from the configuration and the mix."""
    c, t = job.config, job.traffic
    return {"num_bins": c["max_bin"], "max_depth": c["max_depth"],
            "eta": c["eta"], "lambda": c["lambda"], "gamma": c["gamma"],
            "min_child_weight": c["min_child_weight"],
            "num_trees": c["num_boost_round"],
            "subsample": t.get("subsample", 1.0),
            "colsample_bytree": t.get("colsample_bytree", 1.0),
            "seed": job.seed}


def make_data(job) -> tuple:
    c = job.config
    return higgs.higgs_like(c["rows"], c["features"], job.seed, job.device)


def make_model(job, p: dict):
    from dmlc_core_tpu_torch.models import GBDT
    return GBDT(num_features=job.config["features"],
                num_trees=p["num_trees"], max_depth=p["max_depth"],
                num_bins=p["num_bins"], learning_rate=p["eta"],
                lambda_=p["lambda"], gamma=p["gamma"],
                min_child_weight=p["min_child_weight"],
                objective="logistic", subsample=p["subsample"],
                colsample_bytree=p["colsample_bytree"], seed=p["seed"],
                device=job.device)


def program_codes(job, x: torch.Tensor, p: dict) -> torch.Tensor:
    from dmlc_core_tpu_torch.models import QuantileBinner
    sample = x[:job.config["binner_sample_rows"]].cpu().numpy()
    binner = QuantileBinner(num_bins=p["num_bins"], device=job.device)
    return binner.fit(sample).transform(x)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def host_forest(forest: dict) -> dict:
    return {k: forest[k].detach().cpu().numpy() for k in FOREST_KEYS}


def digest(forest: dict) -> str:
    h = hashlib.sha256()
    for k in FOREST_KEYS:
        h.update(np.ascontiguousarray(forest[k]).tobytes())
    return h.hexdigest()


def judge_codes(job, x: torch.Tensor, got: torch.Tensor,
                num_bins: int, dtype=torch.float32) -> int:
    """Codes of the port that differ from the reference's (the control:
    ``dtype=torch.bfloat16`` bins the rows rounded to bfloat16)."""
    sample = x[:job.config["binner_sample_rows"]].cpu().numpy()
    cuts = ref.quantile_cuts(sample, num_bins)
    want = ref.codes(x.to(dtype).to(torch.float32), cuts)
    return int((want != got).sum())


def judge_forests(forests: list, bins: torch.Tensor, y: torch.Tensor,
                  p: dict) -> dict:
    """The worst of each audit number over the distinct forests."""
    worst = {}
    for f in {digest(f): f for f in forests}.values():
        for k, v in ref.audit(f, bins, y, p).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def checks(job, numbers: dict) -> list:
    lim = job.traffic["limits"]
    return [harness.Check(k, float(numbers[k]), float(lim[k]))
            for k in ("codes_wrong", "split_err", "cover_err", "leaf_err")]


def controls(job):
    """Yield (kind, numbers) of the control at the cell's own size: the
    plain reference put in the program's place in bfloat16, the nearest
    precision below the configuration's float32.  Rounding the inputs a
    step would halve (the rows before they are binned; each tree's (g,
    h)) and keeping the sums in float64 is the least a bfloat16 path
    loses, so its readings are the lowest upper readings such a path can
    give."""
    p = params(job)
    x, y = make_data(job)
    want = ref.codes(x, ref.quantile_cuts(
        x[:job.config["binner_sample_rows"]].cpu().numpy(), p["num_bins"]))
    codes = judge_codes(job, x, want, p["num_bins"], torch.bfloat16)
    del x
    forest = ref.fit(want, y, p, torch.bfloat16)
    yield "control", {"codes_wrong": codes, **ref.audit(forest, want, y, p)}


def run(job) -> harness.Outcome:
    ph = harness.Phases(job.t_start)
    p = params(job)
    x, y = make_data(job)
    sync(job.device)
    ph.mark("start and rows")
    bins = program_codes(job, x, p)
    sync(job.device)
    ph.mark("binner")
    model = make_model(job, p)
    model.fit(bins, y)  # builds and loads the kernels; fills the allocator
    sync(job.device)
    ph.mark("warm fit")
    setup_s = time.monotonic() - job.t_start

    forests, spans = [], []
    with job.window() as win:
        while True:
            t0 = time.monotonic()
            with win.span("bench.fit"):
                forest = model.fit(bins, y)
            sync(job.device)
            t1 = time.monotonic()
            forests.append(forest)
            spans.append((t0, t1))
            if t1 - win.t0 >= job.seconds:
                break
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(job.device).type == "cuda" else 0)

    rows, trees = job.config["rows"], p["num_trees"]
    fit_span = spans[-1][1] - spans[0][0]
    forests = [host_forest(f) for f in forests]
    del model
    t_ref = time.monotonic()
    numbers = {"codes_wrong": judge_codes(job, x, bins, p["num_bins"])}
    del bins
    rng = np.random.default_rng(job.seed)
    drawn = rng.choice(len(forests), min(AUDITED_FITS, len(forests)),
                       replace=False)
    want = ref.codes(x, ref.quantile_cuts(
        x[:job.config["binner_sample_rows"]].cpu().numpy(), p["num_bins"]))
    del x
    numbers.update(judge_forests([forests[i] for i in drawn], want, y, p))

    F = job.config["features"]
    record = {
        "fits": len(forests), "fit_span_s": fit_span,
        "rows": rows, "features": F, "trees": trees,
        "depth": p["max_depth"], "bins": p["num_bins"],
        "row_share": p["subsample"],
        "features_used": roof.columns_per_tree(F, p["colsample_bytree"]),
        "window_s": win.seconds, "profile": win.profile,
        "setup_phases": ph,
        "reference_s": time.monotonic() - t_ref,
    }
    return harness.Outcome(
        attempted=len(forests), failed=0,
        metrics={job.traffic["metric"]: rows * trees * len(forests)
                 / fit_span, "setup_s": setup_s},
        checks=checks(job, numbers), record=record,
        memory_peak_bytes=peak)
