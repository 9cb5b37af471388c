"""Multi-class softmax fits back to back on binned rows resident on the
card, a held-out set evaluated every round.

Set-up makes the rows on the device from the seed (``gen.covertype``),
splits them (the first ``train_rows`` train, the rest are the eval set),
fits the port's ``QuantileBinner`` on the first ``binner_sample_rows``
train rows, bins every row on the card, and runs one warm fit.  The window
runs ``GBDT.fit(train, label, eval_set=(eval, eval_label))`` again and
again until ``--seconds`` have passed, each fit ended by a synchronize.
Its rate (named by the mix's ``metric``) is train rows x trees (rounds x
classes) of every fit completed, over the span from the first fit's start
to the last fit's end.  A traced run also arms the port's own trace ring
around the window and reads its ``gbdt.round`` spans, and counts the
trees the window built (the ``gbdt.trees`` counter).

Judged after the window (``reference.gbdt_softmax``): the port's codes
against the reference's own cuts and codes of the same rows, and the
forests of fits drawn from the seed, every node and leaf against float64,
with each fit's held-out losses (``GBDT.eval_history``) against the
float64 mlogloss of its forest.  :func:`controls` gives the control's
readings that the limits were set against.

No row or column sampling, no early stopping.  Mix parameters:
``metric``, the rate's name; ``limits``, each compared number's limit.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness
from benchmark.gen import covertype
from benchmark.reference import gbdt as ref
from benchmark.reference import gbdt_softmax as ref_softmax
from benchmark.runners.gbdt_fit import (AUDITED_FITS, digest, host_forest,
                                        judge_codes, program_codes, sync)

CHECKED = ("codes_wrong", "split_err", "cover_err", "leaf_err", "eval_err")


def params(job) -> dict:
    """The fit's settings from the configuration and the mix."""
    c = job.config
    return {"num_bins": c["max_bin"], "max_depth": c["max_depth"],
            "eta": c["eta"], "lambda": c["lambda"], "gamma": c["gamma"],
            "min_child_weight": c["min_child_weight"],
            "num_trees": c["num_boost_round"], "num_class": c["num_class"],
            "seed": job.seed}


def make_data(job) -> tuple:
    """(x, y) of every row; the first ``train_rows`` are the train rows."""
    return covertype.covertype_like(job.config["rows"], job.seed,
                                    job.device)


def make_model(job, p: dict):
    from dmlc_core_tpu_torch.models import GBDT
    model = GBDT(num_features=job.config["features"],
                 num_trees=p["num_trees"], max_depth=p["max_depth"],
                 num_bins=p["num_bins"], learning_rate=p["eta"],
                 lambda_=p["lambda"], gamma=p["gamma"],
                 min_child_weight=p["min_child_weight"],
                 objective="softmax", num_class=p["num_class"],
                 seed=p["seed"], device=job.device)
    if not hasattr(model, "eval_history"):
        # the held-out losses are judged: a program that does not keep
        # them cannot run this cell
        raise SystemExit("GBDT keeps no eval_history: the cell judges each "
                         "fit's held-out losses")
    return model


def judge_fits(fits: list, data: tuple, p: dict) -> dict:
    """The worst of each audit number over the distinct (forest, held-out
    losses) pairs."""
    worst = {}
    for f, losses in {(digest(f), tuple(h)): (f, h)
                      for f, h in fits}.values():
        for k, v in ref_softmax.audit(f, *data[:2], p, *data[2:],
                                      losses).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def reference_codes(job, x: torch.Tensor, p: dict) -> torch.Tensor:
    """The codes of every row from the reference's own cuts."""
    return ref.codes(x, ref.quantile_cuts(
        x[:job.config["binner_sample_rows"]].cpu().numpy(), p["num_bins"]))


def split(job, codes: torch.Tensor, y: torch.Tensor) -> tuple:
    """(train codes, train labels, eval codes, eval labels)."""
    n = job.config["train_rows"]
    return codes[:n], y[:n], codes[n:], y[n:]


def checks(job, numbers: dict) -> list:
    lim = job.traffic["limits"]
    return [harness.Check(k, float(numbers[k]), float(lim[k]))
            for k in CHECKED]


def controls(job):
    """Yield (kind, numbers) of the control at the cell's own size: the
    plain reference put in the program's place in bfloat16, the nearest
    precision below the configuration's float32: the rows rounded before
    they are binned, each tree's (g, h) and each round's eval margins
    rounded, every sum in float64, so its readings are the lowest upper
    readings a bfloat16 path can give."""
    p = params(job)
    x, y = make_data(job)
    want = reference_codes(job, x, p)
    codes = judge_codes(job, x, want, p["num_bins"], torch.bfloat16)
    data = split(job, want, y)
    del x
    forest, losses = ref_softmax.fit(*data[:2], p, *data[2:],
                                     torch.bfloat16)
    yield "control", {"codes_wrong": codes,
                      **ref_softmax.audit(forest, *data[:2], p, *data[2:],
                                          losses)}


def ring_round_ms(trace: dict) -> tuple:
    """(mean ms, count) of the ``gbdt.round`` spans in a dump of the port's
    trace ring."""
    durs = [e["dur"] for e in trace.get("traceEvents", ())
            if e.get("name") == "gbdt.round" and "dur" in e]
    return (sum(durs) / len(durs) / 1e3 if durs else None), len(durs)


def run(job) -> harness.Outcome:
    from dmlc_core_tpu_torch import telemetry
    ph = harness.Phases(job.t_start)
    p = params(job)
    model = make_model(job, p)
    x, y = make_data(job)
    n = job.config["train_rows"]
    sync(job.device)
    ph.mark("start and rows")
    codes = program_codes(job, x, p)
    train, held = codes[:n], codes[n:]
    y_train, y_held = y[:n], y[n:]
    sync(job.device)
    ph.mark("binner")
    # builds and loads the kernels; fills the allocator
    model.fit(train, y_train, eval_set=(held, y_held))
    sync(job.device)
    ph.mark("warm fit")
    setup_s = time.monotonic() - job.t_start

    fits, spans = [], []
    trees0 = telemetry.counter_get("gbdt.trees")
    if job.trace:
        telemetry.trace_start()
    try:
        with job.window() as win:
            while True:
                t0 = time.monotonic()
                with win.span("bench.fit"):
                    forest = model.fit(train, y_train,
                                       eval_set=(held, y_held))
                sync(job.device)
                t1 = time.monotonic()
                fits.append((forest, list(model.eval_history)))
                spans.append((t0, t1))
                if t1 - win.t0 >= job.seconds:
                    break
    finally:
        if job.trace:
            telemetry.trace_stop()
    trees_built = telemetry.counter_get("gbdt.trees") - trees0
    round_ms, rounds_seen = (ring_round_ms(telemetry.trace_dump())
                             if job.trace else (None, 0))
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(job.device).type == "cuda" else 0)

    trees = p["num_trees"] * p["num_class"]
    fit_span = spans[-1][1] - spans[0][0]
    fits = [(host_forest(f), h) for f, h in fits]
    del model, train, held
    t_ref = time.monotonic()
    want = reference_codes(job, x, p)
    numbers = {"codes_wrong": int((want != codes).sum())}
    del codes, x
    rng = np.random.default_rng(job.seed)
    drawn = rng.choice(len(fits), min(AUDITED_FITS, len(fits)),
                       replace=False)
    data = split(job, want, y)
    numbers.update(judge_fits([fits[i] for i in drawn], data, p))

    F = job.config["features"]
    record = {
        "fits": len(fits), "fit_span_s": fit_span,
        "rows": n, "eval_rows": job.config["rows"] - n, "features": F,
        "classes": p["num_class"], "rounds": p["num_trees"],
        "trees": trees, "depth": p["max_depth"], "bins": p["num_bins"],
        "row_share": 1.0, "features_used": F,
        "trees_built": trees_built, "round_ms": round_ms,
        "rounds_seen": rounds_seen,
        "window_s": win.seconds, "profile": win.profile,
        "setup_phases": ph,
        "reference_s": time.monotonic() - t_ref,
    }
    return harness.Outcome(
        attempted=len(fits), failed=0,
        metrics={job.traffic["metric"]: n * trees * len(fits) / fit_span,
                 "setup_s": setup_s},
        checks=checks(job, numbers), record=record,
        memory_peak_bytes=peak)
