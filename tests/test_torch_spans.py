"""The port's span API (``telemetry.span``) and the boosting driver's spans
(``models/gbdt.py``), on the CPU.

``span`` has two sinks: the native trace ring while the port's
``trace_start`` has armed it, and the torch profiler's timeline (a
``record_function`` user annotation) while a profiler records.  With
neither on it reads no clock and makes no native call.  A fit under a CPU
profiler shows one ``gbdt.fit``, a ``gbdt.tree`` per tree and a
``gbdt.hist`` / ``gbdt.split`` / ``gbdt.route`` per level, nested as the
driver nests them, and grows the same forest as without the profiler.
Under softmax each round is a ``gbdt.round`` holding its ``gbdt.softmax``,
its class trees and, with an eval set, its ``gbdt.eval``; every fit counts
its trees (``gbdt.trees``) and softmax rounds (``gbdt.rounds``).
"""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dmlc_core_tpu_torch import _native, telemetry
from dmlc_core_tpu_torch.data.staging import PaddedBatch
from dmlc_core_tpu_torch.models import GBDT, QuantileBinner

LEVEL = ("gbdt.hist", "gbdt.split", "gbdt.route")


def _raise(*_a, **_k):
    raise AssertionError("called with no sink on")


def _annotations(prof):
    """(name, start_ns, end_ns) of every CPU user annotation."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()
            and e.device_type() == torch.autograd.DeviceType.CPU]


def _paths(prof) -> collections.Counter:
    """Each annotation's path from the outermost one (``a/b/c``), counted:
    the parent is the latest-starting annotation that covers it."""
    spans = sorted(_annotations(prof), key=lambda s: (s[1], -s[2]))
    paths, stack = [], []
    for name, s, e in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        path = (stack[-1][0] + "/" if stack else "") + name
        paths.append(path)
        stack.append((path, e))
    return collections.Counter(paths)


# ---- the span API -----------------------------------------------------------

def test_span_with_no_sink_reads_no_clock_and_no_native(monkeypatch):
    monkeypatch.setattr(telemetry, "_tracing", False)
    monkeypatch.setattr(telemetry, "now_us", _raise)
    monkeypatch.setattr(_native, "lib", _raise)
    a, b = telemetry.span("test.a"), telemetry.span("test.b")
    assert a is b  # one shared no-op context
    with telemetry.span("test.off") as got:
        x = torch.ones(4) * 2
    assert got is None and float(x.sum()) == 8.0
    with pytest.raises(ValueError):  # an exception passes through
        with telemetry.span("test.off"):
            raise ValueError("kept")


def test_span_under_trace_start_reaches_the_ring():
    if not telemetry.enabled():
        pytest.skip("tracing is compiled out")
    telemetry.trace_start()
    try:
        with telemetry.span("test.ring_span"):
            pass
    finally:
        telemetry.trace_stop()
    with telemetry.span("test.after_stop"):  # the mirror is cleared
        pass
    names = [e["name"] for e in telemetry.trace_dump()["traceEvents"]]
    assert names.count("test.ring_span") == 1
    assert "test.after_stop" not in names


def test_span_under_a_cpu_profiler_covers_its_ops():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("test.profiled"):
            y = torch.arange(1000.0).cumsum(0)
            z = y * 3
    assert float(z[-1]) == 3 * 499500.0
    spans = [s for s in _annotations(prof) if s[0] == "test.profiled"]
    assert len(spans) == 1
    _, s0, e0 = spans[0]
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() in ("aten::cumsum", "aten::mul")]
    assert len(ops) == 2
    assert all(s0 <= s and e <= e0 for s, e in ops)


def test_span_with_both_sinks_on():
    if not telemetry.enabled():
        pytest.skip("tracing is compiled out")
    telemetry.trace_start()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with telemetry.span("test.both"):
                torch.ones(8).sum()
    finally:
        telemetry.trace_stop()
    names = [e["name"] for e in telemetry.trace_dump()["traceEvents"]]
    assert names.count("test.both") == 1
    assert [s[0] for s in _annotations(prof)].count("test.both") == 1


# ---- the boosting driver's spans -------------------------------------------

TREES, DEPTH, F, BINS = 3, 3, 5, 16


def _dense(seed=0, rows=600):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, F)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float32)
    bins = QuantileBinner(BINS, device="cpu").fit_transform(x)
    return bins, y, x


def _sparse(seed=1, rows=400):
    """A port PaddedBatch of a random sparse matrix (3 padding lanes) and
    its binner."""
    rng = np.random.default_rng(seed)
    present = rng.random((rows, F)) < 0.5
    vals = rng.uniform(-2, 2, (rows, F)).astype(np.float32)
    vals[vals == 0] = 0.5
    r, f = np.nonzero(present)
    label = np.where(present[:, 0], vals[:, 0] > 0.2, 1.0).astype(np.float32)
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(
        r, minlength=rows))]).astype(np.int32)
    batch = PaddedBatch(
        label=torch.from_numpy(label), weight=torch.ones(rows),
        row_ptr=torch.from_numpy(row_ptr),
        index=torch.from_numpy(np.pad(f, (0, 3)).astype(np.int32)),
        value=torch.from_numpy(np.pad(vals[r, f], (0, 3))), num_rows=rows)
    binner = QuantileBinner(BINS, missing_aware=True, device="cpu") \
        .fit_sparse(f.astype(np.int32), vals[r, f], F)
    return batch, binner


def _fit(kind, model, **kw):
    if kind == "fit":
        bins, y, _ = _dense()
        return model.fit(bins, y, **kw)
    batch, binner = _sparse()
    return model.fit_batch(batch, binner, **kw)


def _tree_paths(trees, sampled):
    tree = "gbdt.fit/gbdt.tree"
    want = {"gbdt.fit": 1, tree: trees,
            tree + "/gbdt.grad": trees, tree + "/gbdt.leaf": trees,
            tree + "/gbdt.margin": trees}
    want.update({tree + "/" + n: trees * DEPTH for n in LEVEL})
    if sampled:
        want[tree + "/gbdt.draws"] = trees
    return want


@pytest.mark.parametrize("kind", ["fit", "fit_batch"])
@pytest.mark.parametrize("sampling", [{}, {"subsample": 0.8},
                                      {"colsample_bytree": 0.6}])
def test_fit_spans_nest_and_keep_the_forest(kind, sampling):
    def model():
        return GBDT(F, num_trees=TREES, max_depth=DEPTH, num_bins=BINS,
                    missing_aware=kind == "fit_batch", device="cpu", seed=7,
                    **sampling)

    plain = _fit(kind, model())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _fit(kind, model())
    assert dict(_paths(prof)) == _tree_paths(TREES, bool(sampling))
    assert sorted(plain) == sorted(traced)
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k


def _softmax_data(rows=600):
    bins, _, x = _dense(seed=3, rows=rows)
    y = np.digitize(x[:, 0], [-0.5, 0.5]).astype(np.float32)  # 3 classes
    return bins, y


def _softmax(rounds, K=3):
    return GBDT(F, num_trees=rounds, max_depth=DEPTH, num_bins=BINS,
                objective="softmax", num_class=K, device="cpu")


def _counters():
    return {k: telemetry.counter_get(k) for k in ("gbdt.trees",
                                                  "gbdt.rounds")}


def test_softmax_opens_a_tree_span_per_class_tree():
    bins, y = _softmax_data()
    K, rounds = 3, 2
    plain = _softmax(rounds, K).fit(bins, y)
    before = _counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _softmax(rounds, K).fit(bins, y)
    after = _counters()
    paths = _paths(prof)
    rnd = "gbdt.fit/gbdt.round"
    tree = rnd + "/gbdt.tree"
    assert paths[rnd] == rounds
    assert paths[tree] == rounds * K
    assert all(paths[tree + "/" + n] == rounds * K * DEPTH for n in LEVEL)
    assert paths[tree + "/gbdt.grad"] == rounds * K
    assert paths[rnd + "/gbdt.softmax"] == rounds  # the round's softmax
    assert not [p for p in paths if p.startswith("gbdt.fit/gbdt.tree")]
    assert paths[rnd + "/gbdt.eval"] == 0  # no eval set
    assert after["gbdt.trees"] - before["gbdt.trees"] == rounds * K
    assert after["gbdt.rounds"] - before["gbdt.rounds"] == rounds
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k


def test_softmax_eval_sits_in_the_round_eval_span():
    bins, y = _softmax_data()
    K, rounds = 3, 3
    model = _softmax(rounds, K)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.fit(bins[:400], y[:400], eval_set=(bins[400:], y[400:]))
    paths = _paths(prof)
    rnd = "gbdt.fit/gbdt.round"
    assert paths[rnd + "/gbdt.eval"] == rounds
    assert paths[rnd + "/gbdt.tree/gbdt.margin"] == rounds * K
    assert not [p for p in paths if p.count("gbdt.eval") > 1
                or "gbdt.tree/gbdt.eval" in p]
    assert len(model.eval_history) == rounds


def test_softmax_round_spans_reach_the_ring():
    if not telemetry.enabled():
        pytest.skip("tracing is compiled out")
    bins, y = _softmax_data()
    K, rounds = 3, 2
    telemetry.trace_start()
    try:
        _softmax(rounds, K).fit(bins[:400], y[:400],
                                eval_set=(bins[400:], y[400:]))
    finally:
        telemetry.trace_stop()
    events = [e for e in telemetry.trace_dump()["traceEvents"]
              if e.get("name", "").startswith("gbdt.")]
    names = collections.Counter(e["name"] for e in events)
    assert names["gbdt.fit"] == 1 and names["gbdt.round"] == rounds
    assert names["gbdt.softmax"] == rounds and names["gbdt.eval"] == rounds
    assert names["gbdt.tree"] == rounds * K
    rounds_us = [e["dur"] for e in events if e["name"] == "gbdt.round"]
    trees_us = [e["dur"] for e in events if e["name"] == "gbdt.tree"]
    assert min(rounds_us) > 0 and sum(rounds_us) >= sum(trees_us)


@pytest.mark.parametrize("kind", ["fit", "fit_batch"])
def test_fits_count_their_trees(kind):
    model = GBDT(F, num_trees=TREES, max_depth=DEPTH, num_bins=BINS,
                 missing_aware=kind == "fit_batch", device="cpu")
    before = _counters()
    _fit(kind, model)
    after = _counters()
    assert after["gbdt.trees"] - before["gbdt.trees"] == TREES
    assert after["gbdt.rounds"] == before["gbdt.rounds"]


def test_eval_margin_and_loss_sit_in_the_margin_span():
    bins, y, _ = _dense(seed=4)
    model = GBDT(F, num_trees=TREES, max_depth=DEPTH, num_bins=BINS,
                 device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.fit(bins[:400], y[:400], eval_set=(bins[400:], y[400:]))
    paths = _paths(prof)
    assert paths["gbdt.fit/gbdt.tree/gbdt.margin"] == TREES
    assert not [p for p in paths if p.count("gbdt.margin") > 1]
    assert not [p for p in paths if "gbdt.round" in p or "gbdt.eval" in p]
    assert len(model.eval_history) == TREES
    model.fit(bins[:400], y[:400])  # a fit without one resets it
    assert model.eval_history == []


def test_fit_spans_reach_the_ring():
    if not telemetry.enabled():
        pytest.skip("tracing is compiled out")
    bins, y, _ = _dense()
    model = GBDT(F, num_trees=TREES, max_depth=DEPTH, num_bins=BINS,
                 device="cpu")
    telemetry.trace_start()
    try:
        model.fit(bins, y)
    finally:
        telemetry.trace_stop()
    names = collections.Counter(e["name"] for e in
                                telemetry.trace_dump()["traceEvents"])
    assert names["gbdt.fit"] == 1 and names["gbdt.tree"] == TREES
    assert all(names[n] == TREES * DEPTH for n in LEVEL)


@pytest.mark.parametrize("histogram,routes", [("xla", 1), ("pallas", DEPTH)])
def test_streamed_fit_spans(histogram, routes):
    """``fit_streamed``'s levels: a kernel level routes in a pass of its
    own (a ``gbdt.route`` a level), an ``index_add`` level routes the
    previous level inside its accumulating pass (under ``gbdt.hist``), so
    only the last pass to the leaves is a ``gbdt.route``."""
    batch, binner = _sparse()
    model = GBDT(F, num_trees=TREES, max_depth=DEPTH, num_bins=BINS,
                 missing_aware=True, histogram=histogram, device="cpu")
    whole = model.fit_batch(batch, binner)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        streamed = model.fit_streamed([batch], binner)
    want = _tree_paths(TREES, False)
    want["gbdt.fit/gbdt.tree/gbdt.route"] = TREES * routes
    assert dict(_paths(prof)) == want
    for k in whole:
        assert torch.equal(whole[k], streamed[k]), k
