"""``spans.reduce_events`` on synthetic kineto event lists: the correlation
link from a device operation to its runtime call (or, failing that, to
the torch operator its linked id names), the innermost of nested
spans, the idle midpoint rule, the ``unlinked`` and ``outside`` buckets, a
span's device shadow left out, host syncs by span; ``trace.summarize``
unmoved by program spans; and the span numbers None where there is
nothing to read."""
import pytest
import torch

from benchmark import spans, trace

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA
MAIN, OTHER = 1, 2


class Ev:
    """The fields of a kineto event that the reductions read (those torch
    2.11's events have)."""

    def __init__(self, name, start, end, device=CPU, user=False, corr=0,
                 linked=0, tid=MAIN):
        self._v = dict(name=name, start=start, dur=end - start,
                       device=device, user=user, corr=corr, linked=linked,
                       tid=tid)

    def name(self):
        return self._v["name"]

    def start_ns(self):
        return self._v["start"]

    def duration_ns(self):
        return self._v["dur"]

    def device_type(self):
        return self._v["device"]

    def is_user_annotation(self):
        return self._v["user"]

    def correlation_id(self):
        return self._v["corr"]

    def linked_correlation_id(self):
        return self._v["linked"]

    def start_thread_id(self):
        return self._v["tid"]


def span(name, start, end, tid=MAIN):
    return Ev(name, start, end, user=True, tid=tid)


def call(corr, start, name="cudaLaunchKernel", tid=MAIN):
    return Ev(name, start, start + 5, corr=corr, tid=tid)


def op(corr, start, end, name="aten::index"):
    return Ev(name, start, end, corr=corr)


def kernel(corr, start, end, name="k", linked=0):
    return Ev(name, start, end, device=CUDA, corr=corr, linked=linked)


def shadow(name, start, end, flagged=True):
    return Ev(name, start, end, device=CUDA, user=flagged)


class Prof:
    """What ``trace.summarize`` reads of a finished profile."""

    def __init__(self, events):
        results = type("R", (), {"events": lambda _self: list(events)})()
        self.profiler = type("P", (), {"kineto_results": results})()


# a window [0, 1000]: a fit (0-900) with a tree (10-890) holding a route
# (100-300) and a hist (300-600); a bench span around it all
EVENTS = [
    Ev("bench.fit", 0, 1000, user=True),
    span("gbdt.fit", 0, 900), span("gbdt.tree", 10, 890),
    span("gbdt.route", 100, 300), span("gbdt.hist", 300, 600),
    op(1, 110, 140), call(1, 120), kernel(1, 150, 250, linked=1),
    call(2, 310), kernel(2, 320, 500, "hist"),  # hist's kernel
    call(3, 650), kernel(3, 700, 800),          # under the tree alone
    call(4, 950), kernel(4, 960, 990),          # after the fit
    kernel(99, 500, 520, linked=98),            # no call, no op: unlinked
    op(40, 610, 640), kernel(77, 640, 650, linked=40),  # the op's link
    call(5, 560, "cudaStreamSynchronize"),
    call(6, 2, "cudaMemcpy"), call(7, 55, "cudaMemcpyAsync"),
    shadow("gbdt.route", 150, 250), shadow("gbdt.fit", 150, 990, False),
]

#: the same work traced from a program without spans
PARENT_EVENTS = [e for e in EVENTS if not e.name().startswith("gbdt.")]
ROUTE = "gbdt.fit/gbdt.tree/gbdt.route"
HIST = "gbdt.fit/gbdt.tree/gbdt.hist"
TREE = "gbdt.fit/gbdt.tree"


@pytest.fixture(scope="module")
def red():
    return spans.reduce_events(EVENTS, 0, 1000)


def test_each_op_goes_to_its_calls_innermost_span(red):
    assert red["device_s"][ROUTE] == pytest.approx(100e-9)
    assert red["device_s"][HIST] == pytest.approx(180e-9)
    # kernel 3 by its runtime call, kernel 77 by its operator's link
    assert red["device_s"][TREE] == pytest.approx(110e-9)
    assert red["launches"] == {ROUTE: 1, HIST: 1, TREE: 2,
                               spans.OUTSIDE: 1, spans.UNLINKED: 1}


def test_unlinked_and_outside(red):
    assert red["device_s"][spans.OUTSIDE] == pytest.approx(30e-9)
    assert red["device_s"][spans.UNLINKED] == pytest.approx(20e-9)


def test_a_spans_device_shadow_is_no_device_work(red):
    # busy: [150, 250] + [320, 520] + [640, 650] + [700, 800] + [960, 990];
    # the flagged route shadow and the unflagged gbdt.fit one are left out
    assert red["busy_s"] == pytest.approx(440e-9)
    assert red["device_total_s"] == pytest.approx(440e-9)


def test_each_idle_interval_goes_whole_to_the_span_at_its_midpoint(red):
    idle = red["idle_s"]
    # [0, 150] mid 75 -> gbdt.tree; [250, 320] mid 285 -> route;
    # [520, 640] mid 580 -> hist, though it ends past the hist span;
    # [650, 700] and [800, 960] -> tree; [990, 1000] -> outside (the bench
    # span is not the program's)
    assert idle[TREE] == pytest.approx((150 + 50 + 160) * 1e-9)
    assert idle[ROUTE] == pytest.approx(70e-9)
    assert idle[HIST] == pytest.approx(120e-9)
    assert idle[spans.OUTSIDE] == pytest.approx(10e-9)
    assert sum(idle.values()) == pytest.approx(
        red["window_s"] - red["busy_s"])


def test_host_syncs_by_span(red):
    # the stream sync under hist, the blocking cudaMemcpy under the fit;
    # cudaMemcpyAsync does not block
    assert red["syncs"] == {HIST: 1, "gbdt.fit": 1}
    assert spans.total(red["syncs"], "gbdt.fit", under=True) == 2


def test_counts_and_totals(red):
    assert red["count"] == {"gbdt.fit": 1, TREE: 1, ROUTE: 1, HIST: 1}
    assert spans.total(red["device_s"], "gbdt.route") == pytest.approx(
        100e-9)
    assert spans.total(red["device_s"], "gbdt.tree", under=True) == \
        pytest.approx(390e-9)


def test_the_innermost_of_nested_spans_is_exact():
    # deep nesting, siblings that touch, a span equal to its parent, and
    # far more spans than a bounded backward scan would reach
    evs = [span("a", 0, 10_000)]
    evs += [span("b", 10 * i, 10 * i + 10) for i in range(1, 900)]
    evs += [span("c", 9_000, 9_500), span("c2", 9_000, 9_500),
            span("d", 9_100, 9_200)]
    th = spans._Thread([(e.start_ns(), e.start_ns() + e.duration_ns(),
                         e.name()) for e in evs])

    def at(t):
        i = th.innermost(t)
        return th.path[i] if i >= 0 else None
    assert at(9_150) == "a/c/c2/d"
    assert at(9_300) == "a/c/c2"
    assert at(9_800) == "a"
    assert at(15) == "a/b"
    assert at(10_001) is None


def test_calls_on_another_thread_take_that_threads_spans():
    evs = [span("gbdt.fit", 0, 100), span("h2d.stage_batch", 0, 100,
                                          tid=OTHER),
           call(1, 10, tid=OTHER), kernel(1, 20, 30),
           call(2, 40), kernel(2, 50, 60)]
    red = spans.reduce_events(evs, 0, 100)
    assert red["launches"] == {"h2d.stage_batch": 1, "gbdt.fit": 1}


def test_summarize_is_unmoved_by_program_spans():
    # kineto flags a span's device shadow as a user annotation
    a = trace.summarize(Prof(PARENT_EVENTS), 0, 1000)
    b = trace.summarize(Prof([e for e in EVENTS if e.is_user_annotation()
                              or not e.name().startswith("gbdt.")]),
                        0, 1000)
    for k in ("window_s", "busy_s", "kernels", "device_ops"):
        assert a[k] == b[k], k
    assert sum(v for _, v in a["idle_gaps"]) == pytest.approx(
        sum(v for _, v in b["idle_gaps"]))


@pytest.mark.parametrize("name", sorted(spans.METRICS))
def test_each_number_is_none_without_something_to_read(name):
    read = spans.METRICS[name]
    parent = spans.reduce_events(PARENT_EVENTS, 0, 1000)
    for rec in ({}, {"profile": None, "fits": 2, "trees": 20},
                {"profile": {"busy_s": 1.0}, "fits": 2, "trees": 20},
                {"profile": {"spans": parent}, "fits": 2, "trees": 20},
                {"profile": {"spans": spans.reduce_events(EVENTS, 0, 1000)},
                 "fits": 0, "trees": 20}):
        assert read(rec) is None


def test_the_numbers_on_a_reduction():
    rec = {"profile": {"spans": spans.reduce_events(EVENTS, 0, 1000)},
           "fits": 1, "trees": 2}
    m = {k: f(rec) for k, f in spans.METRICS.items()}
    assert m["route.ms_tree"] == pytest.approx(1e3 * 100e-9 / 2)
    assert m["level.idle_ms_tree"] == pytest.approx(1e3 * 190e-9 / 2)
    assert m["fit.host_syncs"] == m["fit.host_syncs.sampled"] == 2
    assert m["draws.ms_tree.sampled"] is None  # no gbdt.draws span


def test_span_split_prints_the_harness_line_with_the_split(capsys):
    import json

    from benchmark import harness
    from benchmark.tools import span_split
    from conftest import TINY

    cell = "higgs.fit_sampled"
    rc = span_split.main(["--workload", cell, "--seeds", "3000000123",
                          "--seconds", "1", "--plain", "1"],
                         device="cpu", overrides=TINY[cell])
    assert rc == 0
    plain, traced = [json.loads(ln) for ln in
                     capsys.readouterr().out.strip().splitlines()]
    assert plain["correct"] and traced["correct"]
    assert "span_metrics" not in plain and "spans" not in plain
    assert set(traced["span_metrics"]) == {
        "draws.ms_tree.sampled", "draws.idle_ms_tree.sampled",
        "fit.host_syncs.sampled"}
    count = traced["spans"]["count"]
    assert count["gbdt.fit/gbdt.tree"] == 4 * count["gbdt.fit"] > 0
    assert count["gbdt.fit/gbdt.tree/gbdt.draws"] == count[
        "gbdt.fit/gbdt.tree"]
    assert trace.summarize is span_split._SUMMARIZE
    assert harness.result_line is span_split._RESULT_LINE
