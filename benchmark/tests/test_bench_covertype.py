"""The ``covertype.fit`` cell: its files found by name, a tiny CPU run's
last line, its byte counts against a hand count, the frozen generator
against the bring-up's, and a broken path or evaluation coming out not
correct.  Its tiny size joins the others in ``conftest.TINY``, so the
schema and control tests run the cell too."""
import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.gen import covertype
from benchmark.roofline import gbdt_softmax, hist_level, peaks
from conftest import ROOT, TINY, spec
from runs import run_cell

CELL = "covertype.fit"
TINY.setdefault(CELL, {"config": {"rows": 6000, "train_rows": 4500,
                                  "binner_sample_rows": 3000,
                                  "num_boost_round": 3}})
METRICS = ("hist_dense.roofline_pct.softmax", "fit_mfu.softmax",
           "device_idle.fit_softmax", "tree.launches.softmax",
           "round.host_ms.softmax")
#: the metrics a CPU run can read (the others read device time)
HOST_METRICS = ("fit_mfu.softmax", "tree.launches.softmax",
                "round.host_ms.softmax")


def test_the_registry_finds_the_cells_files():
    s = spec()
    cell, config, traffic = harness.find_cell(s, CELL)
    assert cell["chips"] == 1 and config["name"] == "covertype"
    assert traffic["runner"] == "gbdt_fit_softmax"
    assert hasattr(harness.runner_for(traffic), "controls")
    e2e, layer = harness.cell_metrics(s, CELL)
    assert {m["name"] for m in e2e} == {"setup_s", "row_trees_s"}
    assert {m["name"] for m in layer} == set(METRICS)
    for m in METRICS:
        assert callable(harness.reader_for(m).read)
    assert len(s["workloads"]) == 3


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_cpu_run(trace):
    rc, line, err = run_cell(CELL, TINY[CELL], trace=trace)
    assert rc == 0, err
    assert line["correct"] is True, line["checks"]
    assert list(line["checks"]) == ["codes_wrong", "split_err", "cover_err",
                                    "leaf_err", "eval_err"]
    if trace:
        assert set(HOST_METRICS) <= set(line["metrics"]) <= set(METRICS)
        assert line["metrics"]["round.host_ms.softmax"]["value"] > 0
    else:
        assert set(line["metrics"]) == {"setup_s", "row_trees_s"}


def test_the_readers_give_none_without_a_fit():
    for m in METRICS:
        assert harness.reader_for(m).read({"fits": 0}) is None


def test_roofline_against_a_hand_count():
    rows, ev, F, K, R, depth = 1000, 200, 54, 7, 2, 2
    levels = (rows * (F + 8 + 4) + 1 * F * 256 * 8) + (
        rows * (F + 8 + 4) + 2 * F * 256 * 8)
    tree = levels + rows * (16 + 12) + ev * (depth + 8)
    rnd = rows * 8 * K + ev * (4 * K + 4)
    want = R * (K * tree + rnd)
    assert gbdt_softmax.fit_bytes(rows, ev, F, K, R, depth) == want
    flops = R * (K * (depth * 4 * rows * F + rows * 6 + ev * (depth + 1))
                 + rows * 4 * K + ev * (3 * K + 2))
    assert gbdt_softmax.fit_flops(rows, ev, F, K, R, depth) == flops
    assert gbdt_softmax.fit_bound_s(rows, ev, F, K, R, depth) == max(
        want / peaks.HBM_BYTES_PER_S, flops / peaks.F32_FLOPS_PER_S)
    # the cell's shape: 27.79 GB a fit, 8.3 ms at the peaks; its levels
    # are hist_level's at the train rows
    full = gbdt_softmax.fit_bytes(435_759, 145_253, 54, 7, 20, 6)
    assert 27.7e9 < full < 27.9e9
    assert gbdt_softmax.tree_bytes(435_759, 0, 54, 6) == sum(
        hist_level.level_bytes(435_759, 54, 2 ** d) for d in range(6)) \
        + 435_759 * 28


def test_the_generator_is_the_bring_ups():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    want_x, want_y = chip_smoke.covertype_on_card(torch, "cpu", seed=1998)
    x, y = covertype.covertype_like(covertype.ROWS, 1998, "cpu")
    assert torch.equal(x, want_x) and torch.equal(y, want_y)
    counts = torch.bincount(y.long(), minlength=7).tolist()
    assert tuple(counts) == covertype.COUNTS == chip_smoke.COVER_COUNTS
    assert bool((x[:, 10:14].sum(1) == 1).all())
    assert bool((x[:, 14:].sum(1) == 1).all())
    assert torch.equal(x[:, 10:], x[:, 10:].round())


def _broken(monkeypatch, kind):
    from dmlc_core_tpu_torch.models import GBDT
    fit = GBDT.fit

    def broken(self, bins, label, *a, **kw):
        if kind == "unchanged":
            out = self.init()
            out["base"] = fit(self, bins, label, *a, **kw)["base"]
            return out
        if kind == "half":
            n = bins.shape[0] // 2
            return fit(self, bins[:n], label[:n], *a, **kw)
        if kind == "no_eval":
            out = fit(self, bins, label)
            self.eval_history = []
            return out
        if kind == "eval_off":
            out = fit(self, bins, label, *a, **kw)
            self.eval_history = [h * 1.001 for h in self.eval_history]
            return out
        out = fit(self, bins, label, *a, **kw)
        out["leaf"][0, 0] *= 1.01
        return out
    monkeypatch.setattr(GBDT, "fit", broken)


@pytest.mark.parametrize("kind", ["unchanged", "half", "answer", "no_eval",
                                  "eval_off"])
def test_a_broken_path_is_not_correct(monkeypatch, kind):
    _broken(monkeypatch, kind)
    rc, line, err = run_cell(CELL, TINY[CELL])
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]


def test_a_program_without_eval_history_stops_at_once(monkeypatch):
    from dmlc_core_tpu_torch.models import GBDT
    init = GBDT.__init__

    def old(self, *a, **kw):
        init(self, *a, **kw)
        del self.eval_history
    monkeypatch.setattr(GBDT, "__init__", old)
    with pytest.raises(SystemExit, match="eval_history"):
        run_cell(CELL, TINY[CELL])


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_all_five(card):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         "3000000779", "--seconds", "3", "--trace", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == set(METRICS)
    assert all(m["value"] is not None for m in line["metrics"].values())
