"""A configuration, a traffic mix and a per-layer metric dropped into their
folders, with entries in BENCHMARK.json, are found by name: no harness
edit."""
import json
import shutil

from benchmark import harness
from runs import run_cell


def test_dropped_in_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((root / "benchmark/configs/higgs.json").read_text())
    conf.update(rows=8000, binner_sample_rows=2000, num_boost_round=2,
                max_depth=3)
    (root / "benchmark/configs/tiny-higgs.json").write_text(json.dumps(conf))
    mix = json.loads((root / "benchmark/traffic/fit_resident.json")
                     .read_text())
    mix.update(subsample=0.5, metric="row_trees_s.half")
    (root / "benchmark/traffic/fit_half_rows.json").write_text(
        json.dumps(mix))
    (root / "benchmark/metrics/fits_seen.py").write_text(
        "def read(rec):\n    return float(rec['fits'])\n")
    spec["configs"].append(dict(spec["configs"][0], name="tiny-higgs",
                                file="benchmark/configs/tiny-higgs.json"))
    spec["workloads"].append({"name": "tiny-higgs.half", "config":
                              "tiny-higgs", "traffic": "fit_half_rows",
                              "chips": 1, "why": "a test's cell"})
    spec["end_to_end"].append({"name": "row_trees_s.half", "unit":
                               "row-trees/s", "better": "higher",
                               "bound": 0.1, "source": "host_clock",
                               "workloads": ["tiny-higgs.half"]})
    spec["per_layer"].append({"name": "fits_seen", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "boosting driver",
                              "moves": "row_trees_s.half",
                              "workloads": ["tiny-higgs.half"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, line, err = run_cell("tiny-higgs.half", {}, seconds=0.5, root=root)
    assert rc == 0, err
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"setup_s", "row_trees_s.half"}
    rc, line, err = run_cell("tiny-higgs.half", {}, seconds=0.5, trace=1,
                             root=root)
    assert rc == 0, err
    assert line["metrics"]["fits_seen"]["value"] >= 1
    assert "fit_mfu" not in line["metrics"]
