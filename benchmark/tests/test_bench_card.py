"""Each cell on the card, briefly, through the command line: marked
``cuda`` and skipped without a card (``python -m pytest -m cuda
benchmark/tests``)."""
import json
import subprocess
import sys

import pytest

from benchmark import harness

SPEC = harness.read_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "3000000777", "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == card
