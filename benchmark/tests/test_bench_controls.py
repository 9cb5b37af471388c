"""The control has to come out not correct: the reference in the
program's place in bfloat16 exceeds a limit of the cell's, where sound runs of the port pass
every limit.  At a size a CPU test run can hold; the readings the limits
were set from are the card's, at the cells' own sizes (PERF.md)."""
import pytest

from benchmark import harness
from benchmark.tools import readings
from conftest import CELLS, TINY, spec


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_sound_runs_pass(cell):
    _, _, traffic = harness.find_cell(spec(), cell)
    limits = traffic["limits"]
    lines = readings.main(["--workload", cell, "--seeds", "1",
                           "--control-seeds", "1", "--seconds", "0.5"],
                          device="cpu", overrides=TINY[cell])
    for line in lines:
        over = [k for k, v in line["numbers"].items()
                if k in limits and v > limits[k]]
        if line["kind"] == "sound":
            assert line["numbers"]["correct"] and not over, line
        else:
            assert over, line
