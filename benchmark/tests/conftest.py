"""The benchmark's own tests (``python -m pytest benchmark/tests``): the
harness, the references and the byte counts on the CPU at tiny sizes;
tests marked ``cuda`` run the cells on the card and skip without one."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


CELLS = [w["name"] for w in spec()["workloads"]]

#: each cell cut to a size a CPU test run can hold
TINY = {
    "higgs.fit": {"config": {"rows": 20000, "binner_sample_rows": 5000,
                             "num_boost_round": 4}},
    "higgs.fit_sampled": {"config": {"rows": 20000,
                                     "binner_sample_rows": 5000,
                                     "num_boost_round": 4}},
}


@pytest.fixture
def card():
    """Skips the test without a CUDA card (decided here, never while
    the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
