"""Run one cell of the port's benchmark once; the last line of standard
output is its result.

    python3 benchmark/run.py --workload higgs.fit --seed 7 --seconds 10 --trace 0

Exits with a code other than 0, and prints no result, without a CUDA card
(or with fewer than the cell asks for), or when JAX or the JAX package was
loaded in the process.
"""
import time

T_START = time.monotonic()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = str(Path(__file__).resolve().parent.parent)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
