"""Run the harness in process on the CPU (the look for a card skipped),
and read back its last line."""
import contextlib
import io
import json
import time

from benchmark import harness


def run_cell(cell: str, overrides: dict, seed: int = 3_000_000_123,
             seconds: float = 1.0, trace: int = 0, root=harness.ROOT):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.run(["--workload", cell, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)],
                         time.monotonic(), device="cpu", root=root,
                         overrides=overrides)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
