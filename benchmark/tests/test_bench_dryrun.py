"""A tiny CPU run of each cell prints the contract's last line: its keys,
its metrics with units, its device, the compared numbers last, and with
``--trace 1`` the per-layer metrics, busy and window seconds and the
breakdown."""
import pytest

from benchmark import harness
from conftest import CELLS, TINY, spec
from runs import run_cell

SPEC = spec()


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line_schema(cell, trace):
    rc, line, err = run_cell(cell, TINY[cell], trace=trace)
    assert rc == 0, err
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    e2e, layer = harness.cell_metrics(SPEC, cell)
    want = {m["name"]: m["unit"] for m in (layer if trace else e2e)}
    assert set(line["metrics"]) <= set(want)
    if not trace:
        assert set(line["metrics"]) == set(want)
    for name, m in line["metrics"].items():
        assert m["unit"] == want[name] and isinstance(m["value"], float)
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split(":")[0] for t in tail] == [
        f"check {k}" for k in line["checks"]]
    for c in line["checks"].values():
        assert {"value", "limit"} <= set(c)


def test_refuses_without_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        harness.run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"],
                    0.0)


def test_refuses_jax_in_the_process(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    rc, line, err = run_cell(CELLS[0], TINY[CELLS[0]])
    assert rc != 0 and line is None and "jax" in err
    assert harness.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "dmlc_core_tpu_torch_x",
                        types.ModuleType("y"))
    assert harness.forbidden_modules() == []
