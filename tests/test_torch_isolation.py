"""The port stands alone: no module of dmlc_core_tpu_torch (and not
chip_smoke.py) imports JAX or the JAX package, and its entry points run on
the card unless asked for the CPU — without a card they raise instead of
quietly running on the CPU."""
import ast
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "dmlc_core_tpu")


def _port_sources():
    return sorted((REPO / "dmlc_core_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_imports_no_jax_and_no_jax_package():
    sources = _port_sources()
    assert len(sources) > 15
    bad = []
    for path in sources:
        tree = ast.parse(path.read_text(), filename=str(path))
        for lineno, name in _imported_roots(tree):
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(REPO)}:{lineno} imports {name}")
    assert not bad, "\n".join(bad)


def _entry_points():
    from dmlc_core_tpu_torch.models import (GBDT, FactorizationMachine,
                                            QuantileBinner, SparseLinearModel)
    from dmlc_core_tpu_torch.serving import (MicroBatchQueue, ScoringEngine,
                                             ScoringIterator, ScoringServer,
                                             pack_snapshot)
    snap = pack_snapshot("linear", {"num_features": 4},
                         {"w": [0.0] * 4, "b": 0.0})
    cpu = GBDT(num_features=1, num_trees=1, max_depth=1, num_bins=4,
               missing_aware=True, device="cpu")
    gbdt_snap = pack_snapshot(
        "gbdt", {"num_features": 1, "num_trees": 1, "max_depth": 1,
                 "num_bins": 4, "missing_aware": True}, cpu.init(),
        binner=QuantileBinner(num_bins=4, missing_aware=True,
                              device="cpu").fit_sparse([0, 0], [1.0, 2.0],
                                                       1))
    return {
        "SparseLinearModel": lambda: SparseLinearModel(4),
        "FactorizationMachine": lambda: FactorizationMachine(4),
        "ScoringEngine": lambda: ScoringEngine.from_snapshot_bytes(snap),
        "ScoringIterator": lambda: ScoringIterator(),
        "MicroBatchQueue": lambda: MicroBatchQueue(lambda: None),
        "ScoringServer": lambda: ScoringServer(),
        "GBDT": lambda: GBDT(num_features=4),
        "QuantileBinner.transform": lambda: QuantileBinner(num_bins=4).fit(
            [[0.0], [1.0], [2.0], [3.0]]).transform([[1.5]]),
        "QuantileBinner.transform_entries": lambda: QuantileBinner(
            num_bins=4, missing_aware=True).fit_sparse(
            [0, 0], [1.0, 2.0], 1).transform_entries([0], [1.5]),
        "ScoringEngine (gbdt)": lambda: ScoringEngine.from_snapshot_bytes(
            gbdt_snap),
    }


@pytest.mark.parametrize("name", ["SparseLinearModel", "FactorizationMachine",
                                  "ScoringEngine", "ScoringIterator",
                                  "MicroBatchQueue", "ScoringServer", "GBDT",
                                  "QuantileBinner.transform",
                                  "QuantileBinner.transform_entries",
                                  "ScoringEngine (gbdt)"])
def test_default_device_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()
