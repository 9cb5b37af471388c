"""The port stands alone: no module of dmlc_core_tpu_torch (and not
chip_smoke.py) imports JAX or the JAX package, none names a module of the
JAX package in a string it could run (a subprocess's ``-m`` argument, an
``import_module`` name), and its entry points run on the card unless asked
for the CPU — without a card they raise instead of quietly running on the
CPU."""
import ast
import re
from pathlib import Path

import numpy as np
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
    # the framework-free modules the port keeps its own copies of, and the
    # slice-7 modules, are among those checked
    names = {p.relative_to(REPO).as_posix() for p in sources}
    assert {"dmlc_core_tpu_torch/io.py", "dmlc_core_tpu_torch/checkpoint.py",
            "dmlc_core_tpu_torch/models/ffm.py",
            "dmlc_core_tpu_torch/data/binned_cache.py",
            "dmlc_core_tpu_torch/autotune.py",
            "dmlc_core_tpu_torch/tracker/metrics.py",
            "dmlc_core_tpu_torch/tracker/submit.py",
            "dmlc_core_tpu_torch/parallel/bootstrap.py",
            "dmlc_core_tpu_torch/parallel/collective.py",
            "dmlc_core_tpu_torch/parallel/mesh.py",
            "dmlc_core_tpu_torch/parallel/meshplan.py"} <= names
    bad = []
    for path in sources:
        tree = ast.parse(path.read_text(), filename=str(path))
        for lineno, name in _imported_roots(tree):
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(REPO)}:{lineno} imports {name}")
    assert not bad, "\n".join(bad)


def _docstrings(tree):
    """The docstring nodes of a module and of its classes and functions
    (documentation may name the JAX module a port module copies)."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                yield first.value


JAX_MODULE = re.compile(r"\bdmlc_core_tpu\.")


def test_no_string_names_a_jax_package_module():
    bad = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        docs = {id(node) for node in _docstrings(tree)}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs
                    and JAX_MODULE.search(node.value)):
                bad.append(f"{path.relative_to(REPO)}:{node.lineno} "
                           f"{node.value[:60]!r}")
    assert not bad, "\n".join(bad)
    # the check sees such a string where it would run
    probe = ast.parse('subprocess.Popen(["-m", "dmlc_core_tpu.x.server"])')
    assert any(JAX_MODULE.search(n.value) for n in ast.walk(probe)
               if isinstance(n, ast.Constant) and isinstance(n.value, str))


def _entry_points(tmp_path):
    from dmlc_core_tpu_torch import checkpoint, parallel
    from dmlc_core_tpu_torch import random as prng
    from dmlc_core_tpu_torch.data import (BinnedStagingIter,
                                          DeviceStagingIter, Parser,
                                          RecordStagingIter)
    from dmlc_core_tpu_torch.io import RecordIOWriter
    from dmlc_core_tpu_torch.models import (GBDT, FactorizationMachine,
                                            FieldAwareFactorizationMachine,
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
    data = tmp_path / "rows.libsvm"
    data.write_text("1 0:0.5 2:1.5\n0 1:2\n")
    fields = tmp_path / "rows.libfm"
    fields.write_text("1 0:0:0.5 1:2:1.5\n")
    records = tmp_path / "rows.rec"
    with RecordIOWriter(str(records)) as writer:
        writer.write(b"a record")
    ckpt = tmp_path / "lin.ckpt"
    checkpoint.save({"w": np.zeros(4, np.float32)}, str(ckpt))
    with Parser(str(data)) as parser:  # the host parse needs no device
        assert sum(block.size for block in parser) == 2
    return {
        "DeviceStagingIter": lambda: DeviceStagingIter(str(data)),
        "DeviceStagingIter (libfm fields)": lambda: DeviceStagingIter(
            f"{fields}?format=libfm", with_field=True),
        "GBDT.predict_staged": lambda: GBDT(
            num_features=3, missing_aware=True).predict_staged(
            cpu.init(), str(data), None),
        "random.PRNGKey": lambda: prng.PRNGKey(0),
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
        "FieldAwareFactorizationMachine": lambda:
            FieldAwareFactorizationMachine(4, 2),
        "RecordStagingIter": lambda: RecordStagingIter(str(records)),
        "BinnedStagingIter": lambda: BinnedStagingIter(
            str(data), QuantileBinner(num_bins=4, missing_aware=True,
                                      device="cpu")),
        "checkpoint.load (like=)": lambda: checkpoint.load(
            str(ckpt), like={"w": 0}),
        "parallel.init_from_env": parallel.init_from_env,
    }


@pytest.mark.parametrize("name", ["DeviceStagingIter",
                                  "DeviceStagingIter (libfm fields)",
                                  "GBDT.predict_staged", "random.PRNGKey",
                                  "SparseLinearModel", "FactorizationMachine",
                                  "ScoringEngine", "ScoringIterator",
                                  "MicroBatchQueue", "ScoringServer", "GBDT",
                                  "QuantileBinner.transform",
                                  "QuantileBinner.transform_entries",
                                  "ScoringEngine (gbdt)",
                                  "FieldAwareFactorizationMachine",
                                  "RecordStagingIter", "BinnedStagingIter",
                                  "checkpoint.load (like=)",
                                  "parallel.init_from_env"])
def test_default_device_raises_without_cuda(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    entry = _entry_points(tmp_path)[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
