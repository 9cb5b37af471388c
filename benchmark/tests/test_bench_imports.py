"""Nothing under ``benchmark/`` imports JAX or the JAX package (top-level
names compared whole: ``dmlc_core_tpu_torch`` starts with
``dmlc_core_tpu``), and the references import nothing of the port."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))


def imported(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_nor_the_jax_package(path):
    assert not imported(path) & {"jax", "jaxlib", "flax", "dmlc_core_tpu"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob(
    "*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert "dmlc_core_tpu_torch" not in imported(path)


def test_the_scan_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import dmlc_core_tpu_torch.models\nfrom jax import numpy\n")
    assert imported(f) == {"dmlc_core_tpu_torch", "jax"}


def test_the_harness_reads_no_file_of_the_jax_era():
    text = "".join(p.read_text() for p in FILES
                   if p.parent.name != "tests")
    for name in ("bench.py", "chip_smoke", "BENCH_r0", "MULTICHIP_r0"):
        assert name not in text
