"""The kernel build cache (dmlc_core_tpu_torch.ops._build): a library's file
name hashes the flags, the kernel's source and every header it includes,
so an edited source or header never loads a stale build.  Runs on a copy of
``csrc/`` in a temporary directory; nothing is compiled."""
import shutil

import pytest

from dmlc_core_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, copy)
    monkeypatch.setattr(_build, "_CSRC", copy)
    return copy


@pytest.mark.parametrize("name", ["histogram_gh", "histogram_gh_sparse"])
def test_histogram_kernels_hash_their_shared_header(csrc, name):
    assert [p.name for p in _build.sources(name)] == [f"{name}.cu",
                                                      "hist_fixed.cuh"]
    before = _build._target(name)
    header = csrc / "hist_fixed.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build._target(name)
    assert after != before and after.name.startswith(f"lib{name}-")


def test_nested_headers_count_and_other_kernels_do_not_move(csrc):
    (csrc / "inner.cuh").write_text("#pragma once\n")
    (csrc / "hist_fixed.cuh").write_text(
        '#include "inner.cuh"\n' + (csrc / "hist_fixed.cuh").read_text())
    assert [p.name for p in _build.sources("histogram_gh")] == [
        "histogram_gh.cu", "hist_fixed.cuh", "inner.cuh"]
    seg = _build._target("segment_sum")
    before = _build._target("histogram_gh")
    (csrc / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert _build._target("histogram_gh") != before
    assert _build._target("segment_sum") == seg
