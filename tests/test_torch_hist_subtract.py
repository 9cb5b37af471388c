"""Sibling subtraction of the dense histogram, on its plain int64 route.

A level below the root adds only the rows of the child of each node pair
with fewer rows (``smaller_sides`` of each node's rows) and takes the sibling as the parent
level's int64 accumulator less the built child's
(``histogram_gh_subtract_plain``, what the kernel's subtracted launch is
held to on the card by tests/test_torch_cuda.py).  The sums are exact at
one scale, so the subtracted level must equal the full level's plain
fixed-point accumulator bit for bit, and its f32 histogram too.
"""
import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch.ops import histogram as hg
from dmlc_core_tpu_torch.ops.fixed_point import (dequantize_plain,
                                                 fixed_point_scale, lane_amax,
                                                 value_limit)

# name: (rows, code columns, num_bins, nodes at the subtracted level)
CASES = {
    "higgs-width": (5000, "higgs", 256, 32),
    "covertype-width": (6000, "covertype", 256, 8),
    "codes-past-num-bins": (3000, "wide", 64, 8),
    "zero-weight-rows": (4000, "higgs", 256, 4),
    "nan-lane": (2000, "higgs", 256, 4),
    "lane-past-value-limit": (2000, "higgs", 256, 4),
    "odd-rows": (777, "higgs", 256, 16),
    "null-split": (3001, "covertype", 256, 8),
    "side-ties": (4096, "higgs", 256, 8),
    "any-side": (2500, "covertype", 256, 16),
    "rows-out-of-range": (1999, "higgs", 256, 4),
    "two-nodes": (1001, "wide", 16, 2),
}


def _codes(rng, rows, kind, B):
    if kind == "higgs":  # 28 columns, 4 b-tag columns of 3 values
        bins = rng.integers(0, B, (rows, 28))
        bins[:, [8, 12, 16, 20]] = rng.integers(0, 3, (rows, 4))
    elif kind == "covertype":  # 10 continuous, 4 + 40 one-hot columns
        hot = np.concatenate([np.eye(4, dtype=np.int64)[
            rng.integers(0, 4, rows)], np.eye(40, dtype=np.int64)[
            rng.integers(0, 40, rows)]], 1)
        bins = np.concatenate([rng.integers(0, B, (rows, 10)),
                               np.where(hot == 1, 255, 242)], 1)
    else:  # uint8 codes, some at or past num_bins
        bins = rng.integers(0, 256, (rows, 6))
    return torch.from_numpy(bins.astype(np.uint8))


def _level(name):
    """(bins, gh, each row's node at the parent level and at this one,
    n_nodes, num_bins, scale, qmax, each node's rows)."""
    rows, kind, B, n = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 40)
    bins = _codes(rng, rows, kind, B)
    gh = np.stack([rng.standard_normal(rows),
                   rng.uniform(0.05, 0.25, rows)], 1).astype(np.float32)
    half = n // 2
    parent = rng.integers(0, half, rows)
    right = rng.random(rows) < rng.uniform(0.05, 0.95, half)[parent]
    if name == "zero-weight-rows":
        gh[rng.random(rows) < 0.3] = 0.0
    if name == "nan-lane":
        gh[17, 0] = np.nan
    if name == "null-split":  # pairs 0 and 2 send every row left
        right[np.isin(parent, (0, 2))] = False
    if name == "side-ties":  # every pair splits its rows in half
        order = np.argsort(parent, kind="stable")
        right = np.zeros(rows, bool)
        for p in range(half):
            mine = order[parent[order] == p]
            mine = mine[:len(mine) // 2 * 2]
            right[mine[1::2]] = True
            parent[order[parent[order] == p][len(mine):]] = -1
    rel = np.where(parent >= 0, 2 * parent + right, -1)
    if name == "rows-out-of-range":
        parent[:50], rel[:50] = half + 3, 2 * half + 6
        parent[50:60], rel[50:60] = -1, -2
    g = torch.from_numpy(gh)
    scale, qmax = fixed_point_scale(lane_amax(g), rows), value_limit(rows)
    if name == "lane-past-value-limit":
        # a scale made for a quarter of lane 1's largest value: its largest
        # values reach the value limit and mark the lane
        scale = fixed_point_scale(lane_amax(g) * torch.tensor([1.0, 0.25]),
                                  rows)
    live = rel[(rel >= 0) & (rel < n)]
    counts = torch.bincount(torch.from_numpy(live), minlength=n)
    if name == "any-side":  # counts that build either child at random
        counts = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    return (bins, g, torch.from_numpy(parent.astype(np.int32)),
            torch.from_numpy(rel.astype(np.int32)), n, B, scale, qmax, counts)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_subtracted_level_is_the_full_level_bit_for_bit(name):
    """parent - built child equals the full level's plain int64
    accumulator, marks included, and so its f32 histogram, NaN lanes
    included; the built rows are the fewer of each pair's."""
    bins, gh, parent_rel, rel, n, B, scale, qmax, counts = _level(name)
    full = hg.histogram_gh_accumulate_plain(bins, rel, gh, n, B, scale, qmax)
    parent = hg.histogram_gh_accumulate_plain(bins, parent_rel, gh, n // 2,
                                              B, scale, qmax)
    got = hg.histogram_gh_subtract_plain(bins, rel, gh, n, B, scale, qmax,
                                         parent, counts)
    assert got.dtype == torch.int64 and got.shape == full.shape
    assert torch.equal(got, full)
    assert torch.equal(_bits(dequantize_plain(got, scale, 2)),
                       _bits(dequantize_plain(full, scale, 2)))
    marks = full[-2:].tolist()
    assert marks == {"nan-lane": [1, 0],
                     "lane-past-value-limit": [0, 1]}.get(name, [0, 0])
    if name != "any-side":  # the counts are the rows of each node
        live = rel[rel >= 0].long()
        assert torch.equal(counts.long(), torch.bincount(live[live < n],
                                                         minlength=n))


@pytest.mark.parametrize("counts,want", [
    ([5, 3, 2, 2, 0, 7, 4, 0], [True, False, False, True]),
    ([0, 0], [False]),
    ([10, 0, 1, 2], [True, False]),
])
def test_side_rule_builds_the_child_of_fewer_rows_ties_left(counts, want):
    """The right child (True) is built only where it holds fewer rows than
    the left; a tie and an empty pair build the left, and a null split
    (every row left) builds its empty right child."""
    got = hg.smaller_sides(torch.tensor(counts, dtype=torch.int32))
    assert got.dtype == torch.bool and got.tolist() == want


def test_kernel_wrapper_on_the_cpu_refuses_subtraction():
    """Subtraction and the accumulator are the kernel's, on the card."""
    bins, gh, parent_rel, rel, n, B, *_ = _level("two-nodes")
    with pytest.raises(ValueError, match="on the card"):
        hg.histogram_gh_kernel(bins, rel, gh, n, B, return_acc=True)
    with pytest.raises(ValueError, match="on the card"):
        hg.histogram_gh_kernel(bins, rel, gh, n, B,
                               parent=torch.zeros(8, dtype=torch.int64))
