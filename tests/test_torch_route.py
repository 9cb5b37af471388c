"""Dense GBDT routing (``dmlc_core_tpu_torch.ops.route``) on the CPU.

The plain version (``route_dense_plain``, which the wrapper runs for CPU
tensors) is held to the composition of its own single levels and to the
JAX package's ``GBDT._tree_margins`` on random trees, with and without
``missing_aware``; the wrapper refuses what the kernel does not take; a
CPU fit routes on the plain version and leaves the kernel's counters as
they were.  The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda_route.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
from dmlc_core_tpu_torch.models import GBDT
from dmlc_core_tpu_torch.ops import route
from dmlc_core_tpu_torch.ops.route import route_dense_kernel, route_dense_plain


def _tree(rng, depth: int, F: int, num_bins: int, null_share: float = 0.2):
    """Random int32 split tables of a depth-``depth`` tree in heap order,
    with some nodes that did not split (threshold ``num_bins``, feature 0,
    direction 0, as ``GBDT._pick_splits`` encodes them)."""
    n = 2 ** depth - 1
    feature = rng.integers(0, F, n)
    threshold = rng.integers(0, num_bins, n)
    default_right = rng.integers(0, 2, n)
    null = rng.random(n) < null_share
    feature[null], threshold[null], default_right[null] = 0, num_bins, 0
    return [torch.from_numpy(a.astype(np.int32))
            for a in (feature, threshold, default_right)]


def _bins(rng, rows: int, F: int, num_bins: int, dtype):
    """Codes with a share of missing (0) ones; int32 codes past 255."""
    b = rng.integers(0, num_bins, (rows, F))
    b[rng.random((rows, F)) < 0.15] = 0
    return torch.from_numpy(b).to(dtype).contiguous()


def _level(tables, depth: int):
    lo, hi = 2 ** depth - 1, 2 ** (depth + 1) - 1
    return [t[lo:hi].contiguous() for t in tables]


@pytest.mark.parametrize("missing_aware", [False, True])
@pytest.mark.parametrize("dtype,num_bins", [(torch.uint8, 256),
                                            (torch.int32, 1000)])
@pytest.mark.parametrize("first,levels", [(0, 6), (2, 3), (5, 1), (3, 0)])
def test_plain_walk_equals_its_single_levels(first, levels, dtype, num_bins,
                                             missing_aware):
    rng = np.random.default_rng(first * 10 + levels)
    rows, F, depth = 777, 9, 6
    tables = _tree(rng, depth, F, num_bins)
    bins = _bins(rng, rows, F, num_bins, dtype)
    rel = torch.from_numpy(rng.integers(0, 2 ** first, rows).astype(np.int32))
    want = rel
    for d in range(first, first + levels):
        want = route_dense_plain(bins, want, *_level(tables, d), d, 1,
                                 missing_aware)
    lo, hi = 2 ** first - 1, 2 ** (first + levels) - 1
    walk = [t[lo:hi].contiguous() for t in tables]
    got = route_dense_kernel(bins, rel, *walk, first, levels, missing_aware)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)
    if first == 0:  # from the root, with no node array
        assert torch.equal(route_dense_kernel(bins, None, *walk, 0, levels,
                                              missing_aware), want)


@pytest.mark.parametrize("missing_aware", [False, True])
@pytest.mark.parametrize("depth", [1, 4, 6])
def test_tree_walk_equals_jax_tree_margins(depth, missing_aware):
    rng = np.random.default_rng(100 + depth)
    rows, F, num_bins = 1000, 7, 64
    bins = _bins(rng, rows, F, num_bins, torch.uint8)
    kw = dict(num_features=F, num_trees=3, max_depth=depth,
              num_bins=num_bins, missing_aware=missing_aware)
    port, jax_model = GBDT(device="cpu", **kw), JaxGBDT(**kw)
    for _ in range(3):
        feature, threshold, default_right = _tree(rng, depth, F, num_bins)
        leaf = torch.arange(2 ** depth, dtype=torch.float32)  # leaf ids
        want = np.asarray(jax_model._tree_margins(
            jnp.asarray(feature.numpy()), jnp.asarray(threshold.numpy()),
            jnp.asarray(default_right.numpy()), jnp.asarray(leaf.numpy()),
            jnp.asarray(bins.numpy())))
        got = route_dense_plain(bins, None, feature, threshold,
                                default_right, 0, depth, missing_aware)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
        np.testing.assert_array_equal(
            port._tree_margins(feature, threshold, default_right, leaf,
                               bins).numpy(), want)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(7)
    bins = _bins(rng, 64, 5, 16, torch.uint8)
    f, t, d = _tree(rng, 3, 5, 16)
    rel = torch.zeros(64, dtype=torch.int32)
    ok = route_dense_kernel(bins, rel, f, t, d, 0, 3, False)
    assert ok.shape == (64,)
    with pytest.raises(TypeError, match="uint8/int32 bins"):
        route_dense_kernel(bins.to(torch.int64), rel, f, t, d, 0, 3, False)
    with pytest.raises(TypeError, match="int32"):
        route_dense_kernel(bins, rel.to(torch.int64), f, t, d, 0, 3, False)
    with pytest.raises(TypeError, match="int32"):
        route_dense_kernel(bins, rel, f.to(torch.int64), t, d, 0, 3, False)
    with pytest.raises(ValueError, match="take 7 entries"):
        route_dense_kernel(bins, rel, f[:3], t[:3], d[:3], 0, 3, False)
    with pytest.raises(ValueError, match="take 14 entries"):
        route_dense_kernel(bins, rel, f, t, d, 1, 3, False)
    with pytest.raises(ValueError, match="rel"):
        route_dense_kernel(bins, rel[:10], f, t, d, 0, 3, False)
    with pytest.raises(ValueError, match="bins"):
        route_dense_kernel(bins[0], rel, f, t, d, 0, 3, False)
    with pytest.raises(ValueError, match="past 30"):
        route_dense_kernel(bins, rel, f, t, d, 29, 3, False)
    with pytest.raises(ValueError, match="contiguous"):
        route_dense_kernel(bins.t().contiguous().t(), rel, f, t, d, 0, 3,
                           False)
    with pytest.raises(ValueError, match="contiguous"):
        f2 = torch.stack([f, f], dim=1)[:, 0]
        route_dense_kernel(bins, rel, f2, t, d, 0, 3, False)


def test_cpu_fit_routes_on_the_plain_version(monkeypatch):
    """A CPU fit with a held-out set routes every level and every eval walk
    through the plain version; the kernel's counters stay as they were."""
    rng = np.random.default_rng(11)
    x = rng.integers(0, 32, (400, 6)).astype(np.uint8)
    y = ((x[:, 0] > 15) ^ (x[:, 1] > 20)).astype(np.float32)
    calls = []

    def counted(*args):
        calls.append(args[5:7])  # (first, levels)
        return route_dense_plain(*args)

    monkeypatch.setattr(route, "route_dense_plain", counted)
    before = (route_dense_kernel.launches, route_dense_kernel.levels)
    model = GBDT(num_features=6, num_trees=3, max_depth=4, num_bins=32,
                 device="cpu")
    model.fit(x[:300], y[:300], eval_set=(x[300:], y[300:]))
    assert (route_dense_kernel.launches, route_dense_kernel.levels) == before
    training = [(d, 1) for d in range(4)] * 3
    assert sorted(calls) == sorted(training + [(0, 4)] * 3)
