"""On-card tests of dense GBDT routing (marker ``cuda``; each skips when no
CUDA device is present).  They import neither JAX nor the JAX package::

    python -m pytest --noconftest -m cuda -rP tests/test_torch_cuda_route.py

The route kernel (``csrc/route_dense.cu``, ``ops.route.route_dense_kernel``)
equals its plain version bit for bit: uint8 and int32 codes (int32 past
255), with and without ``missing_aware``, one level at each depth 0-5 and
a whole depth-6 tree walked from the root, at 0, 1, 1023 and 11M rows and
1, 28, 54 and 136 features, with nodes that did not split; also with node
arrays not 16-byte aligned, tables too deep for shared memory, and
features and nodes out of range (clamped into their tables).  A
Higgs-shaped binary fit and a Covertype-shaped softmax fit, each with a
held-out set, give the forests and held-out losses of the same fits routed
by the plain version, byte for byte; the softmax fit's replayed rounds
equal its eager rounds; every routed level and every eval walk of a fit
goes through the kernel.
"""
import functools

import pytest
import torch

from dmlc_core_tpu_torch.models import GBDT
from dmlc_core_tpu_torch.ops.route import route_dense_kernel, route_dense_plain

pytestmark = pytest.mark.cuda
SEED = 2_718_281_829
DEPTH = 6
HIGGS_ROWS = 11_000_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _gen(device, salt: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(SEED + salt)


def _tree(device, depth: int, F: int, num_bins: int, salt: int = 0):
    """int32 split tables of a depth-``depth`` tree in heap order; about a
    fifth of the nodes did not split (feature 0, threshold ``num_bins``,
    direction 0, as ``GBDT._pick_splits`` encodes them)."""
    g = _gen(device, salt)
    n = 2 ** depth - 1
    feature = torch.randint(0, F, (n,), generator=g, device=device)
    threshold = torch.randint(0, num_bins, (n,), generator=g, device=device)
    default_right = torch.randint(0, 2, (n,), generator=g, device=device)
    null = torch.rand(n, generator=g, device=device) < 0.2
    feature[null], threshold[null], default_right[null] = 0, num_bins, 0
    return [t.to(torch.int32) for t in (feature, threshold, default_right)]


@functools.lru_cache(maxsize=4)
def _codes(rows: int, F: int, dtype: torch.dtype):
    """[rows, F] codes on the card, a sixth of them missing (0); int32
    codes run to 999."""
    dev = torch.device("cuda")
    g = _gen(dev, rows + F)
    top = 256 if dtype == torch.uint8 else 1000
    b = torch.randint(0, top, (rows, F), generator=g, device=dev,
                      dtype=torch.int32)
    b[torch.rand((rows, F), generator=g, device=dev) < 1 / 6] = 0
    return b.to(dtype)


def _walk(tables, first: int, levels: int):
    """The tables of ``levels`` levels from level ``first``."""
    lo, hi = 2 ** first - 1, 2 ** (first + levels) - 1
    return [t[lo:hi].contiguous() for t in tables]


SHAPES = [(rows, F) for rows in (0, 1, 1023) for F in (1, 28, 54, 136)] + [
    (HIGGS_ROWS, 28), (HIGGS_ROWS, 54)]


@pytest.mark.parametrize("walk", [f"level{d}" for d in range(DEPTH)]
                         + ["tree"])
@pytest.mark.parametrize("missing_aware", [False, True])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("rows,F", SHAPES)
def test_route_kernel_equals_plain_bit_for_bit(cuda, rows, F, dtype,
                                               missing_aware, walk):
    num_bins = 256 if dtype == torch.uint8 else 1000
    bins = _codes(rows, F, dtype)
    tables = _tree(cuda, DEPTH, F, num_bins, salt=F)
    if walk == "tree":
        args = (None, *tables, 0, DEPTH)
    else:
        d = int(walk[5:])
        rel = torch.randint(0, 2 ** d, (rows,), generator=_gen(cuda, d),
                            device=cuda, dtype=torch.int32)
        args = (rel, *_walk(tables, d, 1), d, 1)
    launches, levels = route_dense_kernel.launches, route_dense_kernel.levels
    got = route_dense_kernel(bins, *args, missing_aware)
    torch.cuda.synchronize()
    want = route_dense_plain(bins, *args, missing_aware)
    assert got.dtype == torch.int32 and got.shape == (rows,)
    assert torch.equal(got, want)
    assert route_dense_kernel.launches == launches + bool(rows)
    assert route_dense_kernel.levels == levels + (args[-1] if rows else 0)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_route_kernel_unaligned_nodes(cuda, offset):
    """Node arrays that start off a 16-byte boundary take the scalar path."""
    bins = _codes(1023, 28, torch.uint8)
    tables = _tree(cuda, DEPTH, 28, 256)
    buf = torch.randint(0, 8, (1023 + offset,), generator=_gen(cuda, 5),
                        device=cuda, dtype=torch.int32)
    rel = buf[offset:]
    for levels in (1, 3):
        walk = _walk(tables, 3, levels)
        got = route_dense_kernel(bins, rel, *walk, 3, levels, True)
        assert torch.equal(got, route_dense_plain(bins, rel, *walk, 3,
                                                  levels, True))


@pytest.mark.parametrize("first,levels", [(12, 1), (13, 1), (0, 13)])
def test_route_kernel_deep_tables(cuda, first, levels):
    """Tables past 4096 entries are read from device memory, not shared."""
    rows, F = 100_003, 28
    bins = _codes(rows, F, torch.uint8)
    tables = _tree(cuda, first + levels, F, 256, salt=first)
    walk = _walk(tables, first, levels)
    rel = (None if first == 0 else
           torch.randint(0, 2 ** first, (rows,), generator=_gen(cuda, 9),
                         device=cuda, dtype=torch.int32))
    for missing_aware in (False, True):
        got = route_dense_kernel(bins, rel, *walk, first, levels,
                                 missing_aware)
        want = route_dense_plain(bins, rel, *walk, first, levels,
                                 missing_aware)
        assert torch.equal(got, want)


def test_route_kernel_clamps_out_of_range_nodes_and_features(cuda):
    """A feature out of range reads the nearest column, a node out of its
    level (a negative one counts as past the end) its level's last node:
    nothing is read outside an array."""
    rows, F = 1023, 28
    bins = _codes(rows, F, torch.uint8)
    feature, threshold, default_right = _walk(_tree(cuda, DEPTH, F, 256), 4,
                                              1)
    feature[::3] = F + 5
    feature[1::5] = -2
    rel = torch.randint(-20, 40, (rows,), generator=_gen(cuda, 4),
                        device=cuda, dtype=torch.int32)
    got = route_dense_kernel(bins, rel, feature, threshold, default_right, 4,
                             1, True)
    n = torch.where((rel < 0) | (rel > 15), 15, rel)
    want = route_dense_plain(bins, n, feature.clamp(0, F - 1), threshold,
                             default_right, 4, 1, True)
    assert torch.equal(got, want + 2 * (rel - n))


def test_route_kernel_refuses_what_it_does_not_take(cuda):
    bins = _codes(1023, 28, torch.uint8)
    f, t, d = _tree(cuda, 3, 28, 256)
    with pytest.raises(ValueError, match="one device"):
        route_dense_kernel(bins, None, f.cpu(), t, d, 0, 3, False)
    with pytest.raises(ValueError, match="one device"):
        route_dense_kernel(bins, torch.zeros(1023, dtype=torch.int32), f, t,
                           d, 0, 3, False)
    with pytest.raises(TypeError, match="uint8/int32 bins"):
        route_dense_kernel(bins.to(torch.int16), None, f, t, d, 0, 3, False)
    with pytest.raises(ValueError, match="take 7 entries"):
        route_dense_kernel(bins, None, f[:6], t[:6], d[:6], 0, 3, False)
    with pytest.raises(ValueError, match="contiguous"):
        route_dense_kernel(bins[:, ::2], None, f, t, d, 0, 3, False)


# ---- fits -------------------------------------------------------------------

def _plain_route(self, bins, rel, split_f, split_b, split_d, levels=1):
    """``GBDT._route_dense`` on the plain version, on the card."""
    first = 0 if rel is None else (
        split_f.shape[0] // (2 ** levels - 1)).bit_length() - 1
    return route_dense_plain(bins, rel, split_f, split_b, split_d, first,
                             levels, self.missing_aware)


def _higgs_like(dev, rows: int):
    """Higgs-width codes (28 columns, 256 bins; four b-tag-like columns of
    three codes) and a 0/1 label of an interaction plus noise."""
    g = _gen(dev, 77)
    bins = torch.randint(0, 256, (rows, 28), generator=g, device=dev,
                         dtype=torch.int32)
    for c in (8, 12, 16, 20):
        bins[:, c] = torch.randint(0, 3, (rows,), generator=g, device=dev)
    z = ((bins[:, 0] - 128) * (bins[:, 1] - 100) / 4096.0
         + (bins[:, 8] - 1) + (bins[:, 25] - 128) / 64.0
         + torch.randn(rows, generator=g, device=dev))
    return bins.to(torch.uint8).contiguous(), (z > 0).to(torch.float32)


def _covertype_like(dev, rows: int):
    """Covertype-width codes: 10 continuous columns, a 4-way and a 40-way
    one-hot group, and 7 classes from a latent of a few columns."""
    g = _gen(dev, 78)
    cont = torch.randint(0, 256, (rows, 10), generator=g, device=dev)
    wild = torch.nn.functional.one_hot(
        torch.randint(0, 4, (rows,), generator=g, device=dev), 4)
    soil = torch.nn.functional.one_hot(
        torch.randint(0, 40, (rows,), generator=g, device=dev), 40)
    bins = torch.cat([cont, wild, soil], dim=1).to(torch.uint8).contiguous()
    latent = (cont[:, 0] / 32.0 + wild[:, 1] * 2.0 - wild[:, 3]
              + (soil[:, :10].sum(1) * 1.5) + cont[:, 3] / 128.0
              + torch.randn(rows, generator=g, device=dev))
    cuts = torch.quantile(latent, torch.tensor(
        [0.36, 0.85, 0.91, 0.92, 0.95, 0.98], device=dev))
    return bins, torch.bucketize(latent, cuts).to(torch.float32)


def _fit(model, bins, y, **kw):
    """(forest, eval_history, route launches, route levels) of one fit."""
    launches, levels = route_dense_kernel.launches, route_dense_kernel.levels
    forest = model.fit(bins, y, **kw)
    torch.cuda.synchronize()
    return (forest, list(model.eval_history),
            route_dense_kernel.launches - launches,
            route_dense_kernel.levels - levels)


def _assert_same_fit(got, want):
    assert set(got[0]) == set(want[0])
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    assert got[1] == want[1]


def test_higgs_fit_equals_the_plain_route(cuda, monkeypatch):
    rows, held = 2_000_000, 500_000
    bins, y = _higgs_like(cuda, rows + held)
    kw = dict(num_features=28, num_trees=6, max_depth=DEPTH, num_bins=256,
              device=cuda)
    ev = (bins[rows:], y[rows:])
    got = _fit(GBDT(**kw), bins[:rows], y[:rows], eval_set=ev)
    # each tree: 6 routed levels and one 6-level eval walk
    assert got[2:] == (6 * (DEPTH + 1), 6 * 2 * DEPTH)
    assert len(got[1]) == 6 and int(got[0]["trees_used"]) == 6
    monkeypatch.setattr(GBDT, "_route_dense", _plain_route)
    want = _fit(GBDT(**kw), bins[:rows], y[:rows], eval_set=ev)
    assert want[2:] == (0, 0)
    _assert_same_fit(got, want)
    assert (got[0]["threshold"] < 256).sum() > 6 * 40  # the trees split


def test_dense_eager_fit_routes_every_level_on_the_kernel(cuda):
    bins, y = _higgs_like(cuda, 300_000)
    model = GBDT(num_features=28, num_trees=5, max_depth=DEPTH,
                 num_bins=256, device=cuda)
    *_, launches, levels = _fit(model, bins, y)
    assert launches == levels == DEPTH * 5


def test_covertype_softmax_fit_equals_the_plain_route(cuda, monkeypatch):
    """Replayed rounds (the default) and eager rounds on the kernel, and
    eager rounds on the plain route: one forest, one held-out history."""
    train, held = 435_759, 145_253
    bins, y = _covertype_like(cuda, train + held)
    kw = dict(num_features=54, num_trees=4, max_depth=DEPTH, num_bins=256,
              objective="softmax", num_class=7, device=cuda)
    fit_kw = dict(eval_set=(bins[train:], y[train:]))
    x, yt = bins[:train], y[:train]
    eager = GBDT(**kw)
    eager._GRAPH_ROUNDS = False
    graphed = GBDT(**kw)
    want = _fit(eager, x, yt, **fit_kw)
    assert want[2:] == (4 * 7 * (DEPTH + 1), 4 * 7 * 2 * DEPTH)
    for _ in range(2):  # the first fit captures, the second replays all
        got = _fit(graphed, x, yt, **fit_kw)
        assert graphed._rounds is not None and graphed._rounds.graph
        _assert_same_fit(got, want)
        assert got[2:] == want[2:]
    monkeypatch.setattr(GBDT, "_route_dense", _plain_route)
    plain = GBDT(**kw)
    plain._GRAPH_ROUNDS = False
    _assert_same_fit(_fit(plain, x, yt, **fit_kw), want)
    assert len(set(int(c) for c in want[0]["feature"].flatten())) > 10
