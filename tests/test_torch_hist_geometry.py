"""The histogram kernels' layouts, launch geometries and in-launch scale,
on the CPU.

* A Covertype-like level (continuous columns beside 2-bin one-hot columns,
  every row of a node in one bin of them) goes through the JAX package's
  ``histogram_gh`` ("xla", and "pallas" in interpret mode) and the port's
  CPU path, within 1e-5 of the largest bin (the JAX package's own
  tolerance between its backends).
* Each feature's used bins (``dense_hist_layout``, ``used_bins``) against
  numpy.
* ``launch_geometry`` of both kernels at every shape ``chip_smoke.py``
  runs and at hypothesis-drawn shapes: within a Hopper block's shared
  memory, every (row, feature, node) or entry in exactly one block, and
  two blocks an SM wherever the work allows.
* A host model of the exponent both kernels compute inside their launch
  against ``fixed_point_scale``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from dmlc_core_tpu.ops.pallas_segment import histogram_gh as jax_histogram_gh
from dmlc_core_tpu_torch.ops import histogram as hg
from dmlc_core_tpu_torch.ops import histogram_sparse as hs
from dmlc_core_tpu_torch.ops.fixed_point import K_MAX, fixed_point_scale

SMS = 132
SMEM = 227 * 1024


# ---- a Covertype-like level --------------------------------------------------

def _covertype_level(rows=640, n=4, B=256, seed=0):
    """3 continuous columns (any of B codes), then 2 + 5 one-hot columns
    whose two codes sit where quantile cuts of a 0/1 column put them (242
    and 255 of 256); the rows of node 0 all hold category 0 of each
    one-hot group, so each of those columns puts the node in one bin."""
    rng = np.random.default_rng(seed)
    rel = rng.integers(0, n, rows).astype(np.int32)
    cont = rng.integers(0, B, (rows, 3))
    wild = np.where(rel == 0, 0, rng.integers(0, 2, rows))
    soil = np.where(rel == 0, 0, rng.integers(0, 5, rows))
    hot = np.concatenate([np.eye(2, dtype=np.int64)[wild],
                          np.eye(5, dtype=np.int64)[soil]], 1)
    bins = np.concatenate([cont, np.where(hot == 1, B - 1, B - 14)], 1)
    gh = np.stack([rng.standard_normal(rows), rng.uniform(0.05, 0.25, rows)],
                  1).astype(np.float32)
    return bins.astype(np.uint8), rel, gh, n, B


@pytest.mark.parametrize("jax_force", [None, "pallas"])
def test_covertype_level_matches_jax(jax_force):
    bins, rel, gh, n, B = _covertype_level()
    want = np.asarray(jax_histogram_gh(
        jnp.asarray(bins.astype(np.int32)), jnp.asarray(rel),
        jnp.asarray(gh), n, B, force=jax_force))
    tb, tr, tg = (torch.from_numpy(a) for a in (bins, rel, gh))
    layout = hg.dense_hist_layout(tb, B)
    assert list(layout.used[3:]) == [2] * 7
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    for force in (None, "pallas"):
        got = hg.histogram_gh(tb, tr, tg, n, B, force=force, layout=layout)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    # node 0 lands in one bin of every one-hot column: its whole mass in
    # the hot code of category 0's columns, in the cold code of the others
    mass = gh[rel == 0].astype(np.float64).sum(0)
    for f in (3, 5):
        np.testing.assert_allclose(want[0, f, B - 1], mass, rtol=1e-5)
        assert (want[0, f, :B - 1] == 0).all()
    for f in (4, 6, 7, 8, 9):
        np.testing.assert_allclose(want[0, f, B - 14], mass, rtol=1e-5)
        assert (np.delete(want[0, f], B - 14, axis=0) == 0).all()


# ---- used bins --------------------------------------------------------------

def _used_numpy(bins, B):
    present = np.zeros((bins.shape[1], B), bool)
    for f in range(bins.shape[1]):
        c = bins[:, f].astype(np.int64)
        present[f, np.unique(c[(c >= 0) & (c < B)])] = True
    return present


@pytest.mark.parametrize("rows,F,B,dtype", [(0, 3, 8, np.int32),
                                            (500, 6, 256, np.uint8),
                                            (3000, 4, 16, np.int32),
                                            (70_000, 2, 2, np.uint8)])
def test_dense_used_bins_match_numpy(rows, F, B, dtype, monkeypatch):
    """present / used / slot of ``dense_hist_layout`` against numpy, with
    codes out of range (past num_bins, negative) ignored and scan steps of
    a few rows (``_PRESENT_ELEMS``)."""
    monkeypatch.setattr(hg, "_PRESENT_ELEMS", 1000)
    rng = np.random.default_rng(rows + F)
    bins = rng.integers(0, B, (rows, F))
    if rows:
        bins[:, 0] = np.where(rng.random(rows) < 0.5, 1, B - 1) % B
        bins[::7, -1] = B  # past num_bins
        if dtype == np.int32:
            bins[::11, -1] = -3
    bins = bins.astype(dtype)
    layout = hg.dense_hist_layout(torch.from_numpy(bins), B)
    want = _used_numpy(bins, B)
    np.testing.assert_array_equal(layout.present, want)
    np.testing.assert_array_equal(layout.used, want.sum(1))
    slot = layout.slot.numpy().reshape(F, B)
    for f in range(F):
        np.testing.assert_array_equal(slot[f][want[f]],
                                      np.arange(want[f].sum()))
        assert (slot[f][~want[f]] == -1).all()


def test_sparse_used_bins_match_numpy():
    rng = np.random.default_rng(3)
    rows, F, B = 2000, 9, 64
    rid, fi = (a.astype(np.int64) for a in np.nonzero(
        rng.random((rows, F)) < 0.3))
    eb = rng.integers(1, B, rid.size)
    eb[fi == 2] = rng.integers(1, 3, (fi == 2).sum())  # two used bins
    keep = fi != 5                                     # no entries at all
    layout = hs.sparse_hist_layout(
        *(torch.from_numpy(a) for a in (rid[keep], fi[keep], eb[keep],
                                        np.ones(keep.sum(), bool))), F, B)
    want = [np.unique(eb[keep & (fi == f)]).size for f in range(F)]
    np.testing.assert_array_equal(layout.used_bins(), want)
    np.testing.assert_array_equal(layout.used_on_device().numpy(), want)


# ---- launch geometry ----------------------------------------------------------

# (rows, F, B, used bins a feature or None, node counts): chip_smoke's
# dense shapes: Higgs, Covertype (10 continuous, 44 one-hot), MSLR,
# gbdt_train --missing, the mesh phase's accumulate shares
DENSE_SHAPES = {
    "Higgs": (11_000_000, 28, 256, None, range(6)),
    "Covertype": (581_012, 54, 256, [256] * 10 + [2] * 44, range(6)),
    "MSLR": (723_412, 136, 256, None, range(6)),
    "--missing": (50_000, 32, 64, None, range(5)),
    "mesh 2-rank": (5_500_000, 28, 256, None, [5]),
    "mesh 4-rank chunk": (2_750_000, 7, 256, None, [5]),
}


def _check_dense(rows, F, B, n, used, geo):
    used = [B] * F if used is None else list(used)
    feats = sorted(f for g in geo["groups"] for f in g)
    assert feats == list(range(F))  # every feature in one group
    assert all(1 <= len(g) <= hg._WIDE_PAIRS for g in geo["groups"])
    for g in range(len(geo["groups"])):
        spans = sorted((n0, n1) for gi, n0, n1 in geo["items"] if gi == g)
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in
                   zip(spans, spans[1:] + [(n, n + 1)]))
    smem = 16 * max((n1 - n0) * sum(used[f] for f in geo["groups"][g])
                    for g, n0, n1 in geo["items"])
    assert geo["smem"] == smem <= SMEM
    # every row in exactly one chunk
    assert geo["n_chunks"] * geo["chunk"] >= rows
    assert (geo["n_chunks"] - 1) * geo["chunk"] < max(rows, 1)
    assert geo["blocks"] == geo["n_chunks"] * len(geo["items"])
    if rows:
        assert geo["blocks"] >= 2 * SMS or geo["chunk"] <= geo["min_chunk"]
    assert geo["min_chunk"] >= hg._MIN_CHUNK
    assert geo["min_chunk"] * 16 >= geo["smem"]
    assert 128 <= geo["threads"] <= 1024
    assert geo["threads"] <= max(128, geo["chunk"])


@pytest.mark.parametrize("name", sorted(DENSE_SHAPES))
def test_dense_geometry_at_chip_smoke_shapes(name):
    rows, F, B, used, depths = DENSE_SHAPES[name]
    for d in depths:
        geo = hg.launch_geometry(rows, F, B, 2 ** d, used)
        _check_dense(rows, F, B, 2 ** d, used, geo)
    if name == "Higgs":  # the geometry tuned at Higgs width stays
        deep = hg.launch_geometry(rows, F, B, 32)
        assert (deep["node_tile"], deep["feat_group"]) == (16, 3)
        assert deep["blocks"] >= hg._DEEP_BLOCKS
    if name == "Covertype":  # the one-hot columns: one tile at depth 5
        geo = hg.launch_geometry(rows, F, B, 32, used)
        few = [i for i in geo["items"] if geo["groups"][i[0]][0] >= 10]
        assert few and all((n0, n1) == (0, 32) for _, n0, n1 in few)


@settings(max_examples=200, deadline=None, database=None)
@given(rows=st.integers(0, 3_000_000), F=st.integers(1, 160),
       B=st.integers(1, 1024), depth=st.integers(0, 9),
       data=st.data())
def test_dense_geometry_drawn_shapes(rows, F, B, depth, data):
    used = data.draw(st.one_of(st.none(), st.lists(
        st.integers(0, B), min_size=F, max_size=F)))
    n = 2 ** depth
    geo = hg.launch_geometry(rows, F, B, n, used)
    _check_dense(rows, F, B, n, used, geo)


# (nnz, F, B, node counts, entries a feature): chip_smoke's sparse shapes:
# Bosch, the streamed and service cells and --native-sparse, --rank, the
# mesh accumulate shares
SPARSE_SHAPES = {
    "Bosch": (217_652_188, 968, 256, range(6)),
    "streamed": (48_194_263, 968, 256, range(6)),
    "--rank": (114_280, 32, 64, range(5)),
    "mesh 2-rank": (108_826_094, 968, 256, [5]),
    "mesh streamed 2-rank": (24_105_121, 968, 256, [5]),
}


def _check_sparse(counts, B, n, geo):
    nnz = int(sum(counts))
    starts = np.concatenate([[0], np.cumsum(counts)])
    n_spans, table = hs.span_table(starts, geo["span"])
    begin, end, feat, per = table.reshape(4, n_spans)
    covered = np.zeros(nnz, np.int64)
    for b, e in zip(begin, end):
        covered[b:e] += 1
    assert (covered == 1).all()  # every entry in exactly one span
    assert (np.bincount(feat, minlength=len(counts)) >= 1).all()
    assert (per == np.bincount(feat)[feat]).all()
    assert (end - begin <= geo["span"]).all()
    tiles = -(-n // geo["node_tile"])
    assert geo["smem"] == 16 * geo["node_tile"] * B <= SMEM
    assert tiles * geo["node_tile"] - n < tiles
    if nnz:
        assert (n_spans * tiles >= 2 * SMS
                or geo["span"] == geo["min_span"])
    assert geo["min_span"] >= max(hs._SPAN_FLOOR, geo["smem"] // 16)


@pytest.mark.parametrize("name", sorted(SPARSE_SHAPES))
def test_sparse_geometry_at_chip_smoke_shapes(name):
    nnz, F, B, depths = SPARSE_SHAPES[name]
    rng = np.random.default_rng(0)
    w = rng.uniform(0.5, 1.5, F)
    counts = np.floor(w / w.sum() * nnz).astype(np.int64)
    counts[0] += nnz - counts.sum()
    for d in depths:
        geo = hs.launch_geometry(nnz, F, B, 2 ** d)
        _check_sparse(counts, B, 2 ** d, geo)
    if name == "Bosch":  # the span it was tuned at stays
        assert hs.launch_geometry(nnz, F, B, 1)["span"] == -(-nnz // 1024)


@settings(max_examples=200, deadline=None, database=None)
@given(counts=st.lists(st.integers(0, 40_000), min_size=1, max_size=64),
       B=st.integers(1, 1024), depth=st.integers(0, 9))
def test_sparse_geometry_drawn_shapes(counts, B, depth):
    geo = hs.launch_geometry(sum(counts), len(counts), B, 2 ** depth)
    _check_sparse(np.array(counts, np.int64), B, 2 ** depth, geo)


# ---- the exponent the kernels compute inside their launch --------------------

def _exponent_model(amax: np.float32, n: int) -> float:
    """k = 62 - ceil(log2(amax * n)), clamped at K_MAX, as exact integer
    arithmetic on the double product: ``frexp`` gives a = m * 2^e with
    1/2 <= m < 1, so ceil(log2(a)) is e - 1 at a power of two, else e.
    Returns the f32 scale 2^k, NaN for a NaN or infinite product."""
    a = float(np.float64(amax) * np.float64(max(n, 1)))
    if math.isnan(a) or math.isinf(a):
        return float("nan")
    if a == 0.0:
        return float(np.float32(2.0 ** K_MAX))
    m, e = math.frexp(a)
    k = min(62 - (e - 1 if m == 0.5 else e), K_MAX)
    return float(np.float32(2.0 ** k))


def _amaxes():
    tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
    vals = [np.float32(0.0), tiny, tiny * np.float32(3),
            np.float32(2.0 ** -130), np.finfo(np.float32).tiny,
            np.finfo(np.float32).max, np.float32(np.nan),
            np.float32(np.inf)]
    for j in range(-30, 31, 3):
        p = np.float32(2.0 ** j)
        vals += [p, np.nextafter(p, np.float32(np.inf)),
                 np.nextafter(p, np.float32(0))]
    return vals


N_MAX = sorted({1, 2, 3, 5, 7, 1000, 581_012, 11_000_000, 2 ** 31 - 1,
                2 ** 31} | {2 ** k + d for k in (4, 10, 20, 30)
                            for d in (-1, 0, 1)})


@pytest.mark.parametrize("n", N_MAX)
def test_in_launch_exponent_model_equals_fixed_point_scale(n):
    """At powers of two, just above and below them, subnormals, 0, the
    largest f32, NaN and Inf, for n_max from 1 to 2^31: the exponent both
    kernels compute in double inside their launch (hist_fixed::scale_of)
    is ``fixed_point_scale`` bit for bit (NaN where not finite)."""
    amax = np.array(_amaxes(), np.float32)
    got = fixed_point_scale(torch.from_numpy(np.stack([amax, amax], 1))[:, 0],
                            n).numpy()
    want = np.array([_exponent_model(a, n) for a in amax], np.float32)
    np.testing.assert_array_equal(got, want)
