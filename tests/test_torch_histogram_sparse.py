"""The port's sparse GBDT histogram (dmlc_core_tpu_torch.ops.histogram_sparse)
against the JAX package's ``histogram_gh_sparse``, on the same numpy inputs.

On the CPU the port's "pallas" backend runs the kernel's plain version over
the feature-sorted layout, and the JAX "pallas" backend runs its Pallas
kernel in interpret mode, as tests/test_pallas.py:291-364 runs it; both
packages' ``None`` backend is the flattened-key scatter-add.  Tolerance:
atol 4e-6, the JAX package's own between its two backends
(tests/test_pallas.py:310; f32 sums in another order).  The CUDA kernel
itself is held to the plain version on the card by tests/test_torch_cuda.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu.ops.pallas_segment import \
    histogram_gh_sparse as jax_histogram_gh_sparse
from dmlc_core_tpu.ops.pallas_segment import \
    sparse_hist_layout as jax_sparse_hist_layout
from dmlc_core_tpu_torch.ops import fixed_point
from dmlc_core_tpu_torch.ops import histogram_sparse as hs
from dmlc_core_tpu_torch.ops.fixed_point import fixed_point_scale, lane_amax
from dmlc_core_tpu_torch.ops.histogram_sparse import (histogram_gh_sparse,
                                                      sparse_hist_layout)

ATOL = 4e-6

# (rows, F, num_bins, n_nodes, nnz, masked): tests/test_pallas.py:297-303's
# geometries (one or several key tiles, non-pow-2 bins, nnz not a block
# multiple, nodes past 8), then masked garbage lanes and 32 nodes
CASES = [(100, 3, 8, 1, 500, 7), (200, 5, 16, 4, 2000, 7),
         (150, 6, 256, 2, 1500, 7), (120, 4, 33, 8, 1111, 7),
         (90, 2, 8, 16, 257, 7), (64, 3, 8, 2, 300, 50),
         (300, 7, 100, 32, 3000, 0)]


def _case(i):
    """Random COO entries whose trailing masked lanes carry garbage
    (tests/test_pallas.py:272's generator)."""
    rows, F, B, n, nnz, n_masked = CASES[i]
    rng = np.random.default_rng(31 + i)
    rid = rng.integers(0, rows, nnz).astype(np.int32)
    fi = rng.integers(0, F, nnz).astype(np.int32)
    eb = rng.integers(1, B, nnz).astype(np.int32)  # bin 0 reserved: missing
    em = np.ones(nnz, bool)
    if n_masked:
        em[-n_masked:] = False
        fi[-n_masked:] = rng.integers(0, 2 ** 20, n_masked)
        eb[-n_masked:] = rng.integers(0, 2 ** 20, n_masked)
    rel = rng.integers(0, n, rows).astype(np.int32)
    gh = rng.standard_normal((rows, 2)).astype(np.float32)
    return rid, fi, eb, em, rel, gh, n, F, B


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@functools.lru_cache(maxsize=None)
def _jax_refs(i):
    rid, fi, eb, em, rel, gh, n, F, B = _case(i)
    args = [jnp.asarray(a) for a in (rid, fi, eb, em, rel, gh)]
    return tuple(np.asarray(jax_histogram_gh_sparse(*args, n, F, B,
                                                    force=f))
                 for f in ("pallas", None))


@pytest.mark.parametrize("force", [None, "pallas"])
@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[str(c) for c in CASES])
def test_matches_jax_both_backends(i, force):
    rid, fi, eb, em, rel, gh, n, F, B = _case(i)
    got = histogram_gh_sparse(*_torch((rid, fi, eb, em, rel, gh)), n, F, B,
                              force=force)
    assert got.dtype == torch.float32
    for want in _jax_refs(i):
        assert tuple(got.shape) == want.shape == (n, F, B, 2)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("force", [None, "pallas"])
def test_masked_lanes_are_inert(force):
    """Masked entries with garbage keys and rows whose gh is not zero add
    nothing: the result equals the one over the live entries alone,
    bitwise."""
    rid, fi, eb, em, rel, gh, n, F, B = _case(5)
    got = histogram_gh_sparse(*_torch((rid, fi, eb, em, rel, gh)), n, F, B,
                              force=force)
    want = histogram_gh_sparse(*_torch((rid[em], fi[em], eb[em], em[em],
                                        rel, gh)), n, F, B, force=force)
    assert torch.equal(got, want)


@pytest.mark.parametrize("force", [None, "pallas"])
def test_bin0_stays_exactly_zero(force):
    rid, fi, eb, em, rel, gh, n, F, B = _case(1)
    got = histogram_gh_sparse(*_torch((rid, fi, eb, em, rel, gh)), n, F, B,
                              force=force)
    assert not got[:, :, 0, :].any()
    assert got.abs().sum() > 0  # and the live bins are not trivially zero


def test_layout_matches_jax_and_is_deterministic():
    """The layout is a pure function of the entry stream: rebuilt layouts
    are equal, its sorted keys and rows equal the JAX layout's live
    prefix, and permuted entries give allclose histograms."""
    rid, fi, eb, em, rel, gh, n, F, B = _case(3)
    t = _torch((rid, fi, eb, em))
    la, lb = sparse_hist_layout(*t, F, B), sparse_hist_layout(*t, F, B)
    for f in ("gkey", "rid", "starts"):
        assert torch.equal(getattr(la, f), getattr(lb, f)), f
    assert la.gkey.dtype == la.rid.dtype == torch.int32
    assert la.starts.device.type == "cpu" and int(la.starts[-1]) == em.sum()
    jl = jax_sparse_hist_layout(rid, fi, eb, em, F, B)
    assert la.nb == jl.nb and la.nnz_live == jl.nnz_live
    np.testing.assert_array_equal(la.gkey.numpy(),
                                  np.asarray(jl.gkey)[:jl.nnz_live])
    np.testing.assert_array_equal(la.rid.numpy(),
                                  np.asarray(jl.rid)[:jl.nnz_live])
    ha = histogram_gh_sparse(*t, *_torch((rel, gh)), n, F, B,
                             force="pallas", layout=la)
    perm = np.random.default_rng(0).permutation(len(rid))
    hb = histogram_gh_sparse(*_torch((rid[perm], fi[perm], eb[perm],
                                      em[perm], rel, gh)), n, F, B,
                             force="pallas")
    np.testing.assert_allclose(ha.numpy(), hb.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("bad", ["findex", "ebin"])
def test_validation_errors_match_jax(bad):
    rid, fi, eb, em, rel, gh, n, F, B = _case(0)
    if bad == "findex":
        fi = fi.copy()
        fi[0] = F
    else:
        eb = eb.copy()
        eb[0] = B
    msg = f"{bad} out of range for live entries"
    with pytest.raises(ValueError, match=msg):
        jax_sparse_hist_layout(rid, fi, eb, em, F, B)
    with pytest.raises(ValueError, match=msg):
        sparse_hist_layout(*_torch((rid, fi, eb, em)), F, B)
    with pytest.raises(ValueError, match="overflows int32"):
        sparse_hist_layout(*_torch((rid[:1], fi[:1] * 0, eb[:1] * 0,
                                    em[:1])), 2 ** 23, 256)


def test_layout_mismatch_and_sharding_refused():
    rid, fi, eb, em, rel, gh, n, F, B = _case(0)
    t = _torch((rid, fi, eb, em))
    # the sharded layout is ported (tests/test_torch_gbdt_mesh.py holds
    # it to the JAX package's); it keeps the JAX package's even-rows rule
    with pytest.raises(ValueError, match="rows divisible"):
        sparse_hist_layout(*t, F, B, num_shards=2, rows=101)
    layout = sparse_hist_layout(*t, F, B)
    with pytest.raises(ValueError, match="layout built for"):
        histogram_gh_sparse(*t, *_torch((rel, gh)), n, F, B + 1,
                            force="pallas", layout=layout)


def test_result_dtype_follows_gh():
    """The kernel route returns f32, cast back to gh's dtype, as the JAX
    front end does; k/8 values sum exactly, so the two backends agree bit
    for bit."""
    rid, fi, eb, em, rel, gh, n, F, B = _case(0)
    gh8 = torch.round(torch.from_numpy(gh) * 8) / 8
    t = _torch((rid, fi, eb, em, rel))
    got = histogram_gh_sparse(*t, gh8.to(torch.bfloat16), n, F, B,
                              force="pallas")
    want = histogram_gh_sparse(*t, gh8, n, F, B)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), want)


def test_kernel_wrapper_cpu_runs_plain_and_counts_nothing():
    rid, fi, eb, em, rel, gh, n, F, B = _case(1)
    layout = sparse_hist_layout(*_torch((rid, fi, eb, em)), F, B)
    rid_l = layout.rid.long()
    rel_e = torch.from_numpy(rel)[rid_l].contiguous()
    gh_e = torch.from_numpy(gh)[rid_l].contiguous()
    before = hs.histogram_gh_sparse_kernel.launches
    got = hs.histogram_gh_sparse_kernel(layout.gkey, rel_e, gh_e,
                                        layout.starts, n, F, B)
    assert hs.histogram_gh_sparse_kernel.launches == before
    assert torch.equal(got, hs.histogram_gh_sparse_plain(
        layout.gkey, rel_e, gh_e, layout.starts, n, F, B))


def test_kernel_wrapper_rejects_other_devices():
    gkey = torch.zeros(4, dtype=torch.int32, device="meta")
    gh = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        hs.histogram_gh_sparse_kernel(gkey, gkey, gh, torch.tensor([0, 4]),
                                      2, 1, 8)


@pytest.mark.parametrize("nnz,F,B,n", [(220_000_000, 968, 256, 1),
                                       (220_000_000, 968, 256, 32),
                                       (1_000_000, 968, 256, 512),
                                       (5000, 3, 2048, 3), (0, 4, 16, 2)])
def test_launch_geometry_fits_the_card(nnz, F, B, n):
    """One shared histogram of node_tile nodes a block, within a Hopper
    block's 227 KB; every node of the level in one tile while they fit
    (depths 0-5 at 256 bins take one pass over the entries), else even
    tiles; at Bosch width spans of at least ``_MIN_SPAN`` entries, about
    ``_TARGET_SPANS`` of them; fewer entries, about ``_SMALL_SPANS``
    spans of at least ``_SPAN_FLOOR``; a block's threads one a quad of
    its span, 128 to 1024."""
    geo = hs.launch_geometry(nnz, F, B, n)
    assert geo["smem"] <= 227 * 1024
    assert geo["smem"] == geo["node_tile"] * B * 16
    assert 1 <= geo["node_tile"] <= n
    tiles = -(-n // geo["node_tile"])
    if n * B * 16 <= 227 * 1024:
        assert tiles == 1
    assert tiles * geo["node_tile"] - n < tiles
    if B == 256 and n <= 32:
        assert geo["node_tile"] == n
    if nnz >= hs._SMALL_SPANS * hs._MIN_SPAN:
        assert geo["span"] >= hs._MIN_SPAN
    assert geo["span"] >= hs._SPAN_FLOOR
    assert nnz // geo["span"] <= max(hs._TARGET_SPANS, hs._SMALL_SPANS)
    assert 128 <= geo["threads"] <= 1024
    assert geo["threads"] <= max(128, geo["span"] / 4)
    with pytest.raises(ValueError, match="shared memory"):
        hs.launch_geometry(100, 2, 40000, 1)


def test_span_table_cuts_features_into_spans():
    """Spans of at most ``span`` entries, one empty span for a feature with
    none (the launch writes every feature's bins), and each span's
    feature's span count (its region's tickets)."""
    starts = np.array([0, 0, 5, 12, 12, 30])
    n_spans, table = hs.span_table(starts, 4)
    assert n_spans == 1 + 2 + 2 + 1 + 5 and table.shape == (4 * n_spans,)
    begin, end, feat, count = table.reshape(4, n_spans)
    np.testing.assert_array_equal(feat, [0, 1, 1, 2, 2, 3, 4, 4, 4, 4, 4])
    np.testing.assert_array_equal(count, [1, 2, 2, 2, 2, 1, 5, 5, 5, 5, 5])
    for s in range(n_spans):
        f = feat[s]
        assert starts[f] <= begin[s] <= end[s] <= starts[f + 1]
        assert end[s] - begin[s] <= 4
        assert (end[s] > begin[s]) == (starts[f + 1] > starts[f])
    # the spans tile every feature's entries in order
    np.testing.assert_array_equal(np.concatenate(
        [np.arange(b, e) for b, e in zip(begin, end)]), np.arange(30))


def test_layout_keeps_its_span_table():
    """A layout builds the span table for a span once and hands the same
    table to every later launch."""
    rid, fi, eb, em, rel, gh, n, F, B = _case(3)
    layout = sparse_hist_layout(*_torch((rid, fi, eb, em)), F, B)
    n_spans, table = layout.span_table(64)
    want_n, want = hs.span_table(layout.starts, 64)
    assert n_spans == want_n and table.device == layout.gkey.device
    np.testing.assert_array_equal(table.numpy(), want)
    assert layout.span_table(64)[1] is table
    assert layout.span_table(32)[0] > n_spans


@pytest.mark.parametrize("force", [None, "pallas"])
def test_pregathered_entry_gh_gives_the_same_histogram(force):
    """A tree gathers each entry's (grad, hess) once (``entry_gh``) and
    hands it to every level: the histogram is the one gathered inside,
    bitwise."""
    rid, fi, eb, em, rel, gh, n, F, B = _case(5)
    t = _torch((rid, fi, eb, em))
    rel_t, gh_t = _torch((rel, gh))
    layout = sparse_hist_layout(*t, F, B)
    gh_e = (hs.entry_gh(gh_t, layout=layout) if force == "pallas"
            else hs.entry_gh(gh_t, t[0].long(), t[3]))
    want = histogram_gh_sparse(*t, rel_t, gh_t, n, F, B, force=force,
                               layout=layout)
    got = histogram_gh_sparse(*t, rel_t, gh_t, n, F, B, force=force,
                              layout=layout, gh_e=gh_e)
    assert torch.equal(got, want)


# ---- the kernel's fixed-point numerics (csrc/hist_fixed.cuh) -----------------

def _bosch_like_level(rng, rows, F, n, nnz, tied):
    """Feature-sorted entries of a mostly-missing matrix: feature counts
    skewed, ``tied`` of each feature's entries in one bin (tied values),
    logistic (grad, hess) by row.  Returns (layout, rel_e, gh_e, gh)."""
    fi = np.minimum(rng.zipf(1.5, nnz) - 1, F - 1).astype(np.int32)
    eb = rng.integers(1, 256, nnz).astype(np.int32)
    eb[rng.random(nnz) < tied] = 7
    layout = sparse_hist_layout(*_torch((rng.integers(0, rows, nnz).astype(
        np.int32), fi, eb, np.ones(nnz, bool))), F, 256)
    p = 1 / (1 + np.exp(-rng.standard_normal(rows)))
    gh = np.stack([p - (rng.random(rows) < p), p * (1 - p)], 1).astype(
        np.float32)
    rel = rng.integers(0, n, rows).astype(np.int32)
    rid = layout.rid.numpy()
    return layout, rel[rid], gh[rid], gh


def _fixed_point_sparse(layout, rel_e, gh_e, n, F, scale):
    """The kernel's arithmetic in numpy: each entry's values quantised once
    (exact f32 product by a power of two, ``np.rint`` half to even like
    ``__float2ll_rn``), summed exactly in int64 by sorted key, each bin
    rounded once to f32; a lane with a non-finite scale, or with a value at
    or past ``value_limit`` of the most entries of one feature, is NaN."""
    s = scale.numpy()
    limit = fixed_point.value_limit(int(np.diff(layout.starts.numpy()).max()))
    with np.errstate(invalid="ignore", over="ignore"):
        qf = np.rint(gh_e * s).astype(np.float64)
        ok = (np.isfinite(s) & (s > 0)
              & (np.abs(qf) < float(limit)).all(0))
    q = np.where(ok, qf, 0).astype(np.int64)
    gk = layout.gkey.numpy().astype(np.int64)
    keys = (rel_e.astype(np.int64) * F + gk // layout.nb) * 256 + gk % layout.nb
    order = np.argsort(keys, kind="stable")
    ks, vs = keys[order], q[order]
    first = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    acc = np.zeros((n * F * 256, 2), np.int64)
    acc[ks[first]] = np.add.reduceat(vs, first, axis=0)
    out = (acc / np.where(ok, s, 1).astype(np.float64)).astype(np.float32)
    out[:, ~ok] = np.nan
    return out.reshape(n, F, 256, 2), keys


def _scale_of(layout, gh):
    n_max = int(np.diff(layout.starts.numpy()).max())
    return fixed_point_scale(lane_amax(torch.from_numpy(gh)), n_max), n_max


@pytest.mark.parametrize("n,tied", [(16, 0.9), (1, 0.0), (32, 0.5)])
def test_fixed_point_error_within_bound_of_float64(n, tied):
    """Bosch-like levels, scaled down (tied values pile into one bin):
    every bin within the header's bound (m * 2^-(k+1) for m entries, plus
    one f32 ulp of the result) of float64, and within 1e-5 of the
    largest bin.  The scale takes n_max = the most entries of one feature
    and amax over the rows' (grad, hess), as the fit's launches do."""
    rng = np.random.default_rng(21 + n)
    F = 40
    layout, rel_e, gh_e, gh = _bosch_like_level(rng, 30_000, F, n, 400_000,
                                                tied)
    scale, n_max = _scale_of(layout, gh)
    got, keys = _fixed_point_sparse(layout, rel_e, gh_e, n, F, scale)
    want = np.stack([np.bincount(keys, gh_e[:, lane].astype(np.float64),
                                 minlength=n * F * 256) for lane in (0, 1)],
                    1).reshape(n, F, 256, 2)
    m = np.bincount(keys, minlength=n * F * 256).reshape(n, F, 256, 1)
    assert m.max() <= n_max
    bound = m * fixed_point.error_bound(scale, 1).numpy() + np.spacing(
        np.abs(got))
    assert (np.abs(got - want) <= bound).all()
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
    assert not got[:, :, 0].any()  # a bin no entry names stays exactly 0


def test_fixed_point_sum_is_the_same_for_any_entry_order():
    """The kernel's blocks add in any order; the fixed-point sum of a
    permuted entry stream (same feature spans) is the same, bitwise."""
    rng = np.random.default_rng(22)
    F, n = 12, 8
    layout, rel_e, gh_e, gh = _bosch_like_level(rng, 5000, F, n, 60_000, 0.3)
    scale, _ = _scale_of(layout, gh)
    a, _ = _fixed_point_sparse(layout, rel_e, gh_e, n, F, scale)
    st = layout.starts.numpy()
    perm = np.concatenate([st[f] + rng.permutation(st[f + 1] - st[f])
                           for f in range(F)])
    shuffled = hs.SparseHistLayout(
        num_features=F, num_bins=256, nb=layout.nb, nnz_live=layout.nnz_live,
        gkey=layout.gkey[perm], rid=layout.rid[perm], starts=layout.starts)
    b, _ = _fixed_point_sparse(shuffled, rel_e[perm], gh_e[perm], n, F, scale)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("lane,bad", [(0, np.nan), (1, np.inf)])
def test_fixed_point_non_finite_lane_is_nan(lane, bad):
    """A NaN or Inf in one lane of the rows' (grad, hess) gives that lane a
    NaN scale and NaN in every bin; the other lane is untouched."""
    rng = np.random.default_rng(23)
    F, n = 6, 4
    layout, rel_e, gh_e, gh = _bosch_like_level(rng, 2000, F, n, 20_000, 0.2)
    clean, _ = _fixed_point_sparse(layout, rel_e, gh_e, n, F,
                                   _scale_of(layout, gh)[0])
    gh[layout.rid.numpy()[5], lane] = bad
    gh_e = gh[layout.rid.numpy()]
    scale, _ = _scale_of(layout, gh)
    assert np.isnan(scale[lane].item()) and np.isfinite(scale[1 - lane].item())
    got, _ = _fixed_point_sparse(layout, rel_e, gh_e, n, F, scale)
    assert np.isnan(got[..., lane]).all()
    assert np.array_equal(got[..., 1 - lane], clean[..., 1 - lane])
