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
from dmlc_core_tpu_torch.ops import histogram_sparse as hs
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
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        sparse_hist_layout(*t, F, B, num_shards=2, rows=100)
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
    """Shared memory within a Hopper block's 227 KB, at least three warps'
    f64 histograms on an SM where one node fits that often, depths 0-4 at
    256 bins in one pass and depth 5 in two even tiles, every node in some
    tile, partials bounded."""
    geo = hs.launch_geometry(nnz, F, B, n)
    assert 1 <= geo["warps"] <= 4 and geo["smem"] <= 227 * 1024
    assert geo["smem"] == geo["warps"] * geo["node_tile"] * B * 16
    assert 1 <= geo["node_tile"] <= n
    if 3 * B * 16 <= 227 * 1024:
        assert geo["warps"] >= 3
    if B == 256 and n <= 32:
        assert geo["node_tile"] == (n if n <= 16 else 16)
    spans = nnz // geo["span"] + F
    assert spans * n * B * 8 <= max(1 << 29, F * n * B * 8)
    with pytest.raises(ValueError, match="shared memory"):
        hs.launch_geometry(100, 2, 40000, 1)


def test_span_table_cuts_features_into_spans():
    starts = np.array([0, 0, 5, 12, 12, 30])
    n_spans, table = hs.span_table(starts, 4)
    begin, end, feat, fs = (table[:n_spans], table[n_spans:2 * n_spans],
                            table[2 * n_spans:3 * n_spans],
                            table[3 * n_spans:])
    assert n_spans == 2 + 2 + 5
    np.testing.assert_array_equal(fs, [0, 0, 2, 4, 4, 9])
    for s in range(n_spans):
        f = feat[s]
        assert starts[f] <= begin[s] < end[s] <= starts[f + 1]
        assert end[s] - begin[s] <= 4
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
