"""On-card tests of the port's CUDA path (marker ``cuda``; each skips when
no CUDA device is present).  They import neither JAX nor the JAX package,
so on a machine with a card and no JAX they run without the suite's
conftest::

    python -m pytest --noconftest -m cuda -rP tests/test_torch_cuda.py

Each kernel (segment sum, dense and sparse histogram) is held to its plain
PyTorch version on the same inputs at
atol = rtol = 1e-5 (f32 sums in another order), and to itself bit for bit
from launch to launch.  All three kernels sum int64 fixed point, and their
sums are also held to its error bound against float64 (``-rP`` prints the measured
errors).
"""
import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch.models import GBDT, QuantileBinner
from dmlc_core_tpu_torch.ops import histogram as hg
from dmlc_core_tpu_torch.ops.fixed_point import (error_bound,
                                                 fixed_point_scale, lane_amax)
from dmlc_core_tpu_torch.ops import segment_sum as ss
from dmlc_core_tpu_torch.serving import (ScoringEngine, ScoringIterator,
                                         pack_snapshot)

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-5, atol=1e-5)

# (nnz, rows, lanes, sorted, id range)
CASES = {
    "sorted-1d": (1000, 64, None, True, (0, 64)),
    "served-16lanes": (16384, 256, 16, True, (0, 256)),
    "64lanes": (8192, 300, 64, True, (0, 300)),
    "ragged": (1001, 37, 5, True, (0, 37)),
    "unsorted-out-of-range": (3000, 100, 4, False, (-7, 113)),
    "one-entry": (1, 4, 3, True, (0, 4)),
    "empty": (0, 8, 2, True, (0, 8)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(name, device):
    nnz, rows, lanes, srt, (lo, hi) = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    rid = rng.integers(lo, hi, nnz).astype(np.int32)
    if srt:
        rid.sort()
    shape = (nnz,) if lanes is None else (nnz, lanes)
    c = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return (torch.from_numpy(c).to(device), torch.from_numpy(rid).to(device),
            rows)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_and_is_bitwise_stable(cuda, name):
    c, rid, rows = _case(name, cuda)
    before = ss.segment_sum_kernel.launches
    a = ss.segment_sum_kernel(c, rid, rows)
    b = ss.segment_sum_kernel(c, rid, rows)
    torch.cuda.synchronize()
    assert ss.segment_sum_kernel.launches == before + 2
    assert a.dtype == torch.float32 and a.device.type == "cuda"
    assert torch.equal(a, b)
    torch.testing.assert_close(a, ss.segment_sum_plain(c, rid, rows), **TOL)


def test_kernel_long_chunks_stay_within_rounding_of_float64(cuda):
    """A GBDT's leaf sums: millions of unsorted (grad, hess) rows into a few
    segments.  Each value is rounded once to int64 fixed point and summed
    exactly, so every output is within the fixed point's bound (m *
    2^-(k+1) for m values) plus one f32 rounding of the float64 sum, and
    within 1e-6 of the largest; a plain running f32 sum that long drifts
    ~1e-4."""
    rng = np.random.default_rng(8)
    n = 4_000_000
    rid = rng.integers(0, 4, n).astype(np.int32)
    gh = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(0.2, 0.25, n)],
                  1).astype(np.float32)
    got = ss.segment_sum_kernel(torch.from_numpy(gh).to(cuda),
                                torch.from_numpy(rid).to(cuda), 4)
    got = got.cpu().numpy()
    want = np.stack([np.bincount(rid, weights=gh[:, lane].astype(np.float64),
                                 minlength=4) for lane in (0, 1)], 1)
    err = np.abs(got - want)
    bound = _fixed_point_bound(gh, np.bincount(rid, minlength=4), n, got)
    print(f"leaf sums: max |kernel - float64| {err.max():.3e} = "
          f"{err.max() / np.abs(want).max():.3e} of the largest; worst "
          f"error / bound {(err / bound).max():.3f}")
    assert (err <= bound).all()
    assert err.max() <= 1e-6 * np.abs(want).max()


def test_kernel_large_output_unsorted_ids(cuda):
    """4096 rows x 16 lanes (65,536 outputs, past shared memory: the adds go
    straight to the global int64 buffer), unsorted ids with some out of
    range: against the plain version, and bitwise stable."""
    rng = np.random.default_rng(21)
    rid = rng.integers(-5, 4101, 160_000).astype(np.int32)
    c = (0.1 * rng.standard_normal((160_000, 16))).astype(np.float32)
    c, rid = torch.from_numpy(c).to(cuda), torch.from_numpy(rid).to(cuda)
    assert not ss.launch_geometry(160_000, 4096, 16)["shared"]
    a = ss.segment_sum_kernel(c, rid, 4096)
    b = ss.segment_sum_kernel(c, rid, 4096)
    assert torch.equal(a, b)
    torch.testing.assert_close(a, ss.segment_sum_plain(c, rid, 4096), **TOL)


def test_kernel_lanes_past_one_launch_match_plain(cuda):
    """More lanes than one launch takes (``_MAX_LANES``): the wrapper sums
    them in column chunks, one launch each, and each lane's scale is its
    own as in one launch."""
    rng = np.random.default_rng(23)
    lanes = ss._MAX_LANES + 5
    rid = rng.integers(0, 7, 300).astype(np.int32)
    c = (0.1 * rng.standard_normal((300, lanes))).astype(np.float32)
    c, rid = torch.from_numpy(c).to(cuda), torch.from_numpy(rid).to(cuda)
    before = ss.segment_sum_kernel.launches
    got, scale = ss.segment_sum_kernel(c, rid, 7, return_scale=True)
    assert ss.segment_sum_kernel.launches == before + 2
    torch.testing.assert_close(got, ss.segment_sum_plain(c, rid, 7), **TOL)
    assert torch.equal(scale, fixed_point_scale(lane_amax(c), 300))


def test_kernel_one_segment_of_many_entries(cuda):
    """A tree's root node total: 1.2M (grad, hess) rows into one segment,
    every entry on the same id (the run folds in registers): within the
    fixed point's bound of float64 and within TOL of the plain version."""
    rng = np.random.default_rng(22)
    n = 1_200_000
    gh = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(0.2, 0.25, n)],
                  1).astype(np.float32)
    g = torch.from_numpy(gh).to(cuda)
    rid = torch.zeros(n, dtype=torch.int32, device=cuda)
    got = ss.segment_sum_kernel(g, rid, 1)
    torch.testing.assert_close(got, ss.segment_sum_plain(g, rid, 1), **TOL)
    got = got.cpu().numpy()
    want = gh.astype(np.float64).sum(0)[None]
    err = np.abs(got - want)
    assert (err <= _fixed_point_bound(gh, np.array([n]), n, got)).all()


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_kernel_poisons_a_non_finite_lane(cuda, bad):
    """A NaN or Inf in one lane makes that lane NaN in every output; the
    other lanes are bitwise what they are without it."""
    c, rid, rows = _case("served-16lanes", cuda)
    clean = ss.segment_sum_kernel(c, rid, rows)
    dirty = c.clone()
    dirty[123, 5] = float(bad)
    got = ss.segment_sum_kernel(dirty, rid, rows)
    assert got[:, 5].isnan().all()
    keep = torch.arange(16, device=cuda) != 5
    assert torch.equal(got[:, keep], clean[:, keep])


@pytest.mark.parametrize("lanes", ["large, one sign", "large, cancelling"])
def test_kernel_values_near_the_value_limit_are_nan_or_exact(cuda, lanes):
    """Values at the top of the f32 range, all in one segment: every
    quantised value sits near the value limit's half, the int64 sums never
    wrap.  One sign: within f32 rounding of the float64 sum (or Inf where
    that sum passes f32); +v and -v in equal numbers: exactly 0."""
    n = 1 << 20
    gh = np.full((n, 2), 1.0e30, np.float32)
    gh[:, 1] = 3.0e38
    if lanes == "large, cancelling":
        gh[1::2] *= -1
    got = ss.segment_sum_kernel(torch.from_numpy(gh).to(cuda),
                                torch.zeros(n, dtype=torch.int32,
                                            device=cuda), 1).cpu().numpy()[0]
    want = gh.astype(np.float64).sum(0)
    assert not np.isnan(got).any()
    if lanes == "large, cancelling":
        assert (got == 0).all()
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=0)
        with np.errstate(over="ignore"):
            assert got[1] == np.float32(want[1])  # past f32: Inf, not wrapped


def test_kernel_is_bitwise_the_same_for_any_order(cuda):
    c, rid, rows = _case("unsorted-out-of-range", cuda)
    perm = torch.randperm(c.shape[0],
                          generator=torch.Generator().manual_seed(0)).to(cuda)
    a = ss.segment_sum_kernel(c, rid, rows)
    b = ss.segment_sum_kernel(c[perm].contiguous(), rid[perm].contiguous(),
                              rows)
    assert torch.equal(a, b)


@pytest.mark.parametrize("j", [-3, 0, 1, 7])
@pytest.mark.parametrize("nnz", [1, 4096, 1_183_747])
def test_kernel_scale_equals_fixed_point_scale(cuda, j, nnz):
    """The scale the kernel finds inside its launch is
    ``fixed_point_scale(lane_amax(c), nnz)`` bit for bit, at amax = 2^j
    (a power of two, where a rounded log2 is most likely to part them) and
    at amax just past it."""
    rng = np.random.default_rng(j + 10)
    c = rng.uniform(-1, 1, (nnz, 2)).astype(np.float32) * np.float32(2.0 ** j)
    c[0, 0] = 2.0 ** j
    c[-1, 1] = np.nextafter(np.float32(2.0 ** j), np.float32(np.inf))
    ct = torch.from_numpy(c).to(cuda)
    rid = torch.zeros(nnz, dtype=torch.int32, device=cuda)
    _, scale = ss.segment_sum_kernel(ct, rid, 3, return_scale=True)
    assert torch.equal(scale, fixed_point_scale(lane_amax(ct), nnz))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int32])
def test_front_end_casts_back_like_plain(cuda, dtype):
    """f32 accumulation cast back to contrib's dtype; k/8 values sum
    exactly, so kernel and plain agree bit for bit."""
    c, rid, rows = _case("unsorted-out-of-range", cuda)
    vals = torch.round(c * 80) / (8 if dtype == torch.bfloat16 else 1)
    got = ss.segment_sum(vals.to(dtype), rid, rows, force="pallas")
    want = ss.segment_sum_plain(vals.to(dtype), rid, rows)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_gradient_on_card_matches_cpu(cuda):
    c, rid, rows = _case("unsorted-out-of-range", cuda)
    g = torch.randn(rows, c.shape[1], generator=torch.Generator().manual_seed(0))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        x = c.detach().to(dev).requires_grad_()
        ss.segment_sum(x, rid.to(dev), rows, force="pallas").backward(
            g.to(dev))
        grads.append(x.grad.cpu())
    assert torch.equal(grads[0], grads[1])  # a gather: exact


def test_kernel_rejects_what_it_does_not_take(cuda):
    rid = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ss.segment_sum_kernel(torch.ones(4, dtype=torch.float64,
                                         device=cuda), rid, 2)
    with pytest.raises(TypeError):
        ss.segment_sum_kernel(torch.ones(4, device=cuda), rid.long(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        ss.segment_sum_kernel(torch.ones(2, 4, device=cuda).t(),
                              rid, 2)
    with pytest.raises(ValueError):
        ss.segment_sum_kernel(torch.ones(4, device=cuda), rid.cpu(), 2)
    with pytest.raises(ValueError):
        ss.segment_sum_kernel(torch.ones(5, device=cuda), rid, 2)


def _fm_snapshot(F=64, K=4, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal(F).astype(np.float32),
              "v": (0.3 * rng.standard_normal((F, K))).astype(np.float32),
              "b": np.float32(-0.1)}
    return pack_snapshot("fm", {"num_features": F, "num_factors": K,
                                "sdot_backend": "pallas"}, params)


def _requests(n, F=64, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, F, 1 + r % 7).tolist(),
             rng.random(1 + r % 7).astype(np.float32).tolist())
            for r in range(n)]


def test_engine_on_card_matches_cpu_and_launches_three_times(cuda):
    snap = _fm_snapshot()
    gpu = ScoringEngine.from_snapshot_bytes(snap, device=cuda)
    cpu = ScoringEngine.from_snapshot_bytes(snap, device="cpu")
    it_gpu, it_cpu = ScoringIterator(device=cuda), ScoringIterator(device="cpu")
    for n in (1, 9, 100):
        reqs = _requests(n, seed=n)
        before = ss.segment_sum_kernel.launches
        got = gpu.score(it_gpu.pack(reqs)[0])
        assert ss.segment_sum_kernel.launches == before + 3
        np.testing.assert_allclose(got, cpu.score(it_cpu.pack(reqs)[0]),
                                   rtol=2e-5, atol=2e-5)


def test_pinned_arena_reuse_keeps_earlier_batch_intact(cuda):
    """Two packs of one geometry back to back: the second waits for the
    first's copy, so the first device batch still holds its own rows."""
    it = ScoringIterator(device=cuda)
    a_reqs = [([1, 2], [1.0, 2.0]), ([3], [3.0])]
    b_reqs = [([4], [4.0]), ([5, 6], [5.0, 6.0])]
    a, _ = it.pack(a_reqs)
    b, _ = it.pack(b_reqs)
    assert len(it._arenas) == 1 and it._arenas[(2, 8)].buf.is_pinned()
    assert a.value.device.type == "cuda"
    np.testing.assert_array_equal(a.value.cpu().numpy()[:3], [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(b.value.cpu().numpy()[:3], [4.0, 5.0, 6.0])
    np.testing.assert_array_equal(a.row_ptr.cpu().numpy(), [0, 2, 3])


# ---- the histogram kernel ----------------------------------------------------

# (rows, F, num_bins, n_nodes): tests/test_pallas.py's shapes, then the
# node cap of GBDT's "auto" route, the widest bins of the op's surface, a
# Higgs-width level and an empty level
HIST_CASES = [(200, 3, 8, 1), (777, 5, 16, 4), (64, 2, 4, 8),
              (130, 2, 128, 8), (300, 3, 1024, 4), (120, 2, 2048, 2),
              (100, 5, 600, 3), (90, 4, 2, 2), (150, 9, 3, 5),
              (20000, 28, 256, 512), (5000, 3, 2048, 3),
              (100000, 28, 256, 32), (0, 4, 16, 2)]


def _hist_case(rows, F, B, n, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    bins = torch.from_numpy(rng.integers(0, B, (rows, F)).astype(np.int32))
    rel = torch.from_numpy(rng.integers(0, n, rows).astype(np.int32))
    gh = torch.from_numpy(rng.standard_normal((rows, 2)).astype(np.float32))
    return bins.to(dtype).to(device), rel.to(device), gh.to(device)


# int32 codes everywhere, uint8 codes (as GBDT stores them) up to 256 bins
HIST_KERNEL_CASES = ([(s, torch.int32) for s in HIST_CASES]
                     + [(s, torch.uint8) for s in HIST_CASES if s[2] <= 256])


@pytest.mark.parametrize("shape,dtype", HIST_KERNEL_CASES, ids=str)
def test_histogram_kernel_matches_plain_and_is_bitwise_stable(cuda, shape,
                                                              dtype):
    rows, F, B, n = shape
    bins, rel, gh = _hist_case(rows, F, B, n, dtype, cuda)
    before = hg.histogram_gh_kernel.launches
    a = hg.histogram_gh_kernel(bins, rel, gh, n, B)
    b = hg.histogram_gh_kernel(bins, rel, gh, n, B)
    torch.cuda.synchronize()
    assert hg.histogram_gh_kernel.launches == before + 2
    assert a.shape == (n, F, B, 2) and a.dtype == torch.float32
    assert torch.equal(a, b)
    torch.testing.assert_close(a, hg.histogram_gh_plain(bins, rel, gh, n, B),
                               **TOL)


def _fixed_point_bound(gh, counts, n_max, got):
    """The kernels' bound per bin (csrc/hist_fixed.cuh): m * 2^-(k+1) for
    the m values a bin sums, plus one f32 ulp of the result for its
    rounding; float64 numpy of the result's shape [..., 2]."""
    scale = fixed_point_scale(lane_amax(torch.from_numpy(gh)), n_max)
    return (counts[..., None] * error_bound(scale, 1).numpy()
            + np.spacing(np.abs(got).astype(np.float32)).astype(np.float64))


def test_histogram_kernel_heavy_bin_stays_within_rounding_of_float64(cuda):
    """Sparse data densified with NaN puts most rows in the missing bin 0: a
    bin summing millions of near-equal hessians.  Every bin stays within
    the fixed point's bound of float64, and within 1e-6 of the largest bin;
    an f32 chain that long drifted 2.8e-3 at Bosch width."""
    rng = np.random.default_rng(12)
    rows, F, B = 2_000_000, 4, 16
    bins = np.where(rng.random((rows, F)) < 0.9, 0,
                    rng.integers(1, B, (rows, F))).astype(np.uint8)
    gh = np.stack([rng.uniform(-0.5, 0.5, rows), rng.uniform(0.24, 0.25, rows)],
                  1).astype(np.float32)
    got = hg.histogram_gh_kernel(torch.from_numpy(bins).to(cuda),
                                 torch.zeros(rows, dtype=torch.int32,
                                             device=cuda),
                                 torch.from_numpy(gh).to(cuda), 1, B)
    got = got.cpu().numpy()
    want = np.stack([[np.stack([np.bincount(
        bins[:, f], weights=gh[:, lane].astype(np.float64), minlength=B)
        for lane in (0, 1)], 1) for f in range(F)]])
    counts = np.stack([[np.bincount(bins[:, f], minlength=B)
                        for f in range(F)]])
    bound = _fixed_point_bound(gh, counts, rows, got)
    err = np.abs(got - want)
    print(f"heavy bin: max |kernel - float64| {err.max():.3e} = "
          f"{err.max() / np.abs(want).max():.3e} of the largest bin; worst "
          f"error / bound {(err / bound).max():.3f}")
    assert (err <= bound).all()
    assert err.max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("lanes", ["large, one sign", "large, cancelling"])
def test_histogram_kernels_one_bin_of_large_values_does_not_overflow(cuda,
                                                                     lanes):
    """Every row in one bin with |g| ~ 1e30, the fixed point's worst case:
    the int64 sums do not wrap.  One sign: within f32 rounding of the exact
    sum; +v and -v in equal numbers: exactly 0, as integers cancel."""
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    rows = 1 << 22
    v = np.float32(1.0e30)
    gh = np.full((rows, 2), v, np.float32)
    gh[:, 1] = 3.0e30
    if lanes == "large, cancelling":
        gh[1::2] *= -1
    want = gh.astype(np.float64).sum(0)
    g = torch.from_numpy(gh).to(cuda)
    zeros = torch.zeros(rows, dtype=torch.int32, device=cuda)
    dense = hg.histogram_gh_kernel(torch.zeros(rows, 1, dtype=torch.uint8,
                                               device=cuda), zeros, g, 1, 4)
    sparse = hs.histogram_gh_sparse_kernel(zeros + 2, zeros, g,
                                           torch.tensor([0, rows]), 1, 1, 4)
    for got in (dense[0, 0, 0].cpu().numpy(), sparse[0, 0, 2].cpu().numpy()):
        assert np.isfinite(got).all()
        if lanes == "large, cancelling":
            assert (got == 0).all()
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_histogram_kernels_poison_a_non_finite_lane(cuda, bad):
    """A NaN or Inf in one lane makes that lane NaN in every bin of either
    kernel; the other lane is bitwise what it is without it."""
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    bins, rel, gh = _hist_case(5000, 4, 16, 4, torch.uint8, cuda, seed=3)
    clean = hg.histogram_gh_kernel(bins, rel, gh, 4, 16)
    bad_gh = gh.clone()
    bad_gh[17, 0] = float(bad)
    got = hg.histogram_gh_kernel(bins, rel, bad_gh, 4, 16)
    assert got[..., 0].isnan().all() and torch.equal(got[..., 1],
                                                     clean[..., 1])
    gkey, rel_e, gh_e, starts = _sparse_level(3000, 4, 16, 4, 20000, cuda,
                                              seed=3)
    clean = hs.histogram_gh_sparse_kernel(gkey, rel_e, gh_e, starts, 4, 4, 16)
    gh_e = gh_e.clone()
    gh_e[5, 1] = float(bad)
    got = hs.histogram_gh_sparse_kernel(gkey, rel_e, gh_e, starts, 4, 4, 16)
    assert got[..., 1].isnan().all() and torch.equal(got[..., 0],
                                                     clean[..., 0])


@pytest.mark.parametrize("under,poisoned", [(2.0 ** 20, True),
                                            (2.0, False)])
def test_sparse_kernel_understated_gh_amax_is_nan_or_exact(cuda, under,
                                                           poisoned):
    """A ``gh_amax`` below the grad lane's values: far below, a value could
    carry a bin past int64, and that lane is NaN everywhere; a little
    below (half), the scale is twice as fine and the sums stay exact,
    within the fixed
    point's bound of float64 (no wrap, no saturation).  The hess lane,
    bounded truly, is bitwise as with the true bound."""
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    gkey, rel_e, gh_e, starts = _sparse_level(3000, 4, 16, 4, 20000, cuda,
                                              seed=5)
    amax = lane_amax(gh_e)
    clean = hs.histogram_gh_sparse_kernel(gkey, rel_e, gh_e, starts, 4, 4, 16,
                                          gh_amax=amax)
    low = amax.clone()
    low[0] /= under
    got = hs.histogram_gh_sparse_kernel(gkey, rel_e, gh_e, starts, 4, 4, 16,
                                        gh_amax=low)
    assert torch.equal(got[..., 1], clean[..., 1])
    if poisoned:
        assert got[..., 0].isnan().all()
        return
    n_max = int((starts[1:] - starts[:-1]).max())
    scale = fixed_point_scale(low, n_max)
    assert float(scale[0]) > float(fixed_point_scale(amax, n_max)[0])
    gk = gkey.long()
    keys = ((rel_e.long() * 4 + gk // 16) * 16 + gk % 16).cpu().numpy()
    g = gh_e[:, 0].double().cpu().numpy()
    want = np.bincount(keys, g, minlength=4 * 4 * 16).reshape(4, 4, 16)
    m = np.bincount(keys, minlength=4 * 4 * 16).reshape(4, 4, 16)
    have = got[..., 0].cpu().numpy()
    bound = m * float(error_bound(scale, 1)[0]) + np.spacing(np.abs(have))
    assert (np.abs(have - want) <= bound).all()


def test_histogram_kernels_are_bitwise_the_same_for_any_order(cuda):
    """Integer sums do not depend on order: permuted rows (dense) and
    entries permuted within each feature (sparse) give bitwise the same
    histogram."""
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    bins, rel, gh = _hist_case(300_000, 28, 256, 32, torch.uint8, cuda,
                               seed=4)
    perm = torch.randperm(300_000, generator=torch.Generator().manual_seed(0))
    perm = perm.to(cuda)
    a = hg.histogram_gh_kernel(bins, rel, gh, 32, 256)
    b = hg.histogram_gh_kernel(bins[perm].contiguous(), rel[perm].contiguous(),
                               gh[perm].contiguous(), 32, 256)
    assert torch.equal(a, b)
    gkey, rel_e, gh_e, starts = _sparse_level(50_000, 40, 256, 32, 1_000_000,
                                              cuda, seed=4)
    rng = np.random.default_rng(0)
    st = starts.numpy()
    p = torch.from_numpy(np.concatenate([
        st[f] + rng.permutation(st[f + 1] - st[f]) for f in range(40)]))
    p = p.to(cuda)
    a = hs.histogram_gh_sparse_kernel(gkey, rel_e, gh_e, starts, 32, 40, 256)
    b = hs.histogram_gh_sparse_kernel(gkey[p].contiguous(),
                                      rel_e[p].contiguous(),
                                      gh_e[p].contiguous(), starts, 32, 40,
                                      256)
    assert torch.equal(a, b)


def test_histogram_kernel_drops_out_of_range_rows(cuda):
    bins, rel, gh = _hist_case(3000, 4, 16, 4, torch.int32, cuda, seed=5)
    rel[::7] = 9       # node ids past n_nodes
    rel[3::11] = -1
    bins[5::13, 1] = 16  # codes past num_bins
    got = hg.histogram_gh_kernel(bins, rel, gh, 4, 16)
    torch.testing.assert_close(got, hg.histogram_gh_plain(bins, rel, gh, 4,
                                                          16), **TOL)


def test_histogram_kernel_rejects_what_it_does_not_take(cuda):
    bins, rel, gh = _hist_case(64, 3, 8, 2, torch.uint8, cuda)
    with pytest.raises(TypeError):
        hg.histogram_gh_kernel(bins.long(), rel, gh, 2, 8)
    with pytest.raises(TypeError):
        hg.histogram_gh_kernel(bins, rel, gh.double(), 2, 8)
    with pytest.raises(ValueError, match="contiguous"):
        hg.histogram_gh_kernel(bins.t().contiguous().t(), rel, gh, 2, 8)
    with pytest.raises(ValueError):
        hg.histogram_gh_kernel(bins, rel.cpu(), gh, 2, 8)
    with pytest.raises(ValueError):
        hg.histogram_gh_kernel(bins, rel[:10], gh, 2, 8)


def test_gbdt_forest_on_kernel_equals_forest_on_plain(cuda):
    """The same fit on the card (histograms on the kernel, leaf sums on the
    segment-sum kernel) and on the CPU (their plain versions): equal splits,
    one histogram launch per level, bitwise the same forest twice on the
    card.  Leaves, gains and covers within atol = rtol = 1e-5: a leaf is
    -G/(H+lambda) over signed gradients that partly cancel, summed in
    another order on each device, tree after tree."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4000, 6)).astype(np.float32)
    y = (x[:, 0] * x[:, 1] + 0.5 * x[:, 2] > 0).astype(np.float32)
    kw = dict(num_features=6, num_trees=4, max_depth=4, num_bins=32,
              learning_rate=0.5, histogram="pallas")
    forests = []
    for dev in (cuda, cuda, torch.device("cpu")):
        bins = QuantileBinner(num_bins=32, device=dev).fit_transform(x)
        before = hg.histogram_gh_kernel.launches
        forests.append(GBDT(device=dev, **kw).fit(bins, y))
        launched = hg.histogram_gh_kernel.launches - before
        assert launched == (4 * 4 if dev.type == "cuda" else 0)
    for k in forests[0]:
        assert torch.equal(forests[0][k], forests[1][k]), k
    gpu, cpu = ({k: v.cpu() for k, v in f.items()} for f in forests[1:])
    for k in ("feature", "threshold", "default_right", "trees_used"):
        assert torch.equal(gpu[k], cpu[k]), k
    for k in ("leaf", "split_gain", "split_cover", "base"):
        torch.testing.assert_close(gpu[k], cpu[k], **TOL)


def _objective_case(objective):
    """A small softmax (7 skewed classes) or rank:pairwise (long-tailed
    query groups) fit's data, continuous columns only, big enough that no
    split is within rounding of another: the card's exact sums and the
    CPU's f32 sums part at near-ties (one-hot columns make exact ones, and
    chip_smoke's float64 audit holds the one-hot Covertype fit).  The
    softmax fit's splits hold under 1e-5 relative noise on every (grad,
    hess)."""
    rng = np.random.default_rng(12)
    if objective == "softmax":
        x = rng.standard_normal((8000, 6)).astype(np.float32)
        latent = x[:, 0] + 0.5 * np.sin(3 * x[:, 1]) + 0.3 * x[:, 2] * x[:, 3]
        y = np.searchsorted(np.quantile(latent, np.cumsum(
            [0.30, 0.25, 0.15, 0.10, 0.08, 0.07])), latent)
        return x, y.astype(np.float32), None, dict(
            objective="softmax", num_class=7, num_features=6)
    sizes = np.maximum(2, rng.lognormal(2.5, 0.8, 80).astype(np.int64))
    sizes[0] = 90
    qid = np.repeat(np.arange(sizes.size), sizes).astype(np.int32)
    x = rng.standard_normal((qid.size, 6)).astype(np.float32)
    latent = x[:, 0] - 0.5 * x[:, 1] + rng.normal(0, 0.3, qid.size)
    y = np.searchsorted(np.quantile(latent, [0.52, 0.84, 0.97, 0.99]),
                        latent).astype(np.float32)
    return x, y, qid, dict(objective="rank:pairwise", num_features=6)


@pytest.mark.parametrize("objective", ["softmax", "rank:pairwise"])
def test_objective_fit_on_card_matches_cpu(cuda, objective):
    """A softmax and a rank:pairwise fit on the card (histograms and leaf
    sums on the kernels) against the port on the CPU: one histogram launch
    a level of every tree and one leaf sum a tree; the same splits; the
    (grad, hess) within 1e-5 of the largest (softmax: the first round's;
    rank: the pairwise scan at the fitted margins, a harder input than the
    first round's constant one); leaves within 1e-4 of the largest (the
    CPU's f32 leaf sums drift); the card's forest scoring every row within
    2e-5 on both devices."""
    x, y, qid, kw = _objective_case(objective)
    kw = dict(kw, num_trees=3, max_depth=3, num_bins=32, learning_rate=0.5)
    K = kw.get("num_class", 1)
    fit_kw = {} if qid is None else {"qid": qid}
    out = {}
    for dev in (cuda, torch.device("cpu")):
        bins = QuantileBinner(num_bins=32, device=dev).fit_transform(x)
        model = GBDT(device=dev, **kw)
        h0, s0 = hg.histogram_gh_kernel.launches, ss.segment_sum_kernel.launches
        forest = model.fit(bins, y, **fit_kw)
        torch.cuda.synchronize()
        if dev.type == "cuda":
            assert hg.histogram_gh_kernel.launches - h0 == 3 * K * 3
            assert ss.segment_sum_kernel.launches - s0 == 3 * K
        label = torch.from_numpy(y).to(dev)
        if K > 1:
            margins = model.margins_multi(forest, bins)
            p = torch.softmax(forest["base"].expand(len(y), K), 1)
            onehot = torch.nn.functional.one_hot(label.long(), K)
            gh = torch.stack([p - onehot, torch.clamp(p * (1 - p),
                                                      min=1e-16)], -1)
        else:
            margins = model.margins(forest, bins)
            grad_hess, _ = model._rank_fns(qid, torch.ones_like(label))
            g, h = grad_hess(margins, label)
            gh = torch.stack([g, h], -1)
        out[dev.type] = (margins.cpu(), gh.cpu(), forest)
    (m_gpu, gh_gpu, f_gpu), (m_cpu, gh_cpu, f_cpu) = out["cuda"], out["cpu"]
    for k in ("feature", "threshold", "default_right"):
        assert torch.equal(f_gpu[k].cpu(), f_cpu[k]), k
    assert float((gh_gpu - gh_cpu).abs().max()) <= \
        1e-5 * float(gh_cpu.abs().max())
    # the CPU sums a leaf in one f32 index_add chain, ~1e-4 relative off
    # over thousands of near-equal hessians; the card sums it exactly
    leaf = f_cpu["leaf"]
    torch.testing.assert_close(f_gpu["leaf"].cpu(), leaf, rtol=0,
                               atol=1e-4 * float(leaf.abs().max()))
    # the card's forest scores every row alike on both devices
    carried = {k: v.cpu() for k, v in f_gpu.items()}
    cpu_model = GBDT(device="cpu", **kw)
    bins = QuantileBinner(num_bins=32, device="cpu").fit_transform(x)
    m_carried = (cpu_model.margins_multi(carried, bins) if K > 1
                 else cpu_model.margins(carried, bins))
    torch.testing.assert_close(m_gpu, m_carried, rtol=0, atol=2e-5)


def _fit_counted(model, bins, y, **kw):
    """(forest, eval_history, histogram launches, segment-sum launches) of
    one fit."""
    h0, s0 = hg.histogram_gh_kernel.launches, ss.segment_sum_kernel.launches
    forest = model.fit(bins, y, **kw)
    torch.cuda.synchronize()
    return (forest, list(model.eval_history),
            hg.histogram_gh_kernel.launches - h0,
            ss.segment_sum_kernel.launches - s0)


@pytest.mark.parametrize("weighted,stop", [(False, 0), (True, 2)])
def test_softmax_round_graph_replays_the_eager_forest(cuda, weighted, stop):
    """A dense softmax fit on the card replays one captured round: its
    forest, held-out losses and launch counts equal the eager rounds'
    bit for bit, on the first fit (which captures) and the next (which
    replays every round); codes changed in place are captured again."""
    rng = np.random.default_rng(19)
    x = rng.standard_normal((6000, 5)).astype(np.float32)
    x = np.concatenate([x, np.eye(4, dtype=np.float32)[
        rng.integers(0, 4, 6000)]], axis=1)
    latent = x[:, 0] + 0.5 * np.sin(3 * x[:, 1]) + x[:, 5] - x[:, 7]
    y = np.searchsorted(np.quantile(latent, np.cumsum(
        [0.30, 0.25, 0.15, 0.10, 0.08, 0.07])), latent).astype(np.float32)
    binner = QuantileBinner(num_bins=64, device=cuda).fit(x[:4000])
    bins, ev = binner.transform(x[:4500]), binner.transform(x[4500:])
    ev_set = (ev, y[4500:]) + ((rng.uniform(0.5, 2, 1500),) if weighted
                               else ())
    kw = dict(num_features=9, num_trees=6, max_depth=4, num_bins=64,
              objective="softmax", num_class=7, device=cuda)
    fit_kw = dict(eval_set=ev_set, early_stopping_rounds=stop)
    graphed, eager = GBDT(**kw), GBDT(**kw)
    eager._GRAPH_ROUNDS = False
    want = _fit_counted(eager, bins, y[:4500], **fit_kw)
    first = _fit_counted(graphed, bins, y[:4500], **fit_kw)
    captured = graphed._rounds
    again = _fit_counted(graphed, bins, y[:4500], **fit_kw)
    assert captured is not None and graphed._rounds is captured
    assert eager._rounds is None and len(want[1]) >= 3
    for got in (first, again):
        assert set(got[0]) == set(want[0])
        for k in want[0]:
            assert torch.equal(got[0][k], want[0][k]), k
        assert got[1:] == want[1:]
    bins.copy_(binner.transform(x[1500:6000]))  # new codes, same tensor
    want = _fit_counted(eager, bins, y[1500:6000], **fit_kw)
    got = _fit_counted(graphed, bins, y[1500:6000], **fit_kw)
    assert graphed._rounds is not captured
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    assert got[1:] == want[1:]


@pytest.mark.parametrize("histogram", ["pallas", "xla"])
def test_gbdt_leaf_sums_run_on_the_kernel_for_either_histogram(cuda,
                                                              histogram):
    """``histogram=`` picks only the level histogram: on the card every
    tree's leaf sums launch the segment-sum kernel once, and the histogram
    kernel launches once a level only on the "pallas" route."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3000, 5)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] * x[:, 2] > 0).astype(np.float32)
    bins = QuantileBinner(num_bins=16, device=cuda).fit_transform(x)
    seg0 = ss.segment_sum_kernel.launches
    hist0 = hg.histogram_gh_kernel.launches
    GBDT(num_features=5, num_trees=3, max_depth=3, num_bins=16, device=cuda,
         histogram=histogram).fit(bins, y)
    assert ss.segment_sum_kernel.launches - seg0 == 3
    assert (hg.histogram_gh_kernel.launches - hist0
            == (3 * 3 if histogram == "pallas" else 0))


# ---- the sparse histogram kernel ---------------------------------------------

# (rows, F, num_bins, n_nodes, nnz): tests/test_pallas.py:297-303's shapes,
# 32 nodes at 256 bins (one pass), the node cap of "auto", non-pow-2 bins,
# a Bosch-width level, an empty feature stream
SPARSE_CASES = [(100, 3, 8, 1, 500), (200, 5, 16, 4, 2000),
                (150, 6, 256, 2, 1500), (120, 4, 33, 8, 1111),
                (90, 2, 8, 16, 257), (5000, 50, 256, 32, 200_000),
                (2000, 20, 256, 512, 100_000), (3000, 9, 300, 5, 50_000),
                (100_000, 968, 256, 8, 2_000_000), (10, 3, 8, 2, 0)]


def _sparse_level(rows, F, B, n, nnz, device, seed=0):
    """A feature-sorted entry stream with skewed feature counts (the
    layout's arrays), and its level inputs on ``device``."""
    from dmlc_core_tpu_torch.ops.histogram_sparse import sparse_hist_layout
    rng = np.random.default_rng(seed)
    fi = np.minimum(rng.zipf(1.3, nnz) - 1, F - 1).astype(np.int32)
    layout = sparse_hist_layout(
        torch.from_numpy(rng.integers(0, rows, nnz).astype(np.int32)),
        torch.from_numpy(fi),
        torch.from_numpy(rng.integers(1, B, nnz).astype(np.int32)),
        torch.ones(nnz, dtype=torch.bool), F, B)
    rid = layout.rid.long()
    rel = torch.from_numpy(rng.integers(0, n, rows).astype(np.int32))
    gh = torch.from_numpy(rng.standard_normal((rows, 2)).astype(np.float32))
    return (layout.gkey.to(device), rel[rid].contiguous().to(device),
            gh[rid].contiguous().to(device), layout.starts)


@pytest.mark.parametrize("shape", SPARSE_CASES, ids=str)
def test_sparse_kernel_matches_plain_and_is_bitwise_stable(cuda, shape):
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    rows, F, B, n, nnz = shape
    gkey, rel_e, gh_e, starts = _sparse_level(rows, F, B, n, nnz, cuda)
    before = hs.histogram_gh_sparse_kernel.launches
    a = hs.histogram_gh_sparse_kernel(gkey, rel_e, gh_e, starts, n, F, B)
    b = hs.histogram_gh_sparse_kernel(gkey, rel_e, gh_e, starts, n, F, B)
    torch.cuda.synchronize()
    assert hs.histogram_gh_sparse_kernel.launches == before + (
        2 if nnz else 0)
    assert a.shape == (n, F, B, 2) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert not a[:, :, 0, :].any()  # bin 0: no entry names it
    torch.testing.assert_close(a, hs.histogram_gh_sparse_plain(
        gkey, rel_e, gh_e, starts, n, F, B), **TOL)


def test_sparse_kernel_tied_bin_stays_within_rounding_of_float64(cuda):
    """One feature whose values tie in one bin for 90% of its entries: a
    bin sums millions of near-equal hessians.  Every bin stays within the
    fixed point's bound of float64, and within 1e-6 of the largest bin."""
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    rng = np.random.default_rng(13)
    nnz, B = 4_000_000, 16
    ebin = np.where(rng.random(nnz) < 0.9, 5,
                    rng.integers(1, B, nnz)).astype(np.int32)
    gh = np.stack([rng.uniform(-0.5, 0.5, nnz), rng.uniform(0.24, 0.25, nnz)],
                  1).astype(np.float32)
    got = hs.histogram_gh_sparse_kernel(
        torch.from_numpy(ebin).to(cuda),
        torch.zeros(nnz, dtype=torch.int32, device=cuda),
        torch.from_numpy(gh).to(cuda), torch.tensor([0, nnz]), 1, 1, B)
    got = got.cpu().numpy()[0, 0]
    want = np.stack([np.bincount(ebin, weights=gh[:, lane].astype(
        np.float64), minlength=B) for lane in (0, 1)], 1)
    bound = _fixed_point_bound(gh, np.bincount(ebin, minlength=B), nnz, got)
    err = np.abs(got - want)
    print(f"tied bin: max |kernel - float64| {err.max():.3e} = "
          f"{err.max() / np.abs(want).max():.3e} of the largest bin; worst "
          f"error / bound {(err / bound).max():.3f}")
    assert (err <= bound).all()
    assert err.max() <= 1e-6 * np.abs(want).max()


def test_sparse_kernel_drops_out_of_range_entries(cuda):
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    gkey, rel_e, gh_e, starts = _sparse_level(3000, 4, 16, 4, 20000, cuda,
                                              seed=5)
    rel_e[::7] = 9     # node ids past n_nodes
    rel_e[3::11] = -1
    got = hs.histogram_gh_sparse_kernel(gkey, rel_e, gh_e, starts, 4, 4, 16)
    torch.testing.assert_close(got, hs.histogram_gh_sparse_plain(
        gkey, rel_e, gh_e, starts, 4, 4, 16), **TOL)


def test_sparse_kernel_rejects_what_it_does_not_take(cuda):
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    gkey, rel_e, gh_e, starts = _sparse_level(64, 3, 8, 2, 500, cuda)
    k = hs.histogram_gh_sparse_kernel
    with pytest.raises(TypeError):
        k(gkey.long(), rel_e, gh_e, starts, 2, 3, 8)
    with pytest.raises(TypeError):
        k(gkey, rel_e, gh_e.double(), starts, 2, 3, 8)
    with pytest.raises(ValueError, match="contiguous"):
        k(gkey, rel_e, torch.stack([gh_e[:, 0], gh_e[:, 1]], 1).t()
          .contiguous().t(), starts, 2, 3, 8)
    with pytest.raises(ValueError):
        k(gkey, rel_e.cpu(), gh_e, starts, 2, 3, 8)
    with pytest.raises(ValueError):
        k(gkey, rel_e[:10], gh_e, starts, 2, 3, 8)
    with pytest.raises(ValueError):
        k(gkey, rel_e, gh_e, starts.to(cuda), 2, 3, 8)
    with pytest.raises(ValueError):
        k(gkey, rel_e, gh_e, starts[:-1], 2, 3, 8)


def _sparse_batch(rows, F, device, seed=0):
    """A CSR batch whose Bernoulli label depends on the presence and the
    values of four features, so every split of a depth-3 tree has signal
    well above f32 rounding (deeper noise splits can tie)."""
    from dmlc_core_tpu_torch.data.staging import PaddedBatch
    rng = np.random.default_rng(seed)
    present = rng.random((rows, F)) < 0.5
    vals = rng.uniform(-2, 2, (rows, F)).astype(np.float32)
    vals[vals == 0] = 0.5
    r, f = np.nonzero(present)
    x = np.where(present, vals, 0.0)
    m = (1.5 * (~present[:, 0] | (x[:, 0] > 0.3)) - 1.0 * (x[:, 1] > -0.5)
         + 0.8 * x[:, 2] - 0.6 * (present[:, 3] & (x[:, 3] < 0.5)))
    y = (rng.random(rows) < 1 / (1 + np.exp(-2 * m))).astype(np.float32)
    row_ptr = np.concatenate([[0], np.cumsum(present.sum(1))])
    batch = PaddedBatch(
        label=torch.from_numpy(y).to(device),
        weight=torch.ones(rows, device=device),
        row_ptr=torch.from_numpy(row_ptr.astype(np.int32)).to(device),
        index=torch.from_numpy(f.astype(np.int32)).to(device),
        value=torch.from_numpy(vals[r, f]).to(device), num_rows=rows)
    return batch, f, vals[r, f], present


def _missing_at_nodes(forest, present, codes, depth):
    """[trees, 2**depth - 1] bool: some training row that reaches the node
    lacks the node's split feature.  ``codes``: [rows, F] bins (0 absent)."""
    feat = forest["feature"].numpy()
    thr = forest["threshold"].numpy()
    dflt = forest["default_right"].numpy()
    rows = np.arange(present.shape[0])
    out = np.zeros(feat.shape, bool)
    for t in range(feat.shape[0]):
        node = np.zeros(present.shape[0], np.int64)
        for _ in range(depth):
            f = feat[t, node]
            np.logical_or.at(out[t], node, ~present[rows, f])
            b = codes[rows, f]
            node = 2 * node + 1 + np.where(b == 0, dflt[t, node] == 1,
                                           b > thr[t, node])
    return out


def test_fit_batch_on_kernel_equals_fit_batch_on_plain(cuda):
    """fit_batch on the card (histograms on the sparse kernel, node totals
    and leaf sums on the segment-sum kernel) and on the CPU (their plain
    versions): equal splits, equal default directions where training rows
    are missing, one histogram launch a level, bitwise the same forest twice
    on the card.  Leaves, gains and covers within 2e-4 of each array's
    largest value: on the CPU the node totals and leaf sums are
    ``index_add``, one f32 chain over up to 20,000 near-equal hessians whose
    rounding errors line up (a leaf off by 3.4e-4 of itself, 5.8e-5 of 0.3,
    on the H100), while the card's segment-sum kernel sums exactly in
    fixed point."""
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    kw = dict(num_features=6, num_trees=3, max_depth=3, num_bins=32,
              learning_rate=0.5, missing_aware=True, histogram="pallas")
    forests = []
    for dev in (cuda, cuda, torch.device("cpu")):
        batch, idx, val, present = _sparse_batch(20000, 6, dev, seed=11)
        binner = QuantileBinner(num_bins=32, missing_aware=True,
                                device=dev).fit_sparse(idx, val, 6)
        before = hs.histogram_gh_sparse_kernel.launches
        forests.append(GBDT(device=dev, **kw).fit_batch(batch, binner))
        launched = hs.histogram_gh_sparse_kernel.launches - before
        assert launched == (3 * 3 if dev.type == "cuda" else 0)
    for k in forests[0]:
        assert torch.equal(forests[0][k], forests[1][k]), k
    gpu, cpu = ({k: v.cpu() for k, v in f.items()} for f in forests[1:])
    for k in ("feature", "threshold", "trees_used"):
        assert torch.equal(gpu[k], cpu[k]), k
    # the default direction wherever a training row is missing; at a node
    # with no missing mass the two directions tie exactly, and rounding
    # picks one (ROADMAP C: not a fault)
    codes = np.zeros(present.shape, np.int64)
    codes[np.nonzero(present)] = binner.transform_entries(
        batch.index, batch.value).numpy()
    miss = _missing_at_nodes(cpu, present, codes, 3)
    assert miss.sum() > 5
    np.testing.assert_array_equal(gpu["default_right"].numpy()[miss],
                                  cpu["default_right"].numpy()[miss])
    torch.testing.assert_close(gpu["base"], cpu["base"], **TOL)
    for k in ("leaf", "split_gain", "split_cover"):
        torch.testing.assert_close(gpu[k], cpu[k], rtol=2e-4,
                                   atol=2e-4 * float(cpu[k].abs().max()))


@pytest.mark.parametrize("histogram", ["auto", "pallas", "xla"])
def test_fit_batch_totals_and_leaves_run_on_the_segment_sum_kernel(
        cuda, histogram):
    """``histogram=`` picks only the level histogram: on the card every
    level's node totals and every tree's leaf sums launch the segment-sum
    kernel, and the sparse kernel launches once a level unless "xla"."""
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    batch, idx, val, _ = _sparse_batch(3000, 5, cuda, seed=4)
    binner = QuantileBinner(num_bins=16, missing_aware=True,
                            device=cuda).fit_sparse(idx, val, 5)
    seg0 = ss.segment_sum_kernel.launches
    hist0 = hs.histogram_gh_sparse_kernel.launches
    GBDT(num_features=5, num_trees=3, max_depth=3, num_bins=16,
         missing_aware=True, device=cuda,
         histogram=histogram).fit_batch(batch, binner)
    assert ss.segment_sum_kernel.launches - seg0 == 3 * (3 + 1)
    assert (hs.histogram_gh_sparse_kernel.launches - hist0
            == (0 if histogram == "xla" else 3 * 3))


def test_gbdt_engine_on_card_matches_cpu(cuda):
    """A gbdt snapshot served on the card scores like the CPU engine."""
    batch, idx, val, _ = _sparse_batch(2000, 8, torch.device("cpu"), seed=6)
    binner = QuantileBinner(num_bins=16, missing_aware=True,
                            device="cpu").fit_sparse(idx, val, 8)
    cfg = dict(num_features=8, num_trees=3, max_depth=3, num_bins=16,
               missing_aware=True)
    forest = GBDT(device="cpu", **cfg).fit_batch(batch, binner)
    snap = pack_snapshot("gbdt", cfg, forest, binner=binner)
    gpu = ScoringEngine.from_snapshot_bytes(snap, device=cuda)
    cpu = ScoringEngine.from_snapshot_bytes(snap, device="cpu")
    it_gpu, it_cpu = ScoringIterator(device=cuda), ScoringIterator(device="cpu")
    for n in (1, 9, 100):
        reqs = _requests(n, F=8, seed=n)
        np.testing.assert_allclose(gpu.score(it_gpu.pack(reqs)[0]),
                                   cpu.score(it_cpu.pack(reqs)[0]),
                                   rtol=2e-5, atol=2e-5)


# ---- staging a file onto the card, training, sampling ---------------------------

def _libsvm(tmp_path, rows=5000, F=1000, seed=0):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(rows):
        n = int(rng.integers(1, 40))
        idx = np.sort(rng.choice(F, n, replace=False))
        val = rng.standard_normal(n).astype(np.float32)
        lines.append(f"{int(rng.integers(0, 2))} " + " ".join(
            f"{i}:{v:.9g}" for i, v in zip(idx, val)))
    path = tmp_path / "stage.libsvm"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _host_packed(uri, batch_size, nnz_bucket):
    """The batches the CPU iterator packs (the same native batcher), as
    numpy."""
    from dmlc_core_tpu_torch.data import DeviceStagingIter
    return [{k: getattr(b, k).numpy().copy() for k in
             ("label", "weight", "row_ptr", "index", "value")}
            for b in DeviceStagingIter(uri, batch_size=batch_size,
                                       nnz_bucket=nnz_bucket, device="cpu")]


def test_staged_batches_survive_a_slow_consumer(cuda, tmp_path):
    """Every batch staged onto the card equals the host packing, bit for
    bit, while the consumer holds batches, launches work on them and
    sleeps: a pinned buffer written again before its copy left, or device
    memory handed out again early, would show as a changed batch."""
    from dmlc_core_tpu_torch.data import DeviceStagingIter
    uri = _libsvm(tmp_path)
    want = _host_packed(uri, 128, 1024)
    it = DeviceStagingIter(uri, batch_size=128, nnz_bucket=1024,
                           num_workers=2, prefetch_depth=2)
    held = []
    for i, b in enumerate(it):
        assert b.value.device.type == "cuda" and isinstance(b.num_rows, int)
        # work on the consumer's stream, then a slow host
        torch.cuda._sleep(2_000_000)
        held.append((b, (b.value * 2).sum()))
        if i % 3 == 0:
            import time
            time.sleep(0.02)
    assert len(held) == len(want) == 40
    for (b, _), w in zip(held, want):
        for k, v in w.items():
            np.testing.assert_array_equal(getattr(b, k).cpu().numpy(), v)
    assert all(buf is None or buf.is_pinned() for buf in it._ring.bufs)


def test_staging_iter_defaults_to_the_card(cuda, tmp_path):
    from dmlc_core_tpu_torch.data import DeviceStagingIter
    it = DeviceStagingIter(_libsvm(tmp_path, rows=300))
    assert it.device.type == "cuda"
    batches = list(it)
    assert all(b.index.device.type == "cuda" for b in batches)
    assert sum(b.num_rows for b in batches) == 300


def test_fm_train_step_on_card_matches_float64(cuda, tmp_path):
    """One FM step on the kernel route: 3 segment-sum launches, and its
    update (-learning_rate * grad, the gradient caught as it lands) within
    1e-5 of a float64 numpy oracle relative to its largest entry, applied
    to the params bit for bit.  (Measured as p1 - p0 it would also hold
    the f32 rounding of storing p1, half an ulp of |p|.)"""
    from dmlc_core_tpu_torch.data import DeviceStagingIter
    from dmlc_core_tpu_torch.models import (FactorizationMachine,
                                            params_from_numpy)
    F, K = 1000, 8
    rng = np.random.default_rng(5)
    p0 = {"w": (0.05 * rng.standard_normal(F)).astype(np.float32),
          "v": (0.05 * rng.standard_normal((F, K))).astype(np.float32),
          "b": np.float32(-0.2)}
    fm = FactorizationMachine(F, num_factors=K, sdot_backend="pallas",
                              learning_rate=0.05, device=cuda)
    fm.load_state_dict(params_from_numpy("fm", p0, cuda))
    batch = next(iter(DeviceStagingIter(_libsvm(tmp_path, rows=2000, F=F),
                                        batch_size=512, nnz_bucket=4096)))
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.detach().clone()))
        for n, p in fm.named_parameters()]
    before = ss.segment_sum_kernel.launches
    fm.train_step(batch)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    assert ss.segment_sum_kernel.launches - before == 3
    # float64 oracle: margins, weighted logistic mean, np.add.at grads
    h = {k: getattr(batch, k).cpu().numpy() for k in
         ("label", "weight", "row_ptr", "index", "value")}
    rid = np.searchsorted(h["row_ptr"], np.arange(h["index"].size),
                          side="right") - 1
    rid = np.minimum(rid, 511)
    x, idx = h["value"].astype(np.float64), h["index"]
    w, v, b = (p0["w"].astype(np.float64), p0["v"].astype(np.float64),
               float(p0["b"]))
    vx = np.zeros((512, K))
    np.add.at(vx, rid, v[idx] * x[:, None])
    v2x2 = np.zeros((512, K))
    np.add.at(v2x2, rid, v[idx] ** 2 * x[:, None] ** 2)
    lin = np.zeros(512)
    np.add.at(lin, rid, w[idx] * x)
    m = b + lin + 0.5 * (vx ** 2 - v2x2).sum(1)
    y = (h["label"] > 0.5).astype(np.float64)
    sw = max(h["weight"].sum(), 1.0)
    dm = (1 / (1 + np.exp(-m)) - y) * h["weight"] / sw
    gw = np.zeros(F)
    np.add.at(gw, idx, dm[rid] * x)
    gv = np.zeros((F, K))
    np.add.at(gv, idx, dm[rid][:, None] * (x[:, None] * vx[rid]
                                           - v[idx] * x[:, None] ** 2))
    want = {"w": -0.05 * gw, "v": -0.05 * gv, "b": -0.05 * dm.sum()}
    for k, d in want.items():
        step = 0.05 * grads[k]
        assert torch.equal(fm.state_dict()[k],
                           torch.as_tensor(p0[k], device=cuda) - step), k
        got = -step.double().cpu().numpy()
        err = np.abs(got - d).max() / max(np.abs(d).max(), 1e-30)
        print(f"train_step {k}: |update - float64| / max {err:.2e}")
        assert err <= 1e-5, k


def test_threefry_draws_on_card_equal_cpu(cuda):
    from dmlc_core_tpu_torch import random as tr
    for seed in (0, 2014, 2 ** 31 + 3):
        host = tr.fold_in(tr.PRNGKey(seed, device="cpu"), 7)
        card = tr.fold_in(tr.PRNGKey(seed, device=cuda), 7)
        assert card.device.type == "cuda"
        assert torch.equal(card.cpu(), host)
        for key in (host, card):
            assert torch.equal(tr.bits(key, (3, 1000), cuda).cpu(),
                               tr.bits(host, (3, 1000)))
            assert torch.equal(tr.bernoulli(key, 0.8, (5000,), cuda).cpu(),
                               tr.bernoulli(host, 0.8, (5000,)))
            u = tr.uniform(key, (999,), cuda).cpu()
            assert torch.equal(u.view(torch.int32),
                               tr.uniform(host, (999,)).view(torch.int32))
            for n in (28, 968, 2 ** 16):
                assert torch.equal(tr.permutation(key, n, cuda).cpu(),
                                   tr.permutation(host, n))


def test_sampled_forest_draws_on_card_equal_cpu(cuda):
    kw = dict(num_features=28, subsample=0.8, colsample_bytree=0.8,
              colsample_bylevel=0.8, seed=9)
    w = torch.rand(10_000, generator=torch.Generator().manual_seed(1))
    card, host = GBDT(device=cuda, **kw), GBDT(device="cpu", **kw)
    for t in range(5):
        cw, cm, ck = card._tree_keys(t, w.to(cuda))
        hw, hm, hk = host._tree_keys(t, w)
        assert torch.equal(cw.cpu(), hw) and torch.equal(cm.cpu(), hm)
        for d in range(6):
            assert torch.equal(card._level_feature_mask(cm, ck, d, None).cpu(),
                               host._level_feature_mask(hm, hk, d, None))


def _libffm(tmp_path, rows=2000, F=500, A=6, seed=0):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(rows):
        n = int(rng.integers(1, 12))
        idx = np.sort(rng.choice(F, n, replace=False))
        val = rng.uniform(0.1, 2.0, n).astype(np.float32)
        lines.append(f"{int(rng.integers(0, 2))} " + " ".join(
            f"{int(rng.integers(0, A))}:{i}:{v:.9g}"
            for i, v in zip(idx, val)))
    path = tmp_path / "stage.libffm"
    path.write_text("\n".join(lines) + "\n")
    return f"{path}?format=libfm"


def test_ffm_train_step_on_card_launches_once_and_matches_cpu(cuda,
                                                              tmp_path):
    """An FFM step on the kernel route: exactly 1 segment-sum launch (the
    linear term; the field-pair sums are index_add), the field lane staged
    onto the card equal to the CPU iterator's, and the step's params within
    1e-5 (of the largest |param|) of the same step on the CPU."""
    from dmlc_core_tpu_torch.data import DeviceStagingIter
    from dmlc_core_tpu_torch.models import (FieldAwareFactorizationMachine,
                                            params_from_numpy)
    F, A, K = 500, 6, 4
    uri = _libffm(tmp_path, F=F, A=A)
    kw = dict(batch_size=256, nnz_bucket=2048, with_field=True)
    dev_b = next(iter(DeviceStagingIter(uri, **kw)))
    cpu_b = next(iter(DeviceStagingIter(uri, device="cpu", **kw)))
    assert dev_b.field.device.type == "cuda"
    assert torch.equal(dev_b.field.cpu(), cpu_b.field)
    rng = np.random.default_rng(3)
    p0 = {"w": (0.1 * rng.standard_normal(F)).astype(np.float32),
          "v": (0.1 * rng.standard_normal((F, A, K))).astype(np.float32),
          "b": np.float32(0.1)}
    models = []
    for dev, batch in ((cuda, dev_b), ("cpu", cpu_b)):
        m = FieldAwareFactorizationMachine(F, A, num_factors=K, l2=1e-4,
                                           learning_rate=0.2,
                                           sdot_backend="pallas", device=dev)
        m.load_state_dict(params_from_numpy("ffm", p0, dev))
        before = ss.segment_sum_kernel.launches
        m.train_step(batch)
        torch.cuda.synchronize()
        if dev == cuda:
            assert ss.segment_sum_kernel.launches - before == 1
        models.append(m)
    for k, v in models[1].state_dict().items():
        tol = 1e-5 * float(v.abs().max())
        torch.testing.assert_close(models[0].state_dict()[k].cpu(), v,
                                   rtol=0, atol=tol)


def test_record_staging_on_card_equals_the_reader(cuda, tmp_path):
    """RecordStagingIter stages every record onto the card (payloads with
    the magic word included) equal to RecordIOReader's, through its pinned
    ring, with 1 and 3 workers, under a slow consumer."""
    import time

    from dmlc_core_tpu_torch.data import RecordStagingIter
    from dmlc_core_tpu_torch.io import RecordIOReader, RecordIOWriter
    rng = np.random.default_rng(4)
    magic = np.uint32(0xCED7230A).tobytes()
    path = str(tmp_path / "r.rec")
    with RecordIOWriter(path) as w:
        for i in range(700):
            p = rng.bytes(int(rng.integers(0, 3000)))
            w.write(magic + p + magic if i % 11 == 0 else p)
    with RecordIOReader(path) as r:
        want = list(r)
    for nw in (1, 3):
        it = RecordStagingIter(path, records_cap=32, bytes_cap=1 << 16,
                               num_workers=nw, prefetch_depth=2)
        got, held = [], []
        for b in it:
            assert b.bytes.device.type == "cuda"
            torch.cuda._sleep(1_000_000)
            held.append(b)
            time.sleep(0.002)
        for b in held:
            raw, offs = b.bytes.cpu().numpy(), b.offsets.cpu().numpy()
            got += [raw[offs[k]:offs[k + 1]].tobytes()
                    for k in range(b.num_records)]
        assert got == want, nw
        assert all(buf is None or buf.is_pinned() for buf in it._ring.bufs)


def test_streamed_forest_on_card_equals_fit_batch(cuda, tmp_path):
    """fit_streamed from the binned epoch cache on the card: the cache
    batches equal the CPU's, the fit launches the sparse kernel once a
    level and the segment sum 4 times a tree (3 node totals, 1 leaf sum),
    and its forest equals fit_batch's on the same rows resident, bit for
    bit (exact fixed-point sums over the same layout)."""
    from dmlc_core_tpu_torch.data import BinnedStagingIter
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    rows, F = 6000, 30
    batch, f, vals, _ = _sparse_batch(rows, F, cuda, seed=9)
    rp = batch.row_ptr.cpu().numpy()
    lab = batch.label.cpu().numpy()
    path = tmp_path / "s.libsvm"
    path.write_text("\n".join(
        f"{int(lab[r])} " + " ".join(f"{i}:{v:.9g}" for i, v in zip(
            f[rp[r]:rp[r + 1]], vals[rp[r]:rp[r + 1]]))
        for r in range(rows)) + "\n")
    binner = QuantileBinner(num_bins=32, missing_aware=True,
                            device=cuda).fit_sparse(f, vals, F)
    kw = dict(batch_size=1000, nnz_bucket=4096, cache=str(tmp_path / "c"))
    it = BinnedStagingIter(str(path), binner, **kw)
    cpu_it = BinnedStagingIter(str(path), QuantileBinner.from_cuts(
        binner.cuts.cpu(), 32, missing_aware=True, device="cpu"),
        device="cpu", **kw)
    for a, b in zip(it, cpu_it):
        for k in ("label", "row_ptr", "index", "ebin", "emask"):
            assert torch.equal(getattr(a, k).cpu(), getattr(b, k)), k
    model = GBDT(num_features=F, num_trees=4, max_depth=3, num_bins=32,
                 missing_aware=True, device=cuda)
    h0, s0 = hs.histogram_gh_sparse_kernel.launches, \
        ss.segment_sum_kernel.launches
    streamed = model.fit_streamed(lambda: iter(it), binner)
    torch.cuda.synchronize()
    assert hs.histogram_gh_sparse_kernel.launches - h0 == 4 * 3
    assert ss.segment_sum_kernel.launches - s0 == 4 * 4
    resident = model.fit_batch(batch, binner)
    for k in resident:
        assert torch.equal(streamed[k], resident[k]), k


def _service_fixture(cuda, tmp_path, rows=6000, F=30):
    """The sparse rows as libsvm, the port's aggregator and one staging
    worker on the card; returns (uri, aggregator, worker)."""
    from dmlc_core_tpu_torch.dataservice import StagingWorker
    from dmlc_core_tpu_torch.tracker import metrics as tm
    batch, f, vals, _ = _sparse_batch(rows, F, cuda, seed=9)
    rp = batch.row_ptr.cpu().numpy()
    lab = batch.label.cpu().numpy()
    path = tmp_path / "s.libsvm"
    path.write_text("\n".join(
        f"{int(lab[r])} " + " ".join(f"{i}:{v:.9g}" for i, v in zip(
            f[rp[r]:rp[r + 1]], vals[rp[r]:rp[r + 1]]))
        for r in range(rows)) + "\n")
    agg = tm.MetricsAggregator()
    worker = StagingWorker(metrics_port=agg.port, tracker_uri="127.0.0.1",
                           cache_dir=str(tmp_path / "cache"))
    return str(path), agg, worker


def _service_iter(uri, agg, binner, **kw):
    from dmlc_core_tpu_torch.dataservice import DataServiceIter
    from dmlc_core_tpu_torch.tracker import metrics as tm
    return DataServiceIter(uri, binner, batch_size=1000, nnz_bucket=4096,
                           shard_client=tm.ShardClient("127.0.0.1", agg.port,
                                                       rank=0), **kw)


def test_service_on_card_equals_a_local_hit(cuda, tmp_path):
    """A staging worker and a client on the card: every BinnedBatch of two
    epochs equals, leaf by leaf on the card, the batch a local
    BinnedStagingIter yields over the worker's cache file (a hit)."""
    from dmlc_core_tpu_torch import telemetry
    from dmlc_core_tpu_torch.data import BinnedStagingIter
    from dmlc_core_tpu_torch.dataservice.server import spec_key
    uri, agg, worker = _service_fixture(cuda, tmp_path)
    try:
        binner = QuantileBinner(num_bins=32, missing_aware=True)
        ds = _service_iter(uri, agg, binner)
        first, second = list(ds), list(ds)
        cache = tmp_path / "cache" / (spec_key(ds.spec) + ".bincache")
        rebuilds = telemetry.counter_get("cache.rebuilds")
        local = list(BinnedStagingIter(
            uri, QuantileBinner(num_bins=32, missing_aware=True),
            cache=str(cache), batch_size=1000, nnz_bucket=4096))
        assert telemetry.counter_get("cache.rebuilds") == rebuilds
    finally:
        worker.close()
        agg.close()
    assert binner.cuts.device.type == "cuda"
    for epoch in (first, second):
        assert len(epoch) == len(local) > 1
        for a, b in zip(epoch, local):
            assert a.num_rows == b.num_rows
            assert a.cuts_digest == b.cuts_digest
            for k in ("label", "weight", "row_ptr", "index", "ebin",
                      "emask"):
                assert getattr(a, k).device.type == "cuda"
                assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_fit_over_the_service_launches_the_kernels(cuda, tmp_path):
    """fit_streamed over the data service on the card: 6 sparse-histogram
    and 7 segment-sum launches a depth-6 tree (6 node totals, 1 leaf sum),
    no dense histogram, and the forest of a fit over one local epoch bit
    for bit."""
    from dmlc_core_tpu_torch.data import BinnedStagingIter
    from dmlc_core_tpu_torch.dataservice.server import spec_key
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    uri, agg, worker = _service_fixture(cuda, tmp_path)
    trees, depth = 3, 6
    try:
        binner = QuantileBinner(num_bins=32, missing_aware=True)
        ds = _service_iter(uri, agg, binner)
        model = GBDT(num_features=30, num_trees=trees, max_depth=depth,
                     num_bins=32, missing_aware=True)
        h0, s0, d0 = (hs.histogram_gh_sparse_kernel.launches,
                      ss.segment_sum_kernel.launches,
                      hg.histogram_gh_kernel.launches)
        served = model.fit_streamed(lambda: iter(ds), binner)
        torch.cuda.synchronize()
        launches = (hs.histogram_gh_sparse_kernel.launches - h0,
                    ss.segment_sum_kernel.launches - s0,
                    hg.histogram_gh_kernel.launches - d0)
        cache = tmp_path / "cache" / (spec_key(ds.spec) + ".bincache")
        local = list(BinnedStagingIter(uri, binner, cache=str(cache),
                                       batch_size=1000, nnz_bucket=4096))
    finally:
        worker.close()
        agg.close()
    assert launches == (trees * depth, trees * (depth + 1), 0)
    want = model.fit_streamed(local, binner)
    for k in want:
        assert torch.equal(served[k], want[k]), k


def test_two_rank_fit_over_the_service_on_card(cuda, tmp_path):
    """Two gloo ranks on the card, each a ``DataServiceIter(sharding=plan)``
    over its share of the worker's parts into ``fit_streamed(histogram=
    "pallas", histogram_mesh=plan)``: every rank launches 6 sparse
    histograms and 7 segment sums a tree (and 1 for the base margin), and
    its forest is the one-process kernel fit's over the service bit for
    bit."""
    from torch_ranks import run_ranks
    uri, agg, worker = _service_fixture(cuda, tmp_path)
    trees, depth = 2, 6
    kw = dict(num_features=30, num_trees=trees, max_depth=depth,
              num_bins=32, missing_aware=True)
    try:
        binner = QuantileBinner(num_bins=32, missing_aware=True)
        ds = _service_iter(uri, agg, binner)
        one = GBDT(histogram="pallas", **kw).fit_streamed(lambda: iter(ds),
                                                          binner)
        res = run_ranks(2, "dataservice_forest", tmp_path, timeout=300,
                        uri=uri, port=agg.port, nnz_max=1000 * 30,
                        geom=dict(batch_size=1000, nnz_bucket=4096), kw=kw,
                        device="cuda")
    finally:
        worker.close()
        agg.close()
    for r in res:
        assert r["epochs"] == 1 + trees * depth
        assert r["launches"] == [trees * depth, trees * (depth + 1) + 1, 0]
        for k, v in one.items():
            np.testing.assert_array_equal(r["forest"][k], v.cpu().numpy(),
                                          err_msg=k)


def test_resource_sample_publishes_the_card_memory(cuda):
    """resource.hbm_bytes_in_use is torch.cuda.memory_allocated at the
    call, resource.hbm_bytes_limit the card's total memory."""
    from dmlc_core_tpu_torch import telemetry
    keep = torch.empty(1 << 20, device=cuda)
    got = telemetry.resource_sample()
    assert got == {
        "resource.hbm_bytes_in_use": torch.cuda.memory_allocated(cuda),
        "resource.hbm_bytes_limit": torch.cuda.mem_get_info(cuda)[1]}
    assert got["resource.hbm_bytes_in_use"] >= keep.numel() * 4
    gauges = telemetry.snapshot()["gauges"]
    for name, value in got.items():
        assert gauges[name] == value


def test_autotuned_epochs_on_card_equal_an_untuned_epoch(cuda, tmp_path,
                                                         monkeypatch):
    """The tuner moves the native pool's knobs every 2 batches (its noise
    floors off); every batch on the card equals an untuned epoch's."""
    from dmlc_core_tpu_torch import autotune
    from dmlc_core_tpu_torch.data import DeviceStagingIter
    monkeypatch.setattr(autotune, "_MIN_WINDOW_BYTES", 0)
    monkeypatch.setattr(autotune, "_MIN_WINDOW_WALL_S", 0.0)
    monkeypatch.setenv("DMLCTPU_AUTOTUNE_WINDOW", "2")
    uri = _libsvm(tmp_path)
    kw = dict(batch_size=128, nnz_bucket=1024, buffer_mb=1)
    want = [{k: getattr(b, k).cpu() for k in ("label", "row_ptr", "index",
                                               "value")}
            for b in DeviceStagingIter(uri, autotune=False, **kw)]
    it = DeviceStagingIter(uri, autotune=True, **kw)
    for _ in range(2):
        got = list(it)
        assert len(got) == len(want)
        for b, w in zip(got, want):
            assert b.value.device.type == "cuda"
            for k, v in w.items():
                assert torch.equal(getattr(b, k).cpu(), v), k
    assert it._tuner.steps > 0


def test_init_from_env_with_one_worker_is_a_no_op_on_the_card(
        cuda, monkeypatch):
    import torch.distributed as dist

    from dmlc_core_tpu_torch import parallel
    for k in ("DMLC_TASK_ID", "DMLC_TRACKER_URI", "DMLC_TRACKER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    info = parallel.init_from_env()  # the default device: the card
    assert info.num_workers == 1 and info.task_id == 0
    assert not dist.is_initialized()


# ---- the accumulate / dequantize pair (the multi-process route) -------------
#
# Each kernel's two halves against their plain versions, bit for bit: the
# int64 accumulator (sums and overflow marks) and the dequantized f32, at a
# scale made for more rows than the launch sees (as a process's share of a
# sharded fit does); and the one-process kernel equals accumulate +
# dequantize at its own scale.

from dmlc_core_tpu_torch.ops import histogram_sparse as hs  # noqa: E402
from dmlc_core_tpu_torch.ops.fixed_point import (  # noqa: E402
    fixed_point_scale as _fps, lane_amax as _amax, value_limit as _vlim)


@pytest.mark.parametrize("rows,F,B,n", [(5000, 7, 64, 4), (20000, 28, 256, 32),
                                        (0, 3, 8, 2)])
def test_histogram_accumulate_and_dequantize_match_plain(cuda, rows, F, B, n):
    bins, rel, gh = _hist_case(rows, F, B, n, torch.uint8, cuda, seed=3)
    scale = _fps(_amax(gh) * 1.5, 4 * max(rows, 1))
    qmax = _vlim(4 * max(rows, 1))
    before = hg.histogram_gh_kernel.launches
    acc = hg.histogram_gh_accumulate(bins, rel, gh, n, B, scale, qmax)
    torch.cuda.synchronize()
    assert hg.histogram_gh_kernel.launches == before + (1 if rows else 0)
    want = hg.histogram_gh_accumulate_plain(bins.cpu(), rel.cpu(), gh.cpu(),
                                            n, B, scale.cpu(), qmax)
    assert torch.equal(acc.cpu(), want)
    out = hg.histogram_gh_dequantize(acc, scale, (n, F, B, 2))
    assert torch.equal(out.cpu(), hg.histogram_gh_dequantize(
        want, scale.cpu(), (n, F, B, 2)))
    own = _fps(_amax(gh), rows)
    one = hg.histogram_gh_dequantize(hg.histogram_gh_accumulate(
        bins, rel, gh, n, B, own, _vlim(rows)), own, (n, F, B, 2))
    assert torch.equal(one, hg.histogram_gh_kernel(bins, rel, gh, n, B))


def test_sparse_accumulate_and_dequantize_match_plain(cuda):
    rng = np.random.default_rng(4)
    rows, F, B, n = 3000, 40, 256, 8
    present = rng.random((rows, F)) < 0.2
    rid, fi = (a.astype(np.int64) for a in np.nonzero(present))
    eb = rng.integers(1, B, rid.size)
    em = np.ones(rid.size, bool)
    layout = hs.sparse_hist_layout(*(torch.from_numpy(a).to(cuda)
                                     for a in (rid, fi, eb, em)), F, B)
    gh = torch.from_numpy(rng.standard_normal((rows, 2)).astype(
        np.float32)).to(cuda)
    rel = torch.from_numpy(rng.integers(0, n, rows).astype(np.int32)).to(
        cuda)
    gh_e = hs.entry_gh(gh, layout=layout)
    rel_e = rel[layout.rid].contiguous()
    n_max = int(hs.feature_counts(layout).max())
    scale, qmax = _fps(_amax(gh), 3 * n_max), _vlim(3 * n_max)
    acc = hs.histogram_gh_sparse_accumulate(layout, rel_e, gh_e, n, scale,
                                            qmax)
    want = hs.histogram_gh_sparse_accumulate_plain(
        layout.gkey.cpu(), rel_e.cpu(), gh_e.cpu(), layout.starts, n, F, B,
        scale.cpu(), qmax)
    assert torch.equal(acc.cpu(), want)
    out = hs.histogram_gh_sparse_dequantize(acc, scale, (n, F, B, 2))
    assert torch.equal(out.cpu(), hs.histogram_gh_sparse_dequantize(
        want, scale.cpu(), (n, F, B, 2)))
    own = _fps(_amax(gh), n_max)
    one = hs.histogram_gh_sparse_dequantize(hs.histogram_gh_sparse_accumulate(
        layout, rel_e, gh_e, n, own, _vlim(n_max)), own, (n, F, B, 2))
    assert torch.equal(one, hs.histogram_gh_sparse_kernel(
        layout.gkey, rel_e, gh_e, layout.starts, n, F, B, layout=layout,
        gh_amax=_amax(gh)))


@pytest.mark.parametrize("name", ["unsorted-out-of-range", "one-entry"])
def test_segment_accumulate_and_dequantize_match_plain(cuda, name):
    c, rid, rows = _case(name, cuda)
    c = c.reshape(c.shape[0], -1).contiguous()
    nnz, lanes = c.shape
    scale = _fps(_amax(c) * 3, 5 * nnz)
    qmax = _vlim(5 * nnz)
    before = ss.segment_sum_kernel.launches
    acc = ss.segment_sum_accumulate(c, rid, rows, scale, qmax)
    torch.cuda.synchronize()
    assert ss.segment_sum_kernel.launches == before + 1
    want = ss.segment_sum_accumulate_plain(c.cpu(), rid.cpu(), rows,
                                           scale.cpu(), qmax)
    assert torch.equal(acc.cpu(), want)
    out = ss.segment_sum_dequantize(acc, scale, rows, lanes)
    assert torch.equal(out.cpu(), ss.segment_sum_dequantize(
        want, scale.cpu(), rows, lanes))
    own = _fps(_amax(c), nnz)
    one = ss.segment_sum_dequantize(ss.segment_sum_accumulate(
        c, rid, rows, own, _vlim(nnz)), own, rows, lanes)
    assert torch.equal(one, ss.segment_sum_kernel(c, rid, rows))


# ---- the histograms at the example and one-hot shapes ------------------------

def _fixed_point_reference(acc_plain, scale, shape):
    """The plain fixed-point route on the CPU: the accumulate half's plain
    version dequantized by the plain rounding; the one-process kernel is
    this bit for bit (its sums are exact, its one rounding the same)."""
    return hg.histogram_gh_dequantize(acc_plain, scale.cpu(), shape)


def _assert_within_float64(got, keys, src):
    """``got`` within 1e-5 of float64 sums of ``src`` by flat ``keys``,
    relative to the largest bin (the kernels' contract; an f32 one-hot
    contraction drifts past a plain 1e-5 on a bin of ~20,000 rows)."""
    h64 = torch.zeros(got.numel() // 2, 2, dtype=torch.float64,
                      device=got.device).index_add_(0, keys, src.double())
    err = float((got.reshape(-1, 2).double() - h64).abs().max())
    assert err <= 1e-5 * max(1.0, float(h64.abs().max()))


def _dense_example_case(kind, cuda, seed=0):
    """--missing: 50,000 x 32 codes of 64 bins, 41% in the missing bin 0;
    Covertype: 100,000 rows of 10 continuous codes then 4 + 40 one-hot
    columns (two codes each, at 242 and 255 of 256); one-bin: every row of
    a 3-column level in one code of column 1 (a one-bin column)."""
    rng = np.random.default_rng(seed)
    if kind == "--missing":
        rows, B = 50_000, 64
        bins = np.where(rng.random((rows, 32)) < 0.41, 0,
                        rng.integers(1, B, (rows, 32)))
    elif kind == "Covertype":
        rows, B = 100_000, 256
        wild = rng.choice(4, rows, p=[0.449, 0.051, 0.436, 0.064])
        soil = rng.integers(0, 40, rows)
        hot = np.concatenate([np.eye(4, dtype=np.int64)[wild],
                              np.eye(40, dtype=np.int64)[soil]], 1)
        bins = np.concatenate([rng.integers(0, B, (rows, 10)),
                               np.where(hot == 1, 255, 242)], 1)
    else:
        rows, B = 70_000, 16
        bins = rng.integers(0, B, (rows, 3))
        bins[:, 1] = 7
    gh = np.stack([rng.standard_normal(rows), rng.uniform(0.05, 0.25, rows)],
                  1).astype(np.float32)
    return (torch.from_numpy(bins.astype(np.uint8)).to(cuda),
            torch.from_numpy(gh).to(cuda), B)


@pytest.mark.parametrize("kind,depths", [("--missing", range(5)),
                                         ("Covertype", range(3)),
                                         ("one-bin", range(3))])
def test_histogram_kernel_at_example_and_one_hot_shapes(cuda, kind, depths):
    """With the fit's layout (few-bin columns pre-reduced, compact shared
    histograms) and without: equal to the plain fixed-point route bit for
    bit, two launches bitwise, within 1e-5 of float64."""
    bins, gh, B = _dense_example_case(kind, cuda)
    rows, F = bins.shape
    layout = hg.dense_hist_layout(bins, B)
    if kind == "Covertype":
        assert list(layout.used[10:]) == [2] * 44
    if kind == "one-bin":
        assert layout.used[1] == 1
    rng = np.random.default_rng(7)
    scale = fixed_point_scale(lane_amax(gh), rows)
    for d in depths:
        n = 2 ** d
        rel = torch.from_numpy(rng.integers(0, n, rows).astype(
            np.int32)).to(cuda)
        want = _fixed_point_reference(hg.histogram_gh_accumulate_plain(
            bins.cpu(), rel.cpu(), gh.cpu(), n, B, scale.cpu(),
            _vlim(rows)), scale, (n, F, B, 2))
        for lay in (layout, None):
            a = hg.histogram_gh_kernel(bins, rel, gh, n, B, lay)
            b = hg.histogram_gh_kernel(bins, rel, gh, n, B, lay)
            assert torch.equal(a, b)
            assert torch.equal(a.cpu(), want)
        keys = ((rel.long()[:, None] * F + torch.arange(F, device=cuda)) * B
                + bins.long()).reshape(-1)
        _assert_within_float64(a, keys, gh[:, None, :].expand(
            rows, F, 2).reshape(-1, 2))


def _rank_example_level(cuda, few_feature=False, seed=0):
    """gbdt_train --rank's entry stream: 15,000 rows of 8 of 32 features
    (~120,000 entries), 64 bins; with ``few_feature``, feature 3's entries
    all in bin 5."""
    from dmlc_core_tpu_torch.ops.histogram_sparse import sparse_hist_layout
    rng = np.random.default_rng(seed)
    rows, F, B = 15_000, 32, 64
    fi = np.stack([rng.choice(F, 8, replace=False) for _ in range(rows)])
    rid = np.repeat(np.arange(rows), 8)
    fi = fi.reshape(-1)
    eb = rng.integers(1, B, fi.size)
    if few_feature:
        eb[fi == 3] = 5
    layout = sparse_hist_layout(*(torch.from_numpy(a).to(cuda) for a in (
        rid.astype(np.int32), fi.astype(np.int32), eb.astype(np.int32),
        np.ones(fi.size, bool))), F, B)
    gh = torch.from_numpy(np.stack([rng.standard_normal(rows),
                                    rng.uniform(0.05, 0.25, rows)], 1).astype(
        np.float32)).to(cuda)
    return layout, gh, rows, F, B


@pytest.mark.parametrize("few_feature", [False, True])
def test_sparse_kernel_at_the_rank_example_shape(cuda, few_feature):
    """The --rank example's level shapes (depths 0-4), with the given-amax
    route of the fit and the launch's own amax: equal to the plain
    fixed-point route bit for bit, two launches bitwise, within 1e-5 of
    float64; a feature of one used bin pre-reduces."""
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    layout, gh, rows, F, B = _rank_example_level(cuda, few_feature)
    assert (int(layout.used_on_device()[3]) == 1) == few_feature
    gh_e = hs.entry_gh(gh, layout=layout)
    n_max = int(hs.feature_counts(layout).max())
    rng = np.random.default_rng(11)
    for d in range(5):
        n = 2 ** d
        rel = torch.from_numpy(rng.integers(0, n, rows).astype(
            np.int32)).to(cuda)
        rel_e = rel[layout.rid.long()].contiguous()
        for amax in (lane_amax(gh), None):
            scale = _fps(lane_amax(gh_e) if amax is None else amax, n_max)
            want = hs.histogram_gh_sparse_dequantize(
                hs.histogram_gh_sparse_accumulate_plain(
                    layout.gkey.cpu(), rel_e.cpu(), gh_e.cpu(), layout.starts,
                    n, F, B, scale.cpu(), _vlim(n_max)), scale.cpu(),
                (n, F, B, 2))
            a = hs.histogram_gh_sparse_kernel(
                layout.gkey, rel_e, gh_e, layout.starts, n, F, B, layout,
                gh_amax=amax)
            b = hs.histogram_gh_sparse_kernel(
                layout.gkey, rel_e, gh_e, layout.starts, n, F, B, layout,
                gh_amax=amax)
            assert torch.equal(a, b) and torch.equal(a.cpu(), want)
        gk = layout.gkey.long()
        _assert_within_float64(a, (rel_e.long() * F + gk // layout.nb) * B
                               + gk % layout.nb, gh_e)


@pytest.mark.parametrize("j,rows", [(0, 4096), (-7, 100_000), (12, 3),
                                    (3, 1 << 20)])
def test_histogram_kernels_scale_equals_fixed_point_scale(cuda, j, rows):
    """The scale both histogram kernels find inside their launch is
    ``fixed_point_scale(lane_amax(gh), n_max)`` bit for bit, at amax = 2^j
    and just past it (``test_kernel_scale_equals_fixed_point_scale`` for
    the histograms)."""
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    rng = np.random.default_rng(j + 20)
    gh = rng.uniform(-1, 1, (rows, 2)).astype(np.float32) * np.float32(2.0 ** j)
    gh[0, 0] = 2.0 ** j
    gh[-1, 1] = np.nextafter(np.float32(2.0 ** j), np.float32(np.inf))
    g = torch.from_numpy(gh).to(cuda)
    bins = torch.from_numpy(rng.integers(0, 8, (rows, 3)).astype(
        np.uint8)).to(cuda)
    rel = torch.zeros(rows, dtype=torch.int32, device=cuda)
    _, scale = hg.histogram_gh_kernel(bins, rel, g, 2, 8, return_scale=True)
    assert torch.equal(scale, fixed_point_scale(lane_amax(g), rows))
    starts = torch.tensor([0, rows // 2, rows])
    gkey = torch.cat([torch.full((rows // 2,), 1), torch.full(
        (rows - rows // 2,), 9)]).to(torch.int32).to(cuda)
    _, scale = hs.histogram_gh_sparse_kernel(gkey, rel, g, starts, 2, 2, 8,
                                             return_scale=True)
    n_max = max(rows // 2, rows - rows // 2)
    assert torch.equal(scale, fixed_point_scale(lane_amax(g), n_max))


def _device_ops(fn) -> list:
    """Names of the device operations (kernels, memsets, copies) one call
    of ``fn`` queues, from torch.profiler, after a warm-up call.  A call
    queues at least one, so a trace that holds none lost its device
    records (CUPTI) and is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               for _ in range(e.count)]
        if ops:
            return ops
    return []


def test_histogram_kernels_queue_two_device_ops_a_call(cuda):
    """One one-process call of either kernel queues at most two device
    operations: the prologue (or the zeroing) and the histogram, no amax,
    scale or dequantize ops around them, also for a dense level built by
    subtraction; a sparse call of one span a feature with the caller's
    bound on |gh| (the --rank shape) is one."""
    from dmlc_core_tpu_torch.ops import histogram_sparse as hs
    bins, gh, B = _dense_example_case("Covertype", cuda)
    layout = hg.dense_hist_layout(bins, B)
    rel = torch.zeros(bins.shape[0], dtype=torch.int32, device=cuda)
    ops = _device_ops(lambda: hg.histogram_gh_kernel(bins, rel, gh, 4, B,
                                                     layout))
    print(f"dense call: {ops}")
    assert len(ops) == 2
    # a level built by sibling subtraction too, its device time under a
    # name that holds hist_dense (the benchmark's roofline reader counts it)
    _, acc = hg.histogram_gh_kernel(bins, rel, gh, 4, B, layout,
                                    return_acc=True)
    child = (2 * rel + (torch.rand(rel.shape, device=cuda) < 0.3)).to(
        torch.int32)
    ops = _device_ops(lambda: hg.histogram_gh_kernel(bins, child, gh, 8, B,
                                                     layout, parent=acc))
    print(f"subtracted call: {ops}")
    assert len(ops) == 2 and sum("hist_dense" in op for op in ops) == 1
    lay, gh, rows, F, B = _rank_example_level(cuda)
    gh_e = hs.entry_gh(gh, layout=lay)
    rel_e = torch.zeros(lay.nnz_live, dtype=torch.int32, device=cuda)
    amax = lane_amax(gh)
    ops = _device_ops(lambda: hs.histogram_gh_sparse_kernel(
        lay.gkey, rel_e, gh_e, lay.starts, 16, F, B, lay, gh_amax=amax))
    print(f"sparse call: {ops}")
    assert len(ops) == 1


@pytest.mark.parametrize("lanes", [1, 16])
def test_model_axis_kernel_sum_is_the_one_process_kernel(cuda, tmp_path,
                                                         lanes):
    """A table sharded by feature over two gloo ranks' model axis on the
    card: each rank's ``csr_matmul`` of its block (one accumulate launch,
    the exact route) sums to ``segment_sum_kernel`` over the whole batch
    bit for bit, padding lanes and indices past the table included; the
    backward of each rank's contrib is the gather ``g[row_id]``."""
    from dmlc_core_tpu_torch.ops.segment_sum import clamp_index
    from torch_ranks import run_ranks
    rng = np.random.default_rng(11 + lanes)
    F, nnz, rows = 64, 8192, 512
    table = rng.standard_normal((F, lanes)).astype(np.float32)
    index = rng.integers(0, F + 9, nnz).astype(np.int32)
    index[-500:] = 0
    value = rng.standard_normal(nnz).astype(np.float32)
    value[-500:] = 0.0
    row_id = np.sort(rng.integers(0, rows, nnz)).astype(np.int32)
    g = rng.standard_normal((rows, lanes)).astype(np.float32)
    res = run_ranks(2, "tp_model_sum", tmp_path, timeout=180, table=table,
                    index=index, value=value, row_id=row_id, num_rows=rows,
                    g=g, device="cuda")
    t = torch.from_numpy(table).to(cuda)
    c = (t[clamp_index(torch.from_numpy(index).to(cuda), F)]
         * torch.from_numpy(value).to(cuda)[:, None]).contiguous()
    want = ss.segment_sum_kernel(c, torch.from_numpy(row_id).to(cuda),
                                 rows).cpu().numpy()
    assert sum(r["entries"] for r in res) == nnz
    for r in res:
        assert r["launches"] == 1
        np.testing.assert_array_equal(r["out"], want)
        np.testing.assert_array_equal(r["grad"], r["gather"])


# ---- sibling subtraction of the dense histogram ------------------------------

def _subtract_case(kind, cuda, seed=0):
    """(bins, gh, B, the layout a fit would build) of a level stack:
    Higgs width (200,000 x 28, b-tag columns 8, 12, 16, 20 of three codes,
    the rest any of 256), Covertype width (_dense_example_case), Higgs
    width with a NaN in the grad lane, and Covertype width with a layout
    scanned before a one-hot column took a third code (codes the layout
    does not hold, added straight to the global accumulator)."""
    rng = np.random.default_rng(seed)
    if kind.startswith("Higgs"):
        rows, B = 200_000, 256
        bins = rng.integers(0, B, (rows, 28))
        bins[:, [8, 12, 16, 20]] = rng.integers(0, 3, (rows, 4))
        bins = torch.from_numpy(bins.astype(np.uint8)).to(cuda)
        gh = torch.from_numpy(np.stack([rng.standard_normal(rows),
                                        rng.uniform(0.05, 0.25, rows)],
                                       1).astype(np.float32)).to(cuda)
        if kind == "Higgs, NaN grad":
            gh[1234, 0] = float("nan")
        return bins, gh, B, hg.dense_hist_layout(bins, B)
    bins, gh, B = _dense_example_case("Covertype", cuda, seed)
    layout = hg.dense_hist_layout(bins, B)
    if kind == "Covertype, codes past the layout":
        bins[rng.integers(0, bins.shape[0], 300), 20] = 250
    return bins, gh, B, layout


@pytest.mark.parametrize("kind", ["Higgs", "Covertype", "Higgs, NaN grad",
                                  "Covertype, codes past the layout"])
def test_subtracted_levels_equal_the_full_levels_bit_for_bit(cuda, kind):
    """Every depth of a six-level stack built by subtraction from the
    level above (itself subtracted) equals the kernel's full level bit for
    bit, in the f32 histogram and in the int64 accumulator with its marks,
    and the plain subtracted route; with the fit's layout and with none.
    Routing draws each pair's split anywhere from 5% to 95% of its rows,
    and null splits (every row left) at depths 2 and 4."""
    bins, gh, B, layout = _subtract_case(kind, cuda)
    rows, F = bins.shape
    rng = np.random.default_rng(23)
    scale = fixed_point_scale(lane_amax(gh), rows).cpu()
    for lay in (layout, None):
        rel = torch.zeros(rows, dtype=torch.int32, device=cuda)
        _, acc = hg.histogram_gh_kernel(bins, rel, gh, 1, B, lay,
                                        return_acc=True)
        for d in range(1, 6):
            n = 2 ** d
            share = rng.uniform(0.05, 0.95, n // 2)
            if d in (2, 4):
                share[::3] = 0.0
            right = torch.from_numpy(rng.random(rows) < share[
                rel.cpu().numpy()]).to(cuda)
            rel = (2 * rel + right).to(torch.int32)
            counts = torch.bincount(rel, minlength=n)
            before = (hg.histogram_gh_kernel.launches,
                      hg.histogram_gh_kernel.subtracted)
            built = torch.zeros((), dtype=torch.int64, device=cuda)
            kept = acc.clone()
            got, got_acc = hg.histogram_gh_kernel(
                bins, rel, gh, n, B, lay, parent=acc, built=built,
                return_acc=True)
            torch.cuda.synchronize()
            assert (hg.histogram_gh_kernel.launches,
                    hg.histogram_gh_kernel.subtracted) == (before[0] + 1,
                                                           before[1] + 1)
            assert int(built) == int(counts.view(-1, 2).amin(1).sum())
            assert torch.equal(acc, kept)  # the parent as it was
            want, want_acc = hg.histogram_gh_kernel(bins, rel, gh, n, B, lay,
                                                    return_acc=True)
            n_acc = n * F * B * 2 + 2
            assert torch.equal(got_acc[:n_acc], want_acc[:n_acc]), d
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            if kind != "Higgs, NaN grad":  # plain zeroes a bad value
                plain = hg.histogram_gh_subtract_plain(
                    bins.cpu(), rel.cpu(), gh.cpu(), n, B, scale,
                    _vlim(rows), acc[:n_acc // 2 + 1].cpu(), counts.cpu())
                assert torch.equal(plain, got_acc[:n_acc].cpu()), d
            acc = got_acc
    if kind == "Higgs, NaN grad":
        assert bool(got[..., 0].isnan().all()) and not bool(
            got[..., 1].isnan().any())


def test_subtracted_level_rejects_what_it_does_not_take(cuda):
    bins, rel, gh = _hist_case(64, 3, 8, 2, torch.uint8, cuda)
    _, acc = hg.histogram_gh_kernel(bins, rel // 2, gh, 1, 8,
                                    return_acc=True)
    for kw in (dict(parent=acc[:10]), dict(parent=acc.int()),
               dict(parent=acc, built=torch.zeros(2, dtype=torch.int64,
                                                  device=cuda)),
               dict(parent=acc, built=torch.zeros((), device=cuda))):
        with pytest.raises(ValueError, match="subtracted level"):
            hg.histogram_gh_kernel(bins, rel, gh, 2, 8, **kw)
    with pytest.raises(ValueError, match="subtracted level"):
        hg.histogram_gh_kernel(bins, rel, gh, 3, 8, parent=acc)


def _built_rows(forest, bins, depth):
    """Rows in the child of fewer rows of each node pair at levels 1 ..
    depth - 1, summed over the forest's trees: what the kernel adds at the
    subtracted levels of a fit, from the forest's own routing."""
    total = 0
    missing = forest.get("missing_aware", False)
    for t in range(forest["feature"].shape[0]):
        node = torch.zeros(bins.shape[0], dtype=torch.int64,
                           device=bins.device)
        for d in range(depth - 1):
            b = torch.gather(bins, 1, forest["feature"][t][node].long()
                             [:, None])[:, 0].to(torch.int32)
            right = b > forest["threshold"][t][node]
            if missing:
                right = torch.where(b == 0,
                                    forest["default_right"][t][node] == 1,
                                    right)
            node = 2 * node + 1 + right.long()
            counts = torch.bincount(node - (2 ** (d + 1) - 1),
                                    minlength=2 ** (d + 1))
            total += int(counts.view(-1, 2).amin(1).sum())
    return total


def _subtract_fit_case(kind, cuda):
    """(data, labels, GBDT keywords, fit keywords) of a fit of ``kind``."""
    rng = np.random.default_rng(29)
    rows = 30_000
    x = rng.standard_normal((rows, 10)).astype(np.float32)
    x[:, 7:] = rng.integers(0, 3, (rows, 3))  # few-bin columns
    kw = dict(num_features=10, num_trees=5, max_depth=6, num_bins=64,
              device=cuda)
    if kind == "missing-aware":
        x[rng.random((rows, 10)) < 0.2] = np.nan
        kw.update(missing_aware=True)
    if kind == "sampled":
        kw.update(subsample=0.8, colsample_bytree=0.8, colsample_bylevel=0.8,
                  seed=5)
    y = (x[:, 0] * x[:, 1] + 0.5 * np.nan_to_num(x[:, 2]) + x[:, 8] > 0.5)
    fit_kw = {}
    if kind.startswith("softmax"):
        latent = np.nan_to_num(x[:, 0] + 0.5 * np.sin(3 * x[:, 1]) + x[:, 8])
        y = np.searchsorted(np.quantile(latent, np.cumsum(
            [0.30, 0.25, 0.15, 0.10, 0.08, 0.07])), latent)
        kw.update(objective="softmax", num_class=7, num_trees=3,
                  max_depth=4)
        fit_kw = dict(eval_set=(x[-5000:], y[-5000:].astype(np.float32)))
        x, y = x[:-5000], y[:-5000]
    return x, y.astype(np.float32), kw, fit_kw


@pytest.mark.parametrize("kind", ["binary", "sampled", "missing-aware",
                                  "softmax, rounds replayed",
                                  "softmax, rounds eager"])
def test_subtracted_fit_equals_the_full_fit_byte_for_byte(cuda, kind):
    """A fit with every level below the root built by subtraction gives
    the forest and held-out losses of the fit built level by level in full
    (``_SUBTRACT = False``), byte for byte, with the same launches;
    ``histogram_gh_kernel.subtracted`` counts every level below the root
    of every tree (also when a captured round replays) and
    ``gbdt.hist_built_permille`` the rows the kernel added there, out of
    rows x those levels, from the forest's own routing."""
    from dmlc_core_tpu_torch import telemetry
    x, y, kw, fit_kw = _subtract_fit_case(kind, cuda)
    binner = QuantileBinner(num_bins=kw["num_bins"], device=cuda,
                            missing_aware=kw.get("missing_aware", False))
    binner.fit(x)
    bins = binner.transform(x)
    if "eval_set" in fit_kw:
        fit_kw["eval_set"] = (binner.transform(fit_kw["eval_set"][0]),
                              fit_kw["eval_set"][1])
    full, sub = GBDT(**kw), GBDT(**kw)
    full._SUBTRACT = False
    if kind == "softmax, rounds eager":
        full._GRAPH_ROUNDS = sub._GRAPH_ROUNDS = False
    trees = kw["num_trees"] * kw.get("num_class", 1)
    levels = trees * (kw["max_depth"] - 1)
    s0 = hg.histogram_gh_kernel.subtracted
    want = _fit_counted(full, bins, y, **fit_kw)
    assert hg.histogram_gh_kernel.subtracted == s0
    for _ in range(2):  # the second softmax fit replays every round
        s0 = hg.histogram_gh_kernel.subtracted
        got = _fit_counted(sub, bins, y, **fit_kw)
        assert hg.histogram_gh_kernel.subtracted - s0 == levels
        for k in want[0]:
            assert torch.equal(got[0][k], want[0][k]), k
        assert got[1:] == want[1:]
        forest = dict(got[0], missing_aware=kw.get("missing_aware", False))
        built = _built_rows(forest, bins, kw["max_depth"])
        permille = telemetry.gauge_get("gbdt.hist_built_permille")
        print(f"{kind}: gbdt.hist_built_permille {permille}")
        assert permille == 1000 * built // (levels * bins.shape[0])
        assert 0 < permille <= 500

