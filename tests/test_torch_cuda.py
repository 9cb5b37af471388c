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
