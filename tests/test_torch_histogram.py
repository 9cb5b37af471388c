"""The port's GBDT histogram (dmlc_core_tpu_torch.ops.histogram) against the
JAX package's ``histogram_gh``, on the same numpy inputs.

On the CPU the port's "pallas" backend runs the kernel's plain version and
the JAX "pallas" backend runs its Pallas kernel in interpret mode, as
tests/test_pallas.py runs it; both packages' ``None`` backend is the
flattened-key scatter-add.  Tolerance: atol = rtol = 1e-5, the JAX
package's own between its two backends (f32 sums in another order).  The
CUDA kernel itself is held to the plain version on the card by
tests/test_torch_cuda.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu.ops.pallas_segment import histogram_gh as jax_histogram_gh
from dmlc_core_tpu_torch.ops import fixed_point
from dmlc_core_tpu_torch.ops import histogram as hg
from dmlc_core_tpu_torch.ops.fixed_point import fixed_point_scale, lane_amax
from dmlc_core_tpu_torch.ops.histogram import histogram_gh

TOL = dict(rtol=1e-5, atol=1e-5)

# (rows, F, num_bins, n_nodes, code dtype): the shapes of
# tests/test_pallas.py:77-78 and :98-104, GBDT's uint8 codes, an empty level
CASES = [(200, 3, 8, 1, "int32"), (777, 5, 16, 4, "int32"),
         (64, 2, 4, 8, "int32"), (130, 2, 128, 8, "int32"),
         (300, 3, 1024, 4, "int32"), (120, 2, 2048, 2, "int32"),
         (100, 5, 600, 3, "int32"), (90, 4, 2, 2, "int32"),
         (150, 9, 3, 5, "int32"), (500, 6, 256, 4, "uint8"),
         (0, 3, 8, 2, "int32")]


def _case(i):
    rows, F, B, n, dt = CASES[i]
    rng = np.random.default_rng(100 + i)
    bins = rng.integers(0, B, (rows, F)).astype(dt)
    rel = rng.integers(0, n, rows).astype(np.int32)
    gh = rng.standard_normal((rows, 2)).astype(np.float32)
    return bins, rel, gh, n, B


@functools.lru_cache(maxsize=None)
def _jax_refs(i):
    bins, rel, gh, n, B = _case(i)
    return tuple(np.asarray(jax_histogram_gh(
        jnp.asarray(bins), jnp.asarray(rel), jnp.asarray(gh), n, B, force=f))
        for f in ("pallas", None))


@pytest.mark.parametrize("force", [None, "pallas"])
@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[str(c) for c in CASES])
def test_matches_jax_both_backends(i, force):
    bins, rel, gh, n, B = _case(i)
    got = histogram_gh(torch.from_numpy(bins), torch.from_numpy(rel),
                       torch.from_numpy(gh), n, B, force=force)
    assert got.dtype == torch.float32
    for want in _jax_refs(i):
        assert tuple(got.shape) == want.shape == (n, bins.shape[1], B, 2)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("force", [None, "pallas"])
def test_out_of_range_rows_add_nothing(force):
    """Node ids past n_nodes add nothing on either backend (the scatter
    drops their keys; the kernel and its plain version match no node)."""
    bins, rel, gh, n, B = _case(1)
    keep = torch.from_numpy(rel) < n - 1
    got = histogram_gh(torch.from_numpy(bins), torch.from_numpy(rel),
                       torch.from_numpy(gh), n - 1, B, force=force)
    want = histogram_gh(torch.from_numpy(bins)[keep],
                        torch.from_numpy(rel)[keep],
                        torch.from_numpy(gh)[keep], n - 1, B, force=force)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("force", [None, "pallas"])
def test_result_dtype_follows_gh(force):
    """f32 accumulation on the kernel path, cast back to gh's dtype, as
    the JAX front end does; k/8 values sum exactly, so the two backends
    agree bit for bit."""
    bins, rel, gh, n, B = _case(0)
    gh8 = torch.round(torch.from_numpy(gh) * 8) / 8
    got = histogram_gh(torch.from_numpy(bins), torch.from_numpy(rel),
                       gh8.to(torch.bfloat16), n, B, force=force)
    want = histogram_gh(torch.from_numpy(bins), torch.from_numpy(rel), gh8,
                        n, B, force="pallas")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want.numpy())


def test_kernel_wrapper_cpu_runs_plain_and_counts_nothing():
    bins, rel, gh, n, B = _case(1)
    t = [torch.from_numpy(a) for a in (bins, rel, gh)]
    before = hg.histogram_gh_kernel.launches
    got = hg.histogram_gh_kernel(*t, n, B)
    assert hg.histogram_gh_kernel.launches == before
    assert torch.equal(got, hg.histogram_gh_plain(*t, n, B))


def test_kernel_wrapper_rejects_other_devices():
    bins = torch.zeros(4, 2, dtype=torch.uint8, device="meta")
    rel = torch.zeros(4, dtype=torch.int32, device="meta")
    gh = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        hg.histogram_gh_kernel(bins, rel, gh, 2, 8)


def test_check_force_rejects_unknown_backend():
    bins, rel, gh, n, B = _case(0)
    with pytest.raises(ValueError, match="want one of"):
        histogram_gh(torch.from_numpy(bins), torch.from_numpy(rel),
                     torch.from_numpy(gh), n, B, force="cuda")


@pytest.mark.parametrize("rows,F,B,n", [(11_000_000, 28, 256, 1),
                                        (11_000_000, 28, 256, 32),
                                        (1_000_000, 28, 256, 512),
                                        (5000, 3, 2048, 3), (0, 4, 16, 2)])
def test_launch_geometry_fits_the_card(rows, F, B, n):
    """How a launch cuts its work: one shared histogram of node_tile x
    feat_group (node, feature) pairs a block, within a Hopper block's 227
    KB; every node of the level in one tile while they fit beside
    ``_DEEP_GROUP`` features (depths 0-4 at 256 bins), else even node
    tiles, each group in its own; every pair in some tile and every row in
    some chunk."""
    geo = hg.launch_geometry(rows, F, B, n)
    assert geo["smem"] <= 227 * 1024
    assert geo["smem"] == geo["node_tile"] * geo["feat_group"] * B * 16
    assert 1 <= geo["node_tile"] <= n and 1 <= geo["feat_group"] <= F
    tiles = -(-n // geo["node_tile"])
    groups = -(-F // geo["feat_group"])
    if n * min(F, hg._DEEP_GROUP) * B * 16 <= 227 * 1024:
        assert tiles == 1
    assert tiles * geo["node_tile"] - n < tiles
    assert (groups - 1) * geo["feat_group"] < F
    if (B, F) == (256, 28) and n <= 32:  # Higgs: one pass, two at depth 5
        assert tiles == (2 if n == 32 else 1)
    chunks = -(-rows // geo["chunk"])
    assert chunks * geo["chunk"] >= rows
    # each group in its own even node tiles (a narrower last group in fewer)
    assert groups == len(geo["groups"])
    assert geo["blocks"] == chunks * len(geo["items"])
    assert len(geo["items"]) <= groups * tiles


def test_launch_geometry_refuses_bins_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        hg.launch_geometry(100, 2, 40000, 1)


# ---- the kernel's fixed-point numerics (csrc/hist_fixed.cuh) -----------------

def _fixed_point_hist(bins, rel, gh, n, B, scale):
    """The kernel's arithmetic in numpy: each value quantised once (the f32
    product by a power of two is exact; ``np.rint`` rounds half to even as
    ``__float2ll_rn`` does), summed exactly in int64 by sorted key, each
    bin rounded once to f32; a lane with a non-finite scale, or with a
    value at or past ``value_limit(rows)``, is NaN."""
    s = scale.numpy()
    with np.errstate(invalid="ignore", over="ignore"):
        qf = np.rint(gh.astype(np.float32) * s).astype(np.float64)
        ok = (np.isfinite(s) & (s > 0) & (np.abs(qf) < float(
            fixed_point.value_limit(len(gh)))).all(0))
    q = np.where(ok, qf, 0).astype(np.int64)
    rows, F = bins.shape
    keys = ((rel.astype(np.int64)[:, None] * F + np.arange(F)) * B
            + bins).reshape(-1)
    vals = np.repeat(q, F, axis=0)
    order = np.argsort(keys, kind="stable")
    ks, vs = keys[order], vals[order]
    first = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]]) if len(ks) else []
    acc = np.zeros((n * F * B, 2), np.int64)
    if len(ks):
        acc[ks[first]] = np.add.reduceat(vs, first, axis=0)
    out = (acc / np.where(ok, s, 1).astype(np.float64)).astype(np.float32)
    out[:, ~ok] = np.nan
    return out.reshape(n, F, B, 2)


def _oracle64(bins, rel, gh, n, B):
    rows, F = bins.shape
    keys = ((rel.astype(np.int64)[:, None] * F + np.arange(F)) * B
            + bins).reshape(-1)
    return np.stack([np.bincount(keys, np.repeat(gh[:, lane], F).astype(
        np.float64), minlength=n * F * B) for lane in (0, 1)], 1).reshape(
        n, F, B, 2)


def _logistic_gh(rng, rows):
    p = 1 / (1 + np.exp(-rng.standard_normal(rows)))
    y = rng.random(rows) < p
    return np.stack([p - y, p * (1 - p)], 1).astype(np.float32)


@pytest.mark.parametrize("n,amax", [(11_000_000, 1.0), (11_000_000, 0.25),
                                    (1 << 20, 1.0 + 2 ** -23),
                                    (1 << 31, 3.0e38), (1, 1e-38), (7, 0.0)])
def test_fixed_point_scale_never_overflows_one_bin(n, amax):
    """Every row in one bin with |value| = amax, the worst case the scale
    admits: n * q(amax) stays below 2^63 (exact Python ints), and where
    the scale is below its cap 2^K_MAX it uses the range (above 2^61)."""
    scale = fixed_point_scale(torch.tensor([amax, -amax], dtype=torch.float32)
                              .abs(), n)
    assert scale.dtype == torch.float32 and bool(torch.isfinite(scale).all())
    for s in scale.tolist():
        q = int(np.rint(np.float32(amax) * np.float32(s)))
        assert n * q < 2 ** 63 and -n * q >= -2 ** 63
        if amax and s < 2.0 ** fixed_point.K_MAX:
            assert n * q > 2 ** 61
    if n <= 1 << 20:  # the emulation's int64 sum itself, materialized
        gh = np.full((n, 2), amax, np.float32)
        got = _fixed_point_hist(np.zeros((n, 1), np.int64),
                                np.zeros(n, np.int32), gh, 1, 1, scale)
        want = np.float32(np.float64(np.float32(amax)) * n)
        bound = float(fixed_point.error_bound(scale, n)[0])
        assert abs(float(got[0, 0, 0, 0]) - float(want)) <= bound + float(
            np.spacing(want))


@pytest.mark.parametrize("n,amax", [(11_000_000, 1.0), (11_000_000, 0.25),
                                    (1 << 20, 1.0 + 2 ** -23),
                                    (1 << 31, 3.0e38), (1, 1e-38), (7, 0.0),
                                    (3, 2.0 ** 40 + 2.0 ** 17), (1, 1.0)])
def test_value_limit_admits_every_value_the_scale_was_made_for(n, amax):
    """``value_limit(n)``: n values below it in magnitude cannot wrap an
    int64 sum, and every value within ``amax`` quantises below it (at
    most about half of it), so a true bound never marks a lane."""
    limit = fixed_point.value_limit(n)
    assert n * limit <= 2 ** 63 - 1 < n * (limit + 1)
    scale = float(fixed_point_scale(torch.tensor([amax]), n)[0])
    q = int(np.rint(np.float32(amax) * np.float32(scale)))
    assert q < limit and 2 * q <= limit + 2


@pytest.mark.parametrize("amax,marked", [(0.6, False), (0.5, True),
                                         (1e-3, True)])
def test_fixed_point_understated_bound_is_nan_or_exact(amax, marked):
    """A grad-lane bound below the lane's largest value (1.0 among values
    near 1e-3): where a value reaches the limit the lane is NaN; where none
    does, the finer scale's sums stay within its bound of float64.  The
    hess lane, truly bounded, is unchanged."""
    rng = np.random.default_rng(10)
    rows, F, n = 1024, 3, 4
    bins = rng.integers(0, 16, (rows, F))
    rel = rng.integers(0, n, rows).astype(np.int32)
    gh = _logistic_gh(rng, rows)
    gh[:, 0] *= 1e-3
    gh[5, 0] = 1.0
    true = lane_amax(torch.from_numpy(gh))
    clean = _fixed_point_hist(bins, rel, gh, n, 16,
                              fixed_point_scale(true, rows))
    scale = fixed_point_scale(torch.tensor([amax, float(true[1])]), rows)
    got = _fixed_point_hist(bins, rel, gh, n, 16, scale)
    assert np.array_equal(got[..., 1], clean[..., 1])
    if marked:
        assert np.isnan(got[..., 0]).all()
        return
    want = _oracle64(bins, rel, gh, n, 16)[..., 0]
    m = _oracle64(bins, rel, np.ones_like(gh), n, 16)[..., 0]
    bound = m * float(fixed_point.error_bound(scale, 1)[0]) + np.spacing(
        np.abs(got[..., 0]))
    assert (np.abs(got[..., 0] - want) <= bound).all()


@pytest.mark.parametrize("rows,F,n", [(120_000, 6, 32), (60_000, 28, 1)])
def test_fixed_point_error_within_bound_of_float64(rows, F, n):
    """Higgs-like levels, scaled down: logistic (grad, hess), 256 bins.
    Every bin is within the header's bound (m * 2^-(k+1) for m rows, plus
    one f32 ulp of the result) of float64, and within 1e-5 of the
    largest bin."""
    rng = np.random.default_rng(7)
    bins = rng.integers(0, 256, (rows, F))
    bins[rng.random((rows, F)) < 0.3] = 3        # a heavy bin
    rel = rng.integers(0, n, rows).astype(np.int32)
    gh = _logistic_gh(rng, rows)
    scale = fixed_point_scale(lane_amax(torch.from_numpy(gh)), rows)
    got = _fixed_point_hist(bins, rel, gh, n, 256, scale)
    want = _oracle64(bins, rel, gh, n, 256)
    m = _oracle64(bins, rel, np.ones_like(gh), n, 256)[..., :1]
    bound = m * fixed_point.error_bound(scale, 1).numpy() + np.spacing(
        np.abs(got))
    assert (np.abs(got - want) <= bound).all()
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_fixed_point_sum_is_the_same_for_any_row_order():
    rng = np.random.default_rng(8)
    rows, F, n = 50_000, 5, 8
    bins = rng.integers(0, 64, (rows, F))
    rel = rng.integers(0, n, rows).astype(np.int32)
    gh = _logistic_gh(rng, rows)
    perm = rng.permutation(rows)
    s1 = fixed_point_scale(lane_amax(torch.from_numpy(gh)), rows)
    s2 = fixed_point_scale(lane_amax(torch.from_numpy(gh[perm])), rows)
    assert torch.equal(s1, s2)
    a = _fixed_point_hist(bins, rel, gh, n, 64, s1)
    b = _fixed_point_hist(bins[perm], rel[perm], gh[perm], n, 64, s2)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_fixed_point_non_finite_lane_is_nan(bad):
    """A NaN or Inf in one lane gives that lane a NaN scale and a NaN
    histogram everywhere; the other lane is untouched."""
    rng = np.random.default_rng(9)
    rows, F, n = 2000, 3, 4
    bins = rng.integers(0, 16, (rows, F))
    rel = rng.integers(0, n, rows).astype(np.int32)
    gh = _logistic_gh(rng, rows)
    clean = _fixed_point_hist(bins, rel, gh, n, 16, fixed_point_scale(
        lane_amax(torch.from_numpy(gh)), rows))
    gh[17, 0] = bad
    scale = fixed_point_scale(lane_amax(torch.from_numpy(gh)), rows)
    assert np.isnan(scale[0].item()) and np.isfinite(scale[1].item())
    got = _fixed_point_hist(bins, rel, gh, n, 16, scale)
    assert np.isnan(got[..., 0]).all()
    assert np.array_equal(got[..., 1], clean[..., 1])
