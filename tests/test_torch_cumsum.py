"""The port's split-finding prefix sum against the JAX package's, on the CPU.

* ``_cumsum_f32`` equals jitted ``jnp.cumsum`` bit for bit (XLA's CPU
  cumsum is a two-level scan over blocks of 16, and the port follows its
  order), at lengths around the block size and at the bins counts GBDT
  uses, along any axis of the histograms split finding scans.
* Forests at 64 and 256 bins (dense ``fit``) and at 64 bins (sparse
  ``fit_batch``) equal the JAX package's node for node, with leaves, covers
  and bases at rtol 1e-5 / atol 1e-6 and gains at rtol 1e-5 plus 4 f32 ulps
  of the largest gain (tests/test_torch_gbdt.py's tolerances and reasons).
  Each fixture is held to a stated gain-gap rule first: in the reference's
  own fit, recomputed in float64, every split's gain beats that of every
  candidate that parts the node's rows another way (mirrored partitions
  included) by at least ``GAP`` of itself, and every null node's best gain
  stays at least ``GAP`` below zero or is -inf, so f32 sums in another
  order cannot pick another split.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu.data.staging import PaddedBatch as JaxBatch
from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
from dmlc_core_tpu.models.gbdt import QuantileBinner as JaxBinner
from dmlc_core_tpu_torch.data.staging import PaddedBatch
from dmlc_core_tpu_torch.models import GBDT, QuantileBinner
from dmlc_core_tpu_torch.models.gbdt import _cumsum_f32

EXACT = ("feature", "threshold", "default_right", "trees_used")
CLOSE = ("leaf", "split_gain", "split_cover", "base")
FOREST_TOL = dict(rtol=1e-5, atol=1e-6)
GAP = 1e-4  # the gain-gap rule: relative to the split's own gain

_jit_cumsum = jax.jit(jnp.cumsum, static_argnums=1)


@pytest.mark.parametrize("n", [1, 3, 16, 17, 18, 64, 255, 256, 257, 1000])
def test_cumsum_f32_equals_jitted_jnp_cumsum_bitwise(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = _cumsum_f32(torch.from_numpy(x), 0).numpy()
    want = np.asarray(_jit_cumsum(x, 0))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("shape,axis", [((8, 28, 256), 2), ((4, 5, 64, 2), 2),
                                        ((3, 257, 2), 1), ((16, 7), 0)])
def test_cumsum_f32_along_the_bins_axis_bitwise(shape, axis):
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    got = _cumsum_f32(torch.from_numpy(x), axis).numpy()
    want = np.asarray(_jit_cumsum(x, axis))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ---- the gain-gap rule ----------------------------------------------------------

def _min_gain_gaps(bins, label, forest, num_bins, lam, mcw, missing_aware):
    """Replay the reference's logistic fit in float64 on its own forest:
    per tree, the rows' (grad, hess) from the margins so far, per level
    every node's candidate gains (bin 0 holding the missing mass when
    ``missing_aware``, both default directions).  Returns (the smallest
    (chosen - best other partition) / |chosen| over the nodes that split, the
    largest best gain / max(1, |largest gain|) over the nodes that do
    not)."""
    rows, F = bins.shape
    B = num_bins
    feat, thr = forest["feature"], forest["threshold"]
    dflt, leaf = forest["default_right"], forest["leaf"].astype(np.float64)
    depth = int(np.log2(leaf.shape[1]))
    y = (label > 0.5).astype(np.float64)
    margin = np.full(rows, float(forest["base"]))
    r = np.arange(rows)
    split_gap, null_worst = np.inf, -np.inf
    for t in range(int(forest["trees_used"])):
        p = 1.0 / (1.0 + np.exp(-margin))
        g, h = p - y, np.maximum(p * (1.0 - p), 1e-16)
        node = np.zeros(rows, np.int64)
        for d in range(depth):
            n = 2 ** d
            rel = node - (n - 1)
            hist = np.zeros((n, F, B, 2))
            for f in range(F):
                key = rel * B + bins[:, f]
                for lane, v in enumerate((g, h)):
                    hist[:, f, :, lane] = np.bincount(
                        key, v, minlength=n * B).reshape(n, B)
            gl = np.cumsum(hist, axis=2)
            tot = gl[:, :, -1:, :]
            dirs = [gl] + ([gl - hist[:, :, :1, :]] if missing_aware else [])
            lefts, gains = [], []
            for a in dirs:
                b_ = tot - a
                gn = (a[..., 0] ** 2 / (a[..., 1] + lam)
                      + b_[..., 0] ** 2 / (b_[..., 1] + lam)
                      - tot[..., 0] ** 2 / (tot[..., 1] + lam))
                ok = (a[..., 1] >= mcw) & (b_[..., 1] >= mcw)
                gains.append(np.where(ok, gn, -np.inf))
                lefts.append(a)
            gain = np.stack(gains, axis=3)               # [n, F, B, nd]
            left = np.stack(lefts, axis=4)               # [n, F, B, 2, nd]
            fin = gain[np.isfinite(gain)]
            scale = max(1.0, float(np.abs(fin).max(initial=0.0)))
            for j in range(n):
                best = gain[j].max()
                if thr[t, n - 1 + j] >= B:
                    if np.isfinite(best):
                        null_worst = max(null_worst, best / scale)
                    continue
                fs, bs = int(feat[t, n - 1 + j]), int(thr[t, n - 1 + j])
                ds = int(dflt[t, n - 1 + j]) if missing_aware else 0
                chosen = gain[j, fs, bs, ds]
                # the same partition of the rows (the same feature and
                # left sums: a cut past empty bins, or the other default
                # direction where nothing is missing) is no other split
                same = np.zeros(gain.shape[1:], bool)
                same[fs] = (left[j, fs] == left[j, fs, bs, :, ds][
                    None, :, None]).all(axis=1)
                runner = np.where(same, -np.inf, gain[j]).max()
                split_gap = min(split_gap, (chosen - runner) / abs(chosen))
            f_r = feat[t, node]
            b_r = bins[r, f_r]
            right = b_r > thr[t, node]
            if missing_aware:
                right = np.where(b_r == 0, dflt[t, node] == 1, right)
            node = 2 * node + 1 + right
        margin = margin + leaf[t, node - (2 ** depth - 1)]
    return split_gap, null_worst


def _assert_forest_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in EXACT:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in CLOSE:
        tol = dict(FOREST_TOL)
        if k == "split_gain":
            tol["atol"] = 4 * 2.0 ** -23 * float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **tol)


# ---- dense fixtures at 64 and 256 bins ---------------------------------------------

def _dense_case(num_bins):
    rng = np.random.default_rng(600 + num_bins)
    x = rng.uniform(-1, 1, (3000, 4)).astype(np.float32)
    y = ((x[:, 0] > 0.1) ^ (x[:, 1] > -0.3)).astype(np.float32)
    flip = rng.random(3000) < 0.1
    y[flip] = 1.0 - y[flip]
    return x, y, dict(num_features=4, num_trees=3, max_depth=3,
                      num_bins=num_bins, learning_rate=0.5)


@pytest.mark.parametrize("histogram", ["xla", "pallas"])
@pytest.mark.parametrize("num_bins", [64, 256])
def test_dense_forest_at_many_bins_equals_jax(num_bins, histogram):
    x, y, kw = _dense_case(num_bins)
    jbinner = JaxBinner(num_bins=num_bins).fit(x)
    jbins = jbinner.transform(jnp.asarray(x))
    want = {k: np.asarray(v) for k, v in JaxGBDT(histogram="xla", **kw).fit(
        jbins, jnp.asarray(y)).items()}
    gap, null = _min_gain_gaps(np.asarray(jbins).astype(np.int64), y, want,
                               num_bins, 1.0, 1e-3, False)
    assert gap >= GAP and null <= -GAP, (gap, null)
    binner = QuantileBinner(num_bins=num_bins, device="cpu").fit(x)
    got = GBDT(histogram=histogram, device="cpu", **kw).fit(
        binner.transform(x), y)
    _assert_forest_equal(got, want)


# ---- a sparse fixture at 64 bins -----------------------------------------------------

def test_sparse_forest_at_64_bins_equals_jax():
    rng = np.random.default_rng(670)
    rows, F, B = 2000, 4, 64
    present = rng.random((rows, F)) < 0.6
    vals = rng.uniform(-2, 2, (rows, F)).astype(np.float32)
    vals[vals == 0] = 0.5
    r, f = np.nonzero(present)
    idx, val = f.astype(np.int32), vals[r, f]
    dense = np.where(present, vals, np.nan)
    # missing reads as 0 in the label, so no node's best split is "missing
    # against present" (whose mirror, threshold 0 against B - 1 with the
    # other default direction, ties it exactly)
    y = ((np.nan_to_num(dense[:, 0]) > 0.3)
         ^ (np.nan_to_num(dense[:, 1]) > 0.5)).astype(np.float32)
    flip = rng.random(rows) < 0.1
    y[flip] = 1.0 - y[flip]
    row_ptr = np.concatenate([[0], np.cumsum(present.sum(1))]).astype(np.int32)
    w = np.ones(rows, np.float32)
    kw = dict(num_features=F, num_trees=3, max_depth=3, num_bins=B,
              learning_rate=0.5, missing_aware=True)
    jb = JaxBatch(label=jnp.asarray(y), weight=jnp.asarray(w),
                  row_ptr=jnp.asarray(row_ptr), index=jnp.asarray(idx),
                  value=jnp.asarray(val), num_rows=jnp.asarray(np.int32(rows)))
    jbinner = JaxBinner(num_bins=B, missing_aware=True).fit_sparse(idx, val, F)
    want = {k: np.asarray(v) for k, v in JaxGBDT(histogram="xla", **kw)
            .fit_batch(jb, jbinner).items()}
    codes = np.zeros((rows, F), np.int64)
    codes[r, f] = np.asarray(jbinner.transform_entries(jnp.asarray(idx),
                                                       jnp.asarray(val)))
    gap, null = _min_gain_gaps(codes, y, want, B, 1.0, 1e-3, True)
    assert gap >= GAP and null <= -GAP, (gap, null)
    tb = PaddedBatch(label=torch.from_numpy(y), weight=torch.from_numpy(w),
                     row_ptr=torch.from_numpy(row_ptr),
                     index=torch.from_numpy(idx), value=torch.from_numpy(val),
                     num_rows=rows)
    binner = QuantileBinner(num_bins=B, missing_aware=True,
                            device="cpu").fit_sparse(idx, val, F)
    for histogram in ("xla", "pallas"):
        got = GBDT(histogram=histogram, device="cpu", **kw).fit_batch(
            tb, binner)
        _assert_forest_equal(got, want)
