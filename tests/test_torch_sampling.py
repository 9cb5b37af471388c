"""Sampled forests (``subsample``, ``colsample_bytree``,
``colsample_bylevel`` below 1.0) of the port against the JAX package's, on
the CPU.  Both draw from ``jax.random``'s threefry stream (the port through
dmlc_core_tpu_torch.random, bit for bit), so on a near-tie-free fixture
the node arrays are equal and leaves, covers and bases allclose at rtol
1e-5 / atol 1e-6, gains at rtol 1e-5 plus 4 f32 ulps of the largest gain
(tests/test_torch_gbdt.py's tolerances and reasons), on both of the port's
histogram backends, for the dense ``fit`` (also softmax, whose tree index
runs over rounds and classes) and the sparse ``fit_batch``."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu.data.staging import PaddedBatch as JaxBatch
from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
from dmlc_core_tpu.models.gbdt import QuantileBinner as JaxBinner
from dmlc_core_tpu_torch.data.staging import PaddedBatch
from dmlc_core_tpu_torch.models import GBDT, QuantileBinner

EXACT = ("feature", "threshold", "default_right", "trees_used")
CLOSE = ("leaf", "split_gain", "split_cover", "base")
FOREST_TOL = dict(rtol=1e-5, atol=1e-6)
SAMPLING = dict(subsample=0.8, colsample_bytree=0.8, colsample_bylevel=0.8)


def _assert_forest_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in EXACT:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in CLOSE:
        tol = dict(FOREST_TOL)
        if k == "split_gain":
            tol["atol"] = 4 * 2.0 ** -23 * float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **tol)


def _dense_case(objective):
    rng = np.random.default_rng(80)
    x = rng.uniform(-1, 1, (800, 6)).astype(np.float32)
    if objective == "softmax":
        y = np.where(x[:, 0] + x[:, 1] > 0.4, 2,
                     np.where(x[:, 2] * x[:, 3] > 0, 1, 0))
        kw = dict(objective="softmax", num_class=3, num_trees=3)
    else:
        y = (x[:, 0] + 0.5 * x[:, 2] - 0.7 * x[:, 4] > 0.1)
        kw = dict(num_trees=5)
    return x, y.astype(np.float32), dict(num_features=6, max_depth=3,
                                         num_bins=16, learning_rate=0.5,
                                         seed=3, **SAMPLING, **kw)


@functools.lru_cache(maxsize=None)
def _jax_dense(objective):
    x, y, kw = _dense_case(objective)
    binner = JaxBinner(num_bins=16).fit(x)
    forest = JaxGBDT(histogram="xla", **kw).fit(binner.transform(
        jnp.asarray(x)), jnp.asarray(y))
    return {k: np.asarray(v) for k, v in forest.items()}


@pytest.mark.parametrize("histogram", ["xla", "pallas"])
@pytest.mark.parametrize("objective", ["logistic", "softmax"])
def test_sampled_dense_forest_equals_jax(objective, histogram):
    x, y, kw = _dense_case(objective)
    want = _jax_dense(objective)
    bins = QuantileBinner(num_bins=16, device="cpu").fit(x).transform(x)
    got = GBDT(histogram=histogram, device="cpu", **kw).fit(bins, y)
    _assert_forest_equal(got, want)
    # the fixture samples: some tree leaves a feature out
    unsampled = GBDT(device="cpu", **{**kw, **dict.fromkeys(SAMPLING, 1.0)})
    assert not torch.equal(unsampled.fit(bins, y)["leaf"], got["leaf"])


def test_sampled_sparse_forest_equals_jax():
    rng = np.random.default_rng(81)
    rows, F, B = 900, 6, 16
    present = rng.random((rows, F)) < 0.6
    vals = rng.uniform(-2, 2, (rows, F)).astype(np.float32)
    vals[vals == 0] = 0.5
    r, f = np.nonzero(present)
    idx, val = f.astype(np.int32), vals[r, f]
    x = np.where(present, vals, 0.0)
    y = (x[:, 0] + 0.6 * x[:, 3] - 0.5 * x[:, 5] > 0.2).astype(np.float32)
    row_ptr = np.concatenate([[0], np.cumsum(present.sum(1))]).astype(np.int32)
    w = np.ones(rows, np.float32)
    kw = dict(num_features=F, num_trees=5, max_depth=3, num_bins=B,
              learning_rate=0.5, missing_aware=True, seed=5, **SAMPLING)
    jb = JaxBatch(label=jnp.asarray(y), weight=jnp.asarray(w),
                  row_ptr=jnp.asarray(row_ptr), index=jnp.asarray(idx),
                  value=jnp.asarray(val), num_rows=jnp.asarray(np.int32(rows)))
    jbinner = JaxBinner(num_bins=B, missing_aware=True).fit_sparse(idx, val, F)
    want = {k: np.asarray(v) for k, v in JaxGBDT(histogram="xla", **kw)
            .fit_batch(jb, jbinner).items()}
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


def test_sampled_fits_repeat_and_seeds_differ():
    x, y, kw = _dense_case("logistic")
    bins = QuantileBinner(num_bins=16, device="cpu").fit(x).transform(x)
    a = GBDT(device="cpu", **kw).fit(bins, y)
    b = GBDT(device="cpu", **kw).fit(bins, y)
    c = GBDT(device="cpu", **{**kw, "seed": 4}).fit(bins, y)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["leaf"], c["leaf"])
