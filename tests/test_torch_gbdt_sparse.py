"""The port's sparse GBDT path (``QuantileBinner``'s COO surface,
``GBDT.fit_batch`` and the batch predict surface) against the JAX package's,
on the same numpy inputs, on the CPU.

* Binner: ``fit_sparse`` / ``partial_fit_sparse`` + ``finalize`` cuts and
  ``cuts_digest`` equal exactly (the same numpy code with the same seed);
  ``transform_entries`` codes equal, NaN -> 0.
* Forests: the JAX package fits with ``histogram="xla"``; the port fits on
  both of its backends ("xla": index_add; "pallas": the sparse kernel's
  plain version over the feature-sorted layout).  Node arrays and
  ``trees_used`` equal; leaves, covers and bases allclose at rtol 1e-5, atol
  1e-6; gains at rtol 1e-5 and an atol of 4 f32 ulps of the forest's
  largest gain (tests/test_torch_gbdt.py's tolerances and reasons).  The
  fixtures keep their split gains clear of near-ties, as
  tests/test_gbdt.py:1241's does: where a node has no missing mass for a
  feature, its two default directions tie up to rounding, and a base or a
  node total summed in another order (an ulp) can flip the tie-break, so
  the squared and softmax seeds were picked free of such flips.
* One tiny case against the JAX package's ``histogram="pallas"`` (its
  kernel in interpret mode), as tests/test_gbdt.py:1241.
* The port's sparse forest equals its dense missing-aware fit on the
  densified matrix (tests/test_gbdt.py:367's claim).
* Prediction: a JAX-trained forest carried across with ``forest_from_numpy``
  routes batches to the same outputs within 2e-5 (tests/test_pallas.py:134).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu.data.staging import PaddedBatch as JaxBatch
from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
from dmlc_core_tpu.models.gbdt import QuantileBinner as JaxBinner
from dmlc_core_tpu.ops.sparse import \
    csr_to_dense_missing as jax_csr_to_dense_missing
from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.data.binned_cache import BinnedBatch
from dmlc_core_tpu_torch.data.staging import PaddedBatch
from dmlc_core_tpu_torch.models import GBDT, QuantileBinner, forest_from_numpy
from dmlc_core_tpu_torch.ops.sparse import csr_to_dense_missing

EXACT = ("feature", "threshold", "default_right", "trees_used")
CLOSE = ("leaf", "split_gain", "split_cover", "base")
FOREST_TOL = dict(rtol=1e-5, atol=1e-6)
PRED_TOL = dict(rtol=2e-5, atol=2e-5)
PAD = 7  # trailing padding lanes of every batch


# ---- fixtures -----------------------------------------------------------------

def _coo(seed, rows, F, density=0.4):
    """Row-major COO entries of a random sparse matrix (values in [-2, 2],
    none exactly 0) and its NaN-for-absent dense form."""
    rng = np.random.default_rng(seed)
    present = rng.random((rows, F)) < density
    vals = rng.uniform(-2, 2, (rows, F)).astype(np.float32)
    vals[vals == 0] = 0.5
    r, f = np.nonzero(present)
    dense = np.where(present, vals, np.nan).astype(np.float32)
    return (r.astype(np.int32), f.astype(np.int32), vals[r, f], dense)


def _batches(rid, idx, val, label, weight=None, qid=None, rows=None):
    """The same CSR batch (with PAD padding lanes) for both packages."""
    rows = len(label) if rows is None else rows
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(
        rid, minlength=rows))]).astype(np.int32)
    index = np.pad(idx, (0, PAD)).astype(np.int32)
    value = np.pad(val, (0, PAD)).astype(np.float32)
    weight = (np.ones(rows, np.float32) if weight is None
              else np.asarray(weight, np.float32))
    label = np.asarray(label, np.float32)
    jb = JaxBatch(label=jnp.asarray(label), weight=jnp.asarray(weight),
                  row_ptr=jnp.asarray(row_ptr), index=jnp.asarray(index),
                  value=jnp.asarray(value),
                  num_rows=jnp.asarray(np.int32(rows)),
                  qid=None if qid is None else jnp.asarray(qid))
    tb = PaddedBatch(label=torch.from_numpy(label),
                     weight=torch.from_numpy(weight),
                     row_ptr=torch.from_numpy(row_ptr),
                     index=torch.from_numpy(index),
                     value=torch.from_numpy(value), num_rows=rows,
                     qid=None if qid is None else torch.from_numpy(qid))
    return jb, tb


def _rule(dense, f=0, thr=0.3):
    """tests/test_gbdt.py:378's label: missing -> 1, else x_f > thr."""
    return np.where(np.isnan(dense[:, f]), 1.0,
                    dense[:, f] > thr).astype(np.float32)


def _case_logistic():
    rid, idx, val, dense = _coo(40, 200, 4)
    return (rid, idx, val, dense), dict(label=_rule(dense)), dict(
        num_features=4, num_trees=2, max_depth=3, num_bins=8,
        learning_rate=0.5)


def _case_squared():
    rid, idx, val, dense = _coo(2041, 300, 3)
    y = (np.where(np.isnan(dense[:, 0]), 2.0, np.sin(2 * dense[:, 0]))
         + 0.5 * np.nan_to_num(dense[:, 1])).astype(np.float32)
    return (rid, idx, val, dense), dict(label=y), dict(
        num_features=3, num_trees=3, max_depth=3, num_bins=16,
        learning_rate=0.5, objective="squared")


def _case_softmax():
    rid, idx, val, dense = _coo(1042, 300, 4, density=0.5)
    x = np.nan_to_num(dense, nan=-3.0)
    y = np.where(x[:, 0] + x[:, 1] > 0.4, 2,
                 np.where(x[:, 2] > 0, 1, 0)).astype(np.float32)
    return (rid, idx, val, dense), dict(label=y), dict(
        num_features=4, num_trees=2, max_depth=3, num_bins=16,
        learning_rate=0.4, objective="softmax", num_class=3)


def _case_rank():
    rows_per_q, n_q = 10, 24
    rid, idx, val, dense = _coo(43, rows_per_q * n_q, 4, density=0.6)
    rng = np.random.default_rng(43)
    qid = np.repeat(np.arange(n_q), rows_per_q).astype(np.int32)
    x = np.nan_to_num(dense, nan=-1.0)
    y = (x[:, 0] + 0.8 * x[:, 1] ** 2
         + np.repeat(rng.uniform(-5, 5, n_q), rows_per_q)).astype(np.float32)
    return (rid, idx, val, dense), dict(label=y, qid=qid), dict(
        num_features=4, num_trees=3, max_depth=3, num_bins=16,
        learning_rate=0.3, objective="rank:pairwise")


def _case_monotone():
    rid, idx, val, dense = _coo(44, 400, 3, density=0.7)
    rng = np.random.default_rng(44)
    x = np.nan_to_num(dense)
    m = 2.0 * x[:, 0] + 0.5 * np.sin(4 * x[:, 1])
    y = (m + rng.normal(0, 0.6, 400) > 0).astype(np.float32)
    return (rid, idx, val, dense), dict(label=y), dict(
        num_features=3, num_trees=3, max_depth=3, num_bins=16,
        learning_rate=0.3, monotone_constraints=[1, 0, -1])


def _case_interaction():
    rid, idx, val, dense = _coo(45, 400, 4, density=0.6)
    x = np.nan_to_num(dense)
    y = (((x[:, 0] > 0) ^ (x[:, 1] > 0)) & (x[:, 2] > -0.5)
         ).astype(np.float32)
    return (rid, idx, val, dense), dict(label=y), dict(
        num_features=4, num_trees=3, max_depth=3, num_bins=16,
        learning_rate=0.4, interaction_constraints=[[0, 1], [2, 3]])


def _case_zero_weight():
    rid, idx, val, dense = _coo(46, 300, 3)
    y = _rule(dense, f=1, thr=-0.2)
    rng = np.random.default_rng(46)
    w = np.where(np.arange(300) < 220, 1.0, 0.0).astype(np.float32)
    y[220:] = rng.integers(0, 2, 80)
    return (rid, idx, val, dense), dict(label=y, weight=w), dict(
        num_features=3, num_trees=3, max_depth=3, num_bins=16,
        learning_rate=0.5)


def _case_early_stopping():
    rid, idx, val, dense = _coo(47, 150, 4)
    rng = np.random.default_rng(47)
    y = (_rule(dense).astype(bool) ^ (rng.random(150) < 0.25)).astype(
        np.float32)
    ev = _coo(48, 300, 4)
    return (rid, idx, val, dense), dict(
        label=y, eval=ev, eval_label=_rule(ev[3]),
        early_stopping_rounds=2), dict(
        num_features=4, num_trees=12, max_depth=4, num_bins=16,
        learning_rate=0.8, lambda_=0.0, min_child_weight=1e-6)


FIT_CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_logistic, _case_squared, _case_softmax, _case_rank,
    _case_monotone, _case_interaction, _case_zero_weight,
    _case_early_stopping)}


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """(jax batch, port batch, jax eval, port eval, model kw, jax binner
    cuts, fit kw) of a case; cuts from the JAX binner's fit_sparse."""
    (rid, idx, val, dense), fit, model_kw = FIT_CASES[name]()
    jb, tb = _batches(rid, idx, val, fit["label"], fit.get("weight"),
                      fit.get("qid"))
    je = te = None
    if "eval" in fit:
        e_rid, e_idx, e_val, _ = fit["eval"]
        je, te = _batches(e_rid, e_idx, e_val, fit["eval_label"])
    cuts = np.asarray(JaxBinner(num_bins=model_kw["num_bins"],
                                missing_aware=True).fit_sparse(
        idx, val, model_kw["num_features"]).cuts)
    return jb, tb, je, te, model_kw, cuts, fit


def _jax_binner(cuts, num_bins):
    b = JaxBinner(num_bins=num_bins, missing_aware=True)
    b.cuts = jnp.asarray(cuts)
    return b


@functools.lru_cache(maxsize=None)
def _jax_forest(name, histogram="xla"):
    jb, _, je, _, model_kw, cuts, fit = _inputs(name)
    kw = {}
    if je is not None:
        kw = dict(eval_set=je,
                  early_stopping_rounds=fit["early_stopping_rounds"])
    forest = JaxGBDT(histogram=histogram, missing_aware=True,
                     **model_kw).fit_batch(
        jb, _jax_binner(cuts, model_kw["num_bins"]), **kw)
    return {k: np.asarray(v) for k, v in forest.items()}


def _port_fit(name, histogram):
    _, tb, _, te, model_kw, cuts, fit = _inputs(name)
    binner = QuantileBinner.from_cuts(cuts, model_kw["num_bins"],
                                      missing_aware=True, device="cpu")
    kw = {}
    if te is not None:
        kw = dict(eval_set=te,
                  early_stopping_rounds=fit["early_stopping_rounds"])
    return GBDT(histogram=histogram, missing_aware=True, device="cpu",
                **model_kw).fit_batch(tb, binner, **kw)


def _assert_forest_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in EXACT:
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in CLOSE:
        assert got[k].dtype == torch.float32, k
        assert tuple(got[k].shape) == want[k].shape, k
        tol = dict(FOREST_TOL)
        if k == "split_gain":
            tol["atol"] = 4 * 2.0 ** -23 * float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **tol)


# ---- the binner -----------------------------------------------------------------

@pytest.mark.parametrize("num_bins", [8, 256])
def test_fit_sparse_cuts_digest_and_codes_equal(num_bins):
    rid, idx, val, _ = _coo(1, 500, 6)
    val = val.copy()
    val[::37] = np.nan  # NaN entries: excluded from cuts, binned as 0
    F = 8               # two trailing features with no entries
    jb = JaxBinner(num_bins=num_bins, missing_aware=True).fit_sparse(
        idx, val, F)
    tb = QuantileBinner(num_bins=num_bins, missing_aware=True,
                        device="cpu").fit_sparse(idx, val, F)
    np.testing.assert_array_equal(tb.cuts.numpy(), np.asarray(jb.cuts))
    assert tb.cuts_digest() == jb.cuts_digest()
    # unseen values, including ones outside the sample's range
    v2 = np.concatenate([val * 3, [np.nan, -9.0, 9.0]]).astype(np.float32)
    i2 = np.concatenate([idx, [0, 7, 5]]).astype(np.int32)
    got = tb.transform_entries(torch.from_numpy(i2), torch.from_numpy(v2))
    want = np.asarray(jb.transform_entries(jnp.asarray(i2), jnp.asarray(v2)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[np.isnan(v2)] == 0).all()
    assert (got.numpy()[~np.isnan(v2)] >= 1).all()


def test_partial_fit_sparse_and_finalize_equal():
    """Chunks past the reservoir size (so the seeded hypergeometric merge
    runs), malformed entries dropped, then finalize: the JAX cuts."""
    rid, idx, val, _ = _coo(2, 900, 5, density=0.5)
    idx = idx.copy()
    idx[::50] = 9  # outside [0, num_features): dropped
    jb = JaxBinner(num_bins=16, missing_aware=True, sketch_size=64,
                   sketch_seed=5)
    tb = QuantileBinner(num_bins=16, missing_aware=True, sketch_size=64,
                        sketch_seed=5, device="cpu")
    for ci, cv in zip(np.array_split(idx, 7), np.array_split(val, 7)):
        jb.partial_fit_sparse(ci, cv, 5)
        tb.partial_fit_sparse(ci, cv, 5)
    jb.finalize()
    tb.finalize()
    np.testing.assert_array_equal(tb.cuts.numpy(), np.asarray(jb.cuts))
    assert tb.cuts_digest() == jb.cuts_digest()


def test_sparse_binner_refusals_match_jax():
    jb, tb = JaxBinner(num_bins=8), QuantileBinner(num_bins=8, device="cpu")
    for fn in ("fit_sparse", "partial_fit_sparse"):
        with pytest.raises(ValueError, match="missing_aware"):
            getattr(jb, fn)(np.zeros(2), np.ones(2), 1)
        with pytest.raises(ValueError, match="missing_aware"):
            getattr(tb, fn)(np.zeros(2), np.ones(2), 1)
    with pytest.raises(ValueError, match="missing_aware"):
        tb.transform_entries(torch.zeros(1), torch.zeros(1))
    with pytest.raises(RuntimeError, match="before fit"):
        QuantileBinner(num_bins=8, missing_aware=True,
                       device="cpu").transform_entries(torch.zeros(1),
                                                       torch.zeros(1))


def test_csr_to_dense_missing_matches_jax():
    rid, idx, val, dense = _coo(3, 50, 6)
    # a stored zero reads as missing; out-of-range entries are dropped
    rid = np.concatenate([rid, [0, 60, 1]]).astype(np.int32)
    idx = np.concatenate([idx, [1, 2, 9]]).astype(np.int32)
    val = np.concatenate([val, [0.0, 1.0, 1.0]]).astype(np.float32)
    want = np.asarray(jax_csr_to_dense_missing(
        jnp.asarray(idx), jnp.asarray(val), jnp.asarray(rid), 50, 6))
    got = csr_to_dense_missing(torch.from_numpy(idx), torch.from_numpy(val),
                               torch.from_numpy(rid), 50, 6)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)  # NaNs in place too


# ---- forest parity --------------------------------------------------------------

@pytest.mark.parametrize("histogram", ["xla", "pallas"])
@pytest.mark.parametrize("name", sorted(FIT_CASES))
def test_fit_batch_forest_equals_jax(name, histogram):
    _assert_forest_equal(_port_fit(name, histogram), _jax_forest(name))


def test_fixtures_exercise_what_they_name():
    """The parity cases are not degenerate: missing values get a
    direction both ways, early stopping stops, softmax has K bases."""
    f = {n: _jax_forest(n) for n in ("logistic", "early_stopping",
                                     "softmax", "interaction")}
    d, real = f["logistic"]["default_right"], f["logistic"]["threshold"] < 8
    assert d[real].any() and not d[real].all()
    assert 1 <= int(f["early_stopping"]["trees_used"]) < 12
    assert f["softmax"]["base"].shape == (3,)
    assert (f["interaction"]["threshold"] < 16).sum() > 3


def test_fit_batch_plain_kernel_equals_jax_pallas():
    """tests/test_gbdt.py:1241's case: the JAX package's interpret-mode
    kernel fit and the port's kernel route (its plain version on the CPU)
    grow the same forest."""
    _assert_forest_equal(_port_fit("logistic", "pallas"),
                         _jax_forest("logistic", "pallas"))


def _row_batches(rid, idx, val, label, cuts):
    """The port batches of rows [0, cuts[0]), [cuts[0], cuts[1]), ...: a
    stream of the same rows."""
    out = []
    for r0, r1 in zip((0,) + cuts, cuts + (len(label),)):
        keep = (rid >= r0) & (rid < r1)
        out.append(_batches(rid[keep] - r0, idx[keep], val[keep],
                            label[r0:r1])[1])
    return out


# the settings that the one split finder carries for the three growers
THREE_GROWER_CASES = {
    "plain": {},
    "monotone": dict(monotone_constraints=[1, -1, 0, 0, 1]),
    "interaction": dict(interaction_constraints=[[0, 1], [2, 3, 4]]),
    "bylevel": dict(colsample_bylevel=0.6, seed=5),
    "early_stopping": dict(num_trees=12, eval=True),
}


@pytest.mark.parametrize("case", list(THREE_GROWER_CASES))
def test_sparse_forest_equals_dense_missing_aware_fit(case):
    """fit_batch on the CSR batch, fit_streamed over its rows in three
    batches and fit on its NaN-densified matrix grow the same forest and
    predict alike (tests/test_gbdt.py:367), under each setting the shared
    split finder carries: monotone and interaction constraints, a column
    draw a level, and a held-out set with early stopping."""
    kw = dict(THREE_GROWER_CASES[case])
    held_out = kw.pop("eval", False)
    rid, idx, val, dense = _coo(11, 512, 5)
    y = _rule(dense)
    _, tb = _batches(rid, idx, val, y)
    x = csr_to_dense_missing(tb.index, tb.value, tb.row_ids(), 512, 5)
    np.testing.assert_array_equal(x.numpy(), dense)
    binner = QuantileBinner(num_bins=16, missing_aware=True,
                            device="cpu").fit(x.numpy())
    model = GBDT(**{**dict(num_features=5, num_trees=3, max_depth=3,
                           num_bins=16, learning_rate=0.5,
                           missing_aware=True, device="cpu"), **kw})
    dense_kw = sparse_kw = {}
    if held_out:
        erid, eidx, evals, edense = _coo(12, 256, 5)
        ey = (_rule(edense).astype(bool)
              ^ (np.random.default_rng(12).random(256) < 0.2)).astype(
            np.float32)
        eb = _batches(erid, eidx, evals, ey)[1]
        ex = csr_to_dense_missing(eb.index, eb.value, eb.row_ids(), 256, 5)
        dense_kw = dict(eval_set=(binner.transform(ex), ey),
                        early_stopping_rounds=2)
        sparse_kw = dict(eval_set=eb, early_stopping_rounds=2)
    forests, histories = [], []
    for fit in (lambda: model.fit(binner.transform(x), y, **dense_kw),
                lambda: model.fit_batch(tb, binner, **sparse_kw),
                lambda: model.fit_streamed(
                    _row_batches(rid, idx, val, y, (200, 400)), binner,
                    **sparse_kw)):
        forests.append(fit())
        histories.append(model.eval_history)
    p_dense = forests[0]
    if held_out:
        assert 1 <= int(p_dense["trees_used"]) < 12
        assert len(histories[0]) < 12
    for p_sparse, history in zip(forests[1:], histories[1:]):
        for k in ("feature", "threshold", "default_right", "trees_used"):
            assert torch.equal(p_dense[k], p_sparse[k]), k
        np.testing.assert_allclose(p_dense["leaf"].numpy(),
                                   p_sparse["leaf"].numpy(), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(history, histories[0], rtol=1e-4)
    pred_d = model.predict(p_dense, binner.transform(x)).numpy()
    for p_sparse in forests[1:]:
        pred_s = model.predict_batch(p_sparse, tb, binner).numpy()
        np.testing.assert_allclose(pred_d, pred_s, rtol=1e-4, atol=1e-6)
        assert np.mean((pred_s > 0.5) == (y > 0.5)) > 0.9


# ---- prediction on a forest carried across ------------------------------------

@pytest.mark.parametrize("name", ["logistic", "squared", "softmax",
                                  "monotone"])
def test_batch_prediction_on_carried_forest(name):
    want_forest = _jax_forest(name)
    jb, tb, _, _, model_kw, cuts, _ = _inputs(name)
    jm = JaxGBDT(histogram="xla", missing_aware=True, **model_kw)
    tm = GBDT(missing_aware=True, device="cpu", **model_kw)
    forest = forest_from_numpy(want_forest, "cpu")
    jbin = _jax_binner(cuts, model_kw["num_bins"])
    tbin = QuantileBinner.from_cuts(cuts, model_kw["num_bins"],
                                    missing_aware=True, device="cpu")
    jf = {k: jnp.asarray(v) for k, v in want_forest.items()}
    # another batch: more rows, unseen values, a row with no entries
    rid, idx, val, _ = _coo(99, 77, model_kw["num_features"])
    jb2, tb2 = _batches(rid, idx, val * 1.5, np.zeros(78, np.float32),
                        rows=78)
    for j, t in ((jb, tb), (jb2, tb2)):
        if name == "softmax":
            np.testing.assert_allclose(
                tm.margins_multi_batch(forest, t, tbin).numpy(),
                np.asarray(jm.margins_multi_batch(jf, j, jbin)), **PRED_TOL)
        else:
            np.testing.assert_allclose(
                tm.margins_batch(forest, t, tbin).numpy(),
                np.asarray(jm.margins_batch(jf, j, jbin)), **PRED_TOL)
        np.testing.assert_allclose(tm.predict_batch(forest, t, tbin).numpy(),
                                   np.asarray(jm.predict_batch(jf, j, jbin)),
                                   **PRED_TOL)
        got = tm.predict_batch_bucketed(forest, t, tbin)
        assert got.shape[0] == t.batch_size
        np.testing.assert_allclose(
            got.numpy(),
            np.asarray(jm.predict_batch_bucketed(jf, j, jbin)), **PRED_TOL)
    if name != "softmax":  # margins_batch is the one-margin surface
        np.testing.assert_allclose(
            tm.margins_batch_bucketed(forest, tb2, tbin,
                                      row_bucket=128).numpy(),
            np.asarray(jm.margins_batch_bucketed(jf, jb2, jbin,
                                                 row_bucket=128)),
            **PRED_TOL)


# ---- what the port refuses, and its backend routing ---------------------------

def test_not_ported_options_raise():
    jb, tb, _, _, model_kw, cuts, _ = _inputs("logistic")
    binner = QuantileBinner.from_cuts(cuts, 8, missing_aware=True,
                                      device="cpu")
    model = GBDT(missing_aware=True, device="cpu", **model_kw)

    # pre-binned batches are taken, but not under another binner's cuts
    binned = BinnedBatch(
        label=tb.label, weight=tb.weight, row_ptr=tb.row_ptr,
        index=tb.index, ebin=binner.transform_entries(
            tb.index, tb.value).to(torch.uint8),
        emask=tb.value != 0, num_rows=tb.num_rows, cuts_digest="0" * 16)
    with pytest.raises(ValueError, match="cuts"):
        model.fit_batch(binned, binner)
    # histogram_mesh takes a mesh spec (the sharded fit is ported:
    # tests/test_torch_gbdt_mesh.py); anything else raises
    with pytest.raises(TypeError, match="not a mesh spec"):
        GBDT(num_features=4, histogram_mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="missing_aware"):
        GBDT(device="cpu", **model_kw).fit_batch(tb, binner)
    with pytest.raises(ValueError, match="missing_aware"):
        GBDT(device="cpu", **model_kw).predict_batch(
            model.init(), tb, binner)


def test_sparse_backend_routing_and_layout():
    """On the CPU "auto" is index_add and builds no layout; "pallas"
    builds one layout a fit and publishes its sort time."""
    m = GBDT(num_features=4, missing_aware=True, device="cpu")
    assert m._hist_impl(1) == "xla" and not m._any_kernel_level()
    p = GBDT(num_features=4, missing_aware=True, device="cpu",
             histogram="pallas")
    assert p._hist_impl(4096) == "pallas"
    assert p._any_kernel_level()
    assert not GBDT(num_features=4, device="cpu",
                    histogram="xla")._any_kernel_level()
    before = telemetry.counter_get("gbdt.entry_sort_us")
    layout = p._sparse_fit_layout(torch.tensor([0, 1]), torch.tensor([2, 0]),
                                  torch.tensor([1, 3]),
                                  torch.tensor([True, True]))
    assert telemetry.counter_get("gbdt.entry_sort_us") >= before
    assert layout.gkey.tolist() == [3, 2 * layout.nb + 1]
    assert m._sparse_fit_layout(None, None, None, None) is None
