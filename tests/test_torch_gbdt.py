"""The port's histogram GBDT (dmlc_core_tpu_torch.models.gbdt) against the
JAX package's, on the same numpy inputs, on the CPU.

* Binner: cut points, codes and ``cuts_digest`` equal exactly (the sketch
  is the same numpy code with the same seed).
* Forests: the JAX package fits with ``histogram="xla"``; the port fits on
  both of its backends ("xla": index_add; "pallas": the kernel's plain
  version on CPU tensors).  ``feature``, ``threshold``, ``default_right``
  and ``trees_used`` must be equal; ``leaf``, ``split_cover`` and ``base``
  allclose at rtol 1e-5, atol 1e-6 (f32 sums in another order; the fixtures
  keep their split gains clear of near-ties, as tests/test_pallas.py's
  forest-identity fixture does).  ``split_gain`` at rtol 1e-5 and an atol
  of 4 f32 ulps of the forest's largest gain: a gain is a difference of
  terms ``G^2/(H+lambda)`` of about that size, so a histogram summed in
  another order (the plain version's blocked product) moves it by ulps of
  those terms, not of itself.
* Prediction: a JAX-trained forest carried across with
  ``forest_from_numpy`` gives the same margins, predictions, losses and
  importances within 2e-5 (the tolerance of tests/test_pallas.py:134).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
from dmlc_core_tpu.models.gbdt import QuantileBinner as JaxBinner
from dmlc_core_tpu_torch.models import (GBDT, QuantileBinner,
                                        forest_from_numpy, params_from_numpy)

EXACT = ("feature", "threshold", "default_right", "trees_used")
CLOSE = ("leaf", "split_gain", "split_cover", "base")
FOREST_TOL = dict(rtol=1e-5, atol=1e-6)
PRED_TOL = dict(rtol=2e-5, atol=2e-5)


# ---- the binner ---------------------------------------------------------------

def _dense(seed, rows=600, F=4, nan_frac=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, F)).astype(np.float32)
    x[:, 1] = np.round(x[:, 1] * 2)  # a feature with heavy ties
    if nan_frac:
        x[rng.random(x.shape) < nan_frac] = np.nan
        x[:, 3] = np.nan  # a fully-missing feature
    return x


@pytest.mark.parametrize("num_bins,missing_aware", [(16, False), (256, False),
                                                    (32, True)])
def test_binner_cuts_codes_and_digest_equal(num_bins, missing_aware):
    x = _dense(1, nan_frac=0.1 if missing_aware else 0.0)
    jb = JaxBinner(num_bins=num_bins, missing_aware=missing_aware)
    tb = QuantileBinner(num_bins=num_bins, missing_aware=missing_aware,
                        device="cpu")
    want = np.asarray(jb.fit_transform(x))
    got = tb.fit_transform(x)
    np.testing.assert_array_equal(tb.cuts.numpy(), np.asarray(jb.cuts))
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert tb.cuts_digest() == jb.cuts_digest()
    # unseen values, including ones outside the sample's range
    x2 = _dense(2, nan_frac=0.1 if missing_aware else 0.0) * 3
    np.testing.assert_array_equal(tb.transform(torch.from_numpy(x2)).numpy(),
                                  np.asarray(jb.transform(jnp.asarray(x2))))


@pytest.mark.parametrize("missing_aware", [False, True])
def test_binner_streaming_sketch_equal(missing_aware):
    """partial_fit over chunks past the reservoir size (so the seeded
    hypergeometric merge runs) and finalize give the JAX package's cuts."""
    x = _dense(3, rows=900, nan_frac=0.05 if missing_aware else 0.0)
    jb = JaxBinner(num_bins=16, missing_aware=missing_aware, sketch_size=64,
                   sketch_seed=5)
    tb = QuantileBinner(num_bins=16, missing_aware=missing_aware,
                        sketch_size=64, sketch_seed=5, device="cpu")
    for chunk in np.array_split(x, 7):
        jb.partial_fit(chunk)
        tb.partial_fit(chunk)
    jb.finalize()
    tb.finalize()
    np.testing.assert_array_equal(tb.cuts.numpy(), np.asarray(jb.cuts))
    assert tb.cuts_digest() == jb.cuts_digest()
    with pytest.raises(RuntimeError, match="finalize"):
        QuantileBinner(device="cpu").finalize()


def test_binner_validation_matches_jax():
    for kw in (dict(num_bins=1), dict(num_bins=300),
               dict(num_bins=2, missing_aware=True),
               dict(num_bins=64, sketch_size=8)):
        with pytest.raises(ValueError):
            JaxBinner(**kw)
        with pytest.raises(ValueError):
            QuantileBinner(device="cpu", **kw)
    with pytest.raises(ValueError, match="missing_aware"):
        QuantileBinner(device="cpu").fit(_dense(0, nan_frac=0.1))
    with pytest.raises(RuntimeError, match="before fit"):
        QuantileBinner(device="cpu").transform(torch.zeros(2, 2))
    b = QuantileBinner.from_cuts(np.asarray(JaxBinner(num_bins=8).fit(
        _dense(4)).cuts), num_bins=8, device="cpu")
    assert b.cuts.dtype == torch.float32 and tuple(b.cuts.shape) == (4, 7)


# ---- forest parity ------------------------------------------------------------

def _xor_data(seed, rows, F):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(rows, F)).astype(np.float32)
    y = ((x[:, 0] > 0) ^ (x[:, 1] > 0.3)).astype(np.float32)
    return x, y


def _case_near_tie_free():
    # tests/test_pallas.py:247-266's fixture
    rng = np.random.default_rng(11)
    x = rng.standard_normal((160, 4)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 2] > 0).astype(np.float32)
    return x, dict(label=y), dict(num_features=4, num_trees=3, max_depth=3,
                                  num_bins=8, learning_rate=0.5, seed=0), {}


def _case_squared():
    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, size=(400, 3)).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) + x[:, 1] ** 2).astype(np.float32)
    return x, dict(label=y), dict(num_features=3, num_trees=4, max_depth=3,
                                  num_bins=16, learning_rate=0.5,
                                  objective="squared"), {}


def _case_missing_aware():
    rng = np.random.default_rng(13)
    x = rng.uniform(-1, 1, size=(500, 3)).astype(np.float32)
    y = ((x[:, 0] > 0.1) | (x[:, 2] < -0.5)).astype(np.float32)
    miss = rng.random(500) < 0.3
    x[miss, 0] = np.nan
    y[miss] = (rng.random(miss.sum()) < 0.8).astype(np.float32)
    return x, dict(label=y), dict(num_features=3, num_trees=3, max_depth=3,
                                  num_bins=16, learning_rate=0.5,
                                  missing_aware=True), dict(missing_aware=True)


def _case_monotone():
    rng = np.random.default_rng(24)
    x = rng.uniform(-1, 1, size=(500, 3)).astype(np.float32)
    m = 2.0 * x[:, 0] + 0.5 * np.sin(4 * x[:, 1])
    y = (m + rng.normal(0, 0.6, 500) > 0).astype(np.float32)
    return x, dict(label=y), dict(num_features=3, num_trees=4, max_depth=3,
                                  num_bins=16, learning_rate=0.3,
                                  monotone_constraints=[1, 0, -1]), {}


def _case_interaction():
    rng = np.random.default_rng(28)
    x = rng.uniform(-1, 1, size=(500, 4)).astype(np.float32)
    y = (((x[:, 0] > 0) ^ (x[:, 1] > 0)) & (x[:, 2] > -0.5)
         ).astype(np.float32)
    return x, dict(label=y), dict(num_features=4, num_trees=4, max_depth=3,
                                  num_bins=16, learning_rate=0.4,
                                  interaction_constraints=[[0, 1], [2, 3]]), {}


def _case_gamma():
    x, y = _xor_data(26, 500, 3)
    return x, dict(label=y), dict(num_features=3, num_trees=3, max_depth=4,
                                  num_bins=16, learning_rate=0.5,
                                  gamma=5.0), {}


def _case_softmax():
    rng = np.random.default_rng(19)
    x = rng.uniform(-1, 1, size=(500, 4)).astype(np.float32)
    y = np.where(x[:, 0] + x[:, 1] > 0.4, 2,
                 np.where(x[:, 0] * x[:, 2] > 0, 1, 0)).astype(np.float32)
    return x, dict(label=y), dict(num_features=4, num_trees=3, max_depth=3,
                                  num_bins=16, learning_rate=0.4,
                                  objective="softmax", num_class=3), {}


def _case_rank():
    rng = np.random.default_rng(21)
    rows_per_q, n_q = 10, 30
    n = rows_per_q * n_q
    x = rng.uniform(-1, 1, size=(n, 4)).astype(np.float32)
    qid = np.repeat(np.arange(n_q), rows_per_q).astype(np.int32)
    offs = np.repeat(rng.uniform(-5, 5, n_q), rows_per_q)
    rel = x[:, 0] + 0.8 * np.sign(x[:, 1]) * x[:, 1] ** 2
    y = (rel + offs).astype(np.float32)
    return x, dict(label=y, qid=qid), dict(num_features=4, num_trees=4,
                                           max_depth=3, num_bins=16,
                                           learning_rate=0.3,
                                           objective="rank:pairwise"), {}


def _case_zero_weight():
    x, y = _xor_data(3, 400, 2)
    rng = np.random.default_rng(30)
    x = np.concatenate([x, rng.uniform(-1, 1, (100, 2)).astype(np.float32)])
    y = np.concatenate([y, rng.integers(0, 2, 100).astype(np.float32)])
    w = np.concatenate([np.ones(400), np.zeros(100)]).astype(np.float32)
    return x, dict(label=y, weight=w), dict(num_features=2, num_trees=3,
                                            max_depth=3, num_bins=16,
                                            learning_rate=0.5), {}


def _case_early_stopping():
    rng = np.random.default_rng(16)
    x_tr = rng.uniform(-1, 1, size=(150, 4)).astype(np.float32)
    noise = rng.random(150) < 0.25
    y_tr = ((x_tr[:, 0] > 0) ^ noise).astype(np.float32)
    x_ev = rng.uniform(-1, 1, size=(400, 4)).astype(np.float32)
    y_ev = (x_ev[:, 0] > 0).astype(np.float32)
    return x_tr, dict(label=y_tr, eval_x=x_ev, eval_label=y_ev,
                      early_stopping_rounds=2), dict(
        num_features=4, num_trees=12, max_depth=4, num_bins=16,
        learning_rate=0.8, lambda_=0.0, min_child_weight=1e-6), {}


def _case_base_score_spw():
    rng = np.random.default_rng(31)
    x = rng.uniform(-1, 1, size=(500, 3)).astype(np.float32)
    y = (x[:, 0] + 0.3 * rng.standard_normal(500) > 0.9).astype(np.float32)
    return x, dict(label=y), dict(num_features=3, num_trees=3, max_depth=3,
                                  num_bins=16, learning_rate=0.3,
                                  base_score=0.3, scale_pos_weight=3.0), {}


FIT_CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_near_tie_free, _case_squared, _case_missing_aware, _case_monotone,
    _case_interaction, _case_gamma, _case_softmax, _case_rank,
    _case_zero_weight, _case_early_stopping, _case_base_score_spw)}


def _fit_args(name):
    """(x, fit kwargs as numpy, GBDT kwargs, binner kwargs, eval x)."""
    x, fit, model_kw, binner_kw = FIT_CASES[name]()
    fit = dict(fit)
    eval_x = fit.pop("eval_x", None)
    return x, fit, model_kw, binner_kw, eval_x


def _jax_fit_kwargs(fit, eval_bins):
    kw = {k: jnp.asarray(v) for k, v in fit.items()
          if k in ("label", "weight", "qid")}
    if eval_bins is not None:
        kw["eval_set"] = (eval_bins, jnp.asarray(fit["eval_label"]))
        kw["early_stopping_rounds"] = fit["early_stopping_rounds"]
    return kw


@functools.lru_cache(maxsize=None)
def _jax_forest(name):
    x, fit, model_kw, binner_kw, eval_x = _fit_args(name)
    binner = JaxBinner(num_bins=model_kw["num_bins"], **binner_kw).fit(x)
    bins = binner.transform(jnp.asarray(x))
    eval_bins = None if eval_x is None else binner.transform(
        jnp.asarray(eval_x))
    model = JaxGBDT(histogram="xla", **model_kw)
    forest = model.fit(bins, **_jax_fit_kwargs(fit, eval_bins))
    return ({k: np.asarray(v) for k, v in forest.items()},
            np.asarray(binner.cuts))


def _port_fit(name, histogram):
    x, fit, model_kw, binner_kw, eval_x = _fit_args(name)
    binner = QuantileBinner(num_bins=model_kw["num_bins"], device="cpu",
                            **binner_kw).fit(x)
    bins = binner.transform(x)
    kw = {k: v for k, v in fit.items() if k in ("label", "weight", "qid")}
    if eval_x is not None:
        kw["eval_set"] = (binner.transform(eval_x), fit["eval_label"])
        kw["early_stopping_rounds"] = fit["early_stopping_rounds"]
    model = GBDT(histogram=histogram, device="cpu", **model_kw)
    return model.fit(bins, **kw), binner


@pytest.mark.parametrize("histogram", ["xla", "pallas"])
@pytest.mark.parametrize("name", sorted(FIT_CASES))
def test_forest_equals_jax(name, histogram):
    want, cuts = _jax_forest(name)
    got, binner = _port_fit(name, histogram)
    np.testing.assert_array_equal(binner.cuts.numpy(), cuts)
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


def test_fixtures_exercise_what_they_name():
    """The parity cases are not degenerate: early stopping stops, gamma
    and the constraints bite, the missing bin gets a direction."""
    f = {n: _jax_forest(n)[0] for n in ("early_stopping", "gamma",
                                        "missing_aware", "softmax")}
    assert 1 <= int(f["early_stopping"]["trees_used"]) < 12
    thr = f["gamma"]["threshold"]
    assert 0 < (thr < 16).sum() < thr.size
    assert f["missing_aware"]["default_right"].any()
    assert f["softmax"]["base"].shape == (3,)


# ---- prediction on a forest carried across ------------------------------------

@pytest.mark.parametrize("name", ["missing_aware", "squared", "softmax",
                                  "monotone"])
def test_prediction_surface_on_carried_forest(name):
    want_forest, cuts = _jax_forest(name)
    x, fit, model_kw, binner_kw, _ = _fit_args(name)
    jm = JaxGBDT(histogram="xla", **model_kw)
    tm = GBDT(device="cpu", **model_kw)
    forest = forest_from_numpy(want_forest, "cpu")
    binner = QuantileBinner.from_cuts(cuts, model_kw["num_bins"],
                                      device="cpu", **binner_kw)
    x2 = np.concatenate([x, _dense(8, rows=77, F=x.shape[1]) * 2])
    jbins = JaxBinner(num_bins=model_kw["num_bins"], **binner_kw)
    jbins.cuts = jnp.asarray(cuts)
    jb = jbins.transform(jnp.asarray(x2))
    tb = binner.transform(x2)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    jf = {k: jnp.asarray(v) for k, v in want_forest.items()}
    if name == "softmax":
        np.testing.assert_allclose(tm.margins_multi(forest, tb).numpy(),
                                   np.asarray(jm.margins_multi(jf, jb)),
                                   **PRED_TOL)
    else:
        np.testing.assert_allclose(tm.margins(forest, tb).numpy(),
                                   np.asarray(jm.margins(jf, jb)), **PRED_TOL)
    np.testing.assert_allclose(tm.predict(forest, tb).numpy(),
                               np.asarray(jm.predict(jf, jb)), **PRED_TOL)
    np.testing.assert_allclose(
        tm.predict_bucketed(forest, tb[:50]).numpy(),
        np.asarray(jm.predict_bucketed(jf, jb[:50])), **PRED_TOL)
    label = fit["label"]
    np.testing.assert_allclose(
        float(tm.loss(forest, tb[:len(label)], label)),
        float(jm.loss(jf, jb[:len(label)], jnp.asarray(label))), **PRED_TOL)
    for kind in ("gain", "weight", "cover", "total_gain", "total_cover"):
        np.testing.assert_allclose(
            tm.feature_importance(forest, kind).numpy(),
            np.asarray(jm.feature_importance(jf, kind)), **PRED_TOL)


def test_rank_scores_and_pairwise_loss_on_carried_forest():
    want_forest, cuts = _jax_forest("rank")
    x, fit, model_kw, _, _ = _fit_args("rank")
    jm = JaxGBDT(histogram="xla", **model_kw)
    tm = GBDT(device="cpu", **model_kw)
    forest = params_from_numpy("gbdt", want_forest, "cpu")
    jb = JaxBinner(num_bins=16)
    jb.cuts = jnp.asarray(cuts)
    bins = np.asarray(jb.transform(jnp.asarray(x)))
    jf = {k: jnp.asarray(v) for k, v in want_forest.items()}
    np.testing.assert_allclose(tm.rank_scores(forest, bins).numpy(),
                               np.asarray(jm.rank_scores(jf, bins)),
                               **PRED_TOL)
    for f in (forest, tm.init()):
        jf_ = jf if f is forest else jm.init()
        np.testing.assert_allclose(
            float(tm.pairwise_loss(f, bins, fit["label"], fit["qid"])),
            float(jm.pairwise_loss(jf_, bins, jnp.asarray(fit["label"]),
                                   jnp.asarray(fit["qid"]))), **PRED_TOL)
    with pytest.raises(ValueError, match="contiguous"):
        tm.fit(bins, fit["label"], qid=np.random.default_rng(0).permutation(
            fit["qid"]))
    with pytest.raises(ValueError, match="qid"):
        tm.fit(bins, fit["label"])
    with pytest.raises(ValueError, match="pairwise_loss"):
        tm.loss(forest, bins, fit["label"])


def test_forest_from_numpy_keeps_dtypes():
    want, _ = _jax_forest("softmax")
    got = forest_from_numpy(want, "cpu")
    for k, v in want.items():
        assert got[k].dtype == getattr(torch, str(v.dtype)), k
        assert tuple(got[k].shape) == v.shape, k
    assert got["trees_used"].dim() == 0
    old = {k: v for k, v in want.items() if k in ("feature", "threshold",
                                                  "leaf", "base")}
    assert sorted(forest_from_numpy(old, "cpu")) == sorted(old)
    with pytest.raises(ValueError, match="missing"):
        forest_from_numpy({"feature": want["feature"]}, "cpu")
    with pytest.raises(ValueError, match="unknown"):
        forest_from_numpy({**want, "w": np.zeros(3)}, "cpu")


# ---- what the port refuses, and its backend routing ---------------------------

def test_histogram_mesh_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        GBDT(num_features=4, histogram_mesh=object(), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(objective="poisson"), dict(objective="softmax"),
    dict(num_class=3), dict(subsample=0.0), dict(colsample_bytree=1.5),
    dict(colsample_bylevel=0.0), dict(gamma=-1.0),
    dict(monotone_constraints=[1, 0]), dict(monotone_constraints=[0.5] * 4),
    dict(interaction_constraints=[[0, 9]]), dict(scale_pos_weight=0.0),
    dict(objective="squared", scale_pos_weight=2.0),
    dict(histogram="bogus")])
def test_invalid_arguments_raise_like_jax(kw):
    with pytest.raises(ValueError):
        JaxGBDT(num_features=4, **kw)
    with pytest.raises(ValueError):
        GBDT(num_features=4, device="cpu", **kw)


def test_histogram_backend_routing(monkeypatch):
    m = GBDT(num_features=3, device="cpu")
    assert m.histogram == "auto"
    assert m._hist_impl(1) == "xla"  # "auto" on the CPU: index_add
    assert GBDT(num_features=3, device="cpu",
                histogram="pallas")._hist_impl(1024) == "pallas"
    monkeypatch.setenv("DMLCTPU_GBDT_HISTOGRAM", "pallas")
    assert GBDT(num_features=3, device="cpu").histogram == "pallas"
    assert GBDT(num_features=3, device="cpu",
                histogram="xla").histogram == "xla"
    monkeypatch.setenv("DMLCTPU_GBDT_HISTOGRAM", "bogus")
    with pytest.raises(ValueError, match="histogram"):
        GBDT(num_features=3, device="cpu")


def test_softmax_labels_out_of_range_raise():
    x, fit, model_kw, _, _ = _fit_args("softmax")
    bins = QuantileBinner(num_bins=16, device="cpu").fit_transform(x)
    with pytest.raises(ValueError, match="softmax labels"):
        GBDT(device="cpu", **model_kw).fit(
            bins, np.where(fit["label"] == 2, 3, fit["label"]))
