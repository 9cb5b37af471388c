"""The port's training slice against the JAX package's, on the CPU: the
same generated libsvm file staged by both packages' ``DeviceStagingIter``,
the same numpy params (through ``params_from_numpy``), then

* 20 ``train_step``s of the linear model and the FM on both
  ``sdot_backend`` routes against the JAX package's jitted
  ``train_step``: every step's loss and the params after every step
  allclose at rtol 1e-5, atol 1e-6 (f32 sums and gradient scatters in
  another order);
* ``SparseLinearModel.evaluate`` equal at the same tolerance;
* ``GBDT.predict_staged`` on a small sparse forest carried across with
  ``forest_from_numpy`` equal to the JAX package's within 2e-5
  (tests/test_pallas.py:134's prediction tolerance), row for row in file
  order.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu.data import DeviceStagingIter as JaxStagingIter
from dmlc_core_tpu.models import FactorizationMachine as JaxFM
from dmlc_core_tpu.models import SparseLinearModel as JaxLinear
from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
from dmlc_core_tpu.models.gbdt import QuantileBinner as JaxBinner
from dmlc_core_tpu_torch.data import DeviceStagingIter
from dmlc_core_tpu_torch.models import (GBDT, FactorizationMachine,
                                        QuantileBinner, SparseLinearModel,
                                        forest_from_numpy, logistic_nll,
                                        params_from_numpy)

TOL = dict(rtol=1e-5, atol=1e-6)
PRED_TOL = dict(rtol=2e-5, atol=2e-5)
F, K, STEPS = 200, 4, 20


@pytest.fixture(scope="module")
def train_file(tmp_path_factory):
    """600 Criteo-like rows: a few log-count fields and hashed categorical
    ones, labels from a planted linear model, values as %.9g."""
    rng = np.random.default_rng(60)
    w_true = rng.standard_normal(F)
    lines = []
    for _ in range(600):
        n = int(rng.integers(3, 10))
        idx = np.sort(rng.choice(F, n, replace=False))
        val = np.where(idx < 20, np.log1p(rng.integers(0, 100, n)),
                       1.0).astype(np.float32)
        p = 1.0 / (1.0 + np.exp(-(w_true[idx] * val).sum() + 0.3))
        y = int(rng.random() < p)
        lines.append(f"{y} " + " ".join(f"{i}:{v:.9g}"
                                         for i, v in zip(idx, val)))
    path = tmp_path_factory.mktemp("train") / "train.libsvm"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _params(family, seed):
    rng = np.random.default_rng(seed)
    p = {"w": (0.1 * rng.standard_normal(F)).astype(np.float32),
         "b": np.float32(0.2)}
    if family == "fm":
        p["v"] = (0.1 * rng.standard_normal((F, K))).astype(np.float32)
    if family == "linear-zero":
        p = {"w": np.zeros(F, np.float32), "b": np.float32(0.0)}
    return p


def _models(family, backend):
    kw = dict(num_features=F, sdot_backend=backend, l2=1e-3)
    if family == "fm":
        return (JaxFM(num_factors=K, **kw),
                FactorizationMachine(num_factors=K, device="cpu", **kw))
    return JaxLinear(**kw), SparseLinearModel(device="cpu", **kw)


def _steps(it, n):
    """n batches, cycling over epochs."""
    out = []
    while len(out) < n:
        out.extend(it)
    return out[:n]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("family", ["linear", "linear-zero", "fm"])
def test_train_step_trajectory_equals_jax(train_file, family, backend):
    kw = dict(batch_size=64, nnz_bucket=256)
    jbatches = _steps(JaxStagingIter(train_file, **kw), STEPS)
    tbatches = _steps(DeviceStagingIter(train_file, device="cpu", **kw),
                      STEPS)
    params_np = _params(family, 61)
    jm, tm = _models(family, backend)
    tm.load_state_dict(params_from_numpy(
        "fm" if family == "fm" else "linear", params_np, "cpu"))
    jp = {k: jnp.asarray(v) for k, v in params_np.items()}
    for step, (jb, tb) in enumerate(zip(jbatches, tbatches)):
        jp, jloss = jm.train_step(jp, jb)
        tloss = tm.train_step(tb)
        assert not tloss.requires_grad
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   err_msg=f"loss, step {step}", **TOL)
        for k, v in tm.state_dict().items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jp[k]),
                                       err_msg=f"{k}, step {step}", **TOL)
        assert all(p.grad is None for p in tm.parameters())
    # the trajectory moved: the loss fell from the start
    first = float(tm.loss(tbatches[0]).detach())
    assert first < float(jm.loss({k: jnp.asarray(v) for k, v in
                                  params_np.items()}, jbatches[0]))


def test_zero_margin_gradient_equals_jax():
    """At a zero margin the loss's slope is the JAX package's, -y (JAX's
    ``maximum`` splits its slope at the tie and its ``abs`` takes +1), so
    a linear model trained from its zero init follows the reference."""
    m = torch.tensor([0.0, 0.0, 0.0, 0.0, -1.5, 2.0], requires_grad=True)
    y = torch.tensor([0.0, 1.0, 1.0, 0.0, 1.0, 0.0])
    logistic_nll(m, y).sum().backward()
    yj = jnp.asarray(y.numpy())
    want = jax.grad(lambda a: jnp.sum(
        jnp.maximum(a, 0) - a * yj
        + jnp.log1p(jnp.exp(-jnp.abs(a)))))(jnp.asarray(m.detach().numpy()))
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_array_equal(m.grad.numpy()[:4], [0.0, -1.0, -1.0, 0.0])


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_linear_evaluate_equals_jax(train_file, backend):
    params_np = _params("linear", 62)
    jm, tm = _models("linear", backend)
    tm.load_state_dict(params_from_numpy("linear", params_np, "cpu"))
    kw = dict(batch_size=128, nnz_bucket=512)
    want = jm.evaluate({k: jnp.asarray(v) for k, v in params_np.items()},
                       JaxStagingIter(train_file, **kw))
    got = tm.evaluate(DeviceStagingIter(train_file, device="cpu", **kw))
    assert sorted(got) == sorted(want) == ["accuracy", "loss"]
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), err_msg=k, **TOL)
    assert not hasattr(FactorizationMachine, "evaluate")  # as the JAX FM


# ---- predict_staged -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sparse_forest():
    """A JAX-trained missing-aware forest on the file's rows and its
    binner's cuts, as numpy."""
    rng = np.random.default_rng(63)
    rows, nf = 300, 6
    present = rng.random((rows, nf)) < 0.5
    vals = rng.uniform(-2, 2, (rows, nf)).astype(np.float32)
    vals[vals == 0] = 0.5
    r, f = np.nonzero(present)
    idx, val = f.astype(np.int32), vals[r, f]
    y = (np.where(present, vals, 0.0)[:, 0] > 0.2).astype(np.float32)
    from dmlc_core_tpu.data.staging import PaddedBatch as JaxBatch
    row_ptr = np.concatenate([[0], np.cumsum(present.sum(1))]).astype(
        np.int32)
    jb = JaxBatch(label=jnp.asarray(y), weight=jnp.ones(rows),
                  row_ptr=jnp.asarray(row_ptr), index=jnp.asarray(idx),
                  value=jnp.asarray(val), num_rows=jnp.asarray(np.int32(rows)))
    binner = JaxBinner(num_bins=16, missing_aware=True).fit_sparse(idx, val,
                                                                   nf)
    kw = dict(num_features=nf, num_trees=3, max_depth=3, num_bins=16,
              learning_rate=0.5, missing_aware=True)
    forest = JaxGBDT(histogram="xla", **kw).fit_batch(jb, binner)
    return ({k: np.asarray(v) for k, v in forest.items()},
            np.asarray(binner.cuts), kw)


@pytest.mark.parametrize("batch_size", [64, 1000])
def test_predict_staged_equals_jax(tmp_path, batch_size):
    forest_np, cuts, kw = _sparse_forest()
    rng = np.random.default_rng(64)
    lines = []
    for _ in range(250):
        n = int(rng.integers(0, 6))
        idx = np.sort(rng.choice(6, n, replace=False))
        val = rng.uniform(-2, 2, n).astype(np.float32)
        lines.append(f"{int(rng.integers(0, 2))} " + " ".join(
            f"{i}:{v:.9g}" for i, v in zip(idx, val)))
    path = tmp_path / "score.libsvm"
    path.write_text("\n".join(lines) + "\n")
    jbinner = JaxBinner(num_bins=16, missing_aware=True)
    jbinner.cuts = jnp.asarray(cuts)
    want = JaxGBDT(**kw).predict_staged(
        {k: jnp.asarray(v) for k, v in forest_np.items()}, str(path),
        jbinner, batch_size=batch_size, nnz_bucket=64)
    model = GBDT(device="cpu", **kw)
    binner = QuantileBinner.from_cuts(cuts, 16, missing_aware=True,
                                      device="cpu")
    got = model.predict_staged(forest_from_numpy(forest_np, "cpu"),
                               str(path), binner, batch_size=batch_size,
                               nnz_bucket=64)
    assert isinstance(got, np.ndarray) and got.shape == (250,)
    np.testing.assert_allclose(got, np.asarray(want), **PRED_TOL)


def test_predict_staged_refuses_sharding(tmp_path):
    forest_np, cuts, kw = _sparse_forest()
    model = GBDT(device="cpu", **kw)
    binner = QuantileBinner.from_cuts(cuts, 16, missing_aware=True,
                                      device="cpu")
    with pytest.raises(ValueError, match="single-host"):
        model.predict_staged(forest_from_numpy(forest_np, "cpu"),
                             str(tmp_path / "any.libsvm"), binner,
                             sharding=object())
