"""The port's batch layout, sparse ops and models against the JAX package's,
on the same numpy inputs and the same numpy params (through
``params_from_numpy``).

Tolerance 2e-5 (atol = rtol), the JAX package's own tolerance between its
two reduction backends for these ops (tests/test_pallas.py): f32 sums
taken in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu.data.staging import PaddedBatch as JaxBatch
from dmlc_core_tpu.data.staging import bucket_pow2 as jax_bucket_pow2
from dmlc_core_tpu.data.staging import \
    pad_batch_to_bucket as jax_pad_batch_to_bucket
from dmlc_core_tpu.models import FactorizationMachine as JaxFM
from dmlc_core_tpu.models import SparseLinearModel as JaxLinear
from dmlc_core_tpu import ops as jax_ops
from dmlc_core_tpu_torch import ops
from dmlc_core_tpu_torch.data.staging import (PaddedBatch, bucket_pow2,
                                              pad_batch_to_bucket)
from dmlc_core_tpu_torch.models import (FactorizationMachine,
                                        SparseLinearModel, logistic_nll,
                                        params_from_numpy)

TOL = dict(rtol=2e-5, atol=2e-5)
F, K = 40, 4


def _np_batch(rows, seed, max_nnz=6, pad_rows=0, pad_nnz=0):
    """A ragged CSR batch (some empty rows) with optional padding rows and
    lanes, as numpy arrays."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max_nnz + 1, rows)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nnz = int(ptr[-1])
    label = (rng.random(rows) > 0.5).astype(np.float32)
    return {
        "label": np.pad(label, (0, pad_rows)),
        "weight": np.pad(np.ones(rows, np.float32), (0, pad_rows)),
        "row_ptr": np.concatenate([ptr, np.full(pad_rows, nnz, np.int32)]),
        "index": np.pad(rng.integers(0, F, nnz).astype(np.int32),
                        (0, pad_nnz)),
        "value": np.pad(rng.standard_normal(nnz).astype(np.float32),
                        (0, pad_nnz)),
        "num_rows": rows,
    }


def _jax(b):
    return JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()
                       if k != "num_rows"},
                    num_rows=jnp.int32(b["num_rows"]))


def _torch(b):
    return PaddedBatch(**{k: torch.from_numpy(v) for k, v in b.items()
                          if k != "num_rows"}, num_rows=b["num_rows"])


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal(F).astype(np.float32),
            "v": (0.3 * rng.standard_normal((F, K))).astype(np.float32),
            "b": np.float32(0.25)}


# ---- batch layout -------------------------------------------------------------

@pytest.mark.parametrize("pad_rows,pad_nnz", [(0, 0), (3, 5)])
def test_row_ids_match_jax(pad_rows, pad_nnz):
    b = _np_batch(20, seed=1, pad_rows=pad_rows, pad_nnz=pad_nnz)
    got = _torch(b).row_ids()
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(_jax(b).row_ids()))
    # sorted by row, and padding lanes land on the last row
    assert (np.diff(got.numpy()) >= 0).all()
    if pad_nnz:
        assert (got.numpy()[-pad_nnz:] == 19 + pad_rows).all()


def test_bucket_pow2_matches_jax():
    for n in range(0, 70):
        for lo, hi in ((1, None), (8, None), (1, 32), (16, 16)):
            assert bucket_pow2(n, lo, hi) == jax_bucket_pow2(n, lo, hi)


@pytest.mark.parametrize("row_bucket,nnz_bucket", [(None, None), (32, 128),
                                                   (2, 4)])
def test_pad_batch_to_bucket_matches_jax(row_bucket, nnz_bucket):
    b = _np_batch(11, seed=2)
    got = pad_batch_to_bucket(_torch(b), row_bucket, nnz_bucket)
    want = jax_pad_batch_to_bucket(_jax(b), row_bucket, nnz_bucket)
    for k in ("label", "weight", "row_ptr", "index", "value"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    assert got.num_rows == 11
    # already on-bucket: the batch itself comes back
    assert pad_batch_to_bucket(got, got.batch_size,
                               got.index.shape[0]) is got


# ---- sparse ops ---------------------------------------------------------------

@pytest.mark.parametrize("force", [None, "pallas"])
@pytest.mark.parametrize("op", ["csr_matvec", "csr_matmul",
                                "csr_row_sumsq_matmul"])
def test_csr_ops_match_jax(op, force):
    rng = np.random.default_rng(5)
    nnz, rows = 3000, 128
    idx = rng.integers(0, F, nnz).astype(np.int32)
    val = rng.standard_normal(nnz).astype(np.float32)
    rid = np.sort(rng.integers(0, rows, nnz)).astype(np.int32)
    dense = rng.standard_normal(F if op == "csr_matvec" else (F, K)
                                ).astype(np.float32)
    want = getattr(jax_ops, op)(*map(jnp.asarray, (dense, idx, val, rid)),
                                rows, force=force)
    got = getattr(ops, op)(*map(torch.from_numpy, (dense, idx, val, rid)),
                           rows, force=force)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gather_clamps_out_of_range_index_like_jax():
    w = np.arange(1, 6, dtype=np.float32)
    idx = np.array([0, 4, 5, 9, -1, -7], np.int32)
    val = np.ones(6, np.float32)
    rid = np.arange(6, dtype=np.int32)
    want = jax_ops.csr_matvec(*map(jnp.asarray, (w, idx, val, rid)), 6)
    got = ops.csr_matvec(*map(torch.from_numpy, (w, idx, val, rid)), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_padded_row_mean_and_logistic_nll_match_jax():
    from dmlc_core_tpu.models.common import logistic_nll as jax_nll
    rng = np.random.default_rng(6)
    m = (10 * rng.standard_normal(50)).astype(np.float32)
    y = rng.choice([-1.0, 0.0, 1.0], 50).astype(np.float32)
    wt = (rng.random(50) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        logistic_nll(torch.from_numpy(m), torch.from_numpy(y)).numpy(),
        np.asarray(jax_nll(jnp.asarray(m), jnp.asarray(y))), **TOL)
    np.testing.assert_allclose(
        float(ops.padded_row_mean(torch.from_numpy(m), torch.from_numpy(wt))),
        float(jax_ops.padded_row_mean(jnp.asarray(m), jnp.asarray(wt))),
        **TOL)


# ---- models -------------------------------------------------------------------

MODEL_CASES = [("linear", "logistic", 0.0), ("linear", "squared", 0.1),
               ("fm", "logistic", 0.0), ("fm", "squared", 0.05)]


def _models(family, objective, l2, backend):
    cls = {"linear": (JaxLinear, SparseLinearModel),
           "fm": (JaxFM, FactorizationMachine)}[family]
    kw = dict(objective=objective, l2=l2, sdot_backend=backend)
    if family == "fm":
        kw["num_factors"] = K
    params = _params(3)
    if family == "linear":
        del params["v"]
    port = cls[1](F, device="cpu", **kw)
    port.load_state_dict(params_from_numpy(family, params, "cpu"))
    return cls[0](F, **kw), params, port


@pytest.mark.parametrize("backend", [None, "pallas"])
@pytest.mark.parametrize("family,objective,l2", MODEL_CASES)
def test_model_margins_predict_loss_match_jax(family, objective, l2,
                                              backend):
    jm, params, pm = _models(family, objective, l2, backend)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    b = _np_batch(24, seed=7, pad_rows=8, pad_nnz=10)
    jb, tb = _jax(b), _torch(b)
    np.testing.assert_allclose(pm.margins(tb).detach().numpy(),
                               np.asarray(jm.margins(jp, jb)), **TOL)
    np.testing.assert_allclose(pm.predict(tb).detach().numpy(),
                               np.asarray(jm.predict(jp, jb)), **TOL)
    np.testing.assert_allclose(pm.loss(tb).item(), float(jm.loss(jp, jb)),
                               **TOL)
    # the bucketed predict slices back to the real rows, unchanged
    unpadded = _torch(_np_batch(24, seed=7))
    np.testing.assert_allclose(
        pm.predict_bucketed(unpadded).detach().numpy(),
        np.asarray(jm.predict_bucketed(jp, _jax(_np_batch(24, seed=7)))),
        **TOL)


@pytest.mark.parametrize("backend", [None, "pallas"])
def test_fm_loss_gradients_match_jax(backend):
    """Gradients flow through the kernel's autograd Function as through
    the JAX custom VJP."""
    jm, params, pm = _models("fm", "logistic", 0.01, backend)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    b = _np_batch(32, seed=8, pad_rows=0, pad_nnz=6)
    want = jax.grad(jm.loss)(jp, _jax(b))
    pm.loss(_torch(b)).backward()
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]),
                                   **TOL, err_msg=name)


def test_params_from_numpy_validates_and_copies():
    p = _params(1)
    state = params_from_numpy("fm", p, "cpu")
    assert state["b"].dim() == 0 and state["v"].shape == (F, K)
    state["w"][0] = 123.0
    assert p["w"][0] != 123.0  # a copy, not a view
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy("linear", p, "cpu")
    with pytest.raises(ValueError, match="family"):
        params_from_numpy("gbdt", p, "cpu")


def test_fm_init_is_seeded_and_scaled():
    a = FactorizationMachine(F, num_factors=K, device="cpu").init(seed=3)
    b = FactorizationMachine(F, num_factors=K, device="cpu").init(seed=3)
    c = FactorizationMachine(F, num_factors=K, device="cpu").init(seed=4)
    assert torch.equal(a.v, b.v) and not torch.equal(a.v, c.v)
    assert not a.w.any() and a.b.item() == 0.0
    assert 0.005 < a.v.detach().std().item() < 0.02  # init_scale 0.01


def test_models_reject_unknown_objective_and_backend():
    with pytest.raises(ValueError, match="objective"):
        SparseLinearModel(F, objective="hinge", device="cpu")
    with pytest.raises(ValueError, match="sdot_backend"):
        FactorizationMachine(F, sdot_backend="cuda", device="cpu")
