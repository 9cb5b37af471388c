"""Data-parallel training steps of the port on 2 gloo ranks on the CPU,
against the JAX package's ``train_step`` on the concatenated global batch.

Each rank steps on its own batch (``batch.plan`` set, as
``DeviceStagingIter(sharding=...)`` stages it): the loss is normalised by
the weight of both ranks' rows, the gradients are all-reduced in one flat
buffer, and the l2 term is added once.  After each of three steps the
parameters and the loss are within 1e-6 relative of the JAX package's
(f32 sums in another order), and the two ranks' parameters are the same
bits.  The batches carry padding rows and non-unit weights, so the global
normaliser is what is tested.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from dmlc_core_tpu.data.staging import PaddedBatch as JaxBatch
from dmlc_core_tpu.models import FactorizationMachine as JaxFM
from dmlc_core_tpu.models import FieldAwareFactorizationMachine as JaxFFM
from dmlc_core_tpu.models import SparseLinearModel as JaxLinear
from torch_ranks import run_ranks

F, A, K, STEPS = 40, 3, 4, 3


def _batch(rows, seed, pad_rows):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 7, rows)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nnz = int(ptr[-1])
    return {
        "label": np.pad((rng.random(rows) > 0.5).astype(np.float32),
                        (0, pad_rows)),
        "weight": np.pad(rng.uniform(0.5, 2.0, rows).astype(np.float32),
                         (0, pad_rows)),
        "row_ptr": np.concatenate([ptr, np.full(pad_rows, nnz, np.int32)]),
        "index": rng.integers(0, F, nnz).astype(np.int32),
        "value": rng.standard_normal(nnz).astype(np.float32),
        "field": rng.integers(0, A, nnz).astype(np.int32),
        "num_rows": rows,
    }


def _concat(a, b):
    g = {k: np.concatenate([a[k], b[k]])
         for k in ("label", "weight", "index", "value", "field") if k in a}
    g["row_ptr"] = np.concatenate([a["row_ptr"][:-1],
                                   b["row_ptr"] + len(a["index"])])
    g["num_rows"] = a["num_rows"] + b["num_rows"]
    return g


def _case(family):
    rng = np.random.default_rng(9)
    params = {"w": rng.standard_normal(F).astype(np.float32),
              "b": np.float32(0.1)}
    kw = dict(num_features=F, learning_rate=0.3, l2=0.01,
              sdot_backend="pallas")
    if family == "fm":
        params["v"] = (0.3 * rng.standard_normal((F, K))).astype(np.float32)
        kw["num_factors"] = K
    if family == "ffm":
        params["v"] = (0.3 * rng.standard_normal((F, A, K))).astype(
            np.float32)
        kw.update(num_fields=A, num_factors=K)
    batches = [[_batch(17 + 5 * r, 10 * i + r, 3 * r) for i in range(STEPS)]
               for r in range(2)]
    if family != "ffm":
        for per_rank in batches:
            for b in per_rank:
                del b["field"]
    return params, kw, batches


@pytest.mark.parametrize("family", ["linear", "fm", "ffm"])
def test_two_rank_steps_equal_jax_global_steps(tmp_path, family):
    params, kw, batches = _case(family)
    res = run_ranks(2, "dp_steps", tmp_path, family=family, params=params,
                    batches=batches, kw=kw, steps=STEPS)
    jcls = {"linear": JaxLinear, "fm": JaxFM, "ffm": JaxFFM}[family]
    jkw = {k: v for k, v in kw.items() if k != "num_features"}
    jm = jcls(F, **jkw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    for i in range(STEPS):
        g = _concat(batches[0][i], batches[1][i])
        jb = JaxBatch(**{k: jnp.asarray(v) for k, v in g.items()
                         if k != "num_rows"},
                      num_rows=jnp.int32(g["num_rows"]))
        jp, loss = jm.train_step(jp, jb)
        for r in (0, 1):
            losses, states = res[r]
            np.testing.assert_allclose(losses[i], float(loss), rtol=1e-6)
            for k, v in states[i].items():
                want = np.asarray(jp[k])
                np.testing.assert_allclose(
                    v, want, rtol=1e-6,
                    atol=1e-6 * float(np.abs(want).max()), err_msg=k)
                np.testing.assert_array_equal(v, res[0][1][i][k])
