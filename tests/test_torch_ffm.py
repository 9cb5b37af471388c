"""The port's field-aware FM (``FieldAwareFactorizationMachine``) and the
field lane through serving, against the JAX package's, on the CPU.

* ``margins`` equal the JAX FFM's within 1e-5 * max(1, max |margin|) on
  both ``sdot_backend`` routes (padding lanes and out-of-range fields
  included), and a float64 pairwise oracle (the sum over entry pairs
  i < j of tests/test_models.py's) likewise.
* 20 ``train_step``s from the same numpy params over a libffm file staged
  by both packages' ``DeviceStagingIter(with_field=True)`` stay within
  1e-5 of the largest |param|, step by step.
* A DTSNAP01 ``ffm`` snapshot packed by the JAX package is served by the
  port's engine and ``ScoringServer(with_field=True, device="cpu")``
  within 1e-5 of the JAX engine's scores; the port packs the same bytes.
"""
import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu.data import DeviceStagingIter as JaxStagingIter
from dmlc_core_tpu.data.staging import PaddedBatch as JaxBatch
from dmlc_core_tpu.models import FieldAwareFactorizationMachine as JaxFFM
from dmlc_core_tpu.serving import ScoringEngine as JaxEngine
from dmlc_core_tpu.serving import ScoringIterator as JaxIterator
from dmlc_core_tpu.serving import pack_snapshot as jax_pack
from dmlc_core_tpu_torch.data import DeviceStagingIter, PaddedBatch
from dmlc_core_tpu_torch.models import (FieldAwareFactorizationMachine,
                                        params_from_numpy)
from dmlc_core_tpu_torch.serving import (ScoringEngine, ScoringIterator,
                                         ScoringServer, pack_snapshot,
                                         push_snapshot, snapshot_digest)

F, A, K = 40, 5, 3
STEPS = 20


def _params(seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal(F)).astype(np.float32),
            "v": (scale * rng.standard_normal((F, A, K))).astype(np.float32),
            "b": np.float32(0.2)}


def _rows(seed, n, max_nnz=7, bad_fields=False):
    """Request rows (index, value, field); with ``bad_fields`` some field
    ids lie outside [0, A) (the model clamps them)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(0, max_nnz + 1))
        lo, hi = (-2, A + 3) if bad_fields else (0, A)
        out.append((rng.integers(0, F, k).tolist(),
                    rng.uniform(-1.5, 1.5, k).astype(np.float32).tolist(),
                    rng.integers(lo, hi, k).tolist()))
    return out


def _batches(rows, pad=5):
    """The same CSR batch (``pad`` padding lanes) for both packages."""
    idx = np.asarray([i for r in rows for i in r[0]], np.int32)
    val = np.asarray([v for r in rows for v in r[1]], np.float32)
    fld = np.asarray([f for r in rows for f in r[2]], np.int32)
    ptr = np.cumsum([0] + [len(r[0]) for r in rows]).astype(np.int32)
    idx, val, fld = (np.pad(a, (0, pad)) for a in (idx, val, fld))
    B = len(rows)
    lab = (np.arange(B) % 2).astype(np.float32)
    w = np.ones(B, np.float32)
    jb = JaxBatch(label=jnp.asarray(lab), weight=jnp.asarray(w),
                  row_ptr=jnp.asarray(ptr), index=jnp.asarray(idx),
                  value=jnp.asarray(val), num_rows=jnp.int32(B),
                  field=jnp.asarray(fld))
    tb = PaddedBatch(label=torch.from_numpy(lab), weight=torch.from_numpy(w),
                     row_ptr=torch.from_numpy(ptr),
                     index=torch.from_numpy(idx),
                     value=torch.from_numpy(val), num_rows=B,
                     field=torch.from_numpy(fld))
    return jb, tb


def _pairwise64(p, rows):
    """float64 margins: b + w.x + sum over i < j of <v[f_i, fl_j],
    v[f_j, fl_i]> x_i x_j (fields clamped into [0, A))."""
    w, v = p["w"].astype(np.float64), p["v"].astype(np.float64)
    out = []
    for idx, val, fld in rows:
        fl = np.clip(fld, 0, A - 1)
        m = float(p["b"]) + sum(w[i] * x for i, x in zip(idx, val))
        for i in range(len(idx)):
            for j in range(i + 1, len(idx)):
                m += float(v[idx[i], fl[j]] @ v[idx[j], fl[i]]) \
                    * val[i] * val[j]
        out.append(m)
    return np.asarray(out)


def _port(params, backend):
    m = FieldAwareFactorizationMachine(F, A, num_factors=K,
                                       sdot_backend=backend, device="cpu")
    m.load_state_dict(params_from_numpy("ffm", params, "cpu"))
    return m


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("bad_fields", [False, True])
def test_margins_equal_jax_and_pairwise_oracle(backend, bad_fields):
    p = _params(1)
    rows = _rows(2, 24, bad_fields=bad_fields)
    jb, tb = _batches(rows)
    want = np.asarray(JaxFFM(F, A, num_factors=K, sdot_backend=backend)
                      .margins({k: jnp.asarray(v) for k, v in p.items()},
                               jb))
    with torch.no_grad():
        got = _port(p, backend).margins(tb).numpy()
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    oracle = _pairwise64(p, rows)
    np.testing.assert_allclose(got, oracle, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(oracle).max()))


def test_missing_fields_raise_as_in_jax():
    jb, tb = _batches(_rows(3, 4))
    tb.field = None
    with pytest.raises(ValueError, match="with_field=True"):
        _port(_params(1), None).margins(tb)
    with pytest.raises(ValueError, match="with_field=True"):
        JaxFFM(F, A).margins(JaxFFM(F, A).init(0), jb.__class__(
            **{**jb.__dict__, "field": None}))
    with pytest.raises(ValueError, match="num_fields"):
        FieldAwareFactorizationMachine(F, 0, device="cpu")


def test_init_params_and_keys():
    m = FieldAwareFactorizationMachine(F, A, num_factors=K,
                                       device="cpu").init(5)
    again = FieldAwareFactorizationMachine(F, A, num_factors=K,
                                           device="cpu").init(5)
    assert tuple(m.v.shape) == (F, A, K) and m.b.dim() == 0
    assert not m.w.detach().any() and not m.b.detach().any()
    assert torch.equal(m.v, again.v) and 0 < float(m.v.detach().std()) < 0.02
    with pytest.raises(ValueError, match="ffm params need keys"):
        params_from_numpy("ffm", {"w": np.zeros(F)}, "cpu")
    assert m._l2_terms()[1] is m.v


@pytest.fixture(scope="module")
def libffm_file(tmp_path_factory):
    """300 rows of libffm (field:index:value), labels from a planted
    linear model, values written with %.9g (f32 round-trips)."""
    rng = np.random.default_rng(70)
    w_true = rng.standard_normal(F)
    lines = []
    for _ in range(300):
        n = int(rng.integers(1, 8))
        idx = np.sort(rng.choice(F, n, replace=False))
        fld = rng.integers(0, A, n)
        val = rng.uniform(0.1, 2.0, n).astype(np.float32)
        y = int(rng.random() < 1 / (1 + np.exp(-(w_true[idx] * val).sum())))
        lines.append(f"{y} " + " ".join(
            f"{f}:{i}:{v:.9g}" for f, i, v in zip(fld, idx, val)))
    path = tmp_path_factory.mktemp("ffm") / "train.libffm"
    path.write_text("\n".join(lines) + "\n")
    return f"{path}?format=libfm"


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_train_step_trajectory_equals_jax(libffm_file, backend):
    kw = dict(batch_size=64, nnz_bucket=256, with_field=True)
    jb = list(JaxStagingIter(libffm_file, **kw))
    tb = list(DeviceStagingIter(libffm_file, device="cpu", **kw))
    jb, tb = (jb * 4)[:STEPS], (tb * 4)[:STEPS]
    assert all(b.field is not None for b in tb)
    p = _params(71, scale=0.1)
    jm = JaxFFM(F, A, num_factors=K, l2=1e-3, learning_rate=0.2,
                sdot_backend=backend)
    tm = FieldAwareFactorizationMachine(F, A, num_factors=K, l2=1e-3,
                                        learning_rate=0.2,
                                        sdot_backend=backend, device="cpu")
    tm.load_state_dict(params_from_numpy("ffm", p, "cpu"))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    first = None
    for step, (j, t) in enumerate(zip(jb, tb)):
        jp, jloss = jm.train_step(jp, j)
        tloss = float(tm.train_step(t))
        first = tloss if first is None else first
        np.testing.assert_allclose(tloss, float(jloss), rtol=1e-5, atol=1e-6,
                                   err_msg=f"loss, step {step}")
        for k, v in tm.state_dict().items():
            ref = np.asarray(jp[k])
            tol = 1e-5 * max(float(np.abs(ref).max()), 1e-30)
            np.testing.assert_allclose(v.numpy(), ref, rtol=0, atol=tol,
                                       err_msg=f"{k}, step {step}")
    assert float(tm.loss(tb[0]).detach()) < first


# ---- the field lane through serving -----------------------------------------

CFG = {"num_features": F, "num_fields": A, "num_factors": K,
       "sdot_backend": "pallas"}


def test_scoring_iterator_field_lane_equals_jax():
    rows = _rows(4, 9)
    it, jit = ScoringIterator(with_field=True, device="cpu"), \
        JaxIterator(with_field=True)
    for reqs in (rows, rows[:3], [(r[0], r[1]) for r in rows[:2]]):
        batch, n = it.pack(reqs)
        jbatch, jn = jit.pack(reqs)
        assert n == jn
        for k in ("label", "weight", "row_ptr", "index", "value", "field"):
            np.testing.assert_array_equal(getattr(batch, k).numpy(),
                                          np.asarray(getattr(jbatch, k)), k)
    assert ScoringIterator(device="cpu").pack(rows)[0].field is None


def test_snapshot_bytes_equal_and_jax_snapshot_served_by_port():
    p = _params(8)
    snap = jax_pack("ffm", CFG, p, seq=3)
    port = _port(p, "pallas")
    assert pack_snapshot("ffm", CFG, port.state_dict(), seq=3) == snap
    want_eng = JaxEngine.from_snapshot_bytes(snap)
    eng = ScoringEngine.from_snapshot_bytes(snap, device="cpu")
    assert eng.digest == want_eng.digest == snapshot_digest(snap)
    eng.warmup(((1, 8), (4, 3)))
    it, jit = ScoringIterator(with_field=True, device="cpu"), \
        JaxIterator(with_field=True)
    for n, seed in ((1, 0), (6, 1), (40, 2)):
        reqs = _rows(seed, n)
        got = eng.score(it.pack(reqs)[0])
        want = want_eng.score(jit.pack(reqs)[0])
        assert got.shape == (n,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with ScoringServer(with_field=True, max_delay_us=200,
                       device="cpu") as srv:
        rep = push_snapshot("127.0.0.1", srv.port, snap, seq=3)
        assert rep["ok"] and rep["digest"] == snapshot_digest(snap)
        reqs = _rows(9, 12)
        body = json.dumps({"rows": [
            {"index": i, "value": v, "field": f} for i, v, f in reqs]})
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.http_port}/score", data=body.encode(),
            method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            doc = json.loads(resp.read())
        assert doc["model"] == snapshot_digest(snap)
        want = want_eng.score(jit.pack(reqs)[0])
        np.testing.assert_allclose(np.asarray(doc["scores"], np.float32),
                                   want, rtol=0, atol=1e-5)
