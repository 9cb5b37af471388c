"""The port's out-of-core GBDT (``GBDT.fit_streamed``) against the JAX
package's and against its own ``fit_batch``, on the CPU.

The fixture is tests/test_torch_cumsum.py's sparse 64-bin case, held first
to its gain-gap rule (in a float64 replay of the reference's fit, every
split beats every other partition by 1e-4 of its gain), split into
batches with padding rows and lanes.

* The port's streamed forest equals the JAX package's streamed forest
  node for node (node arrays exact; leaves, covers, bases at rtol 1e-5 /
  atol 1e-6; gains at 4 f32 ulps of the largest, as
  tests/test_torch_gbdt_sparse.py holds ``fit_batch``).
* The port's streamed forest equals its own ``fit_batch`` on the
  concatenated batches: bit for bit on the kernel route ("pallas", the
  plain version over the once-a-fit layout here), and in every node array,
  leaf and base on the ``index_add`` route, whose per-batch histograms add
  in another order (its gains may differ in the last bits).
* Forests from the text file and from the binned epoch cache are equal,
  bit for bit, and equal the JAX package's within the tolerances above.
* A replay callable is read once for pass 0 and once a level: max_depth + 1
  times a tree on ``index_add``, max_depth times on the kernel.
"""
import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu.data.staging import PaddedBatch as JaxBatch
from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
from dmlc_core_tpu.models.gbdt import QuantileBinner as JaxBinner
from dmlc_core_tpu_torch.data import PaddedBatch
from dmlc_core_tpu_torch.models import GBDT, QuantileBinner
from test_torch_cumsum import GAP, _min_gain_gaps

EXACT = ("feature", "threshold", "default_right", "trees_used")
CLOSE = ("leaf", "split_gain", "split_cover", "base")
ROWS, F, B, PAD = 2000, 4, 64, 7
KW = dict(num_features=F, num_trees=3, max_depth=3, num_bins=B,
          learning_rate=0.5, missing_aware=True)


@functools.lru_cache(maxsize=None)
def _data():
    """tests/test_torch_cumsum.py's sparse 64-bin rows (seed 670)."""
    rng = np.random.default_rng(670)
    present = rng.random((ROWS, F)) < 0.6
    vals = rng.uniform(-2, 2, (ROWS, F)).astype(np.float32)
    vals[vals == 0] = 0.5
    r, f = np.nonzero(present)
    dense = np.where(present, vals, np.nan)
    y = ((np.nan_to_num(dense[:, 0]) > 0.3)
         ^ (np.nan_to_num(dense[:, 1]) > 0.5)).astype(np.float32)
    flip = rng.random(ROWS) < 0.1
    y[flip] = 1.0 - y[flip]
    ptr = np.concatenate([[0], np.cumsum(present.sum(1))]).astype(np.int32)
    return f.astype(np.int32), vals[r, f], y, ptr, r


def _split(rows_per_batch=600, pad_rows=2):
    """(label, weight, row_ptr, index, value) of each batch: the rows in
    order, ``pad_rows`` weight-0 padding rows and PAD padding lanes."""
    idx, val, y, ptr, _ = _data()
    out = []
    for r0 in range(0, ROWS, rows_per_batch):
        r1 = min(r0 + rows_per_batch, ROWS)
        e0, e1 = ptr[r0], ptr[r1]
        rp = np.concatenate([ptr[r0:r1 + 1] - e0,
                             np.full(pad_rows, e1 - e0)]).astype(np.int32)
        out.append((np.pad(y[r0:r1], (0, pad_rows)),
                    np.pad(np.ones(r1 - r0, np.float32), (0, pad_rows)), rp,
                    np.pad(idx[e0:e1], (0, PAD)), np.pad(val[e0:e1],
                                                         (0, PAD))))
    return out


def _port_batches(parts):
    return [PaddedBatch(label=torch.from_numpy(a), weight=torch.from_numpy(b),
                        row_ptr=torch.from_numpy(c),
                        index=torch.from_numpy(d), value=torch.from_numpy(e),
                        num_rows=int((b > 0).sum()))
            for a, b, c, d, e in parts]


def _jax_batches(parts):
    return [JaxBatch(label=jnp.asarray(a), weight=jnp.asarray(b),
                     row_ptr=jnp.asarray(c), index=jnp.asarray(d),
                     value=jnp.asarray(e),
                     num_rows=jnp.int32(int((b > 0).sum())))
            for a, b, c, d, e in parts]


def _concat(batches):
    off = np.cumsum([0] + [b.index.shape[0] for b in batches])
    return PaddedBatch(
        label=torch.cat([b.label for b in batches]),
        weight=torch.cat([b.weight for b in batches]),
        row_ptr=torch.cat([batches[0].row_ptr] + [
            b.row_ptr[1:] + int(o) for b, o in zip(batches[1:], off[1:-1])]),
        index=torch.cat([b.index for b in batches]),
        value=torch.cat([b.value for b in batches]),
        num_rows=sum(b.num_rows for b in batches))


def _binner():
    idx, val, *_ = _data()
    return QuantileBinner(num_bins=B, missing_aware=True,
                          device="cpu").fit_sparse(idx, val, F)


@functools.lru_cache(maxsize=None)
def _jax_streamed():
    """The JAX package's streamed forest, after the fixture passes the
    gain-gap rule on it."""
    idx, val, y, _, r = _data()
    jbinner = JaxBinner(num_bins=B, missing_aware=True).fit_sparse(idx, val,
                                                                   F)
    want = {k: np.asarray(v) for k, v in JaxGBDT(histogram="xla", **KW)
            .fit_streamed(_jax_batches(_split()), jbinner).items()}
    codes = np.zeros((ROWS, F), np.int64)
    codes[r, idx] = np.asarray(jbinner.transform_entries(
        jnp.asarray(idx), jnp.asarray(val)))
    gap, null = _min_gain_gaps(codes, y, want, B, 1.0, 1e-3, True)
    assert gap >= GAP and null <= -GAP, (gap, null)
    return want


def _assert_close_to_jax(got, want):
    assert sorted(got) == sorted(want)
    for k in EXACT:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in CLOSE:
        atol = (4 * 2.0 ** -23 * float(np.abs(want[k]).max())
                if k == "split_gain" else 1e-6)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("histogram", ["xla", "pallas"])
def test_streamed_forest_equals_jax_and_fit_batch(histogram):
    batches = _port_batches(_split())
    calls = []

    def replay():
        calls.append(1)
        return iter(batches)

    model = GBDT(histogram=histogram, device="cpu", **KW)
    got = model.fit_streamed(replay, _binner())
    _assert_close_to_jax(got, _jax_streamed())
    per_tree = KW["max_depth"] + (histogram == "xla")
    assert len(calls) == 1 + KW["num_trees"] * per_tree
    resident = GBDT(histogram=histogram, device="cpu", **KW).fit_batch(
        _concat(batches), _binner())
    keys = (list(resident) if histogram == "pallas" else
            ["feature", "threshold", "default_right", "leaf", "base",
             "trees_used"])
    for k in keys:
        assert torch.equal(got[k], resident[k]), k
    # a sequence replays too, to the same forest
    again = GBDT(histogram=histogram, device="cpu", **KW).fit_streamed(
        batches, _binner())
    assert all(torch.equal(again[k], got[k]) for k in got)


@pytest.fixture(scope="module")
def libsvm_file(tmp_path_factory):
    """The fixture's rows as libsvm, values as %.9g (f32 round-trips)."""
    idx, val, y, ptr, _ = _data()
    lines = []
    for r in range(ROWS):
        s = slice(ptr[r], ptr[r + 1])
        lines.append(f"{int(y[r])} " + " ".join(
            f"{i}:{v:.9g}" for i, v in zip(idx[s], val[s])))
    path = tmp_path_factory.mktemp("streamed") / "rows.libsvm"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("histogram", ["xla", "pallas"])
def test_forests_from_text_and_cache_are_equal(libsvm_file, histogram,
                                               tmp_path):
    opts = dict(batch_size=512, nnz_bucket=1024, device="cpu")
    model = GBDT(histogram=histogram, device="cpu", **KW)
    from_text = model.fit_streamed(libsvm_file, _binner(),
                                   staging_options=opts)
    cache = str(tmp_path / "rows.bincache")
    from_cache = model.fit_streamed(libsvm_file, _binner(),
                                    staging_options=dict(
                                        opts, bin_cache=cache,
                                        binner=_binner()))
    assert Path(cache).exists()
    for k in from_text:
        assert torch.equal(from_text[k], from_cache[k]), k
    _assert_close_to_jax(from_cache, _jax_streamed())


def test_softmax_and_rank_streamed_equal_fit_batch():
    idx, _, y, _, r = _data()
    base = _split(rows_per_batch=500, pad_rows=0)
    has2 = np.isin(np.arange(ROWS), r[idx == 2])
    cls = np.where(has2 & (y == 0), 2.0, y).astype(np.float32)
    parts = [(cls[i * 500:(i + 1) * 500],) + p[1:] for i, p in
             enumerate(base)]
    for kw, extra in ((dict(objective="softmax", num_class=3), {}),
                      (dict(objective="rank:pairwise"), {"qid": True})):
        batches = _port_batches(parts)
        if extra:
            for i, b in enumerate(batches):
                b.qid = torch.from_numpy(
                    (np.arange(500) // 25 + 20 * i).astype(np.int32))
        cfg = dict(KW, **kw)
        got = GBDT(histogram="pallas", device="cpu", **cfg).fit_streamed(
            batches, _binner())
        cat = _concat(batches)
        if extra:
            cat.qid = torch.cat([b.qid for b in batches])
        want = GBDT(histogram="pallas", device="cpu", **cfg).fit_batch(
            cat, _binner())
        assert all(torch.equal(got[k], want[k]) for k in want), kw


def test_streamed_refusals():
    batches = _port_batches(_split())
    with pytest.raises(ValueError, match="empty"):
        GBDT(device="cpu", **KW).fit_streamed([], _binner())
    with pytest.raises(ValueError, match="staging_options"):
        GBDT(device="cpu", **KW).fit_streamed(batches, _binner(),
                                             staging_options={})
    with pytest.raises(ValueError, match="missing_aware"):
        GBDT(device="cpu", **dict(KW, missing_aware=False)).fit_streamed(
            batches, _binner())
    with pytest.raises(ValueError, match="with_qid"):
        GBDT(device="cpu", **dict(KW, objective="rank:pairwise")
             ).fit_streamed(batches, _binner())
