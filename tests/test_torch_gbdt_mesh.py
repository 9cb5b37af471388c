"""Row-sharded GBDT fits of the port (``histogram_mesh=``) on 2 and 4 gloo
ranks on the CPU, against the JAX package's mesh fits on the 8-device
virtual CPU mesh of tests/conftest.py.

* Forests node for node: ``feature``, ``threshold``, ``default_right`` and
  ``trees_used`` equal; leaves, covers and base within 1e-5 (f32 sums in
  another order: the port's fixed point against XLA's scatter);
  ``split_gain`` at an atol of 4 f32 ulps of the largest gain, as
  tests/test_torch_gbdt.py holds it.
* On the fixed-point route (``histogram="pallas"``, the kernels' plain
  accumulate / dequantize on the CPU) every cross-process sum is an exact
  int64 all-reduce, so N ranks give the 1-rank plan's forest bit for bit,
  whatever the strategy (flat, hier) or the overlap chunking.  The shards
  are cut at multiples of 32 rows: torch's CPU kernels for ``sigmoid`` and
  ``exp`` take a scalar path on the tail of a vectorised loop, which can
  round a row's gradient an ulp apart from the vector path, so a row
  whose position in its shard's tail differs would get another gradient
  before any sum is taken.  The sums themselves are bitwise for any cut
  (test_exact_sums_are_bitwise_for_any_shards, uneven and unaligned).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dmlc_core_tpu.data.staging import PaddedBatch as JaxBatch
from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
from dmlc_core_tpu.models.gbdt import QuantileBinner as JaxBinner
from dmlc_core_tpu.ops import pallas_segment
from dmlc_core_tpu_torch.models.gbdt import GBDT
from dmlc_core_tpu_torch.ops.histogram_sparse import sparse_hist_layout
from dmlc_core_tpu_torch.parallel import MeshPlan
from torch_ranks import ops_sharded, run_ranks

EXACT = ("feature", "threshold", "default_right", "trees_used")
CLOSE = ("leaf", "split_cover", "base")
TOL = dict(rtol=1e-5, atol=1e-5)
ROWS = 384  # 32-aligned shards on 2 and 4 ranks, 48 rows a JAX device


def _dense_case(name):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((ROWS, 4)).astype(np.float32)
    kw = dict(num_features=4, num_trees=3, max_depth=3, num_bins=8,
              learning_rate=0.5, seed=0)
    if name == "softmax":
        y = np.where(x[:, 0] > 0.3, 2, np.where(x[:, 1] > 0, 1, 0))
        kw.update(objective="softmax", num_class=3, num_trees=2)
    else:
        y = x[:, 0] + 0.5 * x[:, 2] > 0
    if name == "sampled":
        kw.update(subsample=0.8, colsample_bytree=0.75,
                  colsample_bylevel=0.75, seed=3)
    bins = np.asarray(JaxBinner(num_bins=8).fit_transform(x))
    return bins, y.astype(np.float32), kw


def _sparse_case():
    # tests/test_torch_gbdt_sparse.py's "logistic" fixture
    rng = np.random.default_rng(40)
    rows, F = 200, 4
    present = rng.random((rows, F)) < 0.4
    vals = rng.uniform(-2, 2, (rows, F)).astype(np.float32)
    vals[vals == 0] = 0.5
    r, f = np.nonzero(present)
    dense = np.where(present, vals, np.nan)
    label = np.where(np.isnan(dense[:, 0]), 1.0,
                     dense[:, 0] > 0.3).astype(np.float32)
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(
        r, minlength=rows))]).astype(np.int32)
    data = dict(label=label, weight=np.ones(rows, np.float32),
                row_ptr=row_ptr, index=f.astype(np.int32),
                value=vals[r, f].astype(np.float32))
    kw = dict(num_features=F, num_trees=2, max_depth=3, num_bins=8,
              learning_rate=0.5, missing_aware=True)
    cuts = np.asarray(JaxBinner(num_bins=8, missing_aware=True).fit_sparse(
        data["index"], data["value"], F).cuts)
    return data, kw, cuts


@functools.lru_cache(maxsize=None)
def _jax_mesh_fit(name):
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("data",))
    if name == "sparse":
        data, kw, cuts = _sparse_case()
        binner = JaxBinner(num_bins=kw["num_bins"], missing_aware=True)
        binner.cuts = jnp.asarray(cuts)
        batch = JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()},
                         num_rows=jnp.asarray(np.int32(len(data["label"]))))
        forest = JaxGBDT(histogram="xla", histogram_mesh=(mesh, "data"),
                         **kw).fit_batch(batch, binner)
    else:
        bins, y, kw = _dense_case(name)
        rows = NamedSharding(mesh, P("data"))
        forest = JaxGBDT(histogram="xla", histogram_mesh=(mesh, "data"),
                         **kw).fit(jax.device_put(bins, rows),
                                   jax.device_put(y, rows))
    return {k: np.asarray(v) for k, v in forest.items()}


# the fixed-point route under each strategy, then index_add
PLANS = {2: [(None, None, 1, "pallas"), (None, "hier", 3, "pallas"),
             (None, None, 1, "xla")],
         4: [(None, "flat", 1, "pallas"), (2, "hier", 4, "pallas"),
             (None, None, 1, "xla")]}
DENSE = ("logistic", "softmax", "sampled")


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """{n: {case: [forest of each plan] of every rank]}}"""
    tmp = tmp_path_factory.mktemp("gbdt_mesh")
    data, kw, cuts = _sparse_case()
    out = {}
    for n in (2, 4):
        cases = [dict(kind="dense", bins=_dense_case(c)[0],
                      y=_dense_case(c)[1], kw=_dense_case(c)[2],
                      plans=PLANS[n], uneven=True, align=32)
                 for c in DENSE]
        cases.append(dict(kind="sparse", data=data, kw=kw, cuts=cuts,
                          plans=PLANS[n], uneven=True, align=32))
        res = run_ranks(n, "gbdt_fits", tmp, timeout=120, cases=cases)
        out[n] = {c: [r[i] for r in res]
                  for i, c in enumerate(DENSE + ("sparse",))}
    return out


def _assert_close_forest(got, want):
    assert sorted(got) == sorted(want)
    for k in EXACT:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in CLOSE:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    np.testing.assert_allclose(
        got["split_gain"], want["split_gain"], rtol=1e-5,
        atol=4 * 2.0 ** -23 * float(np.abs(want["split_gain"]).max()))


@pytest.mark.parametrize("plan", range(3), ids=["fixed", "fixed-hier",
                                                "index_add"])
@pytest.mark.parametrize("case", DENSE + ("sparse",))
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_forest_equals_jax_mesh_fit(fits, n, case, plan):
    want = _jax_mesh_fit(case)
    for rank_forests in fits[n][case]:
        _assert_close_forest(rank_forests[plan], want)


@pytest.mark.parametrize("case", DENSE + ("sparse",))
def test_n_ranks_equal_one_rank_bitwise_on_the_fixed_point(fits, case):
    """2 and 4 ranks, flat and hier, unchunked and overlapped: one forest,
    the 1-rank plan's, bit for bit, on every rank."""
    plan = MeshPlan.build()  # one process
    if case == "sparse":
        data, kw, cuts = _sparse_case()
        from dmlc_core_tpu_torch.data.staging import PaddedBatch
        from dmlc_core_tpu_torch.models.gbdt import QuantileBinner
        import torch
        batch = PaddedBatch(num_rows=len(data["label"]),
                            **{k: torch.tensor(v) for k, v in data.items()})
        one = GBDT(device="cpu", histogram="pallas", histogram_mesh=plan,
                   **kw).fit_batch(batch, QuantileBinner.from_cuts(
                       cuts, kw["num_bins"], missing_aware=True,
                       device="cpu"))
    else:
        bins, y, kw = _dense_case(case)
        one = GBDT(device="cpu", histogram="pallas", histogram_mesh=plan,
                   **kw).fit(bins, y)
    for n in (2, 4):
        for rank_forests in fits[n][case]:
            for forest in rank_forests[:2]:
                for k, v in one.items():
                    np.testing.assert_array_equal(forest[k], v.numpy(),
                                                  err_msg=f"{n} {k}")


def test_index_add_route_is_replicated(fits):
    """index_add levels reduce f32 histograms: every rank's forest is the
    same bits as every other's."""
    for n in (2, 4):
        for case in DENSE + ("sparse",):
            first = fits[n][case][0][2]
            for rank_forests in fits[n][case][1:]:
                for k in first:
                    np.testing.assert_array_equal(rank_forests[2][k],
                                                  first[k])


def test_streamed_sharded_fit_equals_sharded_fit_batch(tmp_path):
    data, kw, cuts = _sparse_case()
    res = run_ranks(2, "gbdt_streamed", tmp_path, data=data, kw=kw,
                    cuts=cuts, batch_rows=40)
    want = _jax_mesh_fit("sparse")
    for forest in res:
        _assert_close_forest(forest, want)
        for k in forest:
            np.testing.assert_array_equal(forest[k], res[0][k])


def test_streamed_sharded_fit_takes_the_fixed_point_route(tmp_path):
    """A sharded fit_streamed's kernel levels take the exact route: on 2
    ranks, uneven batches, the 1-rank plan's fit_batch bit for bit."""
    import torch

    from dmlc_core_tpu_torch.data.staging import PaddedBatch
    from dmlc_core_tpu_torch.models.gbdt import QuantileBinner
    data, kw, cuts = _sparse_case()
    res = run_ranks(2, "gbdt_streamed", tmp_path, data=data, kw=kw,
                    cuts=cuts, batch_rows=40, histogram="pallas")
    batch = PaddedBatch(num_rows=len(data["label"]),
                        **{k: torch.tensor(v) for k, v in data.items()})
    one = GBDT(device="cpu", histogram="pallas",
               histogram_mesh=MeshPlan.build(), **kw).fit_batch(
        batch, QuantileBinner.from_cuts(cuts, kw["num_bins"],
                                        missing_aware=True, device="cpu"))
    for forest in res:
        for k, v in one.items():
            np.testing.assert_array_equal(forest[k], v.numpy(), err_msg=k)


def test_exact_sums_are_bitwise_for_any_shards(tmp_path):
    """The dense histogram, the sparse histogram and the segment sum over
    uneven, unaligned shards on 2 and 4 ranks (flat, hier, chunked): the
    one-process result bit for bit."""
    rng = np.random.default_rng(0)
    rows, F, B, n_nodes = 301, 5, 8, 4
    bins = rng.integers(0, B, (rows, F)).astype(np.uint8)
    gh = rng.standard_normal((rows, 2)).astype(np.float32)
    rel = rng.integers(-1, n_nodes, rows).astype(np.int32)
    rid = np.repeat(np.arange(rows), F)
    fi = np.tile(np.arange(F), rows)
    em = rng.random(rows * F) < 0.5
    args = dict(bins=bins, rel=rel, gh=gh, n_nodes=n_nodes, num_bins=B,
                layout_args=(rid, fi, bins.reshape(-1).astype(np.int64), em))
    one = ops_sharded(0, 1, plans=[(None, None, 1)], **args)[0]
    for n, plans in ((2, [(None, None, 1), (None, "hier", 3)]),
                     (4, [(2, "hier", 2), (None, "flat", 5)])):
        for r in run_ranks(n, "ops_sharded", tmp_path, plans=plans,
                           uneven=True, **args):
            for got in r:
                for k in one:
                    np.testing.assert_array_equal(got[k], one[k], err_msg=k)


def test_sparse_hist_layout_shards_equal_jax():
    rng = np.random.default_rng(5)
    rows, F, B = 400, 6, 16
    present = rng.random((rows, F)) < 0.3
    rid, fi = (a.astype(np.int64) for a in np.nonzero(present))
    eb = rng.integers(1, B, rid.size)
    em = rng.random(rid.size) < 0.9
    want = pallas_segment.sparse_hist_layout(rid, fi, eb, em, F, B,
                                             num_shards=4, rows=rows)
    got = sparse_hist_layout(rid, fi, eb, em, F, B, num_shards=4, rows=rows)
    for k in ("gkey", "rid", "w", "tstart", "tcount"):
        np.testing.assert_array_equal(getattr(got, k),
                                      np.asarray(getattr(want, k)), err_msg=k)
    for k in ("num_shards", "nb", "num_kt", "max_tiles", "nnz_pad",
              "nnz_live"):
        assert getattr(got, k) == getattr(want, k), k
    with pytest.raises(ValueError, match="rows divisible"):
        sparse_hist_layout(rid, fi, eb, em, F, B, num_shards=3, rows=rows)
    # each shard's kernel layout holds its rows' live entries, localised
    for s in range(4):
        sh = got.shard(s)
        lo = s * rows // 4
        sel = em & (rid // (rows // 4) == s)
        assert sh.nnz_live == int(sel.sum())
        np.testing.assert_array_equal(np.sort(sh.rid.numpy()),
                                      np.sort(rid[sel] - lo))


def test_sampled_padded_fit_batch_draws_the_one_process_rows(tmp_path):
    """A sampled sharded ``fit_batch`` whose ranks pad their shares with
    weight-0 rows, as a staged share's short last batch is (rank 0 128 real
    rows of 160, rank 1 72): each real row (a batch's first ``num_rows``)
    is drawn at its number among the one-process rows, so on the
    fixed-point route both ranks grow the one-process plan's forest over
    the unsharded rows bit for bit.  Numbering the rows by their padded
    positions shifts rank 1's draws by rank 0's padding.  The one-process
    batch is padded to 256 rows so that every real row takes the same
    vectorised gradient path as on its rank (the module docstring)."""
    data, kw, cuts = _sparse_case()
    kw = dict(kw, subsample=0.8, colsample_bytree=0.75, seed=3)
    res = run_ranks(2, "gbdt_fits", tmp_path, timeout=120, cases=[dict(
        kind="sparse", data=data, kw=kw, cuts=cuts, uneven=True, align=32,
        pad_to=160, plans=[(None, None, 1, "pallas")])])
    import torch

    from dmlc_core_tpu_torch.data.staging import PaddedBatch
    from dmlc_core_tpu_torch.models.gbdt import QuantileBinner
    rows, pad = len(data["label"]), 256 - len(data["label"])
    batch = PaddedBatch(
        label=torch.tensor(np.pad(data["label"], (0, pad))),
        weight=torch.tensor(np.pad(data["weight"], (0, pad))),
        row_ptr=torch.tensor(np.pad(data["row_ptr"], (0, pad), mode="edge")),
        index=torch.tensor(data["index"]), value=torch.tensor(data["value"]),
        num_rows=rows)
    one = GBDT(device="cpu", histogram="pallas", histogram_mesh=MeshPlan.build(),
               **kw).fit_batch(batch, QuantileBinner.from_cuts(
                   cuts, kw["num_bins"], missing_aware=True, device="cpu"))
    for r in res:
        for k, v in one.items():
            np.testing.assert_array_equal(r[0][0][k], v.numpy(), err_msg=k)
