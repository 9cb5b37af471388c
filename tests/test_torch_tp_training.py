"""The dp x tp layout of the port on gloo ranks on the CPU, against the JAX
package's own dp x tp run.

The JAX side is the package's ``train_step`` under GSPMD on a
``("data", "model")`` ``Mesh`` of the conftest's CPU devices: params
``P("model", ...)`` (``b`` replicated), batches ``P("data")``, as the
repo's multi-chip run lays them out.  The port runs the same steps on
D x M gloo ranks (``MeshPlan(make_mesh((D, M), ("data", "model")),
("data",))``): each rank holds its block of ``w`` and ``v`` and steps on
its data group's batch.  Each rank's loss and blocks are held to the
matching block of JAX's params (its shard for the device at the rank's
mesh coordinate) within 1e-6 relative, as the data-parallel tests hold
theirs.  The batches carry padding rows, padding lanes and indices at and
past F (JAX's gather clamps them into the last block).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from dmlc_core_tpu.data.staging import PaddedBatch as JaxBatch
from dmlc_core_tpu.models import FactorizationMachine as JaxFM
from dmlc_core_tpu.models import FieldAwareFactorizationMachine as JaxFFM
from dmlc_core_tpu.models import SparseLinearModel as JaxLinear
from dmlc_core_tpu_torch import checkpoint
from dmlc_core_tpu_torch.ops.fixed_point import (fixed_point_scale,
                                                 lane_amax, value_limit)
from dmlc_core_tpu_torch.ops.segment_sum import (clamp_index,
                                                 segment_sum_accumulate,
                                                 segment_sum_dequantize)
from torch_ranks import run_ranks

F, A, K, STEPS = 40, 3, 4, 3
ROWS, LANES = 16, 112  # a data group's batch: rows and entry lanes
SHAPES = ((1, 2), (2, 2))
FAMILIES = ("linear", "fm", "ffm")
BACKENDS = ("pallas", None)
JAX_CLS = {"linear": JaxLinear, "fm": JaxFM, "ffm": JaxFFM}


def _group_batch(seed, pad_rows):
    """A data group's staged batch: ROWS rows (the last ``pad_rows`` of
    weight 0), LANES entry lanes (the tail padding: index 0, value 0), an
    index equal to F and one past it."""
    rng = np.random.default_rng(seed)
    rows = ROWS - pad_rows
    counts = rng.integers(0, 7, rows)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nnz = int(ptr[-1])
    index = rng.integers(0, F, nnz).astype(np.int32)
    index[rng.choice(nnz, 2, replace=False)] = (F, F + 3)
    pad = LANES - nnz
    return {
        "label": np.pad((rng.random(rows) > 0.5).astype(np.float32),
                        (0, pad_rows)),
        "weight": np.pad(rng.uniform(0.5, 2.0, rows).astype(np.float32),
                         (0, pad_rows)),
        "row_ptr": np.concatenate([ptr, np.full(pad_rows, nnz, np.int32)]),
        "index": np.pad(index, (0, pad)),
        "value": np.pad(rng.standard_normal(nnz).astype(np.float32),
                        (0, pad)),
        "field": np.pad(rng.integers(0, A, nnz).astype(np.int32), (0, pad)),
        "num_rows": rows,
    }


def _global(groups):
    """The JAX package's global batch of the data groups' batches: rows and
    lanes concatenated, each group's row boundaries shifted into its
    LANES-wide segment (as multi-process staging's ``global_row_ptr``)."""
    g = {k: np.concatenate([b[k] for b in groups])
         for k in ("label", "weight", "index", "value", "field")
         if k in groups[0]}
    g["row_ptr"] = np.concatenate(
        [b["row_ptr"][:-1] + d * LANES for d, b in enumerate(groups)]
        + [[LANES * len(groups)]]).astype(np.int32)
    return g


@functools.lru_cache(maxsize=None)
def _case(family, D):
    rng = np.random.default_rng(9)
    params = {"w": rng.standard_normal(F).astype(np.float32),
              "b": np.float32(0.1)}
    kw = dict(num_features=F, learning_rate=0.3, l2=0.01)
    if family == "fm":
        params["v"] = (0.3 * rng.standard_normal((F, K))).astype(np.float32)
        kw["num_factors"] = K
    if family == "ffm":
        params["v"] = (0.3 * rng.standard_normal((F, A, K))).astype(
            np.float32)
        kw.update(num_fields=A, num_factors=K)
    batches = [[_group_batch(100 * i + 10 * d + len(family), 2 * d + 1)
                for i in range(STEPS)] for d in range(D)]
    if family != "ffm":
        for per_group in batches:
            for b in per_group:
                del b["field"]
    return params, kw, batches


def _spec(name, ndim):
    return P() if name == "b" else P("model", *([None] * (ndim - 1)))


@functools.lru_cache(maxsize=None)
def _jax_run(family, shape):
    """The JAX package's dp x tp steps: (the mesh's devices, each param's
    shard index by device, the losses and full params after each step)."""
    D, M = shape
    params, kw, batches = _case(family, D)
    mesh = Mesh(np.asarray(jax.devices()[:D * M]).reshape(D, M),
                ("data", "model"))
    shard = {k: NamedSharding(mesh, _spec(k, np.ndim(v)))
             for k, v in params.items()}
    jkw = {k: v for k, v in kw.items() if k != "num_features"}
    jm = JAX_CLS[family](F, sdot_backend=None, **jkw)
    jp = {k: jax.device_put(np.asarray(v), shard[k])
          for k, v in params.items()}
    index = {k: jp[k].sharding.addressable_devices_indices_map(np.shape(v))
             for k, v in params.items()}
    rows, rep = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
    out, pred = [], None
    for i in range(STEPS):
        g = _global([batches[d][i] for d in range(D)])
        jb = JaxBatch(**{k: jax.device_put(v, rep if k == "row_ptr" else rows)
                         for k, v in g.items()},
                      num_rows=jax.device_put(
                          jnp.int32(sum(batches[d][i]["num_rows"]
                                        for d in range(D))), rep))
        if i == 0:
            pred = np.asarray(jm.predict(jp, jb))
        jp, loss = jm.train_step(jp, jb)
        for k in ("w", "v"):
            if k in jp:  # the tables stay feature-sharded
                assert jp[k].sharding.is_equivalent_to(shard[k],
                                                       jp[k].ndim), k
        out.append((float(loss), {k: np.asarray(v) for k, v in jp.items()}))
    return mesh.devices, index, out, pred


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every family and backend on each plan shape, one job a shape; the
    2 x 2 job also saves its last model to ``runs["ckpt"]``."""
    tmp = tmp_path_factory.mktemp("tp")
    runs = {"ckpt": tmp / "tp_2x2.ckpt"}
    for D, M in SHAPES:
        cases = [(f, be, *_case(f, D), STEPS) for f in FAMILIES
                 for be in BACKENDS]
        runs[(D, M)] = run_ranks(
            D * M, "tp_steps", tmp, timeout=150, shape=(D, M), cases=cases,
            ckpt=str(runs["ckpt"]) if (D, M) == (2, 2) else None)
    return runs


def _rank_device(devices, r):
    d, m = r["coord"]
    return devices[d, m]


@pytest.mark.parametrize("backend", BACKENDS, ids=["pallas", "xla"])
@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("family", FAMILIES)
def test_tp_steps_equal_jax_dp_tp_steps(port_runs, family, shape, backend):
    devices, index, want, pred = _jax_run(family, shape)
    c = FAMILIES.index(family) * len(BACKENDS) + BACKENDS.index(backend)
    res = port_runs[shape]
    M = shape[1]
    for r in res:
        got = r["cases"][c]
        dev = _rank_device(devices, r)
        for i, (loss, jp) in enumerate(want):
            np.testing.assert_allclose(got["losses"][i], loss, rtol=1e-6)
            for k, v in got["states"][i].items():
                w = jp[k][index[k][dev]]
                np.testing.assert_allclose(
                    v, w, rtol=1e-6, atol=1e-6 * float(np.abs(jp[k]).max()),
                    err_msg=f"{k} step {i} rank {r['coord']}")
                if k != "b":  # the blocks stay blocks
                    assert v.shape[0] == F // M
                # every rank of a model coordinate holds the same block,
                # every rank the same b
                peer = next(p for p in res if p["m"] == r["m"])
                np.testing.assert_array_equal(
                    v, peer["cases"][c]["states"][i][k] if k != "b"
                    else res[0]["cases"][c]["states"][i]["b"])


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("family", FAMILIES)
def test_tp_predict_and_loss_equal_jax(port_runs, family, shape):
    """Before any step, a sharded model's ``predict`` of its data group's
    rows equals the JAX package's dp x tp ``predict`` of the global batch
    at those rows, ``predict_bucketed`` equals ``predict``, and ``loss``
    the loss ``train_step`` reports."""
    _, _, want, pred = _jax_run(family, shape)
    for be in BACKENDS:
        c = FAMILIES.index(family) * len(BACKENDS) + BACKENDS.index(be)
        for r in port_runs[shape]:
            got = r["cases"][c]["first"]
            rows = slice(r["d"] * ROWS, (r["d"] + 1) * ROWS)
            np.testing.assert_allclose(got["predict"], pred[rows],
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(got["bucketed"], got["predict"])
            np.testing.assert_allclose(got["loss"], want[0][0], rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x2"])
def test_tp_place_params_and_carry_give_jax_shard(port_runs, shape):
    D, M = shape
    for family in FAMILIES:
        params = _case(family, D)[0]
        devices, index, _, _ = _jax_run(family, shape)
        c = FAMILIES.index(family) * len(BACKENDS)
        for r in port_runs[shape]:
            got = r["cases"][c]
            dev = _rank_device(devices, r)
            lo, hi = got["block"]
            assert index["w"][dev] == (slice(lo, hi, None),)
            assert r["describe"]["model_shards"] == M
            assert r["d"] == r["coord"][0] and r["m"] == r["coord"][1]
            for k, v in params.items():
                want = np.asarray(v)[index[k][dev]]
                for how in ("placed", "carried"):
                    np.testing.assert_array_equal(got[how][k], want,
                                                  err_msg=f"{how} {k}")


def test_tp_checkpoint_is_a_one_process_save(port_runs, tmp_path):
    """The 2 x 2 ranks' save through ``sharded_state_dict()`` writes the
    file of a one-process save of the gathered values, byte for byte, and
    loads back onto each rank's blocks."""
    res = port_runs[(2, 2)]
    last = [r["cases"][-1]["states"][-1] for r in res]
    whole = {k: torch.tensor(np.concatenate(
        [last[r][k] for r in range(len(res)) if res[r]["d"] == 0]))
        for k in ("w", "v")}
    whole["b"] = torch.tensor(last[0]["b"])
    one = tmp_path / "one.ckpt"
    checkpoint.save(whole, str(one))
    assert port_runs["ckpt"].read_bytes() == one.read_bytes()
    assert [r["ckpt"][0] for r in res] == [3, 0, 0, 0]
    for r, state in zip(res, last):
        for k, v in state.items():
            np.testing.assert_array_equal(r["ckpt"][1][k], v, err_msg=k)


def _rows_file(path, rows, seed, with_field):
    """``rows`` libsvm rows (libffm ``field:index:value`` with
    ``with_field``); returns their labels."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(rows):
        idx = np.sort(rng.choice(F, rng.integers(1, 6), replace=False))
        lines.append(f"{i % 2} " + " ".join(
            (f"{j % A}:" if with_field else "")
            + f"{j}:{rng.standard_normal():.4f}" for j in idx))
    path.write_text("\n".join(lines) + "\n")
    return [float(line.split()[0]) for line in lines]


FORMATS = (False, True)  # the libsvm and the libffm (field lane) file


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """One 2 x 2 job staging a libsvm and a libffm file, its plans' row
    layouts and the layout's refusals (a 41-feature table on 2 model
    ranks among them)."""
    tmp = tmp_path_factory.mktemp("tp_staging")
    files, labels = [], []
    for with_field in FORMATS:
        path = tmp / f"rows{int(with_field)}.txt"
        labels.append(_rows_file(path, 203, 4, with_field))
        files.append((str(path), with_field,
                      "libfm" if with_field else "libsvm"))
    return labels, run_ranks(4, "tp_staging", tmp, timeout=120,
                             shape=(2, 2), files=files, B=16,
                             nnz_max=16 * 5, num_features=41)


@pytest.mark.parametrize("with_field", FORMATS, ids=["libsvm", "libffm"])
def test_tp_staged_batches_equal_within_a_data_group(staged, with_field):
    labels, res = staged
    f = FORMATS.index(with_field)
    by_group = {}
    for r in res:
        by_group.setdefault(r["d"], []).append(r["staged"][f])
    rows = []
    for d in sorted(by_group):
        first, *rest = by_group[d]
        assert ("field" in first[0]) == with_field
        for other in rest:
            assert len(other) == len(first)
            for a, b in zip(first, other):
                for k, v in a.items():
                    np.testing.assert_array_equal(np.asarray(v),
                                                  np.asarray(b[k]))
        rows += [x for b in first
                 for x in b["label"][b["weight"] > 0].tolist()]
    assert rows == labels[f]
    for i in range(len(by_group[0][0])):
        got = [by_group[d][0][i] for d in sorted(by_group)]
        assert all(b["planned"] for b in got)
        assert {b["global_num_rows"] for b in got} == {
            sum(b["num_rows"] for b in got)}


def test_row_layouts_of_1d_and_host_chip_plans_unchanged(staged):
    _, res = staged
    n = len(res)
    counts = [10 * (r + 1) for r in range(n)]
    for rank, r in enumerate(res):
        for name in ("flat", "hosts"):
            assert r["layouts"][name] == (n, rank, (sum(counts[:rank]),
                                                    sum(counts)))
        # the dp x tp plan counts data groups: rank (d, m) beside (d', m)
        d, m = divmod(rank, 2)
        peers = [counts[dd * 2 + m] for dd in range(2)]
        assert r["layouts"]["tp"] == (2, d, (sum(peers[:d]), sum(peers)))


def test_tp_refusals(staged):
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                ("data", "model"))
    with pytest.raises(ValueError) as jax_err:
        jax.device_put(np.zeros(41, np.float32),
                       NamedSharding(mesh, P("model")))
    want = ("should be divisible by 2, but it is equal to 41 (full shape: "
            "(41,))")
    assert want in str(jax_err.value)
    for r in staged[1]:
        got = r["refusals"]
        assert want in got["indivisible"]
        assert "one row axis and one model axis" in got["two_model_axes"]
        assert "no model axis" in got["no_model_axis"]


def test_tp_model_sum_is_the_whole_batch_fixed_point_sum(tmp_path):
    """On 2 ranks' model axis, the kernel route's plain version: the summed
    ``csr_matmul`` of the ranks' blocks is the accumulate/dequantize pair
    over the whole batch at the whole batch's scale, bit for bit; each
    rank's contrib gradient is the gather ``g[row_id]``; every entry
    (padding lanes and indices past F included) is one rank's."""
    rng = np.random.default_rng(3)
    nnz, rows, L = 300, 24, 5
    table = rng.standard_normal((F, L)).astype(np.float32)
    index = rng.integers(0, F + 6, nnz).astype(np.int32)
    index[-20:] = 0
    value = rng.standard_normal(nnz).astype(np.float32)
    value[-20:] = 0.0
    row_id = np.sort(rng.integers(0, rows, nnz)).astype(np.int32)
    g = rng.standard_normal((rows, L)).astype(np.float32)
    res = run_ranks(2, "tp_model_sum", tmp_path, table=table, index=index,
                    value=value, row_id=row_id, num_rows=rows, g=g,
                    device="cpu")
    c = (torch.tensor(table)[clamp_index(torch.tensor(index), F)]
         * torch.tensor(value)[:, None])
    scale = fixed_point_scale(lane_amax(c), nnz)
    acc = segment_sum_accumulate(c, torch.tensor(row_id), rows, scale,
                                 value_limit(nnz))
    want = segment_sum_dequantize(acc, scale, rows, L).numpy()
    assert sum(r["entries"] for r in res) == nnz
    for r in res:
        np.testing.assert_array_equal(r["out"], want)
        np.testing.assert_array_equal(r["grad"], r["gather"])
