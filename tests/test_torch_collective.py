"""The port's collectives (dmlc_core_tpu_torch.parallel.collective) on 4
gloo ranks on the CPU, against numpy and the JAX package's conventions.

The ranks run as child processes over a ``FileStore`` (tests/torch_ranks.py,
each with a timeout); one module-scoped run gathers every reading.  Sums of
f32 are held to numpy's at the tolerance of f32 sums in another order;
max, min and int64 sums exactly; every rank's result is the same bits.
"""
import numpy as np
import pytest

from dmlc_core_tpu.parallel import collective as jax_collective
from dmlc_core_tpu_torch.parallel import MeshPlan, allreduce
from dmlc_core_tpu_torch.parallel.collective import reduce_op
from torch_ranks import run_ranks

N = 4
F32_SUM = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(N, "collectives", tmp_path_factory.mktemp("coll"))


@pytest.mark.parametrize("op", ["sum", "max", "min", "mean"])
def test_allreduce_ops_match_numpy(ranks, op):
    xs = np.stack([r["inputs"][0] for r in ranks])
    want = {"sum": xs.sum(0), "max": xs.max(0), "min": xs.min(0),
            "mean": xs.mean(0)}[op]
    got = ranks[0]["ops"][op]
    if op in ("max", "min"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **F32_SUM)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["ops"][op], got)


def test_int64_sum_is_exact_and_inputs_are_untouched(ranks):
    want = np.stack([r["inputs"][1] for r in ranks]).sum(0)
    for r in ranks:
        np.testing.assert_array_equal(r["int_sum"], want)
        np.testing.assert_array_equal(r["x_unchanged"], r["inputs"][0])


def test_unknown_op_raises_the_jax_error():
    with pytest.raises(ValueError) as want:
        jax_collective.allreduce(np.zeros(2), "prod")
    with pytest.raises(ValueError) as got:
        reduce_op("prod")
    assert str(got.value) == str(want.value)


def test_one_process_allreduce_is_identity():
    import torch
    x = torch.arange(5.0)
    assert allreduce(x, "sum") is x
    plan = MeshPlan.build()  # no process group: one process
    assert plan.num_shards == 1 and plan.strategy_for(1 << 30) == "flat"
    assert plan.allreduce(x, "mean") is x


@pytest.mark.parametrize("i,op", enumerate(
    ["allreduce", "allgather", "reducescatter", "ppermute"]))
def test_collective_bench_conventions(ranks, i, op):
    """The JAX package's keys and NCCL-tests conventions: allgather's
    algbw base is n times the per-rank buffer; bus factors 2(n-1)/n,
    (n-1)/n, (n-1)/n, 1."""
    out = ranks[0]["benches"][i]
    assert set(out) == {"devices", "bytes", "seconds_per_iter", "algo_gbps",
                        "bus_gbps", "op"}
    assert out["op"] == op and out["devices"] == N
    per_rank = 0.0625 * (1 << 20)
    assert out["bytes"] == (N * per_rank if op == "allgather" else per_rank)
    factor = {"allreduce": 2 * (N - 1) / N, "allgather": (N - 1) / N,
              "reducescatter": (N - 1) / N, "ppermute": 1.0}[op]
    assert out["seconds_per_iter"] > 0
    assert out["bus_gbps"] == pytest.approx(out["algo_gbps"] * factor)
    assert out["algo_gbps"] == pytest.approx(
        out["bytes"] / out["seconds_per_iter"] / 1e9)


def test_sweep_and_allreduce_bench(ranks):
    sweep, bench = ranks[0]["benches"][4], ranks[0]["benches"][5]
    assert sweep["op"] == bench["op"] == "allreduce"
    assert sweep["bytes"] == 0.03125 * (1 << 20)
    assert bench["bytes"] == 0.0625 * (1 << 20)
