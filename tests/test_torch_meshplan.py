"""The port's MeshPlan and make_mesh (dmlc_core_tpu_torch.parallel) on 4
gloo ranks on the CPU, held to the JAX package's tests/test_meshplan.py.

The hierarchical route (reduce-scatter in the host, all-reduce across
hosts, all-gather in the host; ``hosts=2`` forces the 2-D plan, as
``DMLCTPU_MESH_HOSTS`` does) equals the flat ``all_reduce`` within the JAX
test's f32 tolerance (1e-5), is the same bits run to run, and is the same
bits as flat on int64, where sums are exact.
"""
import numpy as np
import pytest

from dmlc_core_tpu_torch.parallel import MeshPlan, make_mesh
from torch_ranks import run_ranks

N = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(N, "collectives", tmp_path_factory.mktemp("plan"))


@pytest.mark.parametrize("hosts", [None, 2])
@pytest.mark.parametrize("op", ["sum", "max", "min", "mean"])
def test_hier_allreduce_matches_flat(ranks, hosts, op):
    for r in ranks:
        flat, hier, again = r["routes"][(hosts, op)]
        np.testing.assert_allclose(flat, hier, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(hier, again)  # deterministic
        np.testing.assert_array_equal(hier, ranks[0]["routes"][(hosts,
                                                                op)][1])


@pytest.mark.parametrize("hosts", [None, 2])
def test_hier_allreduce_is_exact_on_int64(ranks, hosts):
    want = np.stack([r["inputs"][1] for r in ranks]).sum(0)
    for r in ranks:
        flat, hier = r["routes"][(hosts, "int")]
        np.testing.assert_array_equal(flat, want)
        np.testing.assert_array_equal(hier, want)


def test_plan_allreduce_bench_smoke(ranks):
    flat, hier, auto = ranks[0]["benches"][6:9]
    for out, strat in ((flat, "flat"), (hier, "hier"), (auto, "flat")):
        assert out["devices"] == N and out["strategy"] == strat
        assert out["bus_gbps"] > 0 and out["op"] == "allreduce"
        assert out["bytes"] == int(0.0625 * (1 << 20)) // N


def test_build_topology(ranks):
    one = ranks[0]["routes"][(None, "describe")]
    two = ranks[0]["routes"][(2, "describe")]
    assert one["axes"] == ["data"] and one["hosts"] == 1
    assert one["chips_per_host"] == N and one["devices"] == N
    assert two["axes"] == ["host", "chip"]
    assert two["hosts"] == 2 and two["chips_per_host"] == 2
    assert two["fabric"] == "host" and two["backend"] == "gloo"
    plan_default = ranks[0]["knobs"]["default"]
    assert plan_default[2:] == (("data",), "data", None)


def test_build_hosts_knob(ranks):
    k = ranks[0]["knobs"]
    assert k[("DMLCTPU_MESH_HOSTS", "4")][4:] == ({"host": 4, "chip": 1},
                                                   ("host", "chip"))
    assert "do not split over 3 host" in k[("DMLCTPU_MESH_HOSTS", "3")]


def test_collective_knobs(ranks):
    k = ranks[0]["knobs"]
    two_d = ("DMLCTPU_MESH_HOSTS", "2")
    # "auto" on one axis stays flat at any size; on two axes the 256 KiB
    # threshold picks hier
    assert k["default"][:2] == ("flat", "flat")
    assert k[("DMLCTPU_MESH_HIER_THRESHOLD_KB", "1")][:3] == ("flat",) * 3
    assert k[two_d][:3] == ("flat", "flat", "hier")
    assert k[(two_d, ("DMLCTPU_MESH_HIER_THRESHOLD_KB", "1"))][:3] == (
        "flat", "hier", "hier")
    assert k[("DMLCTPU_MESH_COLLECTIVE", "flat")][2] == "flat"
    assert k[("DMLCTPU_MESH_COLLECTIVE", "hier")][0] == "hier"
    assert "DMLCTPU_MESH_COLLECTIVE" in k[("DMLCTPU_MESH_COLLECTIVE",
                                           "bogus")]
    assert k[("DMLCTPU_MESH_OVERLAP_CHUNKS", "4")][3] == 4


def test_single_shard_plan_stays_flat():
    plan = MeshPlan.build()  # no process group: one process
    assert plan.num_shards == 1
    assert plan.strategy_for(1 << 30) == "flat"
    assert plan.describe()["devices"] == 1


def test_make_mesh_raises_instead_of_asserting(ranks):
    errors = ranks[0]["errors"]
    assert "do not factor the 4 available" in errors[((3, 5),
                                                      ("host", "chip"))]
    assert "axis_sizes required" in errors[(None, ("host", "chip"))]
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()


def test_from_spec_shapes(ranks):
    spec = ranks[0]["spec"]
    assert spec["none"] is None and spec["passthrough"]
    assert spec["bare"] == ("data",) and spec["tuple"] == ("data",)
    assert spec["tuple2"] == ("host", "chip")
    assert spec["mesh2"]["hosts"] == 2
    assert "histogram_mesh axis 'model'" in spec["bad_axis"]


def test_row_offsets(ranks):
    counts = [10 * (r + 1) for r in range(N)]
    for rank, r in enumerate(ranks):
        for hosts in (None, 2):
            assert r["routes"][(hosts, "offsets")] == (sum(counts[:rank]),
                                                       sum(counts))
