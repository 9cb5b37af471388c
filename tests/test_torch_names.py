"""Public names of the JAX package that the port had lacked, each against
its JAX counterpart on the CPU: the native runtime's version, parse-thread
default and log entry point (``_native``); the package's top-level
re-exports, loaded on first use; ``SparseLinearModel.init``;
``ops.sparse.csr_to_dense``; ``MeshPlan.data_sharding`` /
``replicated_sharding``; and ``SparseLinearModel(mesh_plan=)`` with
``place_params``, ``batch_sharding`` and ``grad_allreduce`` (one process,
and two gloo ranks against the JAX package's 2-device CPU mesh)."""
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import dmlc_core_tpu
import dmlc_core_tpu_torch
from dmlc_core_tpu import _native as jax_native
from dmlc_core_tpu.models.linear import SparseLinearModel as JaxLinear
from dmlc_core_tpu.ops.sparse import csr_to_dense as jax_csr_to_dense
from dmlc_core_tpu.parallel.meshplan import MeshPlan as JaxMeshPlan
from dmlc_core_tpu_torch import _native
from dmlc_core_tpu_torch.models import SparseLinearModel
from dmlc_core_tpu_torch.ops import csr_to_dense
from dmlc_core_tpu_torch.parallel import MeshPlan

REPO = Path(__file__).resolve().parent.parent


def test_native_version_and_parse_threads_equal_jax():
    assert _native.version() == jax_native.version()
    assert isinstance(_native.version(), str) and _native.version()
    before = jax_native.get_default_parse_threads()
    try:
        # one library in the process: each package reads what the other set
        _native.set_default_parse_threads(3)
        assert jax_native.get_default_parse_threads() == 3
        jax_native.set_default_parse_threads(5)
        assert _native.get_default_parse_threads() == 5
        _native.set_default_parse_threads(0)
        assert _native.get_default_parse_threads() == \
            jax_native.get_default_parse_threads()
    finally:
        jax_native.set_default_parse_threads(before)


def test_log_emit_equals_jax():
    got = []
    _native.set_log_callback(lambda *rec: got.append(rec))
    try:
        for sev, msg in ((2, "port warning"), (3, "an error: 7")):
            _native.log_emit(sev, msg)
            jax_native.log_emit(sev, msg)
    finally:
        _native.set_log_callback(None)
    assert len(got) == 4
    assert got[0] == got[1] and got[2] == got[3]
    assert [g[0] for g in got[::2]] == [2, 3]
    assert "port warning" in got[0][2] and "an error: 7" in got[2][2]


def test_top_level_names_are_the_jax_package_s():
    assert dmlc_core_tpu_torch.__all__ == dmlc_core_tpu.__all__
    assert dmlc_core_tpu_torch.__version__ == dmlc_core_tpu.__version__
    for name in dmlc_core_tpu.__all__:
        mine, theirs = (getattr(dmlc_core_tpu_torch, name),
                        getattr(dmlc_core_tpu, name))
        if isinstance(theirs, types.ModuleType):
            assert mine.__name__ == f"dmlc_core_tpu_torch.{name}"
        else:
            assert callable(mine) and mine.__name__ == theirs.__name__, name
    assert dmlc_core_tpu_torch.native_version() == \
        dmlc_core_tpu.native_version()
    assert issubclass(dmlc_core_tpu_torch.NativeError, RuntimeError)
    with pytest.raises(AttributeError):
        dmlc_core_tpu_torch.no_such_name  # noqa: B018


def test_importing_the_package_loads_nothing():
    """A fresh interpreter: ``import dmlc_core_tpu_torch`` imports no
    submodule, loads no native library and builds no kernel; the first
    use of a name loads its module only."""
    code = (
        "import sys\n"
        "import dmlc_core_tpu_torch as d\n"
        "mods = sorted(m for m in sys.modules "
        "if m.startswith('dmlc_core_tpu_torch.'))\n"
        "assert mods == [], mods\n"
        "d.RecordIOWriter\n"
        "from dmlc_core_tpu_torch import _native\n"
        "assert _native._LIB is None\n"
        "assert 'dmlc_core_tpu_torch.ops.segment_sum' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_linear_init_equals_jax():
    F = 11
    m = SparseLinearModel(F, device="cpu")
    with torch.no_grad():
        m.w.fill_(2.0)
        m.b.fill_(-1.0)
    assert m.init(7) is m
    want = JaxLinear(F).init(7)
    got = m.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == torch.float32 and v.dtype == np.float32
        assert tuple(got[k].shape) == v.shape
        np.testing.assert_array_equal(got[k].numpy(), v)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csr_to_dense_equals_jax(seed):
    """Duplicates summed, padding lanes inert, negative ids counted from the
    end once, out-of-range rows and features dropped; values on a 1/4 grid
    so every sum is exact in either order."""
    rng = np.random.default_rng(seed)
    R, F, nnz = 9, 7, 120
    row = rng.integers(-R - 2, R + 3, nnz).astype(np.int32)
    idx = rng.integers(-F - 2, F + 3, nnz).astype(np.int32)
    val = (rng.integers(-16, 17, nnz) / 4).astype(np.float32)
    val[::9] = 0.0  # padding lanes
    want = np.asarray(jax_csr_to_dense(jnp.asarray(idx), jnp.asarray(val),
                                       jnp.asarray(row), R, F))
    got = csr_to_dense(torch.from_numpy(idx), torch.from_numpy(val),
                       torch.from_numpy(row), R, F)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_plan_shardings_and_one_process_helpers():
    """Without a process group: the plan's shardings name its axes (JAX's
    ``P(axes)`` and ``P()``), and the model's helpers pass through as the
    JAX package's do without a plan."""
    plan = MeshPlan.build()
    jplan = JaxMeshPlan.build(devices=jax.devices()[:1])
    ds, rs = plan.data_sharding(), plan.replicated_sharding()
    assert ds.axes == plan.axes and ds.mesh is plan.mesh
    assert jplan.data_sharding().spec == P(jplan.axes)
    assert tuple(jplan.axes) == ds.axes
    assert rs.mesh is plan.mesh and jplan.replicated_sharding().spec == P()
    params = {"w": torch.ones(3), "b": torch.zeros(())}
    bare, jbare = SparseLinearModel(3, device="cpu"), JaxLinear(3)
    assert bare.mesh_plan is None and jbare.mesh_plan is None
    assert bare.place_params(params) is params
    assert bare.batch_sharding() is None and jbare.batch_sharding() is None
    assert bare.grad_allreduce(params) is params
    m = SparseLinearModel(3, mesh_plan=plan, device="cpu")
    assert m.mesh_plan is plan
    assert m.batch_sharding().axes == plan.axes
    assert m.place_params(params) is params  # one process: nothing to send
    reduced = m.grad_allreduce(params)
    assert all(reduced[k] is params[k] for k in params)


def test_two_rank_mesh_helpers_equal_jax(tmp_path):
    """Two gloo ranks: ``place_params`` gives both rank 0's values, and
    ``grad_allreduce`` the sum of the ranks' grads, as the JAX package's
    ``place_params`` and ``grad_allreduce`` (inside the plan's
    ``shard_map``) on a 2-device CPU mesh."""
    from torch_ranks import run_ranks
    rng = np.random.default_rng(31)
    F = 6
    params = [{"w": rng.standard_normal(F).astype(np.float32),
               "b": np.float32(r + 0.5)} for r in range(2)]
    grads = [{"w": rng.standard_normal(F).astype(np.float32),
              "b": np.float32(rng.standard_normal())} for _ in range(2)]
    res = run_ranks(2, "linear_mesh_helpers", tmp_path, params=params,
                    grads=grads)

    jplan = JaxMeshPlan.build(devices=jax.devices()[:2])
    jm = JaxLinear(F, mesh_plan=jplan)
    placed = jm.place_params({k: jnp.asarray(v)
                              for k, v in params[0].items()})
    stacked = {k: jnp.stack([jnp.asarray(g[k]) for g in grads])
               for k in grads[0]}
    spec = P(jplan.axes)
    reduce = jplan.shard_map(
        lambda g: jax.tree.map(lambda x: x[None], jm.grad_allreduce(
            jax.tree.map(lambda x: x[0], g))), in_specs=(spec,),
        out_specs=spec)
    summed = {k: np.asarray(v)[0] for k, v in reduce(stacked).items()}
    for r in res:
        assert r["axes"] == tuple(jplan.axes)
        for k in params[0]:
            np.testing.assert_array_equal(r["placed"][k],
                                          np.asarray(placed[k]))
            np.testing.assert_array_equal(r["reduced"][k], summed[k])
