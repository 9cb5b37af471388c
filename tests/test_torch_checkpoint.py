"""The port's checkpoints (``dmlc_core_tpu_torch.checkpoint``) against the
JAX package's (``dmlc_core_tpu.checkpoint``), on the CPU.

The same arrays give the same file, byte for byte: leaves in
``jax.tree.flatten``'s order (a mapping's keys sorted, whatever their
insertion order: a ``state_dict()`` is in registration order) and the same
metadata JSON, ``treedef`` in JAX's spelling.  A checkpoint written by
either package loads in the other bit for bit: dicts, lists, tuples,
nesting, ``None``, an FFM's params, a GBDT forest and a ``bfloat16`` leaf
(read without ``ml_dtypes``, as 2-byte words viewed as ``torch.bfloat16``).
Leaves given as numpy arrays and Python scalars (0-d shapes kept), a
forest taken to numpy, namedtuples and ``defaultdict``s write the JAX
package's file too, and ``load(like=...)`` gives back their types.
"""
import collections
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu import checkpoint as jax_ckpt
from dmlc_core_tpu_torch import checkpoint
from dmlc_core_tpu_torch.io import RecordIOReader
from dmlc_core_tpu_torch.models import (FieldAwareFactorizationMachine,
                                        SparseLinearModel, params_from_numpy)
from dmlc_core_tpu_torch.models.common import FOREST_DTYPES


def _forest(seed=0, trees=3, depth=3):
    rng = np.random.default_rng(seed)
    n, leaves = 2 ** depth - 1, 2 ** depth
    shapes = {"feature": (trees, n), "threshold": (trees, n),
              "default_right": (trees, n), "split_gain": (trees, n),
              "split_cover": (trees, n), "leaf": (trees, leaves),
              "base": (), "trees_used": ()}
    return {k: (rng.integers(0, 9, s) if np.issubdtype(FOREST_DTYPES[k],
                                                       np.integer)
                else rng.standard_normal(s)).astype(FOREST_DTYPES[k])
            for k, s in shapes.items()}


def _ffm(seed=1):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal(12).astype(np.float32),
            "v": rng.standard_normal((12, 3, 4)).astype(np.float32),
            "b": np.float32(0.5)}


def _trees():
    """(name, numpy pytree) with every container kind and dtype covered;
    the bfloat16 leaf is built by JAX (numpy has no bfloat16 of its own)."""
    rng = np.random.default_rng(7)
    bf16 = np.asarray(jnp.asarray(rng.standard_normal(9), jnp.bfloat16))
    return {
        "dict": {"w": rng.standard_normal(5).astype(np.float32),
                 "b": np.float32(2.0), "a": np.arange(6, dtype=np.int32)},
        "list and tuple": [np.ones(4, np.float32),
                           (np.zeros((), np.float32),),
                           (np.arange(3, dtype=np.int64), np.bool_(True))],
        "nested with None": {"z": {"y": [np.eye(2, dtype=np.float64)],
                                   "x": None},
                             "k": (np.uint8(3), np.int16(-2))},
        "ffm params": _ffm(),
        "gbdt forest": _forest(),
        "bfloat16 leaf": {"h": bf16, "f": np.float32(1.5)},
    }


def _to_torch(tree):
    """The same pytree with torch leaves (bfloat16 through its words)."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    if tree is None:
        return None
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x):
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes(), str(x.dtype).removeprefix("torch."), \
            tuple(t.shape)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        a = a.view(np.int16)
        return a.tobytes(), "bfloat16", a.shape
    return a.tobytes(), a.dtype.name, a.shape


@pytest.mark.parametrize("name", list(_trees()))
def test_files_byte_identical_and_load_across(name, tmp_path):
    tree = _trees()[name]
    jax_path, port_path = tmp_path / "jax.ckpt", tmp_path / "port.ckpt"
    n = jax_ckpt.save(tree, str(jax_path))
    assert checkpoint.save(_to_torch(tree), str(port_path)) == n
    assert port_path.read_bytes() == jax_path.read_bytes()
    want = jax.tree.leaves(tree)
    # the port reads the JAX package's file: flat, and into a template
    arrays, meta = checkpoint.load(str(jax_path))
    assert meta["treedef"] == str(jax.tree.structure(tree))
    assert [_bits(a) for a in arrays] == [_bits(w) for w in want]
    back = checkpoint.load(str(jax_path), like=_to_torch(tree), device="cpu")
    assert jax.tree.structure(
        jax.tree.map(lambda t: 0, back, is_leaf=lambda x: isinstance(
            x, torch.Tensor))) == jax.tree.structure(
        jax.tree.map(lambda t: 0, tree))
    got = jax.tree.leaves(back, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in got)
    assert [_bits(t) for t in got] == [_bits(w) for w in want]
    # and the JAX package reads the port's
    jarrays, jmeta = jax_ckpt.load(str(port_path))
    assert jmeta == meta
    assert [_bits(a) for a in jarrays] == [_bits(w) for w in want]


NT = collections.namedtuple("NT", ["w", "b"])


def _port_forest_np():
    """A small forest fitted by the port, taken to numpy (its ``base`` and
    ``trees_used`` are 0-d)."""
    from dmlc_core_tpu_torch.models import GBDT
    rng = np.random.default_rng(4)
    bins = torch.from_numpy(rng.integers(0, 8, (64, 3)).astype(np.uint8))
    y = torch.from_numpy((rng.random(64) < 0.5).astype(np.float32))
    forest = GBDT(num_features=3, num_trees=2, max_depth=2, num_bins=8,
                  device="cpu").fit(bins, y)
    return {k: v.numpy() for k, v in forest.items()}


def _host_trees():
    """(name, pytree) saved as given: numpy and Python scalar leaves, and
    the containers JAX spells as custom nodes."""
    rng = np.random.default_rng(9)
    return {
        "0-d numpy leaves": {"s": np.float32(1.5),
                             "z": np.zeros((), np.int32),
                             "a": np.asarray(3), "v": np.arange(2.0)},
        "python scalars": {"step": 3, "lr": 0.25, "flag": True,
                           "xs": [1, 2.5, False]},
        "forest to numpy": _port_forest_np(),
        "namedtuple": NT(w=rng.standard_normal(4).astype(np.float32),
                         b=np.float32(0.5)),
        "defaultdict": collections.defaultdict(
            list, {"b": [np.ones(2, np.float32)],
                   "a": [np.arange(3), np.int16(-2)]}),
        "nested custom nodes": {
            "opt": NT(w=(np.float32(1.0),), b=None),
            "d": collections.defaultdict(None, {"q": np.eye(2)}),
            "empty": collections.defaultdict(int)},
    }


def _types(tree):
    """The container types of ``tree``, with namedtuple classes and
    defaultdict factories, leaves as None."""
    if isinstance(tree, collections.defaultdict):
        return ("defaultdict", tree.default_factory,
                {k: _types(v) for k, v in tree.items()})
    if isinstance(tree, dict):
        return ("dict", {k: _types(v) for k, v in tree.items()})
    if isinstance(tree, (list, tuple)):
        return (type(tree), [_types(v) for v in tree])
    return None


@pytest.mark.parametrize("name", list(_host_trees()))
def test_host_leaves_and_custom_nodes_byte_identical(name, tmp_path):
    """The port's writer takes numpy and Python scalar leaves, namedtuples
    and defaultdicts as given: the JAX package's file byte for byte (0-d
    leaves write ``"shape": []``), and ``load(like=...)`` gives back the
    template's types with JAX's shapes."""
    tree = _host_trees()[name]
    jax_path, port_path = tmp_path / "jax.ckpt", tmp_path / "port.ckpt"
    n = jax_ckpt.save(tree, str(jax_path))
    assert checkpoint.save(tree, str(port_path)) == n
    assert port_path.read_bytes() == jax_path.read_bytes()
    _, meta = checkpoint.load(str(port_path))
    assert meta["treedef"] == str(jax.tree.structure(tree))
    shapes = [np.shape(x) for x in
              jax.tree.leaves(jax_ckpt.load(str(port_path), like=tree))]
    assert [tuple(s["shape"]) for s in meta["leaves"]] == shapes
    want, _ = jax_ckpt.load(str(port_path))
    back = checkpoint.load(str(port_path), like=tree, device="cpu")
    assert _types(back) == _types(tree)
    got = jax.tree.leaves(back, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert [_bits(t) for t in got] == [_bits(w) for w in want]


def test_unsorted_state_dict_round_trips_to_its_keys(tmp_path):
    """An FFM's state_dict lists w, v, b (registration order); the file
    holds b, v, w as the JAX package's does, and loads back by name."""
    params = _ffm(3)
    ffm = FieldAwareFactorizationMachine(12, 3, num_factors=4, device="cpu")
    ffm.load_state_dict(params_from_numpy("ffm", params, "cpu"))
    sd = ffm.state_dict()
    assert list(sd) == ["w", "v", "b"]
    path = tmp_path / "ffm.ckpt"
    checkpoint.save(sd, str(path))
    jax_path = tmp_path / "ffm_jax.ckpt"
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jax_ckpt.save(jparams, str(jax_path))
    assert path.read_bytes() == jax_path.read_bytes()
    _, meta = checkpoint.load(str(path))
    assert meta["treedef"] == "PyTreeDef({'b': *, 'v': *, 'w': *})"
    fresh = FieldAwareFactorizationMachine(12, 3, num_factors=4,
                                           device="cpu")
    back = checkpoint.load(str(path), like=fresh.state_dict(), device="cpu")
    assert list(back) == ["w", "v", "b"]
    fresh.load_state_dict(back)
    for k, v in params.items():
        np.testing.assert_array_equal(fresh.state_dict()[k].numpy(), v)
    restored = jax_ckpt.load(str(path), like=jparams)
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(restored[k]), v)


def test_checkpoint_is_a_recordio_container_and_contracts(tmp_path):
    model = SparseLinearModel(8, device="cpu")
    path = str(tmp_path / "lin.ckpt")
    assert checkpoint.save(model.state_dict(), path) == 2
    with RecordIOReader(path) as reader:
        records = list(reader)
    assert len(records) == 3  # the meta, then one record a leaf
    meta = json.loads(records[0])
    assert meta == {"version": 1, "treedef": "PyTreeDef({'b': *, 'w': *})",
                    "leaves": [{"dtype": "float32", "shape": []},
                               {"dtype": "float32", "shape": [8]}]}
    with pytest.raises(ValueError, match="template has"):
        checkpoint.load(path, like={"b": 0, "w": 0, "x": 0}, device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            checkpoint.load(path, like=model.state_dict())


def test_multi_process_is_refused(tmp_path, monkeypatch):
    # multi-process checkpoints are ported (a real 2-process save:
    # test_two_process_save_is_the_jax_file): a process other than 0
    # writes nothing and returns 0, and raises when the writer's sync
    # reports a failed write
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda: "gloo")
    writer_ok = [1]

    def all_reduce(flag, op=None):
        flag.fill_(writer_ok[0])

    monkeypatch.setattr(torch.distributed, "all_reduce", all_reduce)
    path = tmp_path / "x.ckpt"
    assert checkpoint.save({"a": np.ones(2)}, str(path)) == 0
    assert not path.exists()
    writer_ok[0] = 0
    with pytest.raises(RuntimeError, match="failed on the writer"):
        checkpoint.save({"a": np.ones(2)}, str(path))


def test_module_state_round_trip_predicts_bit_identically(tmp_path):
    """save -> load -> margins is bit-identical for a trained module (the
    serving hot swap builds on it)."""
    from dmlc_core_tpu_torch.data.staging import PaddedBatch
    rng = np.random.default_rng(5)
    ffm = FieldAwareFactorizationMachine(12, 3, num_factors=4,
                                         device="cpu").init(4)
    with torch.no_grad():
        ffm.w.copy_(torch.from_numpy(rng.standard_normal(12).astype(
            np.float32)))
    batch = PaddedBatch(
        label=torch.zeros(4), weight=torch.ones(4),
        row_ptr=torch.tensor([0, 2, 3, 6, 6], dtype=torch.int32),
        index=torch.tensor([1, 5, 11, 0, 3, 7, 0, 0], dtype=torch.int32),
        value=torch.tensor([1.0, 0.5, 2.0, -1.0, 0.25, 1.5, 0.0, 0.0]),
        field=torch.tensor([0, 2, 1, 1, 0, 2, 0, 0], dtype=torch.int32),
        num_rows=4)
    path = str(tmp_path / "m.ckpt")
    checkpoint.save(ffm.state_dict(), path)
    twin = FieldAwareFactorizationMachine(12, 3, num_factors=4, device="cpu")
    twin.load_state_dict(checkpoint.load(path, like=twin.state_dict(),
                                         device="cpu"))
    with torch.no_grad():
        assert torch.equal(twin.margins(batch), ffm.margins(batch))


def test_two_process_save_is_the_jax_file(tmp_path):
    """Two gloo ranks save FM params whose ``w`` is row-sharded over the
    mesh (a DTensor): rank 0 writes the JAX package's one-process file of
    the same values, byte for byte; rank 1 writes nothing; both load it
    back."""
    from dmlc_core_tpu import checkpoint as jax_checkpoint
    from torch_ranks import run_ranks
    rng = np.random.default_rng(12)
    params = {"w": rng.standard_normal(16).astype(np.float32),
              "v": rng.standard_normal((16, 4)).astype(np.float32),
              "b": np.float32(0.5)}
    path = tmp_path / "two.ckpt"
    res = run_ranks(2, "checkpoint_save", tmp_path, params=params,
                    path=str(path))
    want = tmp_path / "jax.ckpt"
    jax_checkpoint.save({k: jnp.asarray(v) for k, v in params.items()},
                        str(want))
    assert path.read_bytes() == want.read_bytes()
    assert [r[0] for r in res] == [3, 0]
    for _, arrays, meta in res:
        for a, k in zip(arrays, sorted(params)):
            np.testing.assert_array_equal(a, params[k])
