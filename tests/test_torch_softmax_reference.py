"""The benchmark's plain softmax reference (``benchmark/reference/
gbdt_softmax.py``) against the port's multi-class fit, on the CPU at a
small size: Covertype-width rows from the benchmark's generator, 7
classes, depth 4, 4 rounds, a fifth of the rows held out.

The port's forest and its held-out losses (``GBDT.eval_history``) pass
every limit of the ``covertype.fit`` cell; the reference's own float64 fit
picks the port's split at every node up to the first near-tie; the
bfloat16 control fails a limit; and the held-out set changes nothing of
the forest.
"""
import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.gen import covertype
from benchmark.reference import gbdt as ref
from benchmark.reference import gbdt_softmax as ref_softmax
from dmlc_core_tpu_torch.models import GBDT

ROOT = Path(__file__).resolve().parent.parent
LIMITS = json.loads((ROOT / "benchmark/traffic/fit_resident_eval.json")
                    .read_text())["limits"]
ROWS, HELD, K, SEED = 4000, 800, 7, 3_100_000_019
P = {"num_bins": 256, "max_depth": 4, "eta": 0.3, "lambda": 1.0,
     "gamma": 0.0, "min_child_weight": 1.0, "num_trees": 4, "num_class": K}


@pytest.fixture(scope="module")
def data():
    """(train codes, train labels, eval codes, eval labels): the
    reference's codes, cuts from the first 2,000 rows."""
    x, y = covertype.covertype_like(ROWS, SEED, "cpu")
    codes = ref.codes(x, ref.quantile_cuts(x[:2000].numpy(), P["num_bins"]))
    n = ROWS - HELD
    return codes[:n], y[:n], codes[n:], y[n:]


def _port():
    return GBDT(covertype.FEATURES, num_trees=P["num_trees"],
                max_depth=P["max_depth"], num_bins=P["num_bins"],
                learning_rate=P["eta"], lambda_=P["lambda"],
                gamma=P["gamma"], min_child_weight=P["min_child_weight"],
                objective="softmax", num_class=K, device="cpu")


@pytest.fixture(scope="module")
def port(data):
    """(forest as numpy, eval_history) of the port's fit with the eval
    set."""
    model = _port()
    forest = model.fit(data[0], data[1], eval_set=(data[2], data[3]))
    return {k: v.numpy() for k, v in forest.items()}, model.eval_history


def test_the_port_passes_every_limit_of_the_cell(data, port):
    forest, history = port
    got = ref_softmax.audit(forest, data[0], data[1], P, data[2], data[3],
                            history)
    assert set(got) == set(LIMITS) - {"codes_wrong"}
    for k, v in got.items():
        assert v <= LIMITS[k], (k, v)


def _children(j: int, internal: int) -> list:
    return [c for c in (2 * j + 1, 2 * j + 2) if c < internal]


def _agreeing_trees(port: dict, mine: dict) -> int:
    """Trees compared before the first near-tie: every node's (feature,
    threshold) is the same, except where the two gains lie within 1e-5 of
    each other on the same rows (then that node's subtree, and every later
    tree, grows from other margins and is not compared)."""
    trees, internal = port["feature"].shape
    for t in range(trees):
        tied, skip = False, set()
        for j in range(internal):
            if j in skip:
                skip.update(_children(j, internal))
                continue
            if (port["feature"][t, j], port["threshold"][t, j]) == (
                    mine["feature"][t, j], mine["threshold"][t, j]):
                continue
            gain = mine["split_gain"][t, j]
            assert abs(port["split_gain"][t, j] - gain) <= 1e-5 * abs(gain)
            assert abs(port["split_cover"][t, j]
                       - mine["split_cover"][t, j]) <= 1e-5 * (
                mine["split_cover"][t, j] + P["lambda"])
            tied = True
            skip.update(_children(j, internal))
        if tied:
            return t
    return trees


def test_float64_fit_picks_the_ports_splits(data, port):
    forest, _ = port
    mine, losses = ref_softmax.fit(data[0], data[1], P, data[2], data[3])
    assert max(ref_softmax.audit(mine, data[0], data[1], P, data[2],
                                 data[3], losses).values()) < 1e-9
    # this seed's first near-tie is in tree 6 (round 0, class 6; gains
    # 5.6937895 and 5.6937882 on features 4 and 2)
    assert _agreeing_trees(forest, mine) == 6
    np.testing.assert_allclose(forest["leaf"][:6], mine["leaf"][:6],
                               rtol=1e-4, atol=1e-6)


def test_the_bfloat16_control_fails_a_limit(data):
    forest, losses = ref_softmax.fit(data[0], data[1], P, data[2], data[3],
                                     torch.bfloat16)
    got = ref_softmax.audit(forest, data[0], data[1], P, data[2], data[3],
                            losses)
    assert [k for k, v in got.items() if v > LIMITS[k]], got


def test_eval_history_is_the_float64_mlogloss_of_each_round(data, port):
    forest, history = port
    assert len(history) == P["num_trees"]
    assert all(isinstance(v, float) for v in history)
    m = ref_softmax.base_margin(data[1], K).expand(HELD, K).clone()
    leaf = torch.as_tensor(forest["leaf"]).double()
    for r in range(P["num_trees"]):
        for k in range(K):
            t = r * K + k
            m[:, k] += leaf[t][ref_softmax.leaves_of(
                data[2], torch.as_tensor(forest["feature"][t]),
                torch.as_tensor(forest["threshold"][t]), P["max_depth"])]
        want = ref_softmax.mlogloss(m, data[3])
        assert abs(history[r] - want) / want <= LIMITS["eval_err"]
    assert history[-1] < history[0]


def test_a_skipped_or_wrong_evaluation_fails_eval_err(data, port):
    forest, history = port
    audit = lambda losses: ref_softmax.audit(  # noqa: E731
        forest, data[0], data[1], P, data[2], data[3], losses)["eval_err"]
    assert audit([]) == float("inf")
    assert audit(history[:-1]) == float("inf")
    assert audit([h * 1.001 for h in history]) > LIMITS["eval_err"]


def test_the_eval_set_changes_nothing_of_the_forest(data, port):
    model = _port()
    plain = model.fit(data[0], data[1])
    assert model.eval_history == []
    forest, _ = port
    assert sorted(plain) == sorted(forest)
    for k in plain:
        np.testing.assert_array_equal(plain[k].numpy(), forest[k], k)


def test_generator_classes_and_one_hot_columns():
    x, y = covertype.covertype_like(ROWS, SEED, "cpu")
    assert x.shape == (ROWS, covertype.FEATURES) and x.dtype == torch.float32
    counts = torch.bincount(y.long(), minlength=K).tolist()
    assert counts == covertype.class_counts(ROWS) and sum(counts) == ROWS
    assert covertype.class_counts(covertype.ROWS) == list(covertype.COUNTS)
    for cols in (slice(10, 14), slice(14, 54)):
        block = x[:, cols]
        assert bool(((block == 0) | (block == 1)).all())
        assert bool((block.sum(1) == 1).all())
    x2, y2 = covertype.covertype_like(ROWS, SEED, "cpu")
    assert torch.equal(x, x2) and torch.equal(y, y2)


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", ["benchmark/reference/gbdt_softmax.py",
                                  "benchmark/gen/covertype.py"])
def test_reference_and_generator_import_nothing_of_either_package(path):
    got = _imports(ROOT / path)
    assert not got & {"jax", "jaxlib", "dmlc_core_tpu",
                      "dmlc_core_tpu_torch"}, got
    assert "torch" in got
