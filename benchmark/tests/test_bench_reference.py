"""The plain references agree with the port's CPU route at tiny sizes:
codes, threefry draws and forests."""
import torch

from benchmark.gen import higgs
from benchmark.reference import gbdt as ref
from benchmark.reference import threefry

P = {"num_bins": 256, "max_depth": 4, "eta": 0.3, "lambda": 1.0,
     "gamma": 0.0, "min_child_weight": 1.0, "num_trees": 4,
     "subsample": 0.8, "colsample_bytree": 0.8, "seed": 3_000_000_123}


def test_codes_equal_the_port_binner():
    from dmlc_core_tpu_torch.models import QuantileBinner
    x, _ = higgs.higgs_like(30_000, 28, 11, "cpu")
    sample = x[:5000].numpy()
    want = QuantileBinner(256, device="cpu").fit(sample).transform(x)
    assert torch.equal(ref.codes(x, ref.quantile_cuts(sample, 256)), want)


def test_threefry_copy_equals_the_port_stream():
    from dmlc_core_tpu_torch import random as prandom
    key = prandom.fold_in(prandom.PRNGKey(P["seed"], device="cpu"), 6)
    mine = threefry.fold_in(threefry.prng_key(P["seed"]), 6)
    assert (int(key[0]), int(key[1])) == mine
    assert torch.equal(prandom.bernoulli(key, 0.8, (10_000,), "cpu"),
                       threefry.bernoulli(mine, 0.8, 10_000, "cpu"))
    assert torch.equal(prandom.permutation(key, 28, "cpu"),
                       threefry.permutation(mine, 28, "cpu"))


def test_forests_agree_with_the_port():
    from dmlc_core_tpu_torch.models import GBDT
    x, y = higgs.higgs_like(30_000, 28, 12, "cpu")
    bins = ref.codes(x, ref.quantile_cuts(x[:5000].numpy(), 256))
    port = GBDT(28, num_trees=P["num_trees"], max_depth=P["max_depth"],
                num_bins=256, learning_rate=P["eta"], lambda_=P["lambda"],
                min_child_weight=P["min_child_weight"],
                subsample=P["subsample"],
                colsample_bytree=P["colsample_bytree"], seed=P["seed"],
                device="cpu").fit(bins, y)
    mine = ref.fit(bins, y, P)
    same = ((port["feature"].numpy() == mine["feature"])
            & (port["threshold"].numpy() == mine["threshold"]))
    assert same.mean() >= 0.95
    assert max(ref.audit(mine, bins, y, P).values()) < 1e-9
    a = ref.audit({k: v.numpy() for k, v in port.items()}, bins, y, P)
    assert a["split_err"] < 1e-5 and a["cover_err"] < 1e-5
    assert a["leaf_err"] < 1e-3


def test_btag_columns_hold_three_values():
    x, _ = higgs.higgs_like(30_000, 28, 13, "cpu")
    codes = ref.codes(x, ref.quantile_cuts(x[:5000].numpy(), 256))
    for f in range(28):
        used = len(torch.unique(codes[:, f]))
        if f in higgs.BTAG_COLUMNS:
            assert len(torch.unique(x[:, f])) == 3 and used == 3
        else:
            assert used == 256
