"""The multi-class and ranking GBDT of the port against the JAX package's,
on the CPU, at the shapes of chip_smoke.py's full-width objectives cut
down: a Covertype-shaped softmax (7 classes at the dataset's skew over 10
continuous, 4 wilderness and 40 soil one-hot columns, a planted rule) and
an MSLR-WEB10K-shaped ``rank:pairwise`` fit (queries of a long-tailed size
whose largest makes the pairwise scan deeper than 64 shifts, relevance
0-4 skewed to 0).

* Both fits grow the JAX package's forest node for node on both of the
  port's histogram routes (leaves, gains and covers within
  tests/test_torch_gbdt.py's tolerances), and the carried forests score
  within 2e-5 of the JAX package's margins.
* The first round's (grad, hess) equal a float64 numpy recomputation
  within 1e-5 of the largest: ``p - onehot`` and ``p(1-p)`` per class;
  RankNet over every same-query pair with XGBoost's signs.
* Softmax early stopping on a held-out fifth keeps the round that the
  JAX package keeps and that a float64 replay of the per-round eval loss
  picks.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
from dmlc_core_tpu.models.gbdt import QuantileBinner as JaxBinner
from dmlc_core_tpu_torch.models import GBDT, QuantileBinner
from dmlc_core_tpu_torch.models.gbdt import _validate_rank_qid

EXACT = ("feature", "threshold", "default_right", "trees_used")
CLOSE = ("leaf", "split_gain", "split_cover", "base")
FOREST_TOL = dict(rtol=1e-5, atol=1e-6)
MARGIN_TOL = 2e-5
GH_TOL = 1e-5

# UCI Covertype's class counts (Blackard 1998), classes 1-7 as 0-6, and
# the order of their mean elevations, lowest first
COVER_COUNTS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367, 20_510)
COVER_ELEVATION_ORDER = (3, 2, 5, 4, 1, 0, 6)
# MSLR-WEB10K Fold1 train's relevance shares, labels 0-4
MSLR_SHARES = (0.522, 0.321, 0.131, 0.017, 0.009)


def covertype_like(rows: int, seed: int) -> tuple:
    """(x [rows, 54] f32, label [rows]): 10 continuous columns, 4
    wilderness and 40 soil one-hot columns; the classes at Covertype's
    shares, cut from a latent elevation that the first column, the
    wilderness area and the soil type set, so trees can learn them."""
    rng = np.random.default_rng(seed)
    cont = rng.standard_normal((rows, 10)).astype(np.float32)
    wild = rng.choice(4, rows, p=(0.45, 0.05, 0.44, 0.06))
    soil = rng.integers(0, 40, rows)
    latent = (cont[:, 0] + 0.6 * (wild == 2) - 0.8 * (wild == 3)
              + 0.5 * np.sin(soil) + 0.3 * cont[:, 1] * cont[:, 2])
    counts = np.floor(np.asarray(COVER_COUNTS) * rows
                      / sum(COVER_COUNTS)).astype(np.int64)
    counts = np.maximum(counts, 1)
    counts[1] += rows - counts.sum()
    label = np.empty(rows, np.float32)
    order = np.argsort(latent, kind="stable")
    edges = np.concatenate([[0], np.cumsum(
        [counts[c] for c in COVER_ELEVATION_ORDER])])
    for k, c in enumerate(COVER_ELEVATION_ORDER):
        label[order[edges[k]:edges[k + 1]]] = c
    x = np.concatenate([cont, np.eye(4, dtype=np.float32)[wild],
                        np.eye(40, dtype=np.float32)[soil]], axis=1)
    return x, label


def mslr_like(groups: int, features: int, seed: int,
              mean_docs: float = 20.0) -> tuple:
    """(x, relevance, qid): ``groups`` queries, rows contiguous by qid, of
    long-tailed sizes (lognormal around ``mean_docs``, the largest at
    least 3.5x it); relevance 0-4 at MSLR_SHARES from a latent that a few
    features and a per-query offset set."""
    rng = np.random.default_rng(seed)
    sizes = np.maximum(2, rng.lognormal(np.log(mean_docs) - 0.32, 0.8,
                                        groups).astype(np.int64))
    sizes[np.argmax(sizes)] = max(int(sizes.max()),
                                  int(3.5 * mean_docs) + 1)
    qid = np.repeat(np.arange(groups), sizes).astype(np.int32)
    rows = qid.size
    x = rng.standard_normal((rows, features)).astype(np.float32)
    latent = (x[:, 0] + 0.7 * x[:, 1] * (x[:, 2] > 0) - 0.5 * x[:, 3]
              + np.repeat(rng.normal(0, 0.5, groups), sizes)
              + rng.normal(0, 0.3, rows))
    cuts = np.quantile(latent, np.cumsum(MSLR_SHARES)[:-1])
    rel = np.searchsorted(cuts, latent).astype(np.float32)
    return x, rel, qid


def softmax_gh64(margin: np.ndarray, label: np.ndarray) -> np.ndarray:
    """float64 [rows, K, 2]: ``p - onehot`` and ``p(1-p)`` per class."""
    m = margin.astype(np.float64)
    p = np.exp(m - m.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    onehot = np.eye(m.shape[1])[label.astype(np.int64)]
    return np.stack([p - onehot, np.maximum(p * (1 - p), 1e-16)], -1)


def ranknet_gh64(margin: np.ndarray, label: np.ndarray,
                 qid: np.ndarray) -> np.ndarray:
    """float64 [rows, 2]: RankNet over every same-query pair of differing
    relevance, XGBoost's signs (the winner's grad falls, the loser's
    rises)."""
    m, y = margin.astype(np.float64), label.astype(np.float64)
    out = np.zeros((m.size, 2))
    starts = np.flatnonzero(np.r_[True, qid[1:] != qid[:-1]])
    for a, b in zip(starts, np.r_[starts[1:], qid.size]):
        d = m[a:b, None] - m[None, a:b]          # d[i, j] = m_i - m_j
        win = y[a:b, None] > y[None, a:b]        # i beats j
        p = np.where(win, 1.0 / (1.0 + np.exp(d)), 0.0)
        hh = np.where(win, np.maximum(p * (1 - p), 1e-16), 0.0)
        out[a:b, 0] = -p.sum(1) + p.sum(0)
        out[a:b, 1] = hh.sum(1) + hh.sum(0)
    return out


@functools.lru_cache(maxsize=None)
def _case(name: str) -> tuple:
    """(x, fit kwargs, GBDT kwargs) of a case."""
    if name == "covertype":
        x, y = covertype_like(4000, seed=581)
        return x, dict(label=y), dict(
            num_features=54, num_trees=3, max_depth=4, num_bins=32,
            learning_rate=0.5, objective="softmax", num_class=7)
    x, y, q = mslr_like(60, 12, seed=136)
    return x, dict(label=y, qid=q), dict(
        num_features=12, num_trees=3, max_depth=4, num_bins=32,
        learning_rate=0.3, objective="rank:pairwise")


@functools.lru_cache(maxsize=None)
def _jax(name: str) -> tuple:
    x, fit, kw = _case(name)
    binner = JaxBinner(num_bins=kw["num_bins"]).fit(x)
    bins = binner.transform(jnp.asarray(x))
    model = JaxGBDT(histogram="xla", **kw)
    forest = model.fit(bins, **{k: jnp.asarray(v) for k, v in fit.items()})
    margins = (model.margins_multi(forest, bins) if name == "covertype"
               else model.margins(forest, bins))
    return ({k: np.asarray(v) for k, v in forest.items()},
            np.asarray(margins), np.asarray(binner.cuts))


def test_fixtures_have_the_chip_shapes():
    x, fit, _ = _case("covertype")
    assert x.shape[1] == 54
    np.testing.assert_array_equal(x[:, 10:14].sum(1), 1)
    np.testing.assert_array_equal(x[:, 14:].sum(1), 1)
    counts = np.bincount(fit["label"].astype(np.int64), minlength=7)
    share = np.asarray(COVER_COUNTS) / sum(COVER_COUNTS)
    assert np.abs(counts / counts.sum() - share).max() < 0.005, counts
    _, fit, _ = _case("mslr")
    depth = _validate_rank_qid(torch.from_numpy(fit["qid"]))
    assert depth > 64, depth
    shares = np.bincount(fit["label"].astype(np.int64)) / fit["label"].size
    assert np.abs(shares - MSLR_SHARES).max() < 0.01, shares


@pytest.mark.parametrize("histogram", ["xla", "pallas"])
@pytest.mark.parametrize("name", ["covertype", "mslr"])
def test_forest_and_margins_equal_jax(name, histogram):
    want, want_m, cuts = _jax(name)
    x, fit, kw = _case(name)
    binner = QuantileBinner(num_bins=kw["num_bins"], device="cpu").fit(x)
    np.testing.assert_array_equal(binner.cuts.numpy(), cuts)
    bins = binner.transform(x)
    model = GBDT(histogram=histogram, device="cpu", **kw)
    got = model.fit(bins, **fit)
    assert sorted(got) == sorted(want)
    for k in EXACT:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in CLOSE:
        tol = dict(FOREST_TOL)
        if k == "split_gain":
            # a gain is a difference of G^2/H terms near the root's: its
            # rounding scales with the largest gain.  The kernel's plain
            # version sums each bin as a one-hot contraction in blocks,
            # another order than the scatter's, so 1e-5 of the largest
            # there; 4 f32 ulps of it on index_add
            big = float(np.abs(want[k]).max())
            tol["atol"] = (4 * 2.0 ** -23 if histogram == "xla"
                           else 1e-5) * big
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **tol)
    m = (model.margins_multi(got, bins) if name == "covertype"
         else model.margins(got, bins))
    np.testing.assert_allclose(m.numpy(), want_m, rtol=0, atol=MARGIN_TOL)


def test_first_round_gh_against_float64():
    x, fit, kw = _case("covertype")
    model = GBDT(device="cpu", **kw)
    label = torch.from_numpy(fit["label"])
    base = model.fit(QuantileBinner(kw["num_bins"], device="cpu")
                     .fit_transform(x), label)["base"]
    margin = base.expand(label.shape[0], 7)
    p = torch.softmax(margin, 1)
    onehot = torch.nn.functional.one_hot(label.long(), 7)
    got = torch.stack([p - onehot, torch.clamp(p * (1 - p), min=1e-16)], -1)
    want = softmax_gh64(margin.numpy(), fit["label"])
    assert np.abs(got.numpy() - want).max() <= GH_TOL * np.abs(want).max()

    x, fit, kw = _case("mslr")
    model = GBDT(device="cpu", **kw)
    label = torch.from_numpy(fit["label"])
    gh, _ = model._rank_fns(fit["qid"], torch.ones_like(label))
    rng = np.random.default_rng(3)
    margin = torch.from_numpy(rng.normal(0, 1, label.shape[0])
                              .astype(np.float32))
    g, h = gh(margin, label)
    want = ranknet_gh64(margin.numpy(), fit["label"], fit["qid"])
    got = torch.stack([g, h], -1).numpy()
    assert np.abs(got - want).max() <= GH_TOL * np.abs(want).max()


def test_softmax_early_stopping_round():
    """The Covertype-shaped softmax on four fifths of its rows, the rest
    held out, ``early_stopping_rounds=2`` over 8 rounds: ``trees_used`` is
    the JAX package's and the round whose float64 held-out loss is least
    (over the rounds the fit ran), times 7 classes."""
    x, fit, kw = _case("covertype")
    kw = dict(kw, num_trees=8, learning_rate=1.5)
    cut = x.shape[0] * 4 // 5
    y = fit["label"]
    binner = QuantileBinner(num_bins=kw["num_bins"], device="cpu").fit(x)
    bins = binner.transform(x)
    model = GBDT(device="cpu", **kw)
    got = model.fit(bins[:cut], y[:cut], eval_set=(bins[cut:], y[cut:]),
                    early_stopping_rounds=2)
    jb = JaxBinner(num_bins=kw["num_bins"]).fit(x)
    jbins = jb.transform(jnp.asarray(x))
    want = JaxGBDT(histogram="xla", **kw).fit(
        jbins[:cut], jnp.asarray(y[:cut]),
        eval_set=(jbins[cut:], jnp.asarray(y[cut:])),
        early_stopping_rounds=2)
    assert int(got["trees_used"]) == int(want["trees_used"])
    # the float64 replay: every round the full fit grows, scored on the
    # held-out rows
    full = GBDT(device="cpu", **kw).fit(bins[:cut], y[:cut])
    ev = bins[cut:]
    m = np.tile(full["base"].numpy().astype(np.float64), (ev.shape[0], 1))
    losses = []
    for r in range(kw["num_trees"]):
        for k in range(7):
            t = r * 7 + k
            m[:, k] += model._tree_margins(
                full["feature"][t], full["threshold"][t],
                full["default_right"][t], full["leaf"][t], ev
            ).numpy().astype(np.float64)
        z = m - m.max(1, keepdims=True)
        logp = z - np.log(np.exp(z).sum(1, keepdims=True))
        losses.append(-logp[np.arange(ev.shape[0]),
                            y[cut:].astype(np.int64)].mean())
    ran = int(got["trees_used"]) // 7 + 2
    assert ran < kw["num_trees"], "the fit did not stop early"
    assert int(got["trees_used"]) == 7 * (1 + int(np.argmin(losses[:ran])))
