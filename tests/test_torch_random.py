"""The port's threefry stream (dmlc_core_tpu_torch.random) against
``jax.random``, bit for bit, on the CPU: ``PRNGKey``, ``fold_in``,
``bits``, ``uniform``, ``bernoulli`` and ``permutation`` for several
seeds, shapes and ``fold_in`` data, with permutation sizes 28 and 968
(the Higgs and Bosch widths) and 2^16 (two sort rounds).  The JAX side
runs with its defaults, asserted here: a JAX upgrade that changes them
fails loudly instead of moving the port's forests.  Also GBDT's per-tree
draws (``_tree_sampling``, the ``colsample_bylevel`` mask) against the
JAX package's own, equal exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
from dmlc_core_tpu_torch import random as tr
from dmlc_core_tpu_torch.models import GBDT

SEEDS = [0, 7, 2014, 2 ** 31 + 3, -1]
SHAPES = [(), (1,), (5,), (3, 4), (1000,), (2, 3, 5)]


def _key(seed):
    return tr.PRNGKey(seed, device="cpu"), jax.random.PRNGKey(seed)


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    if want.dtype == np.uint32:
        want = want.astype(np.int64)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_jax_defaults_the_port_follows():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable is True
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_equals_jax(seed):
    key, jkey = _key(seed)
    assert key.dtype == torch.int64
    _eq(key, jkey)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 41, 1_000_000, 2 ** 32 - 1])
def test_fold_in_equals_jax(seed, data):
    key, jkey = _key(seed)
    _eq(tr.fold_in(key, data), jax.random.fold_in(jkey, data))
    # chained, as GBDT folds a tree's key and then a depth into it
    _eq(tr.fold_in(tr.fold_in(key, data), 3),
        jax.random.fold_in(jax.random.fold_in(jkey, data), 3))


def test_fold_in_rejects_what_jax_rejects():
    key, jkey = _key(0)
    for bad in (-1, 2 ** 32):
        with pytest.raises(OverflowError):
            jax.random.fold_in(jkey, bad)
        with pytest.raises(OverflowError):
            tr.fold_in(key, bad)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_equals_jax(seed):
    key, jkey = _key(seed)
    for num in (2, 3):
        _eq(tr.split(key, num), jax.random.split(jkey, num))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_uniform_bernoulli_equal_jax(seed, shape):
    key, jkey = _key(seed)
    key, jkey = tr.fold_in(key, 5), jax.random.fold_in(jkey, 5)
    _eq(tr.bits(key, shape), jax.random.bits(jkey, shape))
    u = tr.uniform(key, shape)
    assert u.dtype == torch.float32
    want = np.asarray(jax.random.uniform(jkey, shape))
    np.testing.assert_array_equal(u.numpy().view(np.int32),
                                  want.view(np.int32))
    for p in (0.8, 0.5, 0.1):
        b = tr.bernoulli(key, p, shape)
        assert b.dtype == torch.bool
        _eq(b, jax.random.bernoulli(jkey, p, shape))


@pytest.mark.parametrize("n", [1, 2, 28, 968, 2 ** 16])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_permutation_equals_jax(seed, n):
    key, jkey = _key(seed)
    key, jkey = tr.fold_in(key, 2 * 3 + 1), jax.random.fold_in(jkey, 2 * 3 + 1)
    got = tr.permutation(key, n)
    _eq(got, jax.random.permutation(jkey, n))
    assert sorted(got.tolist()) == list(range(n))


def test_draws_follow_the_device_asked_for():
    """A key on the host draws onto another device on request (here the
    CPU again: the same bits), and a draw's device is the key's by
    default."""
    key = tr.fold_in(tr.PRNGKey(3, device="cpu"), 9)
    a = tr.bits(key, (64,))
    b = tr.bits(key, (64,), device="cpu")
    assert a.device.type == b.device.type == "cpu"
    assert torch.equal(a, b)
    assert torch.equal(tr.permutation(key, 50, device="cpu"),
                       tr.permutation(key, 50))


# ---- GBDT's draws -------------------------------------------------------------

@pytest.mark.parametrize("F,kw", [
    (28, dict(subsample=0.8, colsample_bytree=0.8, colsample_bylevel=0.8)),
    (968, dict(subsample=0.5, colsample_bytree=0.3)),
    (5, dict(colsample_bylevel=0.5)),
])
def test_gbdt_tree_draws_equal_jax(F, kw):
    rows = 777
    w = np.random.default_rng(F).uniform(0.5, 2.0, rows).astype(np.float32)
    jm = JaxGBDT(num_features=F, seed=11, **kw)
    tm = GBDT(num_features=F, seed=11, device="cpu", **kw)
    root, jroot = tr.PRNGKey(11, device="cpu"), jax.random.PRNGKey(11)
    for t_idx in (0, 1, 19):
        jw, jmask = jm._tree_sampling(jroot, t_idx, jnp.asarray(w))
        tw, tmask, ck = tm._tree_keys(t_idx, torch.from_numpy(w))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        jck = jax.random.fold_in(jroot, 1_000_000 + t_idx)
        _eq(ck, jck)
        want_tree = np.asarray(jmask)
        if tmask is None:
            assert want_tree.all()
        else:
            np.testing.assert_array_equal(tmask.numpy(), want_tree)
        for depth in range(3):
            got = tm._level_feature_mask(tmask, ck, depth, None)
            want = np.asarray(jm._level_feature_mask(jmask, jck, depth,
                                                     None))
            if got is None:
                assert want.all()
            else:
                np.testing.assert_array_equal(got.numpy(), want)
    assert tr.fold_in(root, 0).device.type == "cpu"
