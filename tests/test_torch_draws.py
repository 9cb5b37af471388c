"""A sampled tree's draws (``dmlc_core_tpu_torch.ops.draws``) on the CPU,
against ``jax.random``.  The column draw runs on the host and its mask is
``jax.random.permutation``'s; the row draw on CPU tensors takes the plain
route (no kernel launch) and equals ``w * bernoulli(...)`` bit for bit,
with and without an index of stream elements.  The kernel itself is held
to the plain route on the card (``test_torch_cuda_draws.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch import random as tr
from dmlc_core_tpu_torch.models import GBDT
from dmlc_core_tpu_torch.ops import draws

SEED = 2 ** 31 + 5
TINY = float(np.nextafter(np.float32(0), np.float32(1)))


def _weights(n, seed=0):
    """Weights with zeros and negatives, so a dropped negative is -0.0."""
    w = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    w[::7] = 0.0
    return torch.from_numpy(w)


def _bits_equal(a: torch.Tensor, b) -> None:
    b = torch.as_tensor(np.asarray(b))
    assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("t_idx", [0, 1, 19])
@pytest.mark.parametrize("frac", [0.3, 0.8])
@pytest.mark.parametrize("F", [1, 5, 28, 968])
def test_host_column_mask_equals_jax_permutation(F, frac, t_idx):
    kc = tr.fold_in(tr.PRNGKey(SEED, device="cpu"), 2 * t_idx + 1)
    jkc = jax.random.fold_in(jax.random.PRNGKey(SEED), 2 * t_idx + 1)
    k = max(1, int(round(frac * F)))
    want = np.asarray(jnp.zeros(F, bool).at[
        jax.random.permutation(jkc, F)[:k]].set(True))
    got = draws.column_mask(kc, F, k, "cpu")
    assert got.dtype == torch.bool and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # the model's tree draw is that mask
    model = GBDT(num_features=F, colsample_bytree=frac, seed=SEED,
                 device="cpu")
    w = torch.ones(5)
    w_t, mask, _ = model._tree_keys(t_idx, w)
    assert w_t is w
    np.testing.assert_array_equal(mask.numpy(), want)


@pytest.mark.parametrize("p", [0.0, TINY, 0.5, 0.8, 1.0])
def test_sample_weights_on_cpu_is_plain_and_equals_jax(p):
    n = 10_007
    key = tr.fold_in(tr.PRNGKey(SEED, device="cpu"), 6)
    jkey = jax.random.fold_in(jax.random.PRNGKey(SEED), 6)
    w = _weights(n)
    before = draws.sample_weights.launches
    got = draws.sample_weights(key, p, w)
    assert draws.sample_weights.launches == before
    keep = np.array(jax.random.bernoulli(jkey, p, (n,)))
    _bits_equal(got, w.numpy() * keep.astype(np.float32))
    _bits_equal(got, w * tr.bernoulli(key, p, (n,)).to(torch.float32))
    # a dropped negative weight is -0.0, as the product gives it
    dropped = (~torch.from_numpy(keep)) & (w < 0)
    if dropped.any():
        assert torch.signbit(got[dropped]).all()


@pytest.mark.parametrize("p", [0.0, TINY, 0.5, 0.8, 1.0])
def test_sample_weights_on_cpu_at_an_index_equals_bernoulli_at(p):
    n = 4099
    key = tr.fold_in(tr.PRNGKey(SEED, device="cpu"), 8)
    w = _weights(n, 1)
    gen = torch.Generator().manual_seed(3)
    # stream elements at and past 2^32 (a sharded fit's global row numbers)
    index = torch.cat([torch.arange(2 ** 32 - 2, 2 ** 32 + 2),
                       torch.randint(0, 2 ** 40, (n - 4,), generator=gen)])
    before = draws.sample_weights.launches
    got = draws.sample_weights(key, p, w, index)
    assert draws.sample_weights.launches == before
    _bits_equal(got, w * tr.bernoulli_at(key, p, index).to(torch.float32))
    # at small elements the index reads jax.random.bernoulli's stream
    jkey = jax.random.fold_in(jax.random.PRNGKey(SEED), 8)
    perm = torch.randperm(n, generator=gen)
    keep = np.asarray(jax.random.bernoulli(jkey, p, (n,)))[perm.numpy()]
    _bits_equal(draws.sample_weights(key, p, w, perm),
                w.numpy() * keep.astype(np.float32))
