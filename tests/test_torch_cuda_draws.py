"""On-card tests of a sampled tree's draws (marker ``cuda``; each skips when
no CUDA device is present).  They import neither JAX nor the JAX package::

    python -m pytest --noconftest -m cuda -rP tests/test_torch_cuda_draws.py

The row-draw kernel (``csrc/threefry.cu``, ``ops.draws.sample_weights``)
equals its plain version bit for bit, at every size from one row to
Higgs's 11M, at the edges of ``p``, with and without an index past 2^32;
it refuses what it does not take.  ``GBDT._tree_keys`` on a model on the
card equals the same call on the CPU (weights, column mask, level key),
and a sampled fit launches the kernel once a tree.
"""
import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch import random as tr
from dmlc_core_tpu_torch.models import GBDT, QuantileBinner
from dmlc_core_tpu_torch.ops import draws

pytestmark = pytest.mark.cuda
SEED = 3_100_000_007
TINY = float(np.nextafter(np.float32(0), np.float32(1)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _weights(n, device):
    """Normal weights with zeros, so a dropped negative is -0.0."""
    g = torch.Generator(device=device).manual_seed(n)
    w = torch.randn(n, generator=g, device=device)
    w[::7] = 0.0
    return w


def _index(n, device):
    """Stream elements at and past 2^32 (a sharded fit's global rows)."""
    g = torch.Generator(device=device).manual_seed(n + 1)
    index = torch.randint(0, 2 ** 40, (n,), generator=g, device=device)
    index[:4] = torch.arange(2 ** 32 - 2, 2 ** 32 + 2, device=device)[:n]
    return index


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("p", [0.0, TINY, 0.5, 0.8, 1.0])
@pytest.mark.parametrize("n", [1, 31, 1_000_003, 11_000_000])
def test_sample_weights_kernel_equals_plain_bit_for_bit(cuda, n, p, indexed):
    key = tr.fold_in(tr.PRNGKey(SEED, device="cpu"), 40)
    w = _weights(n, cuda)
    index = _index(n, cuda) if indexed else None
    before = draws.sample_weights.launches
    got = draws.sample_weights(key, p, w, index)
    torch.cuda.synchronize()
    assert draws.sample_weights.launches == before + 1
    want = draws.sample_weights_plain(key, p, w, index)
    assert got.dtype == torch.float32 and got.device == w.device
    assert torch.equal(_bits(got), _bits(want))
    assert torch.signbit(got[(want == 0) & (w < 0)]).all()
    if p == 0.0:
        assert not got.count_nonzero()
    if p == 1.0:
        assert torch.equal(_bits(got), _bits(w))


def test_sample_weights_kernel_refuses_what_it_does_not_take(cuda):
    key = tr.PRNGKey(SEED, device="cpu")
    w = _weights(1000, cuda)
    index = torch.arange(1000, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        draws.sample_weights(key, 0.5, w[::2])
    with pytest.raises(ValueError, match="contiguous"):
        draws.sample_weights(key, 0.5, w[:500],
                             torch.arange(1000, device=cuda)[::2])
    with pytest.raises(TypeError):
        draws.sample_weights(key, 0.5, w.double())
    with pytest.raises(TypeError):
        draws.sample_weights(key, 0.5, w, index.int())
    with pytest.raises(ValueError):
        draws.sample_weights(key, 0.5, w, index[:999])
    with pytest.raises(ValueError):
        draws.sample_weights(key, 0.5, w, index.cpu())
    assert draws.sample_weights(key, 0.5, w[:0]).shape == (0,)


@pytest.mark.parametrize("F", [28, 968])
def test_tree_keys_on_card_equal_cpu(cuda, F):
    kw = dict(num_features=F, subsample=0.8, colsample_bytree=0.8, seed=SEED)
    w = torch.rand(1_000_003, generator=torch.Generator().manual_seed(F))
    card, host = GBDT(device=cuda, **kw), GBDT(device="cpu", **kw)
    for t in (0, 1, 19):
        cw, cm, ck = card._tree_keys(t, w.to(cuda))
        hw, hm, hk = host._tree_keys(t, w)
        assert cm.device == cw.device == w.to(cuda).device
        assert torch.equal(_bits(cw.cpu()), _bits(hw))
        assert torch.equal(cm.cpu(), hm)
        assert int(cm.sum()) == round(0.8 * F)
        assert ck.device.type == "cpu" and torch.equal(ck, hk)


def test_sampled_fit_launches_the_kernel_once_a_tree(cuda):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((50_000, 28)).astype(np.float32)
    y = (x[:, 0] * x[:, 1] > 0).astype(np.float32)
    bins = QuantileBinner(num_bins=256, device=cuda).fit_transform(x)
    model = GBDT(num_features=28, num_trees=20, subsample=0.8,
                 colsample_bytree=0.8, seed=SEED, device=cuda)
    before = draws.sample_weights.launches
    forest = model.fit(bins, y)
    torch.cuda.synchronize()
    assert draws.sample_weights.launches == before + 20
    assert int(forest["trees_used"]) == 20
