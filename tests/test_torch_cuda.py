"""On-card tests of the port's CUDA path (marker ``cuda``; each skips when
no CUDA device is present).  They import neither JAX nor the JAX package,
so on a machine with a card and no JAX they run without the suite's
conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernel is held to its plain PyTorch version on the same inputs at
atol = rtol = 1e-5 (f32 sums in another order), and to itself bit for bit
from launch to launch.
"""
import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch.ops import segment_sum as ss
from dmlc_core_tpu_torch.serving import (ScoringEngine, ScoringIterator,
                                         pack_snapshot)

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-5, atol=1e-5)

# (nnz, rows, lanes, sorted, id range)
CASES = {
    "sorted-1d": (1000, 64, None, True, (0, 64)),
    "served-16lanes": (16384, 256, 16, True, (0, 256)),
    "64lanes": (8192, 300, 64, True, (0, 300)),
    "ragged": (1001, 37, 5, True, (0, 37)),
    "unsorted-out-of-range": (3000, 100, 4, False, (-7, 113)),
    "one-entry": (1, 4, 3, True, (0, 4)),
    "empty": (0, 8, 2, True, (0, 8)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(name, device):
    nnz, rows, lanes, srt, (lo, hi) = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    rid = rng.integers(lo, hi, nnz).astype(np.int32)
    if srt:
        rid.sort()
    shape = (nnz,) if lanes is None else (nnz, lanes)
    c = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return (torch.from_numpy(c).to(device), torch.from_numpy(rid).to(device),
            rows)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_and_is_bitwise_stable(cuda, name):
    c, rid, rows = _case(name, cuda)
    before = ss.segment_sum_kernel.launches
    a = ss.segment_sum_kernel(c, rid, rows)
    b = ss.segment_sum_kernel(c, rid, rows)
    torch.cuda.synchronize()
    assert ss.segment_sum_kernel.launches == before + 2
    assert a.dtype == torch.float32 and a.device.type == "cuda"
    assert torch.equal(a, b)
    torch.testing.assert_close(a, ss.segment_sum_plain(c, rid, rows), **TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int32])
def test_front_end_casts_back_like_plain(cuda, dtype):
    """f32 accumulation cast back to contrib's dtype; k/8 values sum
    exactly, so kernel and plain agree bit for bit."""
    c, rid, rows = _case("unsorted-out-of-range", cuda)
    vals = torch.round(c * 80) / (8 if dtype == torch.bfloat16 else 1)
    got = ss.segment_sum(vals.to(dtype), rid, rows, force="pallas")
    want = ss.segment_sum_plain(vals.to(dtype), rid, rows)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_gradient_on_card_matches_cpu(cuda):
    c, rid, rows = _case("unsorted-out-of-range", cuda)
    g = torch.randn(rows, c.shape[1], generator=torch.Generator().manual_seed(0))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        x = c.detach().to(dev).requires_grad_()
        ss.segment_sum(x, rid.to(dev), rows, force="pallas").backward(
            g.to(dev))
        grads.append(x.grad.cpu())
    assert torch.equal(grads[0], grads[1])  # a gather: exact


def test_kernel_rejects_what_it_does_not_take(cuda):
    rid = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ss.segment_sum_kernel(torch.ones(4, dtype=torch.float64,
                                         device=cuda), rid, 2)
    with pytest.raises(TypeError):
        ss.segment_sum_kernel(torch.ones(4, device=cuda), rid.long(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        ss.segment_sum_kernel(torch.ones(2, 4, device=cuda).t(),
                              rid, 2)
    with pytest.raises(ValueError):
        ss.segment_sum_kernel(torch.ones(4, device=cuda), rid.cpu(), 2)
    with pytest.raises(ValueError):
        ss.segment_sum_kernel(torch.ones(5, device=cuda), rid, 2)


def _fm_snapshot(F=64, K=4, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal(F).astype(np.float32),
              "v": (0.3 * rng.standard_normal((F, K))).astype(np.float32),
              "b": np.float32(-0.1)}
    return pack_snapshot("fm", {"num_features": F, "num_factors": K,
                                "sdot_backend": "pallas"}, params)


def _requests(n, F=64, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, F, 1 + r % 7).tolist(),
             rng.random(1 + r % 7).astype(np.float32).tolist())
            for r in range(n)]


def test_engine_on_card_matches_cpu_and_launches_three_times(cuda):
    snap = _fm_snapshot()
    gpu = ScoringEngine.from_snapshot_bytes(snap, device=cuda)
    cpu = ScoringEngine.from_snapshot_bytes(snap, device="cpu")
    it_gpu, it_cpu = ScoringIterator(device=cuda), ScoringIterator(device="cpu")
    for n in (1, 9, 100):
        reqs = _requests(n, seed=n)
        before = ss.segment_sum_kernel.launches
        got = gpu.score(it_gpu.pack(reqs)[0])
        assert ss.segment_sum_kernel.launches == before + 3
        np.testing.assert_allclose(got, cpu.score(it_cpu.pack(reqs)[0]),
                                   rtol=2e-5, atol=2e-5)


def test_pinned_arena_reuse_keeps_earlier_batch_intact(cuda):
    """Two packs of one geometry back to back: the second waits for the
    first's copy, so the first device batch still holds its own rows."""
    it = ScoringIterator(device=cuda)
    a_reqs = [([1, 2], [1.0, 2.0]), ([3], [3.0])]
    b_reqs = [([4], [4.0]), ([5, 6], [5.0, 6.0])]
    a, _ = it.pack(a_reqs)
    b, _ = it.pack(b_reqs)
    assert len(it._arenas) == 1 and it._arenas[(2, 8)].buf.is_pinned()
    assert a.value.device.type == "cuda"
    np.testing.assert_array_equal(a.value.cpu().numpy()[:3], [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(b.value.cpu().numpy()[:3], [4.0, 5.0, 6.0])
    np.testing.assert_array_equal(a.row_ptr.cpu().numpy(), [0, 2, 3])
