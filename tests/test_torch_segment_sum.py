"""The port's segment-sum (dmlc_core_tpu_torch.ops.segment_sum) against the
JAX package's, on the same numpy inputs.

On the CPU the port's "pallas" backend runs the kernel's plain version and
the JAX "pallas" backend runs its Pallas kernel in interpret mode, as
tests/test_pallas.py runs it.  Tolerance: atol = rtol = 1e-5, the JAX
package's own tolerance between its two backends (f32 sums in another
order).  The CUDA kernel itself is held to the plain version on the card
by tests/test_torch_cuda.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu.ops.pallas_segment import segment_sum as jax_segment_sum
from dmlc_core_tpu_torch.ops import segment_sum as ss
from dmlc_core_tpu_torch.ops.segment_sum import (VALID_FORCE, check_force,
                                                 segment_sum)

TOL = dict(rtol=1e-5, atol=1e-5)

# (nnz, rows, lanes, sorted, id range): [nnz] and [nnz, L], unsorted ids,
# ids outside [0, rows) on both sides
CASES = {
    "sorted-1d": (1000, 64, None, True, (0, 64)),
    "sorted-2lanes-513rows": (4096, 513, 2, True, (0, 513)),
    "sparse-rows": (37, 1024, None, True, (0, 1024)),
    "unsorted-3lanes": (2048, 300, 3, False, (0, 300)),
    "out-of-range-4lanes": (3000, 100, 4, False, (-7, 113)),
}


def _case(name):
    nnz, rows, lanes, srt, (lo, hi) = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    rid = rng.integers(lo, hi, nnz).astype(np.int32)
    if srt:
        rid.sort()
    shape = (nnz,) if lanes is None else (nnz, lanes)
    return rng.standard_normal(shape).astype(np.float32), rid, rows


@functools.lru_cache(maxsize=None)
def _jax_refs(name):
    c, rid, rows = _case(name)
    return tuple(np.asarray(jax_segment_sum(jnp.asarray(c), jnp.asarray(rid),
                                            rows, force=f))
                 for f in ("pallas", None))


@pytest.mark.parametrize("force", [None, "xla", "pallas"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_both_backends(name, force):
    c, rid, rows = _case(name)
    got = segment_sum(torch.from_numpy(c), torch.from_numpy(rid), rows,
                      force=force)
    assert got.dtype == torch.float32
    for want in _jax_refs(name):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_unsorted_and_empty_segments():
    rng = np.random.default_rng(3)
    rid = rng.permutation(np.repeat(np.arange(0, 50, 2), 7)).astype(np.int32)
    c = np.ones(rid.shape[0], np.float32)
    got = segment_sum(torch.from_numpy(c), torch.from_numpy(rid), 50,
                      force="pallas")
    want = jax_segment_sum(jnp.asarray(c), jnp.asarray(rid), 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want))
    assert float(got[1]) == 0.0  # empty segment stays zero


def test_padding_entries_inert():
    # staging convention: pad entries carry value 0 at row batch-1
    got = segment_sum(torch.tensor([1.0, 2.0, 0.0, 0.0]),
                      torch.tensor([0, 1, 3, 3], dtype=torch.int32), 4,
                      force="pallas")
    np.testing.assert_allclose(got.numpy(), [1.0, 2.0, 0.0, 0.0])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int32"])
def test_dtype_rule_matches_jax(dtype):
    """Empty input gives zeros in contrib's dtype, and a non-empty input
    is accumulated in f32 and cast back, on both packages."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    rid = np.array([0, 2, 2, 7, -1], np.int32)
    vals = np.array([1, 2, 3, 4, 5], np.float32)
    for lanes in (None, 2):
        c = vals if lanes is None else np.stack([vals, -vals], 1)
        empty = c[:0]
        for arr, ids in ((c, rid), (empty, rid[:0])):
            want = jax_segment_sum(jnp.asarray(arr, jdt), jnp.asarray(ids), 4,
                                   force="pallas")
            got = segment_sum(torch.from_numpy(arr).to(tdt),
                              torch.from_numpy(ids), 4, force="pallas")
            assert want.dtype == jdt and got.dtype == tdt
            assert tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))


@pytest.mark.parametrize("force", [None, "pallas"])
def test_gradient_matches_jax_vjp(force):
    """The cotangent is the gather g[row_id] (with JAX's index clamping
    under "pallas", dropped ids getting 0 under the scatter backend)."""
    rng = np.random.default_rng(9)
    nnz, rows, lanes = 600, 40, 3
    rid = rng.integers(-5, 46, nnz).astype(np.int32)
    c = rng.standard_normal((nnz, lanes)).astype(np.float32)
    g = rng.standard_normal((rows, lanes)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jax_segment_sum(x, jnp.asarray(rid), rows,
                                               force=force), jnp.asarray(c))
    (want,) = vjp(jnp.asarray(g))
    ct = torch.from_numpy(c).requires_grad_()
    out = segment_sum(ct, torch.from_numpy(rid), rows, force=force)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(want), **TOL)


def test_check_force_rejects_unknown_backend():
    assert VALID_FORCE == (None, "xla", "pallas")
    check_force("pallas")
    with pytest.raises(ValueError, match="want one of"):
        check_force("triton")
    with pytest.raises(ValueError):
        segment_sum(torch.ones(3), torch.zeros(3, dtype=torch.int32), 2,
                    force="cuda")
    with pytest.raises(ValueError, match=r"\[nnz\] or \[nnz, L\]"):
        segment_sum(torch.ones(3, 2, 2), torch.zeros(3, dtype=torch.int32),
                    2, force="pallas")


def test_kernel_wrapper_cpu_runs_plain_and_counts_nothing():
    rng = np.random.default_rng(4)
    c = torch.from_numpy(rng.standard_normal((500, 5)).astype(np.float32))
    rid = torch.from_numpy(rng.integers(0, 30, 500).astype(np.int32))
    before = ss.segment_sum_kernel.launches
    got = ss.segment_sum_kernel(c, rid, 30)
    assert ss.segment_sum_kernel.launches == before
    assert torch.equal(got, ss.segment_sum_plain(c, rid, 30))
    want = torch.zeros(30, 5).index_add_(0, rid.long(), c)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("lanes", [None, 3])
def test_plain_version_empty_input(lanes):
    shape = (0,) if lanes is None else (0, lanes)
    got = ss.segment_sum_plain(torch.zeros(shape),
                               torch.zeros(0, dtype=torch.int32), 6)
    assert tuple(got.shape) == (6,) + shape[1:] and not got.any()


def test_kernel_wrapper_rejects_other_devices():
    c = torch.ones(4, device="meta")
    rid = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ss.segment_sum_kernel(c, rid, 2)
