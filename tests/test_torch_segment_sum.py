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
from dmlc_core_tpu_torch.ops import fixed_point
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


# ---- the kernel's fixed-point numerics (csrc/segment_sum.cu) -----------------

def _fixed_point_segment_sum(c, rid, rows, scale=None):
    """The CUDA kernel's arithmetic in numpy: each lane's scale
    ``fixed_point_scale(lane_amax(c), nnz)`` (or the ``scale`` given), each
    kept value quantised once (the f32 product by a power of two is exact;
    ``np.rint`` rounds half to even as ``__float2ll_rn`` does), exact int64
    sums, each output rounded once to f32; a lane with a non-finite scale,
    or with a kept value at or past ``value_limit(nnz)``, is NaN."""
    c2 = c.reshape(len(c), -1).astype(np.float32)
    n = max(len(c2), 1)
    if scale is None:
        scale = fixed_point.fixed_point_scale(
            fixed_point.lane_amax(torch.from_numpy(c2)), n).numpy()
    keep = (rid >= 0) & (rid < rows)
    with np.errstate(invalid="ignore", over="ignore"):
        qf = np.rint(c2[keep] * scale).astype(np.float64)
        ok = (np.isfinite(scale) & (scale > 0)
              & (np.abs(qf) < float(fixed_point.value_limit(n))).all(0))
    q = np.where(ok, qf, 0).astype(np.int64)
    acc = np.zeros((rows, c2.shape[1]), np.int64)
    np.add.at(acc, rid[keep].astype(np.int64), q)
    out = (acc / np.where(ok, scale, 1).astype(np.float64)).astype(np.float32)
    out[:, ~ok] = np.nan
    return out.reshape((rows,) + c.shape[1:])


@pytest.mark.parametrize("force", [None, "pallas"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_fixed_point_emulation_matches_jax(name, force):
    """The kernel's numerics against the JAX package on the same inputs,
    within atol = rtol = 1e-5, and against float64 within the fixed point's
    bound (m * 2^-(k+1) for m values) plus one f32 rounding."""
    c, rid, rows = _case(name)
    got = _fixed_point_segment_sum(c, rid, rows)
    want = np.asarray(jax_segment_sum(jnp.asarray(c), jnp.asarray(rid), rows,
                                      force=force))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    keep = (rid >= 0) & (rid < rows)
    c2 = c.reshape(len(c), -1).astype(np.float64)
    exact = np.zeros((rows, c2.shape[1]))
    np.add.at(exact, rid[keep], c2[keep])
    m = np.bincount(rid[keep], minlength=rows)[:, None]
    scale = fixed_point.fixed_point_scale(
        fixed_point.lane_amax(torch.from_numpy(c.reshape(len(c), -1))),
        len(c))
    bound = (m * fixed_point.error_bound(scale, 1).numpy()
             + np.spacing(np.abs(got.reshape(exact.shape))))
    assert (np.abs(got.reshape(exact.shape) - exact) <= bound).all()


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_fixed_point_emulation_poisons_a_non_finite_lane(bad):
    """A NaN or Inf in one lane (even in an entry whose id is dropped, as
    the TPU kernel's one-hot product spreads it) makes that lane NaN in
    every output; the other lanes are bitwise what they are without it."""
    c, rid, rows = _case("out-of-range-4lanes")
    clean = _fixed_point_segment_sum(c, rid, rows)
    for k in (17, int(np.flatnonzero(rid < 0)[0])):
        dirty = c.copy()
        dirty[k, 2] = bad
        got = _fixed_point_segment_sum(dirty, rid, rows)
        assert np.isnan(got[:, 2]).all()
        np.testing.assert_array_equal(np.delete(got, 2, 1),
                                      np.delete(clean, 2, 1))


@pytest.mark.parametrize("under,poisoned", [(2.0 ** 20, True), (2.0, False)])
def test_fixed_point_emulation_understated_scale_is_nan_or_exact(under,
                                                                 poisoned):
    """A scale made from a bound below the values (the kernel finds its own
    amax, so it never meets this; the rule is hist_fixed.cuh's): far below,
    a value could carry a sum past int64 and the lane is NaN; a little
    below, the sums stay exact and within the finer scale's bound."""
    rng = np.random.default_rng(6)
    nnz, rows = 5000, 3
    rid = rng.integers(0, rows, nnz).astype(np.int32)
    c = rng.uniform(-1, 1, (nnz, 2)).astype(np.float32)
    amax = fixed_point.lane_amax(torch.from_numpy(c))
    low = amax.clone()
    low[0] /= under
    scale = fixed_point.fixed_point_scale(low, nnz).numpy()
    got = _fixed_point_segment_sum(c, rid, rows, scale)
    clean = _fixed_point_segment_sum(c, rid, rows)
    np.testing.assert_array_equal(got[:, 1], clean[:, 1])
    if poisoned:
        assert np.isnan(got[:, 0]).all()
        return
    exact = np.bincount(rid, c[:, 0].astype(np.float64), minlength=rows)
    m = np.bincount(rid, minlength=rows)
    bound = m * 0.5 / float(scale[0]) + np.spacing(np.abs(got[:, 0]))
    assert (np.abs(got[:, 0] - exact) <= bound).all()


def test_fixed_point_emulation_is_bitwise_the_same_for_any_order():
    c, rid, rows = _case("unsorted-3lanes")
    perm = np.random.default_rng(1).permutation(len(rid))
    np.testing.assert_array_equal(
        _fixed_point_segment_sum(c, rid, rows),
        _fixed_point_segment_sum(c[perm], rid[perm], rows))


@pytest.mark.parametrize("j", [-3, 0, 1, 7])
@pytest.mark.parametrize("nnz", [1, 4096, 1_183_747, 11_000_000])
def test_scale_at_powers_of_two_is_exact(j, nnz):
    """At amax = 2^j the scale is 2^(62 - ceil(log2(nnz * 2^j))) with the
    ceiling taken exactly (frexp), where a rounded log2 would be most likely
    to be off by one; the kernel computes its scale with the same steps and
    is held to this function bit for bit on the card."""
    got = float(fixed_point.fixed_point_scale(
        torch.tensor([2.0 ** j], dtype=torch.float32), nnz)[0])
    mant, exp = np.frexp(float(nnz) * 2.0 ** j)  # nnz * 2^j = mant * 2^exp
    ceil_log2 = exp - 1 if mant == 0.5 else exp
    assert got == 2.0 ** min(62 - ceil_log2, fixed_point.K_MAX)


@pytest.mark.parametrize("nnz,rows,lanes,align,vec,shared", [
    (11_000_000, 64, 2, 16, 2, True),     # GBDT leaf sums
    (1_183_747, 1, 2, 16, 2, True),       # root node total
    (16384, 256, 16, 16, 4, True),        # served FM micro-batch, L=16
    (16384, 256, 1, 16, 1, True),         # served, L=1
    (160_000, 4096, 16, 16, 4, False),    # served at max_batch
    (5000, 37, 5, 16, 1, True),           # odd lanes
    (3000, 100, 4, 8, 2, True),           # 8-byte aligned contrib
    (100, 10, 8192, 16, 4, False),        # wide lanes
])
def test_launch_geometry(nnz, rows, lanes, align, vec, shared):
    geo = ss.launch_geometry(nnz, rows, lanes, align)
    assert (geo["vec"], geo["shared"]) == (vec, shared)
    assert 1 <= geo["blocks"] <= ss._MAX_BLOCKS
    assert geo["smem"] == 8 * lanes * (1 + rows * shared)
    assert geo["smem"] <= 227 * 1024


def test_kernel_wrapper_cpu_scale_is_fixed_point_scale():
    c, rid, rows = _case("unsorted-3lanes")
    out, scale = ss.segment_sum_kernel(torch.from_numpy(c),
                                       torch.from_numpy(rid), rows,
                                       return_scale=True)
    assert torch.equal(out, ss.segment_sum_plain(torch.from_numpy(c),
                                                 torch.from_numpy(rid), rows))
    assert torch.equal(scale, fixed_point.fixed_point_scale(
        fixed_point.lane_amax(torch.from_numpy(c)), len(c)))
