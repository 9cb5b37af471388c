"""The port's GBDT histogram (dmlc_core_tpu_torch.ops.histogram) against the
JAX package's ``histogram_gh``, on the same numpy inputs.

On the CPU the port's "pallas" backend runs the kernel's plain version and
the JAX "pallas" backend runs its Pallas kernel in interpret mode, as
tests/test_pallas.py runs it; both packages' ``None`` backend is the
flattened-key scatter-add.  Tolerance: atol = rtol = 1e-5, the JAX
package's own between its two backends (f32 sums in another order).  The
CUDA kernel itself is held to the plain version on the card by
tests/test_torch_cuda.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu.ops.pallas_segment import histogram_gh as jax_histogram_gh
from dmlc_core_tpu_torch.ops import histogram as hg
from dmlc_core_tpu_torch.ops.histogram import histogram_gh

TOL = dict(rtol=1e-5, atol=1e-5)

# (rows, F, num_bins, n_nodes, code dtype): the shapes of
# tests/test_pallas.py:77-78 and :98-104, GBDT's uint8 codes, an empty level
CASES = [(200, 3, 8, 1, "int32"), (777, 5, 16, 4, "int32"),
         (64, 2, 4, 8, "int32"), (130, 2, 128, 8, "int32"),
         (300, 3, 1024, 4, "int32"), (120, 2, 2048, 2, "int32"),
         (100, 5, 600, 3, "int32"), (90, 4, 2, 2, "int32"),
         (150, 9, 3, 5, "int32"), (500, 6, 256, 4, "uint8"),
         (0, 3, 8, 2, "int32")]


def _case(i):
    rows, F, B, n, dt = CASES[i]
    rng = np.random.default_rng(100 + i)
    bins = rng.integers(0, B, (rows, F)).astype(dt)
    rel = rng.integers(0, n, rows).astype(np.int32)
    gh = rng.standard_normal((rows, 2)).astype(np.float32)
    return bins, rel, gh, n, B


@functools.lru_cache(maxsize=None)
def _jax_refs(i):
    bins, rel, gh, n, B = _case(i)
    return tuple(np.asarray(jax_histogram_gh(
        jnp.asarray(bins), jnp.asarray(rel), jnp.asarray(gh), n, B, force=f))
        for f in ("pallas", None))


@pytest.mark.parametrize("force", [None, "pallas"])
@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[str(c) for c in CASES])
def test_matches_jax_both_backends(i, force):
    bins, rel, gh, n, B = _case(i)
    got = histogram_gh(torch.from_numpy(bins), torch.from_numpy(rel),
                       torch.from_numpy(gh), n, B, force=force)
    assert got.dtype == torch.float32
    for want in _jax_refs(i):
        assert tuple(got.shape) == want.shape == (n, bins.shape[1], B, 2)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("force", [None, "pallas"])
def test_out_of_range_rows_add_nothing(force):
    """Node ids past n_nodes add nothing on either backend (the scatter
    drops their keys; the kernel and its plain version match no node)."""
    bins, rel, gh, n, B = _case(1)
    keep = torch.from_numpy(rel) < n - 1
    got = histogram_gh(torch.from_numpy(bins), torch.from_numpy(rel),
                       torch.from_numpy(gh), n - 1, B, force=force)
    want = histogram_gh(torch.from_numpy(bins)[keep],
                        torch.from_numpy(rel)[keep],
                        torch.from_numpy(gh)[keep], n - 1, B, force=force)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("force", [None, "pallas"])
def test_result_dtype_follows_gh(force):
    """f32 accumulation on the kernel path, cast back to gh's dtype, as
    the JAX front end does; k/8 values sum exactly, so the two backends
    agree bit for bit."""
    bins, rel, gh, n, B = _case(0)
    gh8 = torch.round(torch.from_numpy(gh) * 8) / 8
    got = histogram_gh(torch.from_numpy(bins), torch.from_numpy(rel),
                       gh8.to(torch.bfloat16), n, B, force=force)
    want = histogram_gh(torch.from_numpy(bins), torch.from_numpy(rel), gh8,
                        n, B, force="pallas")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want.numpy())


def test_kernel_wrapper_cpu_runs_plain_and_counts_nothing():
    bins, rel, gh, n, B = _case(1)
    t = [torch.from_numpy(a) for a in (bins, rel, gh)]
    before = hg.histogram_gh_kernel.launches
    got = hg.histogram_gh_kernel(*t, n, B)
    assert hg.histogram_gh_kernel.launches == before
    assert torch.equal(got, hg.histogram_gh_plain(*t, n, B))


def test_kernel_wrapper_rejects_other_devices():
    bins = torch.zeros(4, 2, dtype=torch.uint8, device="meta")
    rel = torch.zeros(4, dtype=torch.int32, device="meta")
    gh = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        hg.histogram_gh_kernel(bins, rel, gh, 2, 8)


def test_check_force_rejects_unknown_backend():
    bins, rel, gh, n, B = _case(0)
    with pytest.raises(ValueError, match="want one of"):
        histogram_gh(torch.from_numpy(bins), torch.from_numpy(rel),
                     torch.from_numpy(gh), n, B, force="cuda")


@pytest.mark.parametrize("rows,F,B,n", [(11_000_000, 28, 256, 1),
                                        (11_000_000, 28, 256, 32),
                                        (1_000_000, 28, 256, 512),
                                        (5000, 3, 2048, 3), (0, 4, 16, 2)])
def test_launch_geometry_fits_the_card(rows, F, B, n):
    """How a launch cuts its work: shared memory within a Hopper block's
    227 KB, every node in some tile, every row in some chunk, and the
    partials' scratch bounded."""
    geo = hg.launch_geometry(rows, F, B, n)
    assert 1 <= geo["warps"] <= 4 and geo["smem"] <= 227 * 1024
    assert geo["smem"] == geo["warps"] * geo["node_tile"] * B * 16
    assert 1 <= geo["node_tile"] <= n
    assert geo["n_chunks"] * geo["chunk"] >= rows
    assert (geo["n_chunks"] - 1) * geo["chunk"] < max(rows, 1)
    assert geo["n_chunks"] * n * F * B * 8 <= max(1 << 29, n * F * B * 8)


def test_launch_geometry_refuses_bins_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        hg.launch_geometry(100, 2, 40000, 1)
