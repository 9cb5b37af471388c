"""The port's file-to-device staging (``DeviceStagingIter``, ``Parser``,
``RowBlock``) against the JAX package's, on the same generated files, on
the CPU (``device="cpu"``; the card's pinned-buffer path is in
tests/test_torch_cuda.py).

Batches are compared exactly, array for array (the same native batcher
packs both, and the port copies its bytes): labels, weights, row
pointers, indices, values, fields and query ids, the short final batch and
its padding included, ``num_rows`` and the lineage ids.  Also the
counterparts of tests/test_staging.py's padding, abandonment, worker
determinism, error propagation, watchdog and lineage tests, and what the
port refuses.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu import telemetry as jax_telemetry
from dmlc_core_tpu.data import DeviceStagingIter as JaxStagingIter
from dmlc_core_tpu.data import Parser as JaxParser
from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.data import DeviceStagingIter, Parser, RowBlock
from dmlc_core_tpu_torch.ops.segment_sum import segment_sum

LEAVES = ("label", "weight", "row_ptr", "index", "value", "field", "qid")


@pytest.fixture
def libsvm_file(tmp_path):
    """tests/test_staging.py's file: 1000 rows of 1-5 nonzeros."""
    rows = []
    for i in range(1000):
        nnz = 1 + (i % 5)
        feats = " ".join(f"{(i * 7 + j) % 64}:{0.25 * (j + 1)}"
                         for j in range(nnz))
        rows.append(f"{i % 2} {feats}")
    p = tmp_path / "stage.libsvm"
    p.write_text("\n".join(rows) + "\n")
    return str(p)


def _write_random(tmp_path, fmt, rows=777, seed=0):
    """A libsvm file with qid and some weights, or a libfm file with
    fields; values written with %.9g (f32 round-trips exactly)."""
    rng = np.random.default_rng(seed)
    lines = []
    for r in range(rows):
        n = int(rng.integers(0, 9))  # some rows empty
        idx = np.sort(rng.choice(5000, n, replace=False))
        val = rng.standard_normal(n).astype(np.float32)
        y = int(rng.integers(0, 2))
        if fmt == "libfm":
            fld = rng.integers(0, 6, n)
            feats = " ".join(f"{f}:{i}:{v:.9g}"
                             for f, i, v in zip(fld, idx, val))
            lines.append(f"{y} {feats}")
        else:
            head = f"{y}:{rng.uniform(0.5, 2):.3f}" if r % 5 == 0 else f"{y}"
            feats = " ".join(f"{i}:{v:.9g}" for i, v in zip(idx, val))
            lines.append(f"{head} qid:{r // 10} {feats}")
    p = tmp_path / f"random.{fmt}"
    p.write_text("\n".join(lines) + "\n")
    return f"{p}?format={fmt}"


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for b, jb in zip(got, want):
        assert isinstance(b.num_rows, int)
        assert b.num_rows == int(jb.num_rows)
        for k in LEAVES:
            t, ref = getattr(b, k), getattr(jb, k)
            if ref is None:
                assert t is None, k
                continue
            ref = np.asarray(ref)
            assert t.device.type == "cpu" and t.dtype == {
                np.dtype(np.float32): torch.float32,
                np.dtype(np.int32): torch.int32}[ref.dtype], k
            np.testing.assert_array_equal(t.numpy(), ref, err_msg=k)
        assert telemetry.lineage(b) == jax_telemetry.lineage(jb)


@pytest.mark.parametrize("num_workers", [1, 3])
@pytest.mark.parametrize("fmt,lanes", [
    ("libsvm", {}), ("libsvm", dict(with_qid=True)),
    ("libfm", dict(with_field=True)), ("libfm", {})])
def test_staged_batches_equal_jax(tmp_path, fmt, lanes, num_workers):
    uri = _write_random(tmp_path, fmt)
    kw = dict(batch_size=100, nnz_bucket=256, num_workers=num_workers,
              **lanes)
    it = DeviceStagingIter(uri, device="cpu", **kw)
    got = list(it)
    want = list(JaxStagingIter(uri, **kw))
    _assert_batches_equal(got, want)
    assert got[-1].num_rows == 77  # the short final batch, zero-padded
    assert (got[-1].weight[77:] == 0).all()
    assert it.max_index == 4999 or it.max_index <= 4999
    assert it.batches_staged == len(got) and it.bytes_read > 0
    # a second epoch is the same stream
    _assert_batches_equal(list(it), want)


def test_nnz_max_and_prefetch_depth_equal_jax(libsvm_file):
    kw = dict(batch_size=64, nnz_bucket=128, nnz_max=256, prefetch_depth=1)
    got = list(DeviceStagingIter(libsvm_file, device="cpu", **kw))
    assert all(b.index.shape[0] == 256 for b in got)
    _assert_batches_equal(got, list(JaxStagingIter(libsvm_file, **kw)))


def test_parser_rowblocks_equal_jax(tmp_path):
    uri = _write_random(tmp_path, "libfm", rows=500, seed=3)
    size = (tmp_path / "random.libfm").stat().st_size
    with Parser(uri) as p:
        got = list(p)
        # the native reader may already be reading ahead into a next pass
        assert p.bytes_read >= size
    with JaxParser(uri) as jp:
        want = list(jp)
    assert len(got) == len(want) > 0
    for b, jb in zip(got, want):
        assert isinstance(b, RowBlock)
        for k in ("offset", "label", "index", "weight", "qid", "field",
                  "value"):
            a, ref = getattr(b, k), getattr(jb, k)
            if ref is None:
                assert a is None, k
            else:
                assert a.dtype == ref.dtype, k
                np.testing.assert_array_equal(a, ref, err_msg=k)
        np.testing.assert_array_equal(b.row_ids(), jb.row_ids())


def test_padding_is_inert(libsvm_file):
    """Sum of w[index] * value per row ignores padding lanes and rows
    (tests/test_staging.py's test, on the port's segment sum)."""
    it = DeviceStagingIter(libsvm_file, batch_size=128, nnz_bucket=1024,
                           device="cpu")
    w = torch.ones(64)
    with Parser(libsvm_file, 0, 1, "libsvm") as parser:
        expected = []
        for block in parser:
            vals = block.values_or_ones()
            for r in range(block.size):
                lo, hi = int(block.offset[r]), int(block.offset[r + 1])
                expected.append(vals[lo:hi].sum())
    got = []
    for batch in it:
        for force in (None, "pallas"):
            per_row = segment_sum(w[batch.index.long()] * batch.value,
                                  batch.row_ids(), batch.batch_size,
                                  force=force)
            if force is None:
                got.extend(per_row[:batch.num_rows].tolist())
        np.testing.assert_array_equal(batch.weight[batch.num_rows:].numpy(),
                                      0.0)
    np.testing.assert_allclose(got, expected, rtol=1e-5)


def test_abandoned_iterator_does_not_deadlock(libsvm_file):
    """Breaking out of a staging loop releases the native cursor, so a
    fresh epoch can start."""
    it = DeviceStagingIter(libsvm_file, batch_size=64, nnz_bucket=256,
                           prefetch=1, device="cpu")
    for _ in it:
        break  # abandon with the prefetch queue full
    t0 = time.monotonic()
    assert sum(b.num_rows for b in it) == 1000  # must not hang
    assert time.monotonic() - t0 < 30


def _drain_bits(it):
    return [tuple(getattr(b, k).numpy().tobytes() for k in LEAVES[:5])
            for b in it]


def test_parallel_workers_bitwise_deterministic(libsvm_file):
    """reorder=True: staged batches are bit-identical for any worker
    count."""
    ref = _drain_bits(DeviceStagingIter(libsvm_file, batch_size=128,
                                        nnz_bucket=512, device="cpu"))
    assert len(ref) == 8
    for nw in (2, 4):
        got = _drain_bits(DeviceStagingIter(
            libsvm_file, batch_size=128, nnz_bucket=512, num_workers=nw,
            device="cpu"))
        assert got == ref, f"num_workers={nw} diverged from one worker"


def test_parallel_native_error_propagates(tmp_path):
    """A parse error inside one pool worker surfaces to the consumer as
    the native error."""
    f = tmp_path / "bad.libsvm"
    f.write_text("\n".join(["1 1:1"] * 200 + ["1 3000000000:1"]
                           + ["1 2:1"] * 200) + "\n")
    it = DeviceStagingIter(str(f), batch_size=64, nnz_bucket=64,
                           num_workers=4, device="cpu")
    with pytest.raises(RuntimeError, match="feature id"):
        for _ in it:
            pass


def test_watchdog_no_false_positive_on_slow_epoch(libsvm_file):
    """A slow but progressing epoch never trips the watchdog (the deadline
    runs from the last progress event)."""
    stalls0 = telemetry.watchdog_stall_count()
    with telemetry.watchdog(deadline_s=2.0, poll_s=0.1):
        assert telemetry.watchdog_running()
        it = DeviceStagingIter(libsvm_file, batch_size=64, nnz_bucket=256,
                               num_workers=2, buffer_mb=1, device="cpu")
        rows = 0
        for b in it:
            rows += b.num_rows
            time.sleep(0.05)  # a slow consumer, far under 2 s
        assert rows == 1000
    assert not telemetry.watchdog_running()
    assert telemetry.watchdog_stall_count() == stalls0


def test_lineage_minted_untraced_and_tracing_bit_identity(libsvm_file):
    """Lineage ids are a pure function of the partitioning: present with
    tracing off, identical with tracing on, and the batches bit-identical
    either way.  Tracing is switched in the shared native registry (the
    JAX package's switch; the port records into the same trace)."""
    def drain():
        it = DeviceStagingIter(libsvm_file, batch_size=128, nnz_bucket=512,
                               num_workers=2, device="cpu")
        batches = list(it)
        return _drain_bits(batches), [telemetry.lineage(b) for b in batches]

    ref_bits, ref_lin = drain()
    assert len(ref_bits) == 8
    assert all(lin >= 0 for lin in ref_lin) and ref_lin[0] == 0
    jax_telemetry.trace_start()
    try:
        got_bits, got_lin = drain()
        spans = jax_telemetry.trace_dump_json()
    finally:
        jax_telemetry.trace_stop()
    assert got_bits == ref_bits and got_lin == ref_lin
    assert "h2d.stage_batch" in spans


def test_env_arms_the_watchdog_and_sampler_for_an_epoch(libsvm_file,
                                                        monkeypatch):
    monkeypatch.setenv("DMLCTPU_WATCHDOG_DEADLINE_S", "30")
    monkeypatch.setenv("DMLCTPU_TIMESERIES", "1")
    seen = []
    for _ in DeviceStagingIter(libsvm_file, batch_size=256, device="cpu"):
        seen.append((telemetry.watchdog_running(),
                     telemetry.timeseries_active()))
    assert seen and all(a and b for a, b in seen)
    assert not telemetry.watchdog_running()
    assert not telemetry.timeseries_active()


def test_profile_counters_knobs_and_h2d_metrics(libsvm_file):
    c0 = {k: telemetry.counter_get(k) for k in ("h2d.batches",
                                                 "h2d.busy_us")}
    it = DeviceStagingIter(libsvm_file, batch_size=128, nnz_bucket=512,
                           num_workers=2, device="cpu")
    n = len(list(it))
    assert it.profile["batches"] == n == 8
    assert set(it.profile) == {"native_s", "host_wait_s", "stage_s",
                               "emit_wait_s", "batches"}
    c = it.counters
    assert c["batches_staged"] == 8 and c["num_workers"] == 2
    assert c["bytes_read"] == it.bytes_read > 0
    assert telemetry.counter_get("h2d.batches") - c0["h2d.batches"] == 8
    assert it.max_index == 63
    knobs = it.set_knobs(num_workers=3, buffer_mb=8, prefetch_depth=4)
    assert knobs["pool_live"] and knobs["num_workers"] == 3
    assert knobs["prefetch_depth"] == 4 and knobs["buffer_mb"] == 8
    assert _drain_bits(it) == _drain_bits(DeviceStagingIter(
        libsvm_file, batch_size=128, nnz_bucket=512, device="cpu"))
    one = DeviceStagingIter(libsvm_file, device="cpu")
    assert one.set_knobs(num_workers=2)["pool_live"] is False
    it.close()
    it.close()  # idempotent


@pytest.mark.parametrize("kw,item", [
    (dict(sharding=object()), "A6"), (dict(bin_cache=True), "A5"),
    (dict(autotune=True), "A12")])
def test_unported_options_raise(libsvm_file, kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        DeviceStagingIter(libsvm_file, device="cpu", **kw)


def test_autotune_env_raises_instead_of_being_ignored(libsvm_file,
                                                      monkeypatch):
    monkeypatch.setenv("DMLCTPU_AUTOTUNE", "1")
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        DeviceStagingIter(libsvm_file, device="cpu")
    # an explicit autotune=False wins over the environment, as in the JAX
    # package
    assert len(list(DeviceStagingIter(libsvm_file, device="cpu",
                                      autotune=False))) == 1


def test_batches_feed_the_jax_packages_consumers_unchanged(libsvm_file):
    """A staged port batch, carried to JAX as numpy, scores as the JAX
    package's own staged batch does."""
    from dmlc_core_tpu.ops.sparse import csr_matvec
    w = jnp.asarray(np.linspace(-1, 1, 64, dtype=np.float32))
    for b, jb in zip(DeviceStagingIter(libsvm_file, batch_size=256,
                                       device="cpu"),
                     JaxStagingIter(libsvm_file, batch_size=256)):
        rid = jnp.asarray(b.row_ids().numpy())
        got = csr_matvec(w, jnp.asarray(b.index.numpy()),
                         jnp.asarray(b.value.numpy()), rid, b.batch_size)
        want = csr_matvec(w, jb.index, jb.value, jb.row_ids(), jb.batch_size)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
