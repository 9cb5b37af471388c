"""The port's binned epoch cache (``dmlc_core_tpu_torch.data.binned_cache``)
against the JAX package's, on the same files, on the CPU (``device="cpu"``;
the card's pinned-buffer path is in tests/test_torch_cuda.py).

* A cache written by either package opens in the other with 0 rebuilds,
  and the two packages write byte-identical cache files (raw and lz4).
* ``BinnedBatch`` arrays equal the JAX package's lane for lane, and the
  cache epoch equals the text epoch (``ebin`` = ``transform_entries``).
* The invalidation matrix gives exactly one rebuild for each change; an
  unfitted binner adopts the cached cuts; a failed build serves the text
  path with the same batches; the trainer refuses foreign cuts.
"""
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from dmlc_core_tpu.data import BinnedRowIter as JaxRowIter
from dmlc_core_tpu.data import BinnedStagingIter as JaxBinnedIter
from dmlc_core_tpu.data.binned_cache import bin_entries_np as jax_bin_entries
from dmlc_core_tpu.data import build_bin_cache as jax_build
from dmlc_core_tpu.models import QuantileBinner as JaxBinner
from dmlc_core_tpu_torch import faultinject, telemetry
from dmlc_core_tpu_torch.data import (BinnedBatch, BinnedRowIter,
                                      BinnedStagingIter, DeviceStagingIter,
                                      build_bin_cache)
from dmlc_core_tpu_torch.data.binned_cache import (
    bin_entries_np, cuts_digest_of, decode_block_payload, resolve_codec,
    unpack_block)
from dmlc_core_tpu_torch.models import GBDT, QuantileBinner

FEATURES = 40
LANES = ("label", "weight", "row_ptr", "index", "ebin", "emask")
BINNER = dict(num_bins=16, missing_aware=True, sketch_size=64, sketch_seed=3)


def _write_libsvm(path, rows, seed=0, max_nnz=7, qid=False):
    """tests/test_binned_cache.py's rows: the label is the row index."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(rows):
        nnz = int(rng.integers(1, max_nnz + 1))
        idx = np.sort(rng.choice(FEATURES, size=nnz, replace=False))
        feats = " ".join(f"{j}:{rng.normal():.5f}" for j in idx)
        head = f"{i} qid:{i // 10}" if qid else f"{i}"
        lines.append(f"{head} {feats}")
    Path(path).write_text("\n".join(lines) + "\n")
    return str(path)


def _binner(**kw):
    return QuantileBinner(device="cpu", **{**BINNER, **kw})


def _iter(path, binner, **kw):
    kw.setdefault("batch_size", 256)
    kw.setdefault("nnz_bucket", 1024)
    return BinnedStagingIter(str(path), binner, device="cpu", **kw)


def _bits(b):
    parts = [getattr(b, k).numpy().tobytes() for k in LANES]
    parts.append(b.num_rows)
    if b.qid is not None:
        parts.append(b.qid.numpy().tobytes())
    return tuple(parts)


@pytest.fixture
def data(tmp_path):
    return _write_libsvm(tmp_path / "rows.libsvm", 1200, seed=7)


def _assert_lanes_equal(got, want):
    assert len(got) == len(want) > 0
    for b, jb in zip(got, want):
        assert isinstance(b, BinnedBatch) and isinstance(b.num_rows, int)
        assert b.num_rows == int(jb.num_rows)
        assert b.cuts_digest == jb.cuts_digest
        for k in LANES + ("qid",):
            t, ref = getattr(b, k), getattr(jb, k)
            if ref is None:
                assert t is None, k
                continue
            ref = np.asarray(ref)
            assert t.numpy().dtype == ref.dtype, k
            np.testing.assert_array_equal(t.numpy(), ref, k)


@pytest.mark.parametrize("codec", ["raw", "lz4"])
def test_cache_files_byte_identical_and_open_across(tmp_path, codec):
    if resolve_codec(codec) != codec:
        pytest.skip("libdmlctpu built without codecs")
    path = _write_libsvm(tmp_path / "rows.libsvm", 900, seed=3, qid=True)
    port_cache, jax_cache = tmp_path / "port.bc", tmp_path / "jax.bc"
    kw = dict(batch_size=128, nnz_bucket=512, with_qid=True, codec=codec)
    got = list(BinnedStagingIter(path, _binner(), cache=str(port_cache),
                                 device="cpu", **kw))
    want = list(JaxBinnedIter(path, JaxBinner(**BINNER),
                              cache=str(jax_cache), **kw))
    _assert_lanes_equal(got, want)
    assert port_cache.read_bytes() == jax_cache.read_bytes()
    # each package opens the other's cache: 0 rebuilds, the same batches
    r0 = telemetry.counter_get("cache.rebuilds")
    other = list(BinnedStagingIter(path, _binner(), cache=str(jax_cache),
                                   device="cpu", **kw))
    theirs = list(JaxBinnedIter(path, JaxBinner(**BINNER),
                                cache=str(port_cache), **kw))
    assert telemetry.counter_get("cache.rebuilds") == r0
    _assert_lanes_equal(other, theirs)
    assert [_bits(b) for b in other] == [_bits(b) for b in got]


def test_build_bin_cache_and_row_iter_equal_jax(data, tmp_path):
    port_cache, jax_cache = tmp_path / "p.bc", tmp_path / "j.bc"
    binner, jbinner = _binner(), JaxBinner(**BINNER)
    meta = build_bin_cache(data, str(port_cache), binner, batch_size=64,
                           nnz_bucket=1024)
    jmeta = jax_build(data, str(jax_cache), jbinner, batch_size=64,
                      nnz_bucket=1024)
    assert meta == jmeta
    assert meta["cuts_digest"] == binner.cuts_digest() \
        == cuts_digest_of(binner.cuts) == jbinner.cuts_digest()
    assert port_cache.read_bytes() == jax_cache.read_bytes()
    row = BinnedRowIter(str(port_cache))
    blocks, jblocks = list(row), list(JaxRowIter(str(jax_cache)))
    assert len(blocks) == len(jblocks) >= 8
    for b, jb in zip(blocks, jblocks):
        assert b.keys() == jb.keys()
        for k, v in b.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, jb[k], k)
            else:
                assert v == jb[k], k
    labels = np.concatenate([b["label"] for b in blocks]).astype(int)
    assert sorted(labels.tolist()) == list(range(1200))
    first = sorted(row.part_map)[0]
    sub = list(BinnedRowIter(str(port_cache), parts=[first]))
    assert {b["part_id"] for b in sub} == {first}
    assert sum(b["num_rows"] for b in sub) == int(row.part_map[first]["rows"])


def test_cache_epoch_equals_text_epoch(data):
    binner = _binner()
    it = _iter(data, binner)
    r0 = telemetry.counter_get("cache.rebuilds")
    first = list(it)  # builds (sketch + write), then serves
    assert telemetry.counter_get("cache.rebuilds") == r0
    assert not it.served_from_text
    hit0 = telemetry.counter_get("cache.hit_bytes")
    repeat = list(it)
    assert telemetry.counter_get("cache.hit_bytes") > hit0
    assert [_bits(b) for b in first] == [_bits(b) for b in repeat]
    text = list(DeviceStagingIter(data, batch_size=256, nnz_bucket=1024,
                                  device="cpu"))
    assert len(repeat) == len(text)
    cuts = binner.cuts.numpy()
    for cb, tb in zip(repeat, text):
        for k in ("label", "weight", "row_ptr", "index"):
            assert torch.equal(getattr(cb, k), getattr(tb, k)), k
        assert cb.num_rows == tb.num_rows
        val = tb.value.numpy()
        np.testing.assert_array_equal(
            cb.ebin.numpy().astype(np.int32),
            binner.transform_entries(tb.index, tb.value).numpy())
        np.testing.assert_array_equal(cb.ebin.numpy(), bin_entries_np(
            cuts, tb.index.numpy(), val))
        np.testing.assert_array_equal(cb.emask.numpy(),
                                      (val != 0) & ~np.isnan(val))
        assert cb.cuts_digest == binner.cuts_digest()
        np.testing.assert_array_equal(cb.row_ids().numpy(),
                                      tb.row_ids().numpy())


@pytest.mark.parametrize("num_cuts", [0, 1, 15, 255])
def test_bin_entries_equals_the_broadcast_comparison(num_cuts):
    """``bin_entries_np`` (one searchsorted over ordered keys) gives the
    JAX package's codes (a broadcast comparison with each entry's cuts
    row): ties on a cut, -0.0 against 0.0, +-inf,
    NaN values and NaN cuts, unsorted cuts, indices out of range, and
    255 cuts (whose top code wraps in uint8 as the comparison's does)."""
    rng = np.random.default_rng(num_cuts)
    F = 9
    cuts = np.sort(rng.normal(size=(F, num_cuts)).astype(np.float32), 1)
    if num_cuts:
        cuts[1] = cuts[1][::-1]  # unsorted
        cuts[2, :] = 0.0
        cuts[3, -1] = np.nan
        cuts[4, 0] = -np.inf
        cuts[5, -1] = np.inf
    n = 5000
    index = rng.integers(-2, F + 2, n).astype(np.int32)
    value = rng.normal(size=n).astype(np.float32)
    pool = np.concatenate([cuts.ravel(), [0.0, -0.0, np.inf, -np.inf,
                                          np.nan, 1e30, -1e30]])
    pick = rng.random(n) < 0.4
    value[pick] = rng.choice(pool, pick.sum()).astype(np.float32)
    value[rng.random(n) < 0.05] = np.float32(1e6)  # above every cut
    np.testing.assert_array_equal(
        bin_entries_np(cuts, index, value, chunk=777),
        jax_bin_entries(cuts, index, value))


def test_nnz_max_spill_matches_text_path(data, tmp_path):
    got = list(_iter(data, _binner(), batch_size=64, nnz_max=96))
    text = list(DeviceStagingIter(data, batch_size=64, nnz_bucket=1024,
                                  nnz_max=96, device="cpu"))
    assert len(got) == len(text)
    for cb, tb in zip(got, text):
        for k in ("label", "weight", "row_ptr", "index"):
            assert torch.equal(getattr(cb, k), getattr(tb, k)), k
        assert cb.index.shape == (96,)
    assert any(0 < b.num_rows < 64 for b in got)
    wide = _write_libsvm(tmp_path / "wide.libsvm", 40, seed=1, max_nnz=30)
    with pytest.raises(ValueError, match="nnz_max"):
        list(_iter(wide, _binner(), nnz_max=16))


def _mutants(path):
    def grow_source():
        with open(path, "a") as f:
            f.write("0 1:0.5\n")

    def shifted_cuts():
        fit = _binner()
        rng = np.random.default_rng(99)
        fit.fit_sparse(rng.integers(0, FEATURES, 500),
                       rng.normal(size=500).astype(np.float32) * 3 + 1,
                       num_features=FEATURES)
        return QuantileBinner.from_cuts(fit.cuts, 16, missing_aware=True,
                                        device="cpu")

    return [("num_bins", lambda: _binner(num_bins=8), None),
            ("sketch_seed", lambda: _binner(sketch_seed=9), None),
            ("sketch_size", lambda: _binner(sketch_size=128), None),
            ("source_bytes", _binner, grow_source),
            ("cuts_digest", shifted_cuts, None)]


def test_invalidation_matrix_exactly_one_rebuild_each(data):
    list(_iter(data, _binner()))  # the base build
    for name, make_binner, mutate in _mutants(data):
        if mutate is not None:
            mutate()
        it = _iter(data, make_binner())
        before = telemetry.counter_get("cache.rebuilds")
        first = [_bits(b) for b in it]
        assert telemetry.counter_get("cache.rebuilds") == before + 1, name
        again = [_bits(b) for b in it]
        assert telemetry.counter_get("cache.rebuilds") == before + 1, name
        assert first == again and first, name
    # a codec change is a rebuild too, and a truncated cache
    it = _iter(data, _binner(), codec="lz4")
    before = telemetry.counter_get("cache.rebuilds")
    list(it)
    assert telemetry.counter_get("cache.rebuilds") == before + 1
    cache = Path(it.cache_path)
    cache.write_bytes(cache.read_bytes()[:-64])
    with pytest.raises(ValueError, match="truncated"):
        BinnedRowIter(str(cache))
    list(_iter(data, _binner(), codec="lz4"))
    assert telemetry.counter_get("cache.rebuilds") == before + 2


def test_first_build_is_not_a_rebuild_and_cuts_are_adopted(data):
    b0 = _binner()
    before = telemetry.counter_get("cache.rebuilds")
    ref = [_bits(b) for b in _iter(data, b0)]
    b1 = _binner()
    assert b1.cuts is None
    got = [_bits(b) for b in _iter(data, b1)]
    assert telemetry.counter_get("cache.rebuilds") == before
    assert torch.equal(b1.cuts, b0.cuts) and got == ref


def test_failed_builds_serve_the_text_path(data, tmp_path):
    ref = [_bits(b) for b in _iter(data, _binner(),
                                   cache=str(tmp_path / "clean.bc"))]
    cache = tmp_path / "doomed.bc"
    it = _iter(data, _binner(), cache=str(cache))
    failed0 = telemetry.counter_get("cache.build_failed")
    with faultinject.armed("cache.write.short=err@1.0;seed=7"):
        got = [_bits(b) for b in it]
    assert got == ref and it.served_from_text
    assert telemetry.counter_get("cache.build_failed") >= failed0 + 2
    assert not cache.exists()
    assert [_bits(b) for b in it] == ref and not it.served_from_text
    assert cache.exists()


def test_device_staging_iter_bin_cache_knob(data, tmp_path):
    binner = _binner()
    cache = str(tmp_path / "knob.bc")
    direct = [_bits(b) for b in _iter(data, binner, cache=cache)]
    via = list(DeviceStagingIter(data, batch_size=256, nnz_bucket=1024,
                                 bin_cache=cache, binner=binner,
                                 device="cpu"))
    assert [_bits(b) for b in via] == direct
    with pytest.raises(ValueError, match="binner"):
        DeviceStagingIter(data, bin_cache=cache, device="cpu")


def test_trainer_checks_the_cuts_digest(data):
    binner = _binner()
    batch = next(iter(_iter(data, binner)))
    model = GBDT(num_features=FEATURES, num_bins=16, missing_aware=True,
                 device="cpu")
    rid, fi, eb, em = model._entry_bins(batch, binner)
    assert eb.dtype == torch.int32 and em.dtype == torch.bool
    other = QuantileBinner.from_cuts(binner.cuts + 1.0, 16,
                                     missing_aware=True, device="cpu")
    with pytest.raises(ValueError, match="cuts"):
        model._entry_bins(batch, other)


def test_lz4_blocks_decode_to_the_raw_layout(data, tmp_path):
    if resolve_codec("lz4") != "lz4":
        pytest.skip("libdmlctpu built without codecs")
    raw_c, lz_c = str(tmp_path / "raw.bc"), str(tmp_path / "lz.bc")
    build_bin_cache(data, raw_c, _binner(), batch_size=64, nnz_bucket=1024)
    build_bin_cache(data, lz_c, _binner(), batch_size=64, nnz_bucket=1024,
                    codec="lz4")
    assert os.path.getsize(lz_c) < os.path.getsize(raw_c)
    raw_blocks = list(BinnedRowIter(raw_c))
    for a, b in zip(raw_blocks, BinnedRowIter(lz_c)):
        for k in ("label", "row_ptr", "index", "ebin", "emask"):
            np.testing.assert_array_equal(a[k], b[k])
    # a raw payload (codec flag 0) decodes to itself
    payload = np.frombuffer(bytes(4096), np.uint8)
    assert decode_block_payload(payload) is payload
    assert unpack_block(payload)["num_rows"] == 0


@pytest.mark.parametrize("codec", ["raw", "lz4"])
def test_reader_surface_equals_jax(data, tmp_path, codec):
    """The reader's other calls against the JAX package's on one cache:
    ``set_decode(False)`` serves the stored (compressed) records and
    ``decode_block_payload`` turns them into the decoded ones; ``next_block``
    copies what ``next_block_view`` borrows; ``before_first`` rewinds;
    the backend and the corrupt count agree."""
    from dmlc_core_tpu.data.binned_cache import _NativeReader as JaxReader
    from dmlc_core_tpu_torch.data.binned_cache import _NativeReader
    if resolve_codec(codec) != codec:
        pytest.skip("libdmlctpu built without codecs")
    cache = str(tmp_path / "c.bc")
    build_bin_cache(data, cache, _binner(), batch_size=64, nnz_bucket=1024,
                    codec=codec)

    def blocks(reader, view=True):
        out = []
        while True:
            b = reader.next_block_view() if view else reader.next_block()
            if b is None:
                return out
            out.append(bytes(b))

    r, jr = _NativeReader(cache), JaxReader(cache)
    try:
        assert r.backend == jr.backend and r.corrupt_skipped == 0
        decoded = blocks(r)
        r.before_first()
        assert blocks(r, view=False) == decoded
        r.before_first()
        r.set_decode(False)
        jr.set_decode(False)
        stored = blocks(r)
        assert stored == blocks(jr) and len(stored) == len(decoded) > 1
        assert (stored == decoded) == (codec == "raw")
        for s, d in zip(stored, decoded):
            got = decode_block_payload(np.frombuffer(s, np.uint8))
            assert bytes(got) == d
        assert r.corrupt_skipped == jr.corrupt_skipped == 0
    finally:
        r.close()
        jr.close()


def test_unported_options_raise(data, monkeypatch):
    # sharding= takes a mesh spec (multi-process staging is ported:
    # tests/test_torch_sharded_staging.py); anything else raises
    with pytest.raises(TypeError, match="not a mesh spec"):
        _iter(data, _binner(), sharding=object())
    # without a tracker, coordinated reads are every block of the
    # worker's parts once
    blocks = list(_iter(data, _binner()).host_blocks_coordinated(0))
    assert sum(int(b["num_rows"]) for b in blocks) == 1200
    # autotune is ported: autotune=True and DMLCTPU_AUTOTUNE arm the tuner
    assert _iter(data, _binner(), autotune=True)._autotune
    monkeypatch.setenv("DMLCTPU_AUTOTUNE", "1")
    assert _iter(data, _binner())._autotune
    with pytest.raises(TypeError, match="not a mesh spec"):
        _iter(data, _binner(), sharding=object())
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BinnedStagingIter(data, _binner(), autotune=False)
