"""The port's ``RecordStagingIter`` against the JAX package's, on the same
RecordIO files, on the CPU (``device="cpu"``; the card's pinned-buffer path
is in tests/test_torch_cuda.py).

Batches are compared as numpy, leaf for leaf: the zero-padded payload
bytes, the offsets and the record counts, with ``num_workers`` 1 and 2
(the pool of per-part native cursors), over several parts, with payloads
that hold the RecordIO magic word at 4-aligned offsets (spans hold the
joined payload), and with ``recover=True`` over a corrupt span.
"""
import numpy as np
import pytest
import torch

from dmlc_core_tpu.data import RecordStagingIter as JaxRecordIter
from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.data import RecordBatch, RecordStagingIter
from dmlc_core_tpu_torch.io import RecordIOWriter

MAGIC = np.uint32(0xCED7230A).tobytes()
CAPS = dict(records_cap=64, bytes_cap=1 << 13)


def _write(path, payloads):
    with RecordIOWriter(str(path)) as w:
        for p in payloads:
            w.write(p)
    return str(path)


@pytest.fixture
def recordio_file(tmp_path):
    """tests/test_staging.py's payloads, every 9th with magic words at
    4-aligned offsets."""
    payloads = []
    for i in range(800):
        p = f"record-{i}-".encode() + bytes([i % 251]) * (i % 97)
        if i % 9 == 0:
            p = MAGIC + p[:8] + MAGIC + MAGIC + p[8:]
        payloads.append(p)
    return _write(tmp_path / "stage.rec", payloads), payloads


def _records(batches):
    out = []
    for b in batches:
        raw, offs = np.asarray(b.bytes), np.asarray(b.offsets)
        out += [raw[offs[k]:offs[k + 1]].tobytes()
                for k in range(int(b.num_records))]
    return out


def _host_records(w):
    """The records of one host batch dict (payload bytes and offsets)."""
    raw, offs = w["bytes"], w["offsets"]
    return [raw[offs[k]:offs[k + 1]].tobytes()
            for k in range(int(w["num_records"]))]


@pytest.mark.parametrize("num_workers", [1, 2])
def test_batches_equal_jax(recordio_file, num_workers):
    uri, payloads = recordio_file
    got = list(RecordStagingIter(uri, num_workers=num_workers, device="cpu",
                                 **CAPS))
    want = list(JaxRecordIter(uri, num_workers=num_workers, **CAPS))
    assert len(got) == len(want) > 1
    for b, jb in zip(got, want):
        assert isinstance(b, RecordBatch) and isinstance(b.num_records, int)
        assert b.bytes.dtype == torch.uint8 and b.bytes.shape == (1 << 13,)
        assert b.offsets.dtype == torch.int32 and b.offsets.shape == (65,)
        np.testing.assert_array_equal(b.bytes.numpy(), np.asarray(jb.bytes))
        np.testing.assert_array_equal(b.offsets.numpy(),
                                      np.asarray(jb.offsets))
        assert b.num_records == int(jb.num_records)
        np.testing.assert_array_equal(b.block_num_records.numpy(),
                                      np.asarray(jb.block_num_records))
        for x, y in zip(b.spans(), jb.spans()):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        np.testing.assert_array_equal(b.record_mask().numpy(),
                                      np.asarray(jb.record_mask()))
        n = b.num_records
        offs = b.offsets.numpy()
        assert (offs[n:] == offs[n]).all() and not b.bytes[offs[n]:].any()
    assert _records(got) == payloads


def test_parts_cover_the_file_and_bytes_read(recordio_file):
    uri, payloads = recordio_file
    seen = []
    for part in range(3):
        it = RecordStagingIter(uri, part=part, num_parts=3, device="cpu",
                               **CAPS)
        got = list(it)
        assert _records(got) == _records(JaxRecordIter(
            uri, part=part, num_parts=3, **CAPS))
        assert it.bytes_read > 0
        seen += _records(got)
    assert sorted(seen) == sorted(payloads)
    # a second epoch restages the same batches
    it = RecordStagingIter(uri, device="cpu", **CAPS)
    assert _records(it) == _records(it) == payloads
    assert it.batches_staged == 2 * len(list(JaxRecordIter(uri, **CAPS)))


def test_recover_skips_the_corrupt_span_as_jax_does(tmp_path):
    payloads = [bytes([i % 251]) * (30 + i % 50) for i in range(600)]
    uri = _write(tmp_path / "bad.rec", payloads)
    raw = bytearray(open(uri, "rb").read())
    raw[raw.find(MAGIC, len(raw) // 2)] ^= 0x5A
    open(uri, "wb").write(bytes(raw))
    before = telemetry.counter_get("record.corrupt_skipped")
    got = _records(RecordStagingIter(uri, recover=True, device="cpu",
                                     **CAPS))
    assert telemetry.counter_get("record.corrupt_skipped") > before
    assert got == _records(JaxRecordIter(uri, recover=True, **CAPS))
    assert 0 < len(got) < len(payloads) and set(got) <= set(payloads)


def test_abandoned_epoch_and_close(recordio_file):
    uri, _ = recordio_file
    for nw in (1, 3):
        it = RecordStagingIter(uri, num_workers=nw, device="cpu", **CAPS)
        for i, _ in enumerate(it):
            if i == 1:
                break
        assert len(list(it)) > 2  # a fresh epoch after the abandoned one
        it.close()
        it.close()  # idempotent


def test_unported_options_raise(recordio_file, monkeypatch):
    uri, _ = recordio_file
    # sharding= takes a mesh spec (multi-process staging is ported:
    # tests/test_torch_sharded_staging.py); anything else raises
    with pytest.raises(TypeError, match="not a mesh spec"):
        RecordStagingIter(uri, sharding=object(), device="cpu")
    # without a tracker, coordinated reads are every record once, in order
    got = [b for w in RecordStagingIter(uri, device="cpu")
           .host_batches_coordinated(0)
           for b in _host_records(w)]
    assert got == recordio_file[1]
    # autotune is ported: autotune=True and DMLCTPU_AUTOTUNE arm the tuner
    assert RecordStagingIter(uri, autotune=True, device="cpu")._autotune
    monkeypatch.setenv("DMLCTPU_AUTOTUNE", "1")
    assert RecordStagingIter(uri, device="cpu")._autotune
    with pytest.raises(TypeError, match="not a mesh spec"):
        RecordStagingIter(uri, sharding=object(), device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RecordStagingIter(uri, autotune=False)
