"""The port's IO wrappers (``dmlc_core_tpu_torch.io``) against the JAX
package's (``dmlc_core_tpu.io``), on the same files, on the CPU.

Both bind the same native library, so results are compared exactly:
``InputSplit`` partitions record for record, RecordIO files byte for byte
(payloads holding the magic word at 4-aligned offsets included, which the
writer splits and the reader joins), either package reading the other's
files, ``recover=`` skipping the same corrupt spans, streams and the file
system listings.
"""
import os

import numpy as np
import pytest

import dmlc_core_tpu.io as jio
from dmlc_core_tpu_torch import io as tio
from dmlc_core_tpu_torch._native import NativeError

MAGIC = np.uint32(0xCED7230A).tobytes()


def _payloads(seed=0, n=300):
    """Random payloads of 0..600 bytes; every 7th holds the magic word at
    4-aligned offsets (one at 0, one inside, a run of two)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = bytearray(rng.bytes(int(rng.integers(0, 600))))
        if i % 7 == 0:
            p = bytearray(MAGIC) + p + bytearray(MAGIC * 2) + bytes(i % 5)
        out.append(bytes(p))
    return out


@pytest.fixture
def text_file(tmp_path):
    lines = [f"{i % 2} {i % 31}:{(i % 7) * 0.5} {(i * 3) % 31}:1.5"
             for i in range(700)]
    p = tmp_path / "data.libsvm"
    p.write_text("\n".join(lines) + "\n")
    return str(p), lines


@pytest.mark.parametrize("num_parts", [1, 3, 4])
def test_input_split_partitions_equal_jax(text_file, num_parts):
    uri, lines = text_file
    seen = []
    for part in range(num_parts):
        with tio.InputSplit(uri, part, num_parts, "text") as split, \
                jio.InputSplit(uri, part, num_parts, "text") as jsplit:
            got, want = list(split), list(jsplit)
            assert got == want
            assert split.total_size == jsplit.total_size \
                == os.path.getsize(uri)
            seen.extend(r.decode() for r in got)
    assert sorted(seen) == sorted(lines)


def test_input_split_chunks_reset_and_recordio_parts(text_file, tmp_path):
    uri, _ = text_file
    with tio.InputSplit(uri, 0, 2, "text") as split, \
            jio.InputSplit(uri, 0, 2, "text") as jsplit:
        assert split.next_chunk() == jsplit.next_chunk()
        split.before_first()
        jsplit.before_first()
        assert list(split) == list(jsplit)
        split.reset_partition(1, 2)
        jsplit.reset_partition(1, 2)
        assert list(split) == list(jsplit)
    rec = str(tmp_path / "parts.rec")
    payloads = _payloads(1)
    with tio.RecordIOWriter(rec) as w:
        for p in payloads:
            w.write(p)
    seen = []
    for part in range(3):
        with tio.InputSplit(rec, part, 3, "recordio") as split, \
                jio.InputSplit(rec, part, 3, "recordio") as jsplit:
            got = list(split)
            assert got == list(jsplit)
            seen.extend(got)
    assert sorted(seen) == sorted(payloads)


def test_recordio_files_byte_identical_and_cross_read(tmp_path):
    payloads = _payloads(2)
    port, jax_ = str(tmp_path / "port.rec"), str(tmp_path / "jax.rec")
    with tio.RecordIOWriter(port) as w:
        for p in payloads:
            w.write(p)
    with jio.RecordIOWriter(jax_) as w:
        for p in payloads:
            w.write(p)
    with open(port, "rb") as a, open(jax_, "rb") as b:
        assert a.read() == b.read()
    with tio.RecordIOReader(jax_) as r:
        assert list(r) == payloads
    with jio.RecordIOReader(port) as r:
        assert list(r) == payloads
    # the magic-word payloads were split on disk and joined on read
    with open(port, "rb") as f:
        assert f.read().count(MAGIC) > len(payloads)


def test_recordio_recover_skips_what_jax_skips(tmp_path):
    payloads = [bytes([i % 251]) * (40 + i) for i in range(200)]
    uri = str(tmp_path / "bad.rec")
    with tio.RecordIOWriter(uri) as w:
        for p in payloads:
            w.write(p)
    raw = bytearray(open(uri, "rb").read())
    at = raw.find(MAGIC, len(raw) // 2)
    raw[at] ^= 0x5A  # break one record's magic word mid-file
    open(uri, "wb").write(bytes(raw))
    with pytest.raises(NativeError):
        with tio.RecordIOReader(uri) as r:
            list(r)
    with tio.RecordIOReader(uri, recover=True) as r, \
            jio.RecordIOReader(uri, recover=True) as jr:
        got, want = list(r), list(jr)
        assert got == want and 0 < len(got) < len(payloads)
        assert r.corrupt_skipped == jr.corrupt_skipped > 0
    assert set(got) <= set(payloads)


def test_streams_seek_and_cross_read(tmp_path):
    uri = str(tmp_path / "blob.bin")
    data = os.urandom(3 << 20)
    with tio.open_stream(uri, "w") as s:
        assert s.write(data[:1000]) == 1000
        s.write(data[1000:])
    with jio.open_stream(uri, "r") as s:
        assert s.read() == data
    with tio.open_seek_stream(uri) as s, jio.open_seek_stream(uri) as js:
        assert s.seekable() and js.seekable()
        for pos in (0, 17, 2 << 20, len(data) - 5):
            s.seek(pos)
            js.seek(pos)
            assert s.tell() == js.tell() == pos
            assert s.read(4096) == js.read(4096)
    closed = tio.open_stream(uri, "r")
    closed.close()
    with pytest.raises(ValueError, match="closed"):
        closed.read(1)


def test_listdir_and_path_info_equal_jax(tmp_path):
    (tmp_path / "sub").mkdir()
    for name, n in (("a.txt", 3), ("sub/b.txt", 10), ("c.bin", 0)):
        (tmp_path / name).write_bytes(b"x" * n)
    for recursive in (False, True):
        got = sorted(tio.listdir(str(tmp_path), recursive))
        want = sorted(jio.listdir(str(tmp_path), recursive))
        assert [tuple(g) for g in got] == [tuple(w) for w in want]
    info = tio.path_info(str(tmp_path / "sub" / "b.txt"))
    assert tuple(info) == tuple(jio.path_info(str(tmp_path / "sub" /
                                                  "b.txt")))
    assert info.size == 10 and not info.is_dir
    with pytest.raises((FileNotFoundError, NativeError)):
        tio.path_info(str(tmp_path / "nope"))
