"""Multi-process staging of the port (``sharding=``) on 2 gloo ranks on the
CPU, in the pattern of the JAX package's tests/test_multihost_staging.py:

* uneven parts (60 rows on rank 0, 25 on rank 1): every row delivered
  exactly once, the same batch count on both ranks (the short rank sends
  all-padding batches), each batch's ``global_num_rows`` the sum of the
  ranks' rows and its ``global_row_ptr`` the JAX package's global CSR;
* a missing ``nnz_max`` raises the JAX package's ``ValueError``;
* a parse failure on one rank raises there and, through the status -1
  broadcast, on the other, instead of hanging;
* ``BinnedStagingIter`` and ``RecordStagingIter`` sharded the same way;
* the coordinated readers (``host_batches_coordinated``,
  ``host_blocks_coordinated``) against the port's ``ShardBoard``: a
  flagged worker's shards are stolen and every record is read once.
"""
import numpy as np
import pytest

from dmlc_core_tpu_torch.data.binned_cache import BinnedStagingIter
from dmlc_core_tpu_torch.data.staging import RecordStagingIter
from dmlc_core_tpu_torch.io import RecordIOWriter
from dmlc_core_tpu_torch.models.gbdt import QuantileBinner
from dmlc_core_tpu_torch.tracker.metrics import ShardBoard
from torch_ranks import run_ranks

B, NNZ_MAX, F = 16, 32, 97


def _libsvm(path, part, rows):
    lines = []
    for j in range(rows):
        nnz = (j % 5) + 1
        feats = " ".join(f"{(j * 7 + k) % F}:{k + 1}" for k in range(nnz))
        lines.append(f"{part * 1000 + j} {feats}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _records(path, part, count):
    payloads = [f"r{part}-{j}-".encode() + bytes([j % 251]) * (j % 37)
                for j in range(count)]
    with RecordIOWriter(str(path)) as w:
        for p in payloads:
            w.write(p)
    return str(path), payloads


def _cuts():
    return np.tile(np.linspace(0.5, 5.5, 14, dtype=np.float32), (F, 1))


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_staging")
    files = [_libsvm(tmp / "part0.libsvm", 0, 60),
             _libsvm(tmp / "part1.libsvm", 1, 25)]
    bad = []
    for p in (0, 1):
        rows = ["1 1:1"] * 40 + (["1 3000000000:1"] if p == 0
                                 else ["1 2:1"] * 40)
        (tmp / f"bad{p}.libsvm").write_text("\n".join(rows) + "\n")
        bad.append(str(tmp / f"bad{p}.libsvm"))
    binned = _libsvm(tmp / "binned.libsvm", 0, 90)
    recs = [_records(tmp / f"r{p}.rec", p, n) for p, n in ((0, 29), (1, 8))]
    res = run_ranks(2, "sharded_staging", tmp, files=files, bad_files=bad,
                    B=B, nnz_max=NNZ_MAX, binned_file=binned,
                    record_files=[r[0] for r in recs], cuts=_cuts())
    return res, recs


@pytest.mark.parametrize("sharding", ["plan", "data_sharding"])
def test_uneven_parts_every_row_once(staged, sharding):
    res, _ = staged
    a, b = res[0][sharding], res[1][sharding]
    assert len(a) == len(b) >= 4  # matched counts past rank 1's 2 batches
    rows = sorted(x for r in (a, b) for batch in r for x in batch[0])
    assert rows == sorted([float(j) for j in range(60)]
                          + [1000.0 + j for j in range(25)])
    for (la, ga, rpa, lrpa, na), (lb, gb, rpb, lrpb, nb) in zip(a, b):
        assert ga == gb == na + nb
        np.testing.assert_array_equal(rpa, rpb)
        # the JAX package's global CSR: each rank's row pointer shifted
        # into its nnz_max segment
        want = np.concatenate([lrpa[:-1], lrpb[:-1] + NNZ_MAX,
                               [2 * NNZ_MAX]])
        np.testing.assert_array_equal(rpa, want)
    assert res[0][sharding + "_max_index"] == res[1][sharding + "_max_index"]
    # every rank folds every peer's largest id
    assert res[0][sharding + "_max_index"] == max(
        (j * 7 + k) % F for n in (60, 25) for j in range(n)
        for k in range(j % 5 + 1))


def test_missing_nnz_max_raises(staged):
    for r in staged[0]:
        assert "needs fixed shapes" in r["no_nnz_max"]
        assert "nnz_max" in r["no_nnz_max"]


def test_one_rank_failure_raises_on_the_other(staged):
    r0, r1 = staged[0]
    assert r0["failure"] is not None and "feature" in r0["failure"]
    assert "process(es) [0]" in r1["failure"]


def test_binned_staging_sharded(staged):
    a, b = staged[0][0]["binned"], staged[0][1]["binned"]
    assert len(a) == len(b)
    rows = sorted(x for r in (a, b) for batch in r for x in batch[0])
    assert rows == [float(j) for j in range(90)]
    for ba, bb in zip(a, b):
        assert ba[1] == bb[1] == ba[4] + bb[4]
        np.testing.assert_array_equal(ba[2], bb[2])


def test_record_staging_sharded(staged):
    res, recs = staged
    a, b = res[0]["records"], res[1]["records"]
    assert len(a) == len(b) >= 4  # 29 records in blocks of 8
    assert [p for batch in a for p in batch[0]] == recs[0][1]
    assert [p for batch in b for p in batch[0]] == recs[1][1]
    for (ra, na, oa, ca), (rb, nb, ob, cb) in zip(a, b):
        assert na == nb == len(ra) + len(rb)
        np.testing.assert_array_equal(oa, ob)
        np.testing.assert_array_equal(ca, [len(ra), len(rb)])


class _BoardClient:
    """The ShardClient surface over an in-process ShardBoard."""

    def __init__(self, board, rank, flagged=()):
        self.board, self.rank, self.flagged = board, rank, set(flagged)

    def register(self, epoch, shards):
        return self.board.register(self.rank, epoch, shards)

    def claim(self, epoch, shard):
        return bool(self.board.claim(self.rank, epoch, shard)["ok"])

    def steal(self, epoch):
        return self.board.steal(self.rank, epoch, self.flagged)

    def done(self, epoch, shard):
        return self.board.done(self.rank, epoch, shard)


def test_coordinated_records_against_the_shard_board(tmp_path):
    path, payloads = _records(tmp_path / "all.rec", 0, 300)
    board = ShardBoard()
    workers = [RecordStagingIter(path, records_cap=16, bytes_cap=1 << 14,
                                 part=p, num_parts=2, device="cpu")
               for p in (0, 1)]
    c0 = _BoardClient(board, 0, flagged={1})
    c1 = _BoardClient(board, 1)
    V = workers[1]._resolve_virtual_parts()
    c1.register(0, list(range(V, 2 * V)))  # the straggler registers, stalls
    got0 = [r for w in workers[0].host_batches_coordinated(0, client=c0)
            for r in _host(w)]
    got1 = [r for w in workers[1].host_batches_coordinated(0, client=c1)
            for r in _host(w)]
    assert got1 == []  # every one of its shards was stolen
    assert sorted(got0) == sorted(payloads)
    stolen = board.state()["0"]["stolen"]
    assert {s["to"] for s in stolen} == {0} and len(stolen) == V


def test_coordinated_cache_blocks_against_the_shard_board(tmp_path):
    uri = _libsvm(tmp_path / "cache.libsvm", 0, 400)
    binner = QuantileBinner.from_cuts(_cuts(), 16, missing_aware=True,
                                      device="cpu")
    its = [BinnedStagingIter(uri, binner, cache=str(tmp_path / "c.bin"),
                             batch_size=32, part=p, num_parts=2,
                             device="cpu") for p in (0, 1)]
    its[0].ensure_cache()
    board = ShardBoard()
    blocks = [list(it.host_blocks_coordinated(0, client=_BoardClient(
        board, p))) for p, it in enumerate(its)]
    labels = sorted(float(x) for bl in blocks for b in bl
                    for x in b["label"][:int(b["num_rows"])])
    assert labels == [float(j) for j in range(400)]


def _host(w):
    raw, offs = w["bytes"], w["offsets"]
    return [raw[offs[k]:offs[k + 1]].tobytes()
            for k in range(int(w["num_records"]))]
