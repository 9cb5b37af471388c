"""End-to-end histogram-GBDT example: a libsvm file -> native parse and
pack -> batches staged onto the device -> densify -> quantile bins ->
boosted trees, every level's histogram on the hand-written kernel on the
card (``index_add`` on the CPU).

The XGBoost-hist workflow on the port::

    python -m dmlc_core_tpu_torch.examples.gbdt_train [--data f.libsvm]
        [--trees 10] [--depth 5] [--bins 64] [--dim 32]
        [--native-sparse | --rank | --missing] [--shard [--kernel-mesh]]
        [--device cuda|cpu]

With no --data a synthetic nonlinear dataset is generated (the JAX
example's bytes, in the temp directory).  The paths:

* the dense default: each staged batch densified (``csr_to_dense``, or
  ``csr_to_dense_missing`` with ``--missing``: absent features are
  missing, learned default directions), ``QuantileBinner.fit_transform``,
  then ``GBDT.fit``;
* ``--native-sparse``: the staged CSR rows concatenated with no densify,
  bin cuts from the streaming sketch fed batch by batch
  (``partial_fit_sparse``, then ``finalize``), then ``fit_batch``;
* ``--rank``: a qid-grouped libsvm file staged with ``with_qid=True`` into
  ``objective="rank:pairwise"`` by ``fit_batch``, scored by
  ``margins_batch`` (reports within-query pairwise accuracy).

``--shard`` (the dense path): data parallel over the ranks of the job that
``python -m dmlc_core_tpu_torch.tracker.dmlc_submit --cluster=local -n N
-- python -m dmlc_core_tpu_torch.examples.gbdt_train --shard`` starts
(gloo when ranks share a card): every rank bins the whole file with the
same cuts and fits its contiguous share of the rows with
``GBDT(histogram_mesh=plan)``, each level's histogram all-reduced exactly,
so every rank grows the one-process forest.  Without a job it is a 1-rank
plan.  ``--kernel-mesh`` (needs ``--shard``) pins the sharded route to the
kernel (``histogram="pallas"``; its plain version on the CPU).  (In the
JAX package ``--shard`` lays rows over the local devices of one process.)

Exit code 0 iff the accuracy (pairwise accuracy with ``--rank``) is past
0.8.  ``--device`` defaults to the card and raises without one.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Optional

import numpy as np


def synth_dataset(path: str, rows: int = 50_000, dim: int = 32) -> None:
    """Sparse rows whose label is a nonlinear (XOR-style) feature rule,
    unlearnable by the linear model, easy for trees (the JAX example's
    rows, byte for byte)."""
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for _ in range(rows):
            nnz = rng.integers(max(4, dim // 4), dim)
            idx = np.sort(rng.choice(dim, size=nnz, replace=False))
            val = rng.uniform(-1, 1, size=nnz)
            lut = dict(zip(idx.tolist(), val.tolist()))
            y = int((lut.get(0, 0.0) > 0) ^ (lut.get(1, 0.0) > 0.2))
            f.write(f"{y} " + " ".join(f"{i}:{v:.4f}" for i, v in lut.items())
                    + "\n")


def synth_rank_dataset(path: str, dim: int = 32) -> None:
    """1,500 queries of 6-13 documents whose relevance follows features 0
    and 1 (the JAX example's ranking rows, byte for byte)."""
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for q in range(1500):
            for _ in range(int(rng.integers(6, 14))):
                v = {int(i): float(rng.uniform(0.1, 2.0))
                     for i in np.sort(rng.choice(
                         dim, size=max(3, dim // 4), replace=False))}
                rel = round(2 * v.get(0, 0.0)
                            + v.get(1, 0.0) ** 2
                            + float(rng.normal(0, 0.05)), 4)
                f.write(f"{rel} qid:{q} " + " ".join(
                    f"{i}:{val:.4f}" for i, val in v.items()) + "\n")


def entry_mask(row_ptr: np.ndarray, n_entries: int) -> np.ndarray:
    """Structural mask of REAL CSR entries: the slots covered by some
    row's [row_ptr[r], row_ptr[r+1]) span.  Everything outside a span is
    nnz-bucket lane padding; unlike ``value != 0`` this keeps genuine
    zero-valued features and works on concatenated batches whose padding
    lanes sit between the per-batch segments."""
    edges = np.zeros(n_entries + 1, np.int64)
    np.add.at(edges, row_ptr[:-1], 1)
    np.add.at(edges, row_ptr[1:], -1)
    return np.cumsum(edges[:-1]) > 0


def _default_data(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None)
    ap.add_argument("--trees", type=int, default=10)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--bins", type=int, default=64)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=16384)
    ap.add_argument("--num-workers", type=int, default=1,
                    help="parallel parse workers for the staging iterator "
                         "(deterministic: batches are identical for any "
                         "worker count)")
    ap.add_argument("--prefetch-depth", type=int, default=None,
                    help="staged batches buffered ahead of the consumer "
                         "(default: staging iterator's own default)")
    ap.add_argument("--shard", action="store_true",
                    help="row-shard over the job's ranks (data parallel; a "
                         "1-rank plan outside a job)")
    ap.add_argument("--kernel-mesh", action="store_true",
                    help="with --shard: the sharded route on the histogram "
                         "kernel (histogram='pallas'; its plain version on "
                         "the CPU)")
    ap.add_argument("--missing", action="store_true",
                    help="sparsity-aware mode: absent libsvm features are "
                         "MISSING (NaN -> reserved bin, learned per-node "
                         "default direction), not zeros")
    ap.add_argument("--native-sparse", action="store_true",
                    help="train straight on the staged CSR batch "
                         "(fit_batch: O(nnz) histograms, no densify; "
                         "implies --missing semantics)")
    ap.add_argument("--rank", action="store_true",
                    help="learning-to-rank demo: a qid-grouped libsvm "
                         "dataset staged with with_qid=True into "
                         "objective='rank:pairwise' (reports within-query "
                         "pairwise accuracy)")
    ap.add_argument("--device", default="cuda",
                    help="the card (default; raises without one) or cpu")
    args = ap.parse_args(argv)

    import torch

    from .._device import resolve_device
    from ..data import DeviceStagingIter, PaddedBatch
    from ..models import GBDT, QuantileBinner
    from ..ops.sparse import csr_to_dense, csr_to_dense_missing

    dev = resolve_device(args.device)
    stage_kw = dict(num_workers=args.num_workers, device=dev)
    if args.prefetch_depth is not None:
        stage_kw["prefetch_depth"] = args.prefetch_depth

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def concat_staged(uri, with_qid=False, sketch=None):
        """Drain ALL staged batches of a dataset into one PaddedBatch on
        the device (hist-GBDT needs the full dataset a level); None if no
        rows.  With ``sketch`` (a QuantileBinner), each batch's entries
        feed the streaming quantile sketch as it goes by: bounded-memory
        cuts over the whole stream, the XGBoost-sketch pattern for data
        that never fits in one sample (the caller runs
        ``sketch.finalize()`` after)."""
        it = DeviceStagingIter(uri, batch_size=args.batch_size,
                               with_qid=with_qid, **stage_kw)
        parts = []
        for b in it:
            idxs, vals = b.index.cpu().numpy(), b.value.cpu().numpy()
            if sketch is not None:
                m = entry_mask(b.row_ptr.cpu().numpy(), vals.shape[0])
                sketch.partial_fit_sparse(idxs[m], vals[m], args.dim)
            parts.append((b.label.cpu().numpy(), b.weight.cpu().numpy(),
                          b.row_ptr.cpu().numpy(), idxs, vals,
                          b.qid.cpu().numpy() if with_qid else None))
        it.close()
        if not parts:
            return None
        nnz_off = np.cumsum([0] + [p[4].shape[0] for p in parts])

        def on_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return PaddedBatch(
            label=on_dev(np.concatenate([p[0] for p in parts])),
            weight=on_dev(np.concatenate([p[1] for p in parts])),
            row_ptr=on_dev(np.concatenate(
                [parts[0][2]] + [p[2][1:] + off for p, off
                                 in zip(parts[1:], nnz_off[1:-1])])),
            index=on_dev(np.concatenate([p[3] for p in parts])),
            value=on_dev(np.concatenate([p[4] for p in parts])),
            num_rows=sum(int((p[1] > 0).sum()) for p in parts),
            qid=(on_dev(np.concatenate([p[5] for p in parts]))
                 if with_qid else None))

    if args.rank:
        data_rank = args.data or _default_data("gbdt_rank_example.libsvm")
        if args.data is None and not os.path.exists(data_rank):
            print("generating synthetic ranking dataset...", flush=True)
            synth_rank_dataset(data_rank, args.dim)
        batch = concat_staged(data_rank, with_qid=True)
        if batch is None:
            print(f"error: no rows staged from {data_rank}", file=sys.stderr)
            return 1
        mask = entry_mask(batch.row_ptr.cpu().numpy(),
                          int(batch.value.shape[0]))
        binner = QuantileBinner(num_bins=args.bins, missing_aware=True,
                                device=dev)
        binner.fit_sparse(batch.index.cpu().numpy()[mask],
                          batch.value.cpu().numpy()[mask],
                          num_features=args.dim)
        model = GBDT(num_features=args.dim, num_trees=args.trees,
                     max_depth=args.depth, num_bins=args.bins,
                     learning_rate=0.3, objective="rank:pairwise",
                     missing_aware=True, device=dev)
        sync()
        t0 = time.monotonic()
        params = model.fit_batch(batch, binner)
        sync()
        t_fit = time.monotonic() - t0
        scores = model.margins_batch(params, batch, binner).cpu().numpy()
        w = batch.weight.cpu().numpy()
        y = batch.label.cpu().numpy()
        q = batch.qid.cpu().numpy()
        # within-query pairwise accuracy over a row sample
        rng2 = np.random.default_rng(1)
        real = np.flatnonzero(w > 0)
        good = total = 0
        for i in rng2.choice(real, size=min(4000, len(real)), replace=False):
            same = real[(q[real] == q[i]) & (real != i)]
            for j in same:
                if y[i] == y[j]:
                    continue
                total += 1
                good += (scores[i] > scores[j]) == (y[i] > y[j])
        acc = good / max(total, 1)
        print(f"fit {args.trees} rank trees in {t_fit:.2f}s; "
              f"pairwise accuracy={acc:.4f} over {total} sampled pairs",
              flush=True)
        print(f"final: pairwise_accuracy={acc:.4f}", flush=True)
        return 0 if acc > 0.8 else 1

    data = args.data
    if data is None:
        data = _default_data("gbdt_example.libsvm")
        if not os.path.exists(data):
            print("generating synthetic dataset...", flush=True)
            synth_dataset(data, dim=args.dim)

    if args.native_sparse:
        # no densify: staged CSR batches concatenated into one batch for
        # fit_batch; bin cuts from the STREAMING sketch fed batch by batch
        # during the drain.  The reservoir is sized past this dataset's
        # per-feature counts so the streamed cuts stay EXACTLY the one-shot
        # fit_sparse cuts; at real scale the default (smaller) reservoir
        # subsamples, and that bounded memory is the streaming path's point
        binner = QuantileBinner(num_bins=args.bins, missing_aware=True,
                                sketch_size=1 << 16, device=dev)
        t0 = time.monotonic()
        batch = concat_staged(data, sketch=binner)
        if batch is None:
            print(f"error: no rows staged from {data}", file=sys.stderr)
            return 1
        t_stage = time.monotonic() - t0
        binner.finalize()
        mask = entry_mask(batch.row_ptr.cpu().numpy(),
                          int(batch.value.shape[0]))
        n_real = int(batch.weight.sum())
        print(f"staged {n_real} rows ({int(mask.sum())} nnz) "
              f"in {t_stage:.2f}s (bin cuts streamed per batch)", flush=True)
        model = GBDT(num_features=args.dim, num_trees=args.trees,
                     max_depth=args.depth, num_bins=args.bins,
                     learning_rate=0.4, missing_aware=True, device=dev)
        sync()
        t0 = time.monotonic()
        params = model.fit_batch(batch, binner)
        sync()
        t_fit = time.monotonic() - t0
        pred = model.predict_batch(params, batch, binner).cpu().numpy()
        w = batch.weight.cpu().numpy()
        y = batch.label.cpu().numpy()
        acc = float(((pred > 0.5) == (y > 0.5))[w > 0].mean())
        rate = args.trees * n_real / max(t_fit, 1e-9)
        print(f"fit {args.trees} trees (sparse-native, depth {args.depth}, "
              f"{args.bins} bins) in {t_fit:.2f}s = {rate:,.0f} "
              f"row-trees/s", flush=True)
        print(f"final: accuracy={acc:.4f}", flush=True)
        return 0 if acc > 0.8 else 1

    if args.kernel_mesh and not args.shard:
        raise SystemExit("--kernel-mesh requires --shard")

    # stage sparse batches to the device, densify each into [rows, dim]
    t0 = time.monotonic()
    it = DeviceStagingIter(data, batch_size=args.batch_size, **stage_kw)
    dense_parts, label_parts = [], []
    densify = csr_to_dense_missing if args.missing else csr_to_dense
    for batch in it:
        d = densify(batch.index, batch.value, batch.row_ids(),
                    batch.batch_size, args.dim)
        keep = batch.weight > 0  # drop padding rows
        dense_parts.append(d[keep].cpu().numpy())
        label_parts.append(batch.label[keep].cpu().numpy())
    it.close()
    x = np.concatenate(dense_parts)
    y = np.concatenate(label_parts)
    t_stage = time.monotonic() - t0
    print(f"staged+densified {x.shape[0]} rows x {args.dim} features "
          f"in {t_stage:.2f}s", flush=True)

    binner = QuantileBinner(num_bins=args.bins, missing_aware=args.missing,
                            device=dev)
    bins = binner.fit_transform(x)
    label = torch.from_numpy(y).to(dev)

    worker = None
    mesh_kw = {}
    rows = slice(None)
    if args.shard:
        from ..parallel import MeshPlan
        from ._common import join_job
        rank, ranks, dev, worker = join_job(args.device)
        bins, label = bins.to(dev), label.to(dev)
        plan = MeshPlan.build()
        n = plan.num_shards
        rows = slice(len(y) * plan.shard_index // n,
                     len(y) * (plan.shard_index + 1) // n)
        mesh_kw = dict(histogram_mesh=plan)
        print(f"sharding {len(y)} rows over {n} ranks "
              f"({rows.stop - rows.start} on rank {plan.shard_index})",
              flush=True)
        if args.kernel_mesh:
            mesh_kw["histogram"] = "pallas"
            print("histogram route: the histogram kernel on every rank, "
                  "levels all-reduced exactly", flush=True)
    try:
        model = GBDT(num_features=args.dim, num_trees=args.trees,
                     max_depth=args.depth, num_bins=args.bins,
                     learning_rate=0.4, missing_aware=args.missing,
                     device=dev, **mesh_kw)
        sync()
        t0 = time.monotonic()
        params = model.fit(bins[rows], label[rows])
        sync()
        t_fit = time.monotonic() - t0
        # every rank scores every row (under a plan the loss's sums run
        # over the ranks, each adding all rows: the same mean)
        pred = model.predict(params, bins).cpu().numpy()
        loss = float(model.loss(params, bins, label))
    finally:
        if args.shard:
            from ._common import leave_job
            leave_job(worker)

    acc = float(np.mean((pred > 0.5) == (y > 0.5)))
    rate = args.trees * x.shape[0] / max(t_fit, 1e-9)
    print(f"fit {args.trees} trees (depth {args.depth}, {args.bins} bins) "
          f"in {t_fit:.2f}s = {rate:,.0f} row-trees/s", flush=True)
    print(f"final: loss={loss:.4f} accuracy={acc:.4f}", flush=True)
    return 0 if acc > 0.8 else 1


if __name__ == "__main__":
    sys.exit(main())
