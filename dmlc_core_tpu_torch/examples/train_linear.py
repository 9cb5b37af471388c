"""End-to-end training example: a libsvm file -> native parse and pack ->
batches staged onto the device -> sparse logistic regression by SGD, its
margins on the segment-sum kernel (one launch a step on the card;
``index_add`` on the CPU).

    python -m dmlc_core_tpu_torch.examples.train_linear [--data f.libsvm]
        [--epochs 3] [--batch-size 8192] [--lr 0.5] [--shard]
        [--device cuda|cpu]

With no --data a synthetic dataset is generated (the JAX example's bytes,
in the temp directory).  ``--device`` defaults to the card and raises
without one; ``--device cpu`` runs the kernel's plain version.

``--shard``: data parallel over the ranks of the job that
``python -m dmlc_core_tpu_torch.tracker.dmlc_submit --cluster=local -n N
-- python -m dmlc_core_tpu_torch.examples.train_linear --shard`` starts
(each rank joins the ``torch.distributed`` group from the DMLC_* contract;
gloo when ranks share a card).  Rank r stages part r of N of the file as
its share of each global batch (``DeviceStagingIter(sharding=plan,
nnz_max=...)``) and every step all-reduces the gradient
(``SparseLinearModel(mesh_plan=plan)``).  Without a job it is a 1-rank
plan.  (In the JAX package ``--shard`` lays each batch over the local
devices of one process.)
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Optional


def synth_dataset(path: str, rows: int = 200_000, dim: int = 1000) -> None:
    """Sparse binary problem with a planted weight vector (the JAX
    example's rows, byte for byte)."""
    import numpy as np
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=dim)
    with open(path, "w") as f:
        for _ in range(rows):
            nnz = rng.integers(5, 30)
            idx = rng.choice(dim, size=nnz, replace=False)
            val = rng.random(nnz).astype(np.float32)
            y = int(val @ w_true[idx] > 0)
            f.write(f"{y} " + " ".join(f"{i}:{v:.4f}" for i, v in
                                       sorted(zip(idx, val))) + "\n")


def size_features(data: str) -> tuple:
    """A host-only pass over the whole file: (features, the most nonzeros
    of a row)."""
    from ..data import Parser
    num_features = widest = 0
    with Parser(data) as sizing:
        for block in sizing:
            if len(block.index):
                num_features = max(num_features, int(block.index.max()) + 1)
                widest = max(widest, int((block.offset[1:]
                                          - block.offset[:-1]).max()))
    return num_features, widest


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--shard", action="store_true",
                    help="data parallel over the job's ranks (a 1-rank "
                         "plan outside a job)")
    ap.add_argument("--device", default="cuda",
                    help="the card (default; raises without one) or cpu")
    args = ap.parse_args(argv)

    from ..data import DeviceStagingIter
    from ..models import SparseLinearModel
    from ..parallel import MeshPlan
    from ._common import join_job, leave_job, sdot_backend

    data = args.data
    if data is None:
        data = os.path.join(tempfile.gettempdir(),
                            "train_linear_synth.libsvm")
        if not os.path.exists(data):
            print("generating synthetic dataset ...")
            synth_dataset(data)

    rank, ranks, dev, worker = join_job(args.device) if args.shard else (
        0, 1, args.device, None)
    try:
        plan = MeshPlan.build() if args.shard else None
        num_features, widest = size_features(data)
        print(f"{num_features} features")
        if plan is not None:
            print(f"sharding batches over {plan.num_shards} ranks")
            # fixed shapes on every rank, wide enough that no batch closes
            # before batch_size rows
            it = DeviceStagingIter(data, batch_size=args.batch_size,
                                   nnz_bucket=1 << 16, part=rank,
                                   num_parts=ranks, sharding=plan,
                                   nnz_max=args.batch_size * max(widest, 1),
                                   device=dev)
        else:
            it = DeviceStagingIter(data, batch_size=args.batch_size,
                                   nnz_bucket=1 << 16, device=dev)
        model = SparseLinearModel(num_features=num_features,
                                  learning_rate=args.lr,
                                  sdot_backend=sdot_backend(dev), mesh_plan=plan,
                                  device=dev).init()
        for epoch in range(args.epochs):
            t0 = time.monotonic()
            loss = None
            n = 0
            for batch in it:
                loss = model.train_step(batch)
                n += 1
            secs = time.monotonic() - t0
            print(f"epoch {epoch}: loss {float(loss):.4f}  "
                  f"({n} batches, {secs:.1f}s)")
        metrics = model.evaluate(it)
        it.close()
        print(f"final: {metrics}")
    finally:
        leave_job(worker)
    return 0


if __name__ == "__main__":
    sys.exit(main())
