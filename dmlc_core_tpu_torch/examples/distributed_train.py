"""Multi-process training example: one rank of a data-parallel sparse
logistic regression.

Each rank parses ITS part of the dataset (part = rank of N) and stages it
as its share of every global batch (``DeviceStagingIter(sharding=plan,
nnz_max=...)``: fixed shapes on every rank); each step all-reduces the
gradient, so the replicas stay one model, and the margins run on the
segment-sum kernel on the card (``index_add`` on the CPU)::

    # under the port's launcher (the DMLC_* env carries the tracker's
    # address and the task ids; gloo when ranks share a card):
    python -m dmlc_core_tpu_torch.tracker.dmlc_submit --cluster=local -n 2 \\
        -- python -m dmlc_core_tpu_torch.examples.distributed_train

    # or standalone on one machine, two processes (a TCP
    # init_process_group at --coord):
    python -m dmlc_core_tpu_torch.examples.distributed_train \\
        --coord 127.0.0.1:9355 --nprocs 2 --pid 0 &
    python -m dmlc_core_tpu_torch.examples.distributed_train \\
        --coord 127.0.0.1:9355 --nprocs 2 --pid 1

Rank 0 prints each epoch's last loss (the global batch's), then ``final:
losses=[...]`` with every epoch's at full precision; every rank prints
its steps and kernel launches.  ``--device`` defaults to the card and
raises without one.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Optional


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=os.path.join(
        tempfile.gettempdir(), "train_linear_synth.libsvm"))
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=4096,
                    help="rows per PROCESS per global batch")
    ap.add_argument("--nnz-max", type=int, default=1 << 17,
                    help="hard per-process nonzero cap (fixed shapes)")
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--coord", default=None,
                    help="host:port of a TCP init_process_group (default: "
                         "the DMLC_* contract of the launcher)")
    ap.add_argument("--nprocs", type=int, default=None)
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="the card (default; raises without one) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..data import DeviceStagingIter
    from ..models import SparseLinearModel
    from ..ops import segment_sum as ss_mod
    from ..parallel import MeshPlan
    from ._common import join_job, leave_job, sdot_backend
    from .train_linear import synth_dataset

    # the demo dataset is made BEFORE joining the job: every process writes
    # its own copy when missing (one seed, the same bytes), which also
    # covers hosts with their own temp directories
    if not os.path.exists(args.data):
        synth_dataset(args.data)

    rank, ranks, dev, worker = join_job(args.device, args.coord,
                                        args.nprocs, args.pid)
    try:
        plan = MeshPlan.build()
        devices = (min(ranks, torch.cuda.device_count())
                   if dev.type == "cuda" else 1)
        it = DeviceStagingIter(args.data, batch_size=args.batch_size,
                               nnz_bucket=1 << 14, nnz_max=args.nnz_max,
                               part=rank, num_parts=ranks, sharding=plan,
                               device=dev)
        for _ in it:  # size the feature space; max_index folds over ranks
            pass
        num_features = it.max_index + 1

        model = SparseLinearModel(num_features=num_features,
                                  learning_rate=args.lr,
                                  sdot_backend=sdot_backend(dev),
                                  mesh_plan=plan, device=dev).init()
        launches0 = ss_mod.segment_sum_kernel.launches
        losses, steps = [], 0
        for epoch in range(args.epochs):
            loss = None
            for batch in it:
                loss = model.train_step(batch)
                steps += 1
            losses.append(float(loss))
            if rank == 0:
                print(f"epoch {epoch}: loss {losses[-1]:.4f} "
                      f"({ranks} processes, {devices} devices)", flush=True)
        it.close()
        print(f"rank {rank}: {steps} steps, segment_sum launches "
              f"{ss_mod.segment_sum_kernel.launches - launches0}",
              flush=True)
        if rank == 0:
            print("done", flush=True)
            print(f"final: losses={losses!r}", flush=True)
    finally:
        leave_job(worker)
    return 0


if __name__ == "__main__":
    sys.exit(main())
