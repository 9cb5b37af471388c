"""Field-aware FM training example: a libfm file ("label field:idx:val")
-> native parser -> field-staged batches -> FFM SGD, its linear term on
the segment-sum kernel (one launch a step on the card; ``index_add`` on
the CPU).

    python -m dmlc_core_tpu_torch.examples.train_ffm [--data f.libfm]
        [--epochs 30] [--batch-size 4096] [--num-fields 0]
        [--num-factors 8] [--device cuda|cpu]

With no --data a synthetic CTR-style dataset is generated (the JAX
example's bytes) whose signal lives in FIELD PAIRINGS (user x item
parity): a plain FM or linear model cannot express it, an FFM fits it.
The format is auto-detected from the .libfm extension; pass
?format=libfm in the URI for other names.  ``--device`` defaults to the
card and raises without one.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Optional


def synth_dataset(path: str, rows: int = 20_000, per_field: int = 8) -> int:
    """Two-field interaction problem: y = 1 iff (user + item) is even (the
    JAX example's rows, byte for byte).  Returns the feature count."""
    import numpy as np
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for _ in range(rows):
            u = int(rng.integers(0, per_field))
            i = int(rng.integers(0, per_field))
            y = 1 if (u + i) % 2 == 0 else 0
            f.write(f"{y} 0:{u}:1 1:{per_field + i}:1\n")
    return 2 * per_field  # num_features


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=4096)
    ap.add_argument("--num-fields", type=int, default=0,
                    help="0 = discover from the data (max field id + 1)")
    ap.add_argument("--num-factors", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="the card (default; raises without one) or cpu")
    args = ap.parse_args(argv)

    import torch

    from .._device import resolve_device
    from ..data import DeviceStagingIter, Parser
    from ..models import FieldAwareFactorizationMachine
    from ._common import sdot_backend

    dev = resolve_device(args.device)
    tmp = None
    if args.data is None:
        tmp = tempfile.NamedTemporaryFile(suffix=".libfm", delete=False)
        tmp.close()
        synth_dataset(tmp.name)
        args.data = tmp.name

    # a host-only pass sizes BOTH the feature and the field space;
    # silently clamping out-of-range field ids would train a
    # plausible-looking but structurally wrong model
    num_features = 0
    max_field = -1
    with Parser(args.data) as sizing:
        for block in sizing:
            if len(block.index):
                num_features = max(num_features, int(block.index.max()) + 1)
            if block.field is not None and len(block.field):
                max_field = max(max_field, int(block.field.max()))
    if max_field < 0:
        raise SystemExit(f"{args.data} carries no field ids; FFM needs "
                         "libfm 'field:idx:val' triples")
    num_fields = args.num_fields or (max_field + 1)
    if max_field >= num_fields:
        raise SystemExit(
            f"data contains field id {max_field} but --num-fields is "
            f"{num_fields}; fields would be clamped together")
    print(f"{num_features} features, {num_fields} fields")

    ffm = FieldAwareFactorizationMachine(
        num_features=num_features, num_fields=num_fields,
        num_factors=args.num_factors, learning_rate=0.5, init_scale=0.1,
        sdot_backend=sdot_backend(dev), device=dev).init(seed=1)
    # ONE staging iterator serves every epoch and the final eval pass
    it = DeviceStagingIter(args.data, batch_size=args.batch_size,
                           with_field=True, device=dev)
    for epoch in range(args.epochs):
        last = None
        for batch in it:
            last = ffm.train_step(batch)
        if epoch % max(args.epochs // 5, 1) == 0 or epoch == args.epochs - 1:
            print(f"epoch {epoch}: loss {float(last):.4f}")

    # weighted accuracy over one pass (padding rows carry weight 0)
    correct = total = 0.0
    with torch.no_grad():
        for batch in it:
            pred = ffm.predict(batch) > 0.5
            y = batch.label > 0.5
            w = batch.weight
            correct += float(((pred == y) * w).sum())
            total += float(w.sum())
    it.close()
    print(f"final accuracy: {correct / max(total, 1.0):.3f}")
    if tmp is not None:
        os.unlink(tmp.name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
