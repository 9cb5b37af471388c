"""The disaggregated staging service on the 0xff9a wire.

Staging workers (:mod:`.server`) build the binned epoch cache of a dataset
once and stream its blocks (or, in the staged mode, packed text-parse
batches) to trainer clients (:mod:`.client`) over the data channel
(:mod:`.protocol`); the tracker's lease board hands each client's epoch
out part by part, so every client sees every part once an epoch however
the worker fleet grows, shrinks or fails mid-stream.
"""
from .client import DataServiceIter
from .protocol import DATA_MAGIC

__all__ = ["DataServiceIter", "StagingWorker", "DATA_MAGIC"]


def __getattr__(name):
    # imported on first use, so ``python -m dmlc_core_tpu_torch.dataservice
    # .server`` does not find its module imported already by the package
    if name == "StagingWorker":
        from .server import StagingWorker
        return StagingWorker
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
