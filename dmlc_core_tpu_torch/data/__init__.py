"""Data layer: parsed RowBlocks (numpy), batch layout and bucketing,
staging a dataset or RecordIO file onto the card, and the binned epoch
cache."""
from .rowblock import Parser, RowBlock
from .staging import (DeviceStagingIter, PaddedBatch, RecordBatch,
                      RecordStagingIter, bucket_pow2, pad_batch_to_bucket)
from .binned_cache import (BinnedBatch, BinnedRowIter,  # noqa: E402
                           BinnedStagingIter, build_bin_cache)

__all__ = ["BinnedBatch", "BinnedRowIter", "BinnedStagingIter",
           "DeviceStagingIter", "PaddedBatch", "Parser", "RecordBatch",
           "RecordStagingIter", "RowBlock", "bucket_pow2", "build_bin_cache",
           "pad_batch_to_bucket"]
