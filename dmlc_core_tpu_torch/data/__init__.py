"""Data layer: parsed RowBlocks (numpy), batch layout and bucketing, and
staging a dataset file onto the card."""
from .rowblock import Parser, RowBlock
from .staging import (DeviceStagingIter, PaddedBatch, bucket_pow2,
                      pad_batch_to_bucket)

__all__ = ["DeviceStagingIter", "PaddedBatch", "Parser", "RowBlock",
           "bucket_pow2", "pad_batch_to_bucket"]
