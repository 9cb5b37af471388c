"""Batch layout and bucketing for the port."""
from .staging import PaddedBatch, bucket_pow2, pad_batch_to_bucket

__all__ = ["PaddedBatch", "bucket_pow2", "pad_batch_to_bucket"]
