"""Static-shape sparse batches and their pow-2 bucket geometry.

The port of ``PaddedBatch``, ``bucket_pow2`` and ``pad_batch_to_bucket``
from ``dmlc_core_tpu.data.staging``, over torch tensors, plus the host to
device copy the serving packer uses.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F


@dataclass
class PaddedBatch:
    """Static-shape CSR batch.

    Row r's nonzeros span ``index/value[row_ptr[r]:row_ptr[r+1]]``.  Padding
    rows have ``weight == 0`` and empty spans; padding nonzero lanes (k >=
    row_ptr[batch_size]) have ``value == 0``.  ``num_rows`` is the true
    (unpadded) row count.
    """

    label: torch.Tensor    # f32 [batch]
    weight: torch.Tensor   # f32 [batch]
    row_ptr: torch.Tensor  # i32 [batch + 1] CSR row pointer
    index: torch.Tensor    # i32 [nnz_pad] column ids
    value: torch.Tensor    # f32 [nnz_pad]
    num_rows: int
    field: Optional[torch.Tensor] = None  # i32 [nnz_pad] (libfm)
    qid: Optional[torch.Tensor] = None    # i32 [batch] query ids (ranking)

    @property
    def batch_size(self) -> int:
        return self.label.shape[0]

    def row_ids(self) -> torch.Tensor:
        """COO row id per nonzero (i32).  Padding lanes map to row
        ``batch_size - 1`` (their value is 0, so reductions are
        unaffected)."""
        k = torch.arange(self.index.shape[0], dtype=self.row_ptr.dtype,
                         device=self.row_ptr.device)
        r = torch.searchsorted(self.row_ptr, k, right=True,
                               out_int32=True) - 1
        return torch.clamp(r, max=self.batch_size - 1)


def bucket_pow2(n: int, lo: int = 1, hi: Optional[int] = None) -> int:
    """Smallest power of two >= max(n, lo), clamped to ``hi`` — but never
    below ``n`` itself (a ceiling must not truncate real data)."""
    n = int(n)
    b = 1 << max(0, max(n, int(lo)) - 1).bit_length()
    if hi is not None:
        b = min(b, int(hi))
    return max(b, n)


def pad_batch_to_bucket(batch: PaddedBatch, row_bucket: Optional[int] = None,
                        nnz_bucket: Optional[int] = None,
                        min_rows: int = 1, min_nnz: int = 8) -> PaddedBatch:
    """Pad ``batch`` up to a pow-2 (rows, nnz) bucket geometry, keeping
    every padding invariant: added rows carry ``weight == 0`` and empty
    spans (``row_ptr`` repeats its last value), added lanes ``value == 0``.
    Explicit buckets override the pow-2 rule (clamped up to the real
    extent, never down).  Returns ``batch`` itself when already on-bucket.
    """
    rows = batch.batch_size
    nnz = int(batch.index.shape[0])
    rb = (bucket_pow2(rows, min_rows) if row_bucket is None
          else max(int(row_bucket), rows))
    nb = (bucket_pow2(nnz, min_nnz) if nnz_bucket is None
          else max(int(nnz_bucket), nnz))
    if rb == rows and nb == nnz:
        return batch
    pr, pn = rb - rows, nb - nnz
    kw = {}
    if pr:
        kw["label"] = F.pad(batch.label, (0, pr))
        kw["weight"] = F.pad(batch.weight, (0, pr))
        kw["row_ptr"] = torch.cat(
            [batch.row_ptr, batch.row_ptr[-1:].expand(pr)])
        if batch.qid is not None:
            kw["qid"] = F.pad(batch.qid, (0, pr))
    if pn:
        kw["index"] = F.pad(batch.index, (0, pn))
        kw["value"] = F.pad(batch.value, (0, pn))
        if batch.field is not None:
            kw["field"] = F.pad(batch.field, (0, pn))
    return dataclasses.replace(batch, **kw)


def to_device_async(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Copy a (pinned) host tensor to ``device`` without blocking the host.

    Stands in for the JAX package's donated ``device_put``: the caller must
    not overwrite ``host`` until the copy is done — record a CUDA event
    after this call and wait on it first.  On a CPU ``device`` the tensor
    itself comes back (no copy)."""
    if device.type == "cpu":
        return host
    return host.to(device, non_blocking=True)
