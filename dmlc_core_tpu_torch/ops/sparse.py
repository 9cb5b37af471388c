"""Sparse CSR/COO ops over padded batches (the Row::SDot analogue).

All ops take flattened COO tensors (index/value/row_id of a PaddedBatch):
one gather from the dense operand, then one segment-sum whose backend is
chosen per call (``force``, see :mod:`.segment_sum`).  Gathers clamp their
indices as JAX's do, so an index past the table reads its last row instead
of faulting.  Padding convention: value == 0 means the entry contributes
nothing.
"""
from __future__ import annotations

import torch

from .segment_sum import clamp_index, segment_sum


def csr_matvec(weights: torch.Tensor, index: torch.Tensor,
               value: torch.Tensor, row_id: torch.Tensor, num_rows: int,
               force: str | None = None) -> torch.Tensor:
    """Per-row sparse dot product:
    out[r] = sum over k with row_id[k] == r of w[index[k]] * value[k]."""
    contrib = weights[clamp_index(index, weights.shape[0])] * value
    return segment_sum(contrib, row_id, num_rows, force=force)


def csr_matmul(table: torch.Tensor, index: torch.Tensor, value: torch.Tensor,
               row_id: torch.Tensor, num_rows: int,
               force: str | None = None) -> torch.Tensor:
    """Sparse x dense: out[r, :] = sum_k value[k] * table[index[k], :], with
    ``table`` [num_features, K] -> [num_rows, K] (K lanes, one pass)."""
    gathered = table[clamp_index(index, table.shape[0])] * value[:, None]
    return segment_sum(gathered, row_id, num_rows, force=force)


def csr_row_sumsq_matmul(table: torch.Tensor, index: torch.Tensor,
                         value: torch.Tensor, row_id: torch.Tensor,
                         num_rows: int,
                         force: str | None = None) -> torch.Tensor:
    """out[r, :] = sum_k value[k]^2 * table[index[k], :]^2 (the FM
    second-order term)."""
    gathered = ((table[clamp_index(index, table.shape[0])] ** 2)
                * (value[:, None] ** 2))
    return segment_sum(gathered, row_id, num_rows, force=force)


def csr_to_dense_missing(index: torch.Tensor, value: torch.Tensor,
                         row_id: torch.Tensor, num_rows: int,
                         num_features: int) -> torch.Tensor:
    """Densify a COO batch with NaN for ABSENT cells (absent feature !=
    zero-valued feature, XGBoost's sparse semantics): ``out[r, f]`` is the
    sum of ``value[k]`` over entries at (r, f), NaN where none has a
    nonzero value.  Padding lanes (value 0) mark nothing, so a stored 0
    reads as missing; entries with an out-of-range row or feature are
    dropped.  Feed the result to a ``missing_aware`` QuantileBinner/GBDT
    pair.  Returns f32 [num_rows, num_features]."""
    # one two-lane scatter (value, presence) over flattened (row, feature)
    # cells; dropped entries go to one spare cell that is cut off
    lanes = torch.stack([value.to(torch.float32),
                         (value != 0).to(torch.float32)], dim=-1)
    r, f = row_id.to(torch.int64), index.to(torch.int64)
    cells = num_rows * num_features
    keep = (r >= 0) & (r < num_rows) & (f >= 0) & (f < num_features)
    flat = torch.where(keep, r * num_features + f, cells)
    acc = torch.zeros(cells + 1, 2, dtype=torch.float32,
                      device=value.device).index_add_(0, flat, lanes)
    acc = acc[:cells].reshape(num_rows, num_features, 2)
    return torch.where(acc[..., 1] > 0, acc[..., 0], torch.nan)


def padded_row_mean(per_row: torch.Tensor,
                    weight: torch.Tensor) -> torch.Tensor:
    """Weighted mean over rows that treats padding rows (weight 0) as
    absent."""
    return torch.sum(per_row * weight) / torch.clamp(torch.sum(weight),
                                                     min=1.0)
