"""Sparse CSR/COO ops over padded batches (the Row::SDot analogue).

All ops take flattened COO tensors (index/value/row_id of a PaddedBatch):
one gather from the dense operand, then one segment-sum whose backend is
chosen per call (``force``, see :mod:`.segment_sum`).  Gathers take their
indices as JAX's do (:func:`take_rows`): an index past the table reads its
last row instead of faulting, and its gradient is dropped.  Padding
convention: value == 0 means the entry contributes nothing.

A table sharded by feature over a model axis (the dp x tp layout) holds
one block of rows on each process.  :func:`local_entries` picks the
entries of a batch whose (clamped) index falls in this process's block, and
the ops given them (``entries=``) look up only local rows and sum over the
model axis (:func:`.segment_sum.segment_sum_model`): every entry, padding
lanes included, belongs to exactly one process, so the sums are the whole
batch's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .segment_sum import clamp_index, segment_sum, segment_sum_model


def in_table(index: torch.Tensor, n: int) -> torch.Tensor:
    """bool: the indices a gather on an axis of length ``n`` takes as they
    are (a negative one counting from the end)."""
    return (index >= -n) & (index < n)


def take_rows(table: torch.Tensor, rows: torch.Tensor, live: torch.Tensor,
              *more) -> torch.Tensor:
    """``table[rows, *more]`` (``rows`` already clamped) with the gradient
    of the entries where ``live`` is False dropped: JAX's gather reads the
    clamped row of an index past the table, and its transpose drops that
    entry's update."""
    out = table[(rows,) + more]
    if not out.requires_grad:
        return out
    keep = live.reshape((-1,) + (1,) * (out.dim() - 1))
    return torch.where(keep, out, out.detach())


class LocalEntries(NamedTuple):
    """The entries of a batch that index this process's block of a table
    sharded by feature."""

    pos: torch.Tensor     # int64 [n]: their positions in the batch
    row: torch.Tensor     # int64 [n]: their rows of the local block
    live: torch.Tensor    # bool [n]: their index is inside the table
    row_id: torch.Tensor  # [n]: their batch rows
    plan: object          # the model-axis plan their partial sums sum over


def local_entries(index: torch.Tensor, row_id: torch.Tensor,
                  num_features: int, block: tuple, plan) -> LocalEntries:
    """The entries whose index, clamped into ``[0, num_features)`` as
    JAX's gather clamps it, falls in ``block`` = (start, stop), this
    process's rows of the table; the others belong to another process of
    ``plan`` and are dropped here (a host sync for the count)."""
    c = clamp_index(index, num_features)
    start, stop = block
    pos = torch.nonzero((c >= start) & (c < stop)).reshape(-1)
    return LocalEntries(pos, c[pos].to(torch.int64) - start,
                        in_table(index[pos], num_features), row_id[pos],
                        plan)


def _rows(table, index, entries):
    """The gathered rows of ``table`` for the batch's entries (this
    process's, with ``entries``) and their values' positions."""
    if entries is not None:
        return take_rows(table, entries.row, entries.live), entries.pos
    n = table.shape[0]
    return take_rows(table, clamp_index(index, n), in_table(index, n)), None


def _sum(contrib, row_id, num_rows, force, entries):
    if entries is None:
        return segment_sum(contrib, row_id, num_rows, force=force)
    return segment_sum_model(contrib, entries.row_id, num_rows,
                             entries.plan, force)


def csr_matvec(weights: torch.Tensor, index: torch.Tensor,
               value: torch.Tensor, row_id: torch.Tensor, num_rows: int,
               force: str | None = None,
               entries: LocalEntries | None = None) -> torch.Tensor:
    """Per-row sparse dot product:
    out[r] = sum over k with row_id[k] == r of w[index[k]] * value[k].
    With ``entries``, ``weights`` is this process's block and the sum runs
    over the model axis."""
    rows, pos = _rows(weights, index, entries)
    return _sum(rows * (value if pos is None else value[pos]), row_id,
                num_rows, force, entries)


def csr_matmul(table: torch.Tensor, index: torch.Tensor, value: torch.Tensor,
               row_id: torch.Tensor, num_rows: int,
               force: str | None = None,
               entries: LocalEntries | None = None) -> torch.Tensor:
    """Sparse x dense: out[r, :] = sum_k value[k] * table[index[k], :], with
    ``table`` [num_features, K] -> [num_rows, K] (K lanes, one pass).  With
    ``entries``, as :func:`csr_matvec`."""
    rows, pos = _rows(table, index, entries)
    val = value if pos is None else value[pos]
    return _sum(rows * val[:, None], row_id, num_rows, force, entries)


def csr_row_sumsq_matmul(table: torch.Tensor, index: torch.Tensor,
                         value: torch.Tensor, row_id: torch.Tensor,
                         num_rows: int,
                         force: str | None = None,
                         entries: LocalEntries | None = None
                         ) -> torch.Tensor:
    """out[r, :] = sum_k value[k]^2 * table[index[k], :]^2 (the FM
    second-order term).  With ``entries``, as :func:`csr_matvec`."""
    rows, pos = _rows(table, index, entries)
    val = value if pos is None else value[pos]
    return _sum((rows ** 2) * (val[:, None] ** 2), row_id, num_rows, force,
                entries)


def csr_to_dense(index: torch.Tensor, value: torch.Tensor,
                 row_id: torch.Tensor, num_rows: int,
                 num_features: int) -> torch.Tensor:
    """Densify a COO batch: ``out[r, f]`` is the sum of ``value[k]`` over
    the entries with ``row_id[k] == r`` and ``index[k] == f``, in
    ``value``'s dtype.  Ids are taken as JAX's ``.at[].add(mode="drop")``
    takes them: a negative id counts from the end once, and an entry whose
    row or feature is then out of range is dropped (padding lanes, value
    0, add nothing).  A plain scatter-add, as the JAX package's is plain
    XLA."""
    r, f = row_id.to(torch.int64), index.to(torch.int64)
    r = torch.where(r < 0, r + num_rows, r)
    f = torch.where(f < 0, f + num_features, f)
    keep = (r >= 0) & (r < num_rows) & (f >= 0) & (f < num_features)
    cells = num_rows * num_features
    flat = torch.where(keep, r * num_features + f, cells)
    out = torch.zeros(cells + 1, dtype=value.dtype, device=value.device)
    out.index_add_(0, flat, value)
    return out[:cells].reshape(num_rows, num_features)


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
