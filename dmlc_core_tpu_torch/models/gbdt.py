"""Histogram gradient-boosted decision trees over binned features.

The port of ``dmlc_core_tpu.models.gbdt``: the same hist algorithm
(XGBoost-hist), in PyTorch, held to the JAX package's forests on the same
inputs.

* ``QuantileBinner`` cuts each feature at quantiles of a host sample (numpy)
  and maps values to uint8 bin codes with ``torch.searchsorted``, or COO
  entries to int32 codes with a per-entry binary search;
* dense path (``fit``): each tree level builds ONE ``[nodes, features,
  bins]`` (grad, hess) histogram (``ops.histogram.histogram_gh``: the
  hand-written CUDA kernel on the card), finds splits with a cumsum and a
  flat argmax over it, and routes rows to the children with a gather;
* sparse path (``fit_batch``, on a CSR ``PaddedBatch`` or a pre-binned
  ``BinnedBatch`` from the epoch cache, no densify): each level's histogram
  comes from the present entries only (``ops.histogram_sparse``: a
  hand-written CUDA kernel over a once-a-fit feature-sorted layout), absent
  cells count as missing, and rows route by a segment-max over their
  entries;
* out of core (``fit_streamed``): the same trees from a replayable stream
  of batches (a file, the binned epoch cache, a sequence), with only the
  rows' state and the sorted layout resident;
* trees are fixed-depth complete binary heaps in flat arrays, so a forest is
  a dict of tensors with the JAX package's keys, shapes and dtypes.

Sampling below 1.0 (``subsample``, ``colsample_bytree``,
``colsample_bylevel``) draws from :mod:`..random`, ``jax.random``'s threefry
stream bit for bit, so a sampled forest is the JAX package's.

Row-sharded fits (``histogram_mesh=``, a ``parallel.MeshPlan``, a
``DeviceMesh`` or the ``(mesh, axis)`` tuple): every process of the plan
calls ``fit`` / ``fit_batch`` / ``fit_streamed`` with its own rows, and
every cross-row sum of the fit goes through the plan.  The kernel levels'
histograms, the node totals, the leaf sums and the base margin's, priors'
and eval losses' sums ride the kernels' int64 fixed point: each process
accumulates its rows at one shared scale, the accumulators are all-reduced
exactly, and one dequantize rounds them, so those sums are the same bits
whatever the process count or the plan's strategy, and equal to the
one-process kernels' over all rows.  ``index_add`` levels reduce their f32
histograms through the plan.  The forest comes out replicated, equal on
every process.
"""
from __future__ import annotations

import hashlib
import os
import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from .._device import resolve_device
from ..data.staging import (DeviceStagingIter, bucket_pow2,
                            pad_batch_to_bucket)
from ..ops.histogram import histogram_gh, histogram_gh_sharded
from ..ops.histogram_sparse import (entry_gh, feature_counts,
                                    histogram_gh_sparse,
                                    histogram_gh_sparse_sharded,
                                    sparse_hist_layout)
from ..ops.segment_sum import clamp_index, segment_sum, segment_sum_sharded
from ..parallel.meshplan import MeshPlan
from ..random import (PRNGKey, bernoulli, bernoulli_at, fold_in,
                      permutation, uniform)
from .common import logistic_nll


class QuantileBinner:
    """Per-feature quantile binning to uint8 codes (XGBoost-hist's sketch).

    ``fit`` computes per-feature quantile cut points on a host sample
    (numpy; the same cuts as the JAX package's binner); ``transform`` maps
    values to codes in ``[0, num_bins)`` with a searchsorted over the cuts,
    on the binner's device.

    With ``missing_aware=True`` bin 0 is RESERVED for missing values (NaN);
    present values map to ``[1, num_bins)``.  Pair with
    ``GBDT(missing_aware=True)``.

    ``partial_fit``/``finalize`` accumulate a bounded per-feature reservoir
    over a stream of chunks (numpy, seeded by ``sketch_seed``) and give the
    same cuts as the JAX package's streaming sketch.
    """

    def __init__(self, num_bins: int = 256, missing_aware: bool = False,
                 sketch_size: int = 4096, sketch_seed: int = 0,
                 device="cuda"):
        if not 2 <= num_bins <= 256:
            raise ValueError("num_bins must be in [2, 256] (uint8 codes)")
        if missing_aware and num_bins < 3:
            raise ValueError("missing_aware needs >= 3 bins")
        if sketch_size < num_bins:
            raise ValueError("sketch_size must be >= num_bins")
        self.device = resolve_device(device)
        self.num_bins = num_bins
        self.missing_aware = missing_aware
        self.sketch_size = sketch_size
        self.sketch_seed = sketch_seed
        # f32 [features, value_bins - 1] where value_bins excludes bin 0
        # in missing_aware mode
        self.cuts: Optional[torch.Tensor] = None
        self._sketch_values = None

    @classmethod
    def from_cuts(cls, cuts, num_bins: int, missing_aware: bool = False,
                  device="cuda") -> "QuantileBinner":
        """A fitted binner from cut points made elsewhere (for example the
        JAX package's ``binner.cuts`` as numpy)."""
        binner = cls(num_bins=num_bins, missing_aware=missing_aware,
                     device=device)
        binner._set_cuts(cuts)
        return binner

    def _set_cuts(self, cuts) -> None:
        self.cuts = torch.tensor(np.asarray(cuts, np.float32),
                                 device=self.device)

    def fit(self, sample: np.ndarray) -> "QuantileBinner":
        sample = np.asarray(sample, np.float32)
        if sample.ndim != 2:
            raise ValueError("fit expects [rows, features]")
        if not self.missing_aware and np.isnan(sample).any():
            raise ValueError(
                "sample contains NaN but missing_aware=False; construct "
                "QuantileBinner(..., missing_aware=True) (and pair it with "
                "GBDT(missing_aware=True)) to model missing values")
        value_bins = self.num_bins - 1 if self.missing_aware else self.num_bins
        qs = np.linspace(0.0, 1.0, value_bins + 1)[1:-1]
        with warnings.catch_warnings():
            # an all-NaN column (fully-missing feature) is legal input
            warnings.simplefilter("ignore", RuntimeWarning)
            cuts = np.nanquantile(sample, qs, axis=0).T
        cuts = np.nan_to_num(cuts)  # all-missing feature: degenerate cuts
        # non-decreasing cuts keep searchsorted stable on ties
        self._set_cuts(np.maximum.accumulate(cuts, axis=1))
        return self

    def transform(self, x) -> torch.Tensor:
        """[rows, features] float -> [rows, features] uint8 bin codes."""
        if self.cuts is None:
            raise RuntimeError("QuantileBinner.transform before fit")
        x = torch.as_tensor(x, device=self.device).to(torch.float32)
        codes = torch.searchsorted(self.cuts, x.T.contiguous(), right=True,
                                   out_int32=True).T
        if self.missing_aware:
            codes = torch.where(torch.isnan(x), 0, codes + 1)
        return codes.to(torch.uint8).contiguous()

    def fit_transform(self, x: np.ndarray) -> torch.Tensor:
        return self.fit(x).transform(np.asarray(x, np.float32))

    # ---- sparse (COO-entry) surface -----------------------------------------

    def fit_sparse(self, index: np.ndarray, value: np.ndarray,
                   num_features: int) -> "QuantileBinner":
        """Per-feature quantile cuts from a COO sample (host numpy, the JAX
        package's nearest-rank rule): the entries of feature f are its
        PRESENT values.  Requires ``missing_aware=True`` (absent cells are
        missing by construction in sparse data)."""
        if not self.missing_aware:
            raise ValueError("fit_sparse requires missing_aware=True "
                             "(absent cells are missing, not 0)")
        index = np.asarray(index, np.int64)
        value = np.asarray(value, np.float32)
        # NaN entries are malformed COO (missing = absent entry)
        keep = ~np.isnan(value)
        index, value = index[keep], value[keep]
        order = np.lexsort((value, index))
        idx_s, val_s = index[order], value[order]
        feats = np.arange(num_features)
        starts = np.searchsorted(idx_s, feats)
        ends = np.searchsorted(idx_s, feats + 1)
        lens = ends - starts
        value_bins = self.num_bins - 1
        qs = np.linspace(0.0, 1.0, value_bins + 1)[1:-1]
        pos = starts[:, None] + np.round(
            qs[None, :] * np.maximum(lens[:, None] - 1, 0)).astype(np.int64)
        pos = np.minimum(pos, np.maximum(ends[:, None] - 1, starts[:, None]))
        # empty trailing features have starts == ends == len(val_s); keep
        # the gather in bounds (their cuts are overwritten below anyway)
        pos = np.clip(pos, 0, max(val_s.size - 1, 0))
        cuts = (val_s[pos] if val_s.size
                else np.zeros((num_features, qs.size), np.float32))
        cuts[lens == 0] = 0.0  # feature never present: degenerate cuts
        self._set_cuts(np.maximum.accumulate(cuts, axis=1))
        return self

    def transform_entries(self, index, value) -> torch.Tensor:
        """Bin COO entries on the binner's device: the code of ``value[k]``
        under feature ``index[k]``'s cuts, in ``[1, num_bins)`` (0 stays
        reserved for missing = absent; a NaN value reads as 0).  A binary
        search of ``ceil(log2(C + 1))`` rounds of one gather each
        (searchsorted side="right"), with no [nnz, C] cut matrix.  Returns
        int32 [nnz]."""
        if not self.missing_aware:
            raise ValueError("transform_entries requires missing_aware=True")
        if self.cuts is None:
            raise RuntimeError("transform_entries before fit")
        F, C = self.cuts.shape
        flat = self.cuts.reshape(-1)
        # an index past the cut table reads its last feature, as JAX's
        # gather clamps it
        base = clamp_index(torch.as_tensor(index, device=self.device).to(
            torch.int64), F) * C
        v = torch.as_tensor(value, device=self.device).to(torch.float32)
        lo = torch.zeros(v.shape, dtype=torch.int64, device=self.device)
        hi = torch.full(v.shape, C, dtype=torch.int64, device=self.device)
        for _ in range(max(1, int(np.ceil(np.log2(C + 1))))):
            mid = (lo + hi) // 2
            cut = flat[base + torch.clamp(mid, max=C - 1)]
            go = (cut <= v) & (mid < hi)
            lo = torch.where(go, mid + 1, lo)
            hi = torch.where(go, hi, mid)
        return torch.where(torch.isnan(v), 0, lo + 1).to(torch.int32)

    def cuts_digest(self) -> str:
        """Short content digest of the fitted cuts (the JAX package's
        identity for a binner's bin vocabulary)."""
        if self.cuts is None:
            raise RuntimeError("cuts_digest before fit")
        a = np.ascontiguousarray(self.cuts.cpu().numpy().astype(np.float32))
        h = hashlib.sha256(a.tobytes())
        h.update(repr(a.shape).encode())
        return h.hexdigest()[:16]

    # ---- streaming (bounded-memory, mergeable) sketch -----------------------

    def partial_fit(self, x: np.ndarray) -> "QuantileBinner":
        """Accumulate a dense ``[rows, features]`` chunk into the sketch."""
        x = np.asarray(x, np.float32)
        if x.ndim != 2:
            raise ValueError("partial_fit expects [rows, features]")
        if not self.missing_aware and np.isnan(x).any():
            raise ValueError(
                "chunk contains NaN but missing_aware=False; construct "
                "QuantileBinner(..., missing_aware=True)")
        self._sketch_ensure(x.shape[1])
        for f in range(x.shape[1]):
            col = x[:, f]
            self._sketch_absorb(f, col[~np.isnan(col)])
        return self

    def partial_fit_sparse(self, index: np.ndarray, value: np.ndarray,
                           num_features: int) -> "QuantileBinner":
        """Accumulate a COO entry chunk (one staged batch's ``index`` /
        ``value``, padding masked off) into the sketch."""
        if not self.missing_aware:
            raise ValueError("partial_fit_sparse requires missing_aware=True "
                             "(absent cells are missing, not 0)")
        index = np.asarray(index, np.int64)
        value = np.asarray(value, np.float32)
        # malformed entries (NaN values, indices outside [0, num_features))
        # are dropped, as fit_sparse never visits them
        keep = (~np.isnan(value)) & (index >= 0) & (index < num_features)
        index, value = index[keep], value[keep]
        self._sketch_ensure(num_features)
        order = np.argsort(index, kind="stable")
        idx_s, val_s = index[order], value[order]
        feats = np.unique(idx_s)
        starts = np.searchsorted(idx_s, feats)
        ends = np.searchsorted(idx_s, feats + 1)
        for f, lo, hi in zip(feats, starts, ends):
            self._sketch_absorb(int(f), val_s[lo:hi])
        return self

    def finalize(self) -> "QuantileBinner":
        """Compute cuts from the accumulated reservoirs (nearest-rank) and
        drop the sketch state."""
        if self._sketch_values is None:
            raise RuntimeError("finalize before partial_fit/"
                               "partial_fit_sparse")
        res, fill = self._sketch_values, self._sketch_fill
        k = res.shape[1]
        value_bins = self.num_bins - 1 if self.missing_aware else self.num_bins
        qs = np.linspace(0.0, 1.0, value_bins + 1)[1:-1]
        # sort with +inf padding so every row's live prefix is its sample
        padded = np.where(np.arange(k)[None, :] < fill[:, None], res, np.inf)
        srt = np.sort(padded, axis=1)
        pos = np.round(qs[None, :] * np.maximum(fill[:, None] - 1, 0)
                       ).astype(np.int64)
        cuts = np.take_along_axis(srt, pos, axis=1).astype(np.float32)
        cuts[fill == 0] = 0.0  # feature never present: degenerate cuts
        self._set_cuts(np.maximum.accumulate(cuts, axis=1))
        self._sketch_values = None
        self._sketch_fill = None
        self._sketch_seen = None
        return self

    def _sketch_ensure(self, num_features: int) -> None:
        """Create (or grow) the per-feature reservoir state."""
        if self._sketch_values is None:
            self._sketch_rng = np.random.default_rng(self.sketch_seed)
            self._sketch_values = np.zeros((num_features, self.sketch_size),
                                           np.float32)
            self._sketch_fill = np.zeros(num_features, np.int64)
            self._sketch_seen = np.zeros(num_features, np.int64)
            return
        have = self._sketch_values.shape[0]
        if num_features > have:
            grow = num_features - have
            self._sketch_values = np.concatenate(
                [self._sketch_values,
                 np.zeros((grow, self.sketch_size), np.float32)])
            self._sketch_fill = np.concatenate(
                [self._sketch_fill, np.zeros(grow, np.int64)])
            self._sketch_seen = np.concatenate(
                [self._sketch_seen, np.zeros(grow, np.int64)])

    def _sketch_absorb(self, f: int, chunk: np.ndarray) -> None:
        """Merge one feature's chunk into its reservoir, keeping the
        reservoir a uniform sample of everything seen for that feature."""
        m = chunk.size
        if m == 0:
            return
        k = self.sketch_size
        fill = int(self._sketch_fill[f])
        seen = int(self._sketch_seen[f])
        rng = self._sketch_rng
        if seen + m <= k:
            # everything still fits: the reservoir is the complete stream
            self._sketch_values[f, fill:fill + m] = chunk
            self._sketch_fill[f] = fill + m
        else:
            # union sample: t slots from the old side, k - t from the chunk
            t = int(rng.hypergeometric(seen, m, k))
            t = min(t, fill)  # guard the degenerate fill < seen edge
            old = self._sketch_values[f, rng.choice(fill, t, replace=False)] \
                if t else np.empty(0, np.float32)
            new = chunk[rng.choice(m, k - t, replace=False)]
            self._sketch_values[f, :t] = old
            self._sketch_values[f, t:k] = new
            self._sketch_fill[f] = k
        self._sketch_seen[f] = seen + m


# ---- objectives ---------------------------------------------------------------

def _logistic_grad_hess(margin: torch.Tensor, label: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    p = torch.sigmoid(margin)
    y = (label > 0.5).to(margin.dtype)
    return p - y, torch.clamp(p * (1.0 - p), min=1e-16)


def _squared_grad_hess(margin: torch.Tensor, label: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    return margin - label, torch.ones_like(margin)


def _pairwise_terms(margin: torch.Tensor, label: torch.Tensor,
                    qid: torch.Tensor, weight: torch.Tensor, max_shift: int):
    """Pairwise logistic (RankNet) terms over qid-contiguous rows.

    Pairs each row i with row i+s for ``s = 1..max_shift`` when both sit in
    the same query group (every within-group pair appears for exactly one
    shift).  Returns (grad, hess, loss_sum, pair_count) with XGBoost's
    rank:pairwise signs (winner pushed up, loser down)."""
    rows = margin.shape[0]
    pos = torch.arange(rows, device=margin.device)
    g = torch.zeros(rows, dtype=torch.float32, device=margin.device)
    h = torch.zeros_like(g)
    loss = torch.zeros((), dtype=torch.float32, device=margin.device)
    npairs = torch.zeros((), dtype=torch.int32, device=margin.device)
    for s in range(1, max_shift + 1):
        mj = torch.roll(margin, -s)
        yj = torch.roll(label, -s)
        qj = torch.roll(qid, -s)
        wj = torch.roll(weight, -s)
        mask = ((qid == qj) & (pos < rows - s)   # same group, no wraparound
                & (weight > 0) & (wj > 0))
        dy = label - yj
        winner_i = dy > 0
        pair = mask & (dy != 0)
        d = torch.where(winner_i, margin - mj, mj - margin)  # winner - loser
        p = torch.sigmoid(-d)
        lam = torch.where(pair, p, 0.0)
        hh = torch.where(pair, torch.clamp(p * (1.0 - p), min=1e-16), 0.0)
        gi = torch.where(winner_i, -lam, lam)  # row i's share of the pair
        g = g + gi + torch.roll(-gi, s)        # row i+s gets the other sign
        h = h + hh + torch.roll(hh, s)
        # stable log(1 + e^-d)
        loss = loss + torch.sum(torch.where(
            pair, torch.clamp(-d, min=0) + torch.log1p(torch.exp(-d.abs())),
            0.0))
        npairs = npairs + torch.sum(pair).to(torch.int32)
    return g, h, loss, npairs


def _validate_rank_qid(qid, weight=None) -> int:
    """Host-side qid checks for the pairwise scan.

    Real (weight>0) rows of each query must form one contiguous block.
    Returns the scan depth: the max POSITIONAL span of a group's real rows
    plus one."""
    q = _host(qid)
    pos = (np.flatnonzero(_host(weight) > 0) if weight is not None
           else np.arange(q.size))
    qf = q[pos]
    if qf.size == 0:
        raise ValueError("rank:pairwise needs a non-empty qid array")
    boundaries = np.flatnonzero(np.diff(qf) != 0)
    starts = np.concatenate([[0], boundaries + 1])
    ends = np.concatenate([boundaries + 1, [qf.size]])
    if len(starts) != len(np.unique(qf)):
        raise ValueError(
            "rank:pairwise requires qid groups to be contiguous runs "
            "(sort rows by qid; libsvm ranking files already are)")
    spans = pos[ends - 1] - pos[starts]
    return int(spans.max()) + 1


def _softmax_ce(margin: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Per-row cross-entropy from [rows, K] margins and integer labels."""
    logz = torch.logsumexp(margin, dim=1)
    picked = torch.gather(margin, 1,
                          label.to(torch.int64)[:, None])[:, 0]
    return logz - picked


_SCAN_BLOCK = 16  # XLA's CPU cumsum: the block its two-level scan takes


def _cumsum_f32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Prefix sum along ``dim`` in f32.  On the CPU it adds in the order of
    the JAX package's jitted ``jnp.cumsum`` there, bit for bit: XLA scans
    blocks of 16 in sequence, scans the block totals by the same rule
    (recursively), then adds each block's carry to its in-block prefixes.
    (torch's CPU cumsum carries f32 sums in double, and a plain running
    sum parts from XLA's past 17 values; either moves split gains by an
    ulp.)  On CUDA it is ``torch.cumsum``, in f32 in the card's own
    order."""
    if x.device.type != "cpu":
        return torch.cumsum(x, dim)
    x = x.movedim(dim, -1)
    n, k = x.shape[-1], _SCAN_BLOCK
    if n <= k:
        parts = list(x.unbind(-1))
        for i in range(1, n):
            parts[i] = parts[i - 1] + parts[i]
        out = torch.stack(parts, -1) if parts else x
        return out.movedim(-1, dim)
    nb = -(-n // k)
    cols = list(torch.nn.functional.pad(x, (0, nb * k - n))
                .reshape(*x.shape[:-1], nb, k).unbind(-1))
    for i in range(1, k):
        cols[i] = cols[i - 1] + cols[i]
    inblock = torch.stack(cols, -1)                 # [..., nb, k]
    carry = _cumsum_f32(inblock[..., -1], -1)       # [..., nb]
    out = torch.cat([inblock[..., :1, :],
                     carry[..., :-1, None] + inblock[..., 1:, :]], -2)
    return out.reshape(*x.shape[:-1], nb * k)[..., :n].movedim(-1, dim)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---- the model ----------------------------------------------------------------


class GBDT:
    """Gradient-boosted complete binary trees over binned features.

    Parameters mirror the JAX package's ``GBDT`` (XGBoost-hist's
    essentials): ``num_trees``, ``max_depth``, ``learning_rate``,
    ``lambda_``, ``min_child_weight``, ``gamma``, ``objective``
    ("logistic", "squared", "softmax" with ``num_class``, "rank:pairwise"),
    ``missing_aware``, ``monotone_constraints``, ``interaction_constraints``,
    ``base_score``, ``scale_pos_weight`` and ``histogram`` ("auto", "xla",
    "pallas"; the ``DMLCTPU_GBDT_HISTOGRAM`` environment variable sets it
    when the argument is "auto").  ``device`` is where the forest is built:
    the card unless the caller passes ``device="cpu"``.  ``subsample`` /
    ``colsample_bytree`` in (0, 1] draw a per-tree Bernoulli row mask
    (folded into the weights) and feature subset, ``colsample_bylevel`` a
    fresh subset of that per depth, all from ``jax.random``'s stream under
    ``seed`` (:mod:`..random`), so they equal the JAX package's draws bit
    for bit.  ``histogram_mesh`` (a ``parallel.MeshPlan``, a ``DeviceMesh``
    or the ``(mesh, axis)`` tuple) shards the fit's rows over the plan's
    processes (see the module docstring); each process passes its own rows
    and gets the same forest.

    The forest is a dict of tensors on that device::

        feature       i32 [num_trees, 2**max_depth - 1]  per internal node
        threshold     i32 [num_trees, 2**max_depth - 1]  go right if bin > thr
        default_right i32 [num_trees, 2**max_depth - 1]  missing-bin routing
        split_gain    f32 [num_trees, 2**max_depth - 1]
        split_cover   f32 [num_trees, 2**max_depth - 1]
        leaf          f32 [num_trees, 2**max_depth]      shrunken leaf weights
        base          f32 [] ([num_class] for softmax)   initial margin
        trees_used    i32 []

    Null splits use ``threshold == num_bins`` (no code exceeds it).
    """

    def __init__(self, num_features: int, num_trees: int = 20,
                 max_depth: int = 6, num_bins: int = 256,
                 learning_rate: float = 0.3, lambda_: float = 1.0,
                 min_child_weight: float = 1e-3,
                 gamma: float = 0.0,
                 objective: str = "logistic",
                 missing_aware: bool = False,
                 subsample: float = 1.0,
                 colsample_bytree: float = 1.0,
                 seed: int = 0,
                 num_class: int = 0,
                 monotone_constraints=None,
                 colsample_bylevel: float = 1.0,
                 interaction_constraints=None,
                 base_score=None,
                 scale_pos_weight: float = 1.0,
                 histogram: str = "auto",
                 histogram_mesh=None,
                 device="cuda"):
        if objective not in ("logistic", "squared", "softmax",
                             "rank:pairwise"):
            raise ValueError(f"unknown objective '{objective}'")
        if objective == "softmax" and num_class < 2:
            raise ValueError("objective='softmax' needs num_class >= 2")
        if objective != "softmax" and num_class:
            raise ValueError("num_class is only valid with "
                             "objective='softmax'")
        for name, frac in (("subsample", subsample),
                           ("colsample_bytree", colsample_bytree),
                           ("colsample_bylevel", colsample_bylevel)):
            if not 0.0 < frac <= 1.0:
                raise ValueError(f"{name} must be in (0, 1]")
        if gamma < 0:
            raise ValueError("gamma must be >= 0")
        self.mesh_plan = MeshPlan.from_spec(histogram_mesh)
        # each local row's global row number during a sharded fit: the
        # sampling draws' element of each row
        self._row_index = None
        self.device = resolve_device(device)
        self.num_features = num_features
        self.num_trees = num_trees
        self.max_depth = max_depth
        self.num_bins = num_bins
        self.learning_rate = learning_rate
        self.lambda_ = lambda_
        self.min_child_weight = min_child_weight
        self.gamma = gamma
        self.objective = objective
        self.missing_aware = missing_aware
        self.num_class = num_class
        self.subsample = subsample
        self.colsample_bytree = colsample_bytree
        self.colsample_bylevel = colsample_bylevel
        self.seed = seed
        if monotone_constraints is not None:
            raw = np.asarray(monotone_constraints)
            # validate before casting: int32 truncation would silently
            # accept (and neuter) values like 0.5
            if (raw.shape != (num_features,)
                    or not np.isin(raw, (-1, 0, 1)).all()):
                raise ValueError("monotone_constraints must be a length-"
                                 "num_features sequence of -1/0/+1")
            mc = raw.astype(np.int32)
            monotone_constraints = (torch.as_tensor(mc, device=self.device)
                                    if mc.any() else None)
        self.monotone_constraints = monotone_constraints
        self._interaction_groups = None
        if interaction_constraints is not None:
            # membership[g, f]: feature f belongs to group g; features in
            # no group become singletons (XGBoost's group identity)
            rows = []
            grouped = np.zeros(num_features, dtype=bool)
            for group in interaction_constraints:
                g = np.asarray(group, np.int64)
                if g.size and ((g < 0) | (g >= num_features)).any():
                    raise ValueError(
                        "interaction_constraints feature ids must be in "
                        f"[0, {num_features})")
                row = np.zeros(num_features, dtype=bool)
                row[g] = True
                rows.append(row)
                grouped[g] = True
            for f in np.flatnonzero(~grouped):
                row = np.zeros(num_features, dtype=bool)
                row[f] = True
                rows.append(row)
            self._interaction_groups = torch.as_tensor(np.stack(rows),
                                                       device=self.device)
        self.base_score = base_score  # None = weighted prior from data
        if scale_pos_weight <= 0:
            raise ValueError("scale_pos_weight must be > 0")
        if scale_pos_weight != 1.0 and objective != "logistic":
            raise ValueError("scale_pos_weight applies to the logistic "
                             "objective (weight rows directly otherwise)")
        self.scale_pos_weight = scale_pos_weight
        if histogram == "auto":
            # ops escape hatch: force a histogram backend fleet-wide; an
            # explicit constructor argument always wins
            histogram = (os.environ.get("DMLCTPU_GBDT_HISTOGRAM", "").strip()
                         or "auto")
        if histogram not in ("auto", "xla", "pallas"):
            raise ValueError("histogram must be 'auto', 'xla' or 'pallas'")
        self.histogram = histogram
        self._grad_hess = (_logistic_grad_hess if objective == "logistic"
                           else _squared_grad_hess)

    # "auto" caps the kernel at this many nodes per level, as the JAX
    # package does: the kernel's node tiles grow with n_nodes, and past the
    # cap the level goes to index_add
    _PALLAS_NODE_LIMIT = 512

    def _hist_impl(self, n_nodes: int) -> str:
        """Histogram backend for a level with ``n_nodes`` nodes: an explicit
        "xla"/"pallas" wins; "auto" is the kernel on a CUDA device within
        the node cap, ``index_add`` ("xla") elsewhere (so on the CPU)."""
        if self.histogram != "auto":
            return self.histogram
        if (self.device.type == "cuda"
                and n_nodes <= self._PALLAS_NODE_LIMIT):
            return "pallas"
        return "xla"

    @staticmethod
    def _leaf_impl(grad: torch.Tensor) -> Optional[str]:
        """Leaf-sum backend, whatever ``histogram`` says.  On the card
        ``index_add`` adds with atomics in an order that changes from run to
        run, so leaf sums go through the deterministic segment-sum kernel.
        On the CPU: ``index_add``, as the JAX package sums leaves with
        ``jax.ops.segment_sum``."""
        return "pallas" if grad.device.type == "cuda" else None

    def _level_histogram(self, bins: torch.Tensor, rel: torch.Tensor,
                         gh: torch.Tensor, n_nodes: int) -> torch.Tensor:
        """Per-level [nodes, F, bins, 2] histogram with backend routing.
        With a mesh plan, over every process's rows
        (``histogram_gh_sharded``: exact on kernel levels), in
        ``overlap_chunks`` feature chunks whose all-reduces overlap the
        next chunk's histogram; ``mesh.overlap_occupancy`` is set to the
        structural overlap (K - 1) / K in permille."""
        impl = self._hist_impl(n_nodes)
        plan = self.mesh_plan
        if plan is None:
            return histogram_gh(bins, rel, gh, n_nodes, self.num_bins,
                                force=impl)
        K = min(plan.overlap_chunks, self.num_features)
        telemetry.gauge_set("mesh.overlap_occupancy", (K - 1) * 1000 // K)
        return histogram_gh_sharded(bins, rel, gh, n_nodes, self.num_bins,
                                    plan, chunks=K, force=impl).to(gh.dtype)

    def _seg_sum(self, gh: torch.Tensor, ids: torch.Tensor,
                 n: int) -> torch.Tensor:
        """Node totals and leaf sums: [n, 2] sums of ``gh`` by ``ids``.  With
        a mesh plan over every process's rows on the exact fixed-point
        route (``segment_sum_sharded``); else the segment-sum kernel on the
        card and ``index_add`` on the CPU (`_leaf_impl`)."""
        if self.mesh_plan is not None:
            return segment_sum_sharded(gh, ids, n, self.mesh_plan)
        return segment_sum(gh, ids, n, force=self._leaf_impl(gh))

    def _row_sums(self, x: torch.Tensor) -> torch.Tensor:
        """[L] column sums of ``x`` [rows, L] over every process's rows, on
        the exact fixed-point route (one segment), so every process gets
        the same bits whatever the plan's strategy.  Only under a plan."""
        zeros = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
        return segment_sum_sharded(x.to(torch.float32), zeros, 1,
                                   self.mesh_plan)[0]

    # the sparse kernel's node cap for "auto", as the JAX package sets it:
    # its shared-memory node tiles grow with n_nodes like the dense one's
    _SPARSE_PALLAS_NODE_LIMIT = 512

    def _hist_impl_sparse(self, n_nodes: int) -> str:
        """Sparse-histogram backend for a level: an explicit "xla"/"pallas"
        wins; "auto" is the kernel on a CUDA device within the sparse node
        cap, ``index_add`` ("xla") elsewhere."""
        if self.histogram != "auto":
            return self.histogram
        if (self.device.type == "cuda"
                and n_nodes <= self._SPARSE_PALLAS_NODE_LIMIT):
            return "pallas"
        return "xla"

    def _sparse_layout_enabled(self) -> bool:
        """Whether any level of this fit can resolve to the sparse kernel,
        i.e. whether `_sparse_fit_layout` builds a layout."""
        if self.histogram == "xla":
            return False
        return self.histogram == "pallas" or any(
            self._hist_impl_sparse(2 ** d) == "pallas"
            for d in range(self.max_depth))

    def _sparse_fit_layout(self, row_id, findex, ebin, emask):
        """The once-a-fit feature-sorted entry layout, or None when no level
        can resolve to the kernel (``index_add`` needs no layout).  Built on
        the model's device; ``findex`` is the same at every level of every
        tree, so the sort serves all ``num_trees * max_depth`` levels.  Its
        cost is published as ``gbdt.entry_sort_us``."""
        if not self._sparse_layout_enabled():
            return None
        t0 = time.monotonic()
        layout = sparse_hist_layout(row_id, findex, ebin, emask,
                                    self.num_features, self.num_bins)
        telemetry.counter_add("gbdt.entry_sort_us",
                              int((time.monotonic() - t0) * 1e6))
        return layout

    def _level_histogram_sparse(self, layout, rel: torch.Tensor,
                                gh_row: torch.Tensor, gh_e: torch.Tensor,
                                n_nodes: int) -> torch.Tensor:
        """Sparse per-level [nodes, F, bins, 2] on the kernel (the
        single-device route of the JAX package): ``gh_e`` is gathered once a
        tree by the caller (`entry_gh`); only the entries' node ids change
        by level.  With a mesh plan, over every process's entries
        (``histogram_gh_sparse_sharded``, exact)."""
        if self.mesh_plan is not None:
            return histogram_gh_sparse_sharded(layout, rel, gh_row, gh_e,
                                               n_nodes, self.mesh_plan,
                                               feature_counts(layout))
        return histogram_gh_sparse(None, None, None, None, rel, gh_row,
                                   n_nodes, self.num_features, self.num_bins,
                                   force="pallas", layout=layout, gh_e=gh_e)

    def _start_fit(self, rows: int, real: list) -> None:
        """Under a mesh plan: each local row's global row number, for the
        sampling draws (a collective).  ``real``: the rows that hold data in
        this process's ``rows`` rows, as ``(first row, count)`` spans; the
        other rows are padding (weight 0).  The real rows are numbered as
        the one-process epoch numbers them, after every earlier process's
        real rows, so a sharded fit whose processes pad their short and
        missing batches draws the one-process rows; padding rows take
        number 0, and their weight keeps them out of every sum."""
        if self.mesh_plan is None:
            self._row_index = None
            return
        off, _ = self.mesh_plan.row_offsets(sum(n for _, n in real))
        index = torch.zeros(rows, dtype=torch.int64, device=self.device)
        for first, n in real:
            index[first:first + n] = torch.arange(off, off + n,
                                                  device=self.device)
            off += n
        self._row_index = index

    def _t(self, x, dtype=None) -> torch.Tensor:
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()  # torch shares numpy memory and wants it writable
        t = torch.as_tensor(x, device=self.device)
        return t if dtype is None else t.to(dtype)

    # ---- forest construction ------------------------------------------------

    def init(self) -> dict:
        n_internal = 2 ** self.max_depth - 1
        # softmax grows K trees per round (round-major: tree i -> class i%K)
        total = self.num_trees * max(self.num_class, 1)
        dev = self.device
        return {
            "feature": torch.zeros(total, n_internal, dtype=torch.int32,
                                   device=dev),
            "threshold": torch.full((total, n_internal), self.num_bins,
                                    dtype=torch.int32, device=dev),
            "default_right": torch.zeros(total, n_internal,
                                         dtype=torch.int32, device=dev),
            "split_gain": torch.zeros(total, n_internal, device=dev),
            "split_cover": torch.zeros(total, n_internal, device=dev),
            "leaf": torch.zeros(total, 2 ** self.max_depth, device=dev),
            "base": (torch.zeros(self.num_class, device=dev)
                     if self.objective == "softmax"
                     else torch.zeros((), device=dev)),
            "trees_used": torch.zeros((), dtype=torch.int32, device=dev),
        }

    @staticmethod
    def _collapse_dir_ties(gain: torch.Tensor) -> torch.Tensor:
        """Deterministic default-direction tie-break on a [nodes, F, B,
        n_dir] gain array: where dir 0's gain sits within eps of the pair
        max, lift dir 0 TO the pair max, so the flat argmax lands on dir 0
        (missing-left) on every path."""
        if gain.shape[3] < 2:
            return gain
        g0, g1 = gain[..., 0], gain[..., 1]
        best = torch.maximum(g0, g1)
        prefer0 = g0 >= best - 1e-6 * (best.abs() + 1.0)
        return torch.stack([torch.where(prefer0, best, g0), g1], dim=3)

    def _pick_splits(self, gain: torch.Tensor,
                     col_mask: Optional[torch.Tensor]):
        """Flat argmax over a [nodes, F, B, n_dir] gain array plus null-split
        encoding.  ``col_mask``, when given, disables features: [F]
        (colsample_bytree / bylevel) or [nodes, F] (per-node interaction
        constraints).  Returns (split_f, split_b, split_d, split_gain) with
        nulls encoded as (0, num_bins, 0, 0.0)."""
        n_nodes = gain.shape[0]
        B = self.num_bins
        n_dir = gain.shape[3]
        if col_mask is not None:
            mask = (col_mask[None, :, None, None] if col_mask.dim() == 1
                    else col_mask[:, :, None, None])
            gain = torch.where(mask, gain, -torch.inf)
        flat = gain.reshape(n_nodes, -1)
        # torch.argmax, like jnp.argmax, returns the first maximum
        best_flat = torch.argmax(flat, dim=1)
        best_gain = torch.gather(flat, 1, best_flat[:, None])[:, 0]
        split_d = (best_flat % n_dir).to(torch.int32)
        best = best_flat // n_dir
        split_f = (best // B).to(torch.int32)
        split_b = (best % B).to(torch.int32)
        # gamma = min_split_loss on XGBoost's scale (raw gain <= 2*gamma)
        null = best_gain <= 2.0 * self.gamma
        zero = torch.zeros_like(split_f)
        return (torch.where(null, zero, split_f),
                torch.where(null, B, split_b),   # everything routes left
                torch.where(null, zero, split_d),
                torch.where(null, 0.0, best_gain))

    def _objective_loss(self, margin: torch.Tensor, label: torch.Tensor,
                        weight: Optional[torch.Tensor]) -> torch.Tensor:
        """Weighted mean objective from margins.  softmax: margin is
        [rows, K], label integer class ids."""
        if self.objective == "logistic":
            per = logistic_nll(margin, label)
        elif self.objective == "softmax":
            per = _softmax_ce(margin, label)
        else:
            per = 0.5 * (margin - label) ** 2
        if self.mesh_plan is not None:
            # over every process's rows: the exact sums of (per * w, w)
            w = (torch.ones_like(per) if weight is None
                 else weight.to(torch.float32))
            if per.dim() == 2:
                per = per.reshape(-1)
            tot = self._row_sums(torch.stack([per * w, w], dim=1))
            if weight is None:
                return tot[0] / tot[1]
            return tot[0] / torch.clamp(tot[1], min=1e-12)
        if weight is None:
            return torch.mean(per)
        w = weight.to(torch.float32)
        return torch.sum(per * w) / torch.clamp(torch.sum(w), min=1e-12)

    def _rank_fns(self, qid, w, eval_qid=None, eval_w=None,
                  have_eval: bool = False):
        """(grad_hess, eval_loss_fn) closures for rank:pairwise."""
        if qid is None:
            raise ValueError("objective='rank:pairwise' needs qid= "
                             "(per-row query ids; stage with with_qid=True)")
        if have_eval and eval_qid is None:
            raise ValueError(
                "rank:pairwise eval_set needs the eval qids: pass "
                "(eval_bins, eval_label, eval_weight_or_None, eval_qid)")
        qid = self._t(qid, torch.int32)
        max_group = _validate_rank_qid(qid, w)

        def grad_hess(margin, label):
            g, h, _, _ = _pairwise_terms(margin, label, qid, w,
                                         max_group - 1)
            return g, h

        eval_loss_fn = None
        if eval_qid is not None:
            eval_qid_t = self._t(eval_qid, torch.int32)
            ev_group = _validate_rank_qid(eval_qid_t, eval_w)

            def eval_loss_fn(margin, label, weight):  # noqa: F811
                ew = (torch.ones_like(label) if weight is None
                      else weight.to(torch.float32))
                _, _, loss, npairs = _pairwise_terms(
                    margin, label, eval_qid_t, ew, ev_group - 1)
                if self.mesh_plan is not None:  # every process's pairs
                    loss, npairs = self._row_sums(torch.stack(
                        [loss, npairs.to(torch.float32)])[None])
                return loss / torch.clamp(npairs, min=1)

        return grad_hess, eval_loss_fn

    def rank_scores(self, params: dict, bins) -> torch.Tensor:
        """Ranking scores (higher = ranked above) — just the margins."""
        return self.margins(params, bins)

    def pairwise_loss(self, params: dict, bins, label, qid,
                      weight=None) -> torch.Tensor:
        """Mean pairwise logistic loss over same-query pairs."""
        label = self._t(label, torch.float32)
        w = (torch.ones_like(label) if weight is None
             else self._t(weight, torch.float32))
        qid = self._t(qid, torch.int32)
        max_group = _validate_rank_qid(qid, w)
        m = self.margins(params, bins)
        _, _, loss, npairs = _pairwise_terms(m, label, qid, w, max_group - 1)
        return loss / torch.clamp(npairs, min=1)

    def _base_margin(self, label: torch.Tensor, w: torch.Tensor
                     ) -> torch.Tensor:
        if self.base_score is not None:
            bs = torch.tensor(float(self.base_score), device=self.device)
            if self.objective == "logistic":
                # XGBoost semantics: base_score is a PROBABILITY for the
                # logistic objective (its default 0.5 means margin 0)
                bs = torch.clamp(bs, 1e-6, 1 - 1e-6)
                return torch.log(bs / (1 - bs))
            return bs
        if self.objective == "logistic":
            num = torch.where(label > 0.5, w, 0.0)
        else:
            num = label * w
        if self.mesh_plan is not None:
            # over every process's rows, on the exact route
            tot = self._row_sums(torch.stack([w, num], dim=1))
            sum_w, sum_num = torch.clamp(tot[0], min=1e-12), tot[1]
        else:
            sum_w, sum_num = torch.clamp(torch.sum(w), min=1e-12), \
                torch.sum(num)
        if self.objective == "logistic":
            # base margin from the weighted prior, clamped away from 0/1
            p = torch.clamp(sum_num / sum_w, 1e-6, 1 - 1e-6)
            return torch.log(p / (1 - p))
        return sum_num / sum_w

    def _boost(self, label: torch.Tensor, w: torch.Tensor, build_tree,
               eval_margin=None, eval_label=None, eval_weight=None,
               early_stopping_rounds: int = 0,
               grad_hess=None, eval_loss_fn=None) -> dict:
        """Boosting driver: base prior, tree loop, early stopping, stacking.
        ``build_tree(grad, hess, col_mask, col_key)`` returns `_build_tree`'s
        7-tuple; ``eval_margin(f, t, d, leaf)`` gives one tree's margins on
        the held-out set.  With early stopping the forest is truncated at
        the best round and null-padded to its static shapes."""
        params = self.init()
        if self.scale_pos_weight != 1.0:
            # XGBoost's positive-class reweighting, as weight sugar
            w = w * torch.where(label > 0.5, self.scale_pos_weight, 1.0)
        params["base"] = self._base_margin(label, w).to(torch.float32)

        margin = params["base"].expand(label.shape).clone()
        have_eval = eval_margin is not None
        ev_m = (params["base"].expand(eval_label.shape).clone() if have_eval
                else None)
        best_loss, best_t, since_best = float("inf"), 0, 0
        feats, thrs, dirs, sgains, scovers, leaves = [], [], [], [], [], []
        grad_hess = grad_hess or self._grad_hess
        eval_loss_fn = eval_loss_fn or self._objective_loss
        for t_idx in range(self.num_trees):
            g, h = grad_hess(margin, label)
            w_t, col_mask, ck = self._tree_keys(t_idx, w)
            f, t, d, sg, sc, leaf, leaf_rel = build_tree(g * w_t, h * w_t,
                                                         col_mask, ck)
            margin = margin + leaf[leaf_rel]
            feats.append(f)
            thrs.append(t)
            dirs.append(d)
            sgains.append(sg)
            scovers.append(sc)
            leaves.append(leaf)
            if have_eval:
                ev_m = ev_m + eval_margin(f, t, d, leaf)
                loss = float(eval_loss_fn(ev_m, eval_label, eval_weight))
                if loss < best_loss:
                    best_loss, best_t, since_best = loss, t_idx + 1, 0
                elif early_stopping_rounds > 0:
                    since_best += 1
                    if since_best >= early_stopping_rounds:
                        break
        # truncation at the best round only when stopping was requested:
        # an eval_set alone is monitoring, not a pruning instruction
        stop_on = have_eval and early_stopping_rounds > 0
        trees_used = best_t if stop_on else len(feats)
        return self._stack_forest(params, feats, thrs, dirs, sgains,
                                  scovers, leaves, trees_used,
                                  self.num_trees)

    def _boost_multi(self, label: torch.Tensor, w: torch.Tensor, build_tree,
                     eval_margin=None, eval_label=None, eval_weight=None,
                     early_stopping_rounds: int = 0) -> dict:
        """Softmax boosting: K one-vs-rest trees per round against the
        shared softmax distribution (XGBoost multi:softprob).  Tree i
        belongs to class ``i % K``; early stopping works on whole rounds."""
        K = self.num_class
        params = self.init()
        label = label.to(torch.int32)
        lo, hi = int(label.min()), int(label.max())
        if self.mesh_plan is not None:  # every process checks every label
            neg_lo, hi = self.mesh_plan.allreduce(torch.tensor([-lo, hi]),
                                                  "max").tolist()
            lo = -neg_lo
        if lo < 0 or hi >= K:
            # out-of-range classes would silently train a corrupted forest
            raise ValueError(f"softmax labels must be integers in [0, {K}); "
                             f"got range [{lo}, {hi}]")
        onehot = torch.nn.functional.one_hot(label.to(torch.int64), K).to(
            torch.float32)
        if self.base_score is not None:
            params["base"] = self._t(np.broadcast_to(
                np.asarray(self.base_score, np.float32), (K,)).copy())
        else:
            if self.mesh_plan is not None:
                # every process's rows, on the exact route
                tot = self._row_sums(torch.cat([onehot * w[:, None],
                                                w[:, None]], dim=1))
                class_w, sum_w = tot[:K], torch.clamp(tot[K], min=1e-12)
            else:
                sum_w = torch.clamp(torch.sum(w), min=1e-12)
                class_w = torch.sum(onehot * w[:, None], dim=0)
            prior = torch.clamp(class_w / sum_w, 1e-6, 1.0)
            params["base"] = torch.log(prior)

        margin = params["base"].expand(label.shape[0], K).clone()
        have_eval = eval_margin is not None
        ev_m = (params["base"].expand(eval_label.shape[0], K).clone()
                if have_eval else None)
        best_loss, best_round, since_best = float("inf"), 0, 0
        feats, thrs, dirs, sgains, scovers, leaves = [], [], [], [], [], []
        for r in range(self.num_trees):
            p = torch.softmax(margin, dim=1)
            ev_round = []
            for k in range(K):
                g = p[:, k] - onehot[:, k]
                h = torch.clamp(p[:, k] * (1.0 - p[:, k]), min=1e-16)
                w_t, col_mask, ck = self._tree_keys(r * K + k, w)
                f, t, d, sg, sc, leaf, leaf_rel = build_tree(
                    g * w_t, h * w_t, col_mask, ck)
                margin[:, k] += leaf[leaf_rel]
                feats.append(f)
                thrs.append(t)
                dirs.append(d)
                sgains.append(sg)
                scovers.append(sc)
                leaves.append(leaf)
                if have_eval:
                    ev_round.append(eval_margin(f, t, d, leaf))
            if have_eval:
                ev_m = ev_m + torch.stack(ev_round, dim=1)
                loss = float(self._objective_loss(ev_m, eval_label,
                                                  eval_weight))
                if loss < best_loss:
                    best_loss, best_round, since_best = loss, r + 1, 0
                elif early_stopping_rounds > 0:
                    since_best += 1
                    if since_best >= early_stopping_rounds:
                        break
        stop_on = have_eval and early_stopping_rounds > 0
        trees_used = best_round * K if stop_on else len(feats)
        return self._stack_forest(params, feats, thrs, dirs, sgains,
                                  scovers, leaves, trees_used,
                                  self.num_trees * K)

    def _dir_child_weights(self, dirs, g_tot, h_tot):
        """Child weights -GL/(HL+λ), -GR/(HR+λ) per direction, stacked to the
        gain array's [nodes, F, B, n_dir] layout."""
        lam = self.lambda_
        ws = [(-a / (b + lam), -(g_tot - a) / (h_tot - b + lam))
              for a, b in dirs]
        wl = torch.stack([wp[0] for wp in ws], dim=3)
        wr = torch.stack([wp[1] for wp in ws], dim=3)
        return wl, wr

    def _apply_monotone(self, gain, wl, wr, lo, hi):
        """Mask monotonicity-violating splits (XGBoost
        monotone_constraints); gain/wl/wr [nodes, F, B, n_dir], lo/hi
        [nodes] output bounds."""
        c = self.monotone_constraints  # [F] in {-1, 0, +1}
        lo4, hi4 = lo[:, None, None, None], hi[:, None, None, None]
        wl_c = torch.clamp(wl, lo4, hi4)
        wr_c = torch.clamp(wr, lo4, hi4)
        ok_pos = wl_c <= wr_c
        ok_neg = wl_c >= wr_c
        cb = c[None, :, None, None]
        ok = torch.where(cb > 0, ok_pos, torch.where(cb < 0, ok_neg, True))
        return torch.where(ok, gain, -torch.inf)

    def _child_bounds(self, split_f, split_b, split_d, wl, wr, lo, hi):
        """Bounds for the next level's nodes after splitting (length
        2 * nodes, heap child order); null splits pass bounds through."""
        n_nodes = wl.shape[0]
        B = self.num_bins
        # null splits encode threshold == B: clamp the gather (mid is
        # unused for them — the where below passes bounds through)
        flat_idx = torch.clamp((split_f.to(torch.int64) * B + split_b)
                               * wl.shape[3] + split_d,
                               max=wl.shape[1] * B * wl.shape[3] - 1)

        def pick(a):
            return torch.gather(a.reshape(n_nodes, -1), 1,
                                flat_idx[:, None])[:, 0]

        wl_c = torch.clamp(pick(wl), lo, hi)
        wr_c = torch.clamp(pick(wr), lo, hi)
        mid = 0.5 * (wl_c + wr_c)
        c = self.monotone_constraints[split_f.to(torch.int64)]
        real = split_b < B
        hi_l = torch.where(real & (c > 0), torch.minimum(hi, mid), hi)
        lo_l = torch.where(real & (c < 0), torch.maximum(lo, mid), lo)
        lo_r = torch.where(real & (c > 0), torch.maximum(lo, mid), lo)
        hi_r = torch.where(real & (c < 0), torch.minimum(hi, mid), hi)
        # heap order: children of node n are 2n+1, 2n+2 -> interleave
        lo2 = torch.stack([lo_l, lo_r], dim=1).reshape(-1)
        hi2 = torch.stack([hi_l, hi_r], dim=1).reshape(-1)
        return lo2, hi2

    def _level_feature_mask(self, col_mask, col_key, depth: int,
                            active) -> Optional[torch.Tensor]:
        """The features a level may split on: the tree's ``col_mask`` [F]
        (None: all), intersected with a fresh ``colsample_bylevel`` draw
        from ``fold_in(col_key, depth)`` (sampled WITHIN the tree's subset,
        so it never goes empty), and with each node's active interaction
        groups.  Returns [F], [nodes, F], or None when nothing is masked."""
        eff = col_mask
        if self.colsample_bylevel < 1.0:
            F = self.num_features
            k_tree = (max(1, int(round(self.colsample_bytree * F)))
                      if self.colsample_bytree < 1.0 else F)
            k_level = max(1, int(round(self.colsample_bylevel * k_tree)))
            u = uniform(fold_in(col_key, depth), (F,), self.device)
            scores = u if col_mask is None else torch.where(
                col_mask, u, torch.inf)
            thresh = torch.sort(scores).values[k_level - 1]
            eff = scores <= thresh
        if active is None:
            return eff
        allowed = (active.to(torch.float32)
                   @ self._interaction_groups.to(torch.float32)) > 0
        return allowed if eff is None else allowed & eff[None, :]

    def _tree_sampling(self, root_key, t_idx: int, w: torch.Tensor):
        """Per-tree stochastic-GBM draws, shared by every boosting driver: a
        Bernoulli row mask folded into the weights (routing still sees all
        rows) and a feature subset [F] (None: all features).  Derived from
        (seed, tree index) only; the keys stay on the host and the draws
        land on the model's device."""
        w_t, col_mask = w, None
        if self.subsample < 1.0:
            kr = fold_in(root_key, 2 * t_idx)
            if self._row_index is None:
                keep = bernoulli(kr, self.subsample, tuple(w.shape),
                                 self.device)
            else:
                # a sharded fit: the one global draw at this process's
                # global row numbers
                keep = bernoulli_at(kr, self.subsample, self._row_index)
            w_t = w * keep.to(torch.float32)
        if self.colsample_bytree < 1.0:
            kc = fold_in(root_key, 2 * t_idx + 1)
            F = self.num_features
            k_cols = max(1, int(round(self.colsample_bytree * F)))
            sel = permutation(kc, F, self.device)[:k_cols]
            col_mask = torch.zeros(F, dtype=torch.bool, device=self.device)
            col_mask[sel] = True
        return w_t, col_mask

    def _tree_keys(self, t_idx: int, w: torch.Tensor):
        """(weights, col_mask, col_key) of tree ``t_idx``: its draws under
        ``PRNGKey(seed)``, and the key its levels fold their depth into
        (``fold_in(root, 1_000_000 + t_idx)``), as the JAX package's
        drivers take them.  Without sampling nothing is drawn."""
        if min(self.subsample, self.colsample_bytree,
               self.colsample_bylevel) == 1.0:
            return w, None, None
        root = PRNGKey(self.seed, device="cpu")
        w_t, col_mask = self._tree_sampling(root, t_idx, w)
        return w_t, col_mask, fold_in(root, 1_000_000 + t_idx)

    def _next_active(self, active, split_f, split_b):
        """Propagate interaction-constraint group sets to the children: a
        real split on f keeps only the active groups CONTAINING f; null
        splits pass through.  [n, G] -> [2n, G] in heap child order."""
        null = (split_b >= self.num_bins)[:, None]
        in_group = self._interaction_groups[:, split_f.to(torch.int64)].T
        nxt = torch.where(null, active, active & in_group)
        return torch.repeat_interleave(nxt, 2, dim=0)

    def _stack_forest(self, params, feats, thrs, dirs, sgains, scovers,
                      leaves, trees_used: int, total: int) -> dict:
        """Null-pad the per-tree lists to ``total`` static slots (trees past
        trees_used route every row left to leaf 0 whose weight is 0) and
        stack into the forest dict."""
        n_internal = 2 ** self.max_depth - 1
        dev = self.device
        null_f = torch.zeros(n_internal, dtype=torch.int32, device=dev)
        null_t = torch.full((n_internal,), self.num_bins, dtype=torch.int32,
                            device=dev)
        null_g = torch.zeros(n_internal, device=dev)
        null_leaf = torch.zeros(2 ** self.max_depth, device=dev)
        for i in range(trees_used, total):
            if i < len(feats):
                feats[i], thrs[i], dirs[i] = null_f, null_t, null_f
                sgains[i], scovers[i], leaves[i] = null_g, null_g, null_leaf
            else:
                feats.append(null_f)
                thrs.append(null_t)
                dirs.append(null_f)
                sgains.append(null_g)
                scovers.append(null_g)
                leaves.append(null_leaf)
        params["feature"] = torch.stack(feats)
        params["threshold"] = torch.stack(thrs)
        params["default_right"] = torch.stack(dirs)
        params["split_gain"] = torch.stack(sgains)
        params["split_cover"] = torch.stack(scovers)
        params["leaf"] = torch.stack(leaves)
        params["trees_used"] = torch.tensor(trees_used, dtype=torch.int32,
                                            device=dev)
        return params

    @torch.no_grad()
    def _build_tree(self, bins: torch.Tensor, grad: torch.Tensor,
                    hess: torch.Tensor, col_mask=None, col_key=None):
        """One tree from per-row (grad, hess), level by level.

        bins: u8 (or i32) [rows, features]; grad/hess: f32 [rows]
        (weight-scaled, padding rows carry 0 mass); ``col_mask`` /
        ``col_key``: the tree's feature draws (`_tree_keys`).  Returns
        (feature, threshold, default_right, split_gain, split_cover, leaf,
        leaf_rel) where leaf_rel is each row's final leaf index."""
        B = self.num_bins
        rows = bins.shape[0]
        dev = bins.device
        node = torch.zeros(rows, dtype=torch.int32, device=dev)
        mono = self.monotone_constraints is not None
        lo = torch.full((1,), -torch.inf, device=dev)
        hi = torch.full((1,), torch.inf, device=dev)
        active = (torch.ones(1, self._interaction_groups.shape[0],
                             dtype=torch.bool, device=dev)
                  if self._interaction_groups is not None else None)
        gh = torch.stack([grad, hess], dim=-1).contiguous()  # [rows, 2]
        features, thresholds, defaults, gains, covers = [], [], [], [], []
        lam = self.lambda_
        for depth in range(self.max_depth):
            first = 2 ** depth - 1          # heap id of the level's first node
            n_nodes = 2 ** depth
            rel = node - first              # [rows] in [0, n_nodes)
            hist = self._level_histogram(bins, rel, gh, n_nodes)
            hist_g = hist[..., 0]
            hist_h = hist[..., 1]
            # left cumulative mass for "go right if bin > b" at each cut b
            gl = _cumsum_f32(hist_g, dim=2)
            hl = _cumsum_f32(hist_h, dim=2)
            g_tot = gl[:, :, -1:]
            h_tot = hl[:, :, -1:]

            def split_gain(gl_, hl_):
                gr_ = g_tot - gl_
                hr_ = h_tot - hl_
                g = (gl_ ** 2 / (hl_ + lam) + gr_ ** 2 / (hr_ + lam)
                     - g_tot ** 2 / (h_tot + lam))          # [nodes, F, B]
                ok = ((hl_ >= self.min_child_weight)
                      & (hr_ >= self.min_child_weight))
                return torch.where(ok, g, -torch.inf)

            if self.missing_aware:
                # every cut twice from the same histograms: missing (bin 0)
                # mass on the left (its natural cumsum side) vs the right
                dirs = [(gl, hl),
                        (gl - hist_g[:, :, 0:1], hl - hist_h[:, :, 0:1])]
            else:
                dirs = [(gl, hl)]
            gain = torch.stack([split_gain(a, b) for a, b in dirs], dim=3)
            if mono:
                wl, wr = self._dir_child_weights(dirs, g_tot, h_tot)
                gain = self._apply_monotone(gain, wl, wr, lo, hi)
            gain = self._collapse_dir_ties(gain)
            node_mask = self._level_feature_mask(col_mask, col_key, depth,
                                                 active)
            split_f, split_b, split_d, split_g = self._pick_splits(gain,
                                                                   node_mask)
            if mono:
                lo, hi = self._child_bounds(split_f, split_b, split_d,
                                            wl, wr, lo, hi)
            if active is not None:
                active = self._next_active(active, split_f, split_b)
            features.append(split_f)
            thresholds.append(split_b)
            defaults.append(split_d)
            gains.append(split_g)
            covers.append(h_tot[:, 0, 0])   # node hessian mass (any f)
            # route rows: children of heap node n are 2n+1 (left), 2n+2
            rel_l = rel.to(torch.int64)
            row_bin = torch.gather(bins, 1, split_f[rel_l].to(torch.int64)
                                   [:, None])[:, 0].to(torch.int32)
            go_right = row_bin > split_b[rel_l]
            if self.missing_aware:
                go_right = torch.where(row_bin == 0, split_d[rel_l] == 1,
                                       go_right)
            node = 2 * node + 1 + go_right.to(torch.int32)

        # leaf weights: -G/(H + lambda) per leaf, shrunken (clamped into the
        # node's propagated bounds first under monotone constraints)
        n_leaves = 2 ** self.max_depth
        leaf_rel = node - (n_leaves - 1)
        gh_leaf = self._seg_sum(gh, leaf_rel, n_leaves)
        leaf_w = -gh_leaf[:, 0] / (gh_leaf[:, 1] + self.lambda_)
        if mono:
            leaf_w = torch.clamp(leaf_w, lo, hi)
        leaf = self.learning_rate * leaf_w
        return (torch.cat(features), torch.cat(thresholds),
                torch.cat(defaults), torch.cat(gains), torch.cat(covers),
                leaf, leaf_rel)

    def _tree_margins(self, feature: torch.Tensor, threshold: torch.Tensor,
                      default_right: torch.Tensor, leaf: torch.Tensor,
                      bins: torch.Tensor) -> torch.Tensor:
        """Route every row down one tree; returns its leaf weight per row."""
        rows = bins.shape[0]
        node = torch.zeros(rows, dtype=torch.int64, device=bins.device)
        for _ in range(self.max_depth):
            f = feature[node].to(torch.int64)
            t = threshold[node]
            b = torch.gather(bins, 1, f[:, None])[:, 0].to(torch.int32)
            go_right = b > t
            if self.missing_aware:
                go_right = torch.where(b == 0, default_right[node] == 1,
                                       go_right)
            node = 2 * node + 1 + go_right.to(torch.int64)
        return leaf[node - (2 ** self.max_depth - 1)]

    # ---- the sparse (COO-entry) path ----------------------------------------

    def _level_splits_from_hist(self, hist: torch.Tensor,
                                gh_node: torch.Tensor, lo, hi, active,
                                col_mask=None, col_key=None, depth: int = 0):
        """Split finding for one level from its present-entry [n_nodes, F,
        B, 2] histogram and [n_nodes, 2] node totals: each (node, feature)'s
        missing mass is the node total minus its present sum; dir 0 sends
        it left, dir 1 right.  Kept apart from `_build_tree`'s inline split
        code, as the JAX package keeps it.  Returns (split_f, split_b,
        split_d, split_g, lo, hi, active)."""
        lam = self.lambda_
        mono = self.monotone_constraints is not None
        gl = _cumsum_f32(hist, dim=2)                  # present mass
        miss = gh_node[:, None, :] - torch.sum(hist, dim=2)  # [n, F, 2]
        g_tot = gh_node[:, 0][:, None, None]           # [n, 1, 1]
        h_tot = gh_node[:, 1][:, None, None]

        def split_gain(gl_, hl_):
            gr_ = g_tot - gl_
            hr_ = h_tot - hl_
            g = (gl_ ** 2 / (hl_ + lam) + gr_ ** 2 / (hr_ + lam)
                 - g_tot ** 2 / (h_tot + lam))
            ok = ((hl_ >= self.min_child_weight)
                  & (hr_ >= self.min_child_weight))
            return torch.where(ok, g, -torch.inf)

        dirs = [(gl[..., 0] + miss[:, :, None, 0],
                 gl[..., 1] + miss[:, :, None, 1]),
                (gl[..., 0], gl[..., 1])]
        gain = torch.stack([split_gain(a, b) for a, b in dirs], dim=3)
        if mono:
            wl, wr = self._dir_child_weights(dirs, g_tot, h_tot)
            gain = self._apply_monotone(gain, wl, wr, lo, hi)
        gain = self._collapse_dir_ties(gain)
        split_f, split_b, split_d, split_g = self._pick_splits(
            gain, self._level_feature_mask(col_mask, col_key, depth, active))
        if mono:
            lo, hi = self._child_bounds(split_f, split_b, split_d,
                                        wl, wr, lo, hi)
        if active is not None:
            active = self._next_active(active, split_f, split_b)
        return split_f, split_b, split_d, split_g, lo, hi, active

    @staticmethod
    def _sparse_entries(row_id, findex, ebin, emask):
        """The entry arrays `_build_tree_sparse` reads, cast once a fit:
        int64 row ids (the routing scatter's index), int32 features and
        bins, the bool mask."""
        return (row_id.to(torch.int64), findex.to(torch.int32),
                ebin.to(torch.int32), emask)

    @torch.no_grad()
    def _build_tree_sparse(self, entries, grad: torch.Tensor,
                           hess: torch.Tensor, col_mask=None, col_key=None,
                           layout=None):
        """One tree from COO entries, O(nnz) histogram work a level.

        Present entries add their row's (grad, hess) into [nodes, features,
        bins] by (node of the row, feature, bin); missing mass comes from
        the node totals (`_level_splits_from_hist`).  Needs missing-aware
        codes from ``transform_entries`` (bin 0 stays empty).  A level's
        histogram goes to the kernel over ``layout`` or to ``index_add``
        (`_hist_impl_sparse`); node totals and leaf sums go through the
        segment-sum kernel on the card whatever ``histogram`` says
        (`_leaf_impl`).  Returns `_build_tree`'s 7-tuple."""
        F, B = self.num_features, self.num_bins
        rows = grad.shape[0]
        dev = grad.device
        mono = self.monotone_constraints is not None
        rid, fi, ebin, emask = entries
        gh_row = torch.stack([grad, hess], dim=-1).contiguous()  # [rows, 2]
        # entry (grad, hess), gathered once a tree for each backend its
        # levels take: the kernel's in feature order, index_add's in entry
        # order with padding lanes carrying 0 mass
        gh_e = {}
        node = torch.zeros(rows, dtype=torch.int32, device=dev)
        lo = torch.full((1,), -torch.inf, device=dev)
        hi = torch.full((1,), torch.inf, device=dev)
        active = (torch.ones(1, self._interaction_groups.shape[0],
                             dtype=torch.bool, device=dev)
                  if self._interaction_groups is not None else None)
        features, thresholds, defaults, gains, covers = [], [], [], [], []
        for depth in range(self.max_depth):
            n_nodes = 2 ** depth
            rel = node - (n_nodes - 1)
            impl = (self._hist_impl_sparse(n_nodes) if layout is not None
                    else "xla")
            if impl not in gh_e:
                gh_e[impl] = entry_gh(gh_row, rid, emask, layout
                                      if impl == "pallas" else None)
            if impl == "pallas":
                hist = self._level_histogram_sparse(layout, rel, gh_row,
                                                    gh_e[impl], n_nodes)
            else:                                      # bin 0 is empty
                hist = histogram_gh_sparse(rid, fi, ebin, emask, rel, gh_row,
                                           n_nodes, F, B, gh_e=gh_e[impl])
                if self.mesh_plan is not None:
                    hist = self.mesh_plan.allreduce(hist)
            gh_node = self._seg_sum(gh_row, rel, n_nodes)
            (split_f, split_b, split_d, split_g,
             lo, hi, active) = self._level_splits_from_hist(
                hist, gh_node, lo, hi, active, col_mask, col_key, depth)
            features.append(split_f)
            thresholds.append(split_b)
            defaults.append(split_d)
            gains.append(split_g)
            covers.append(gh_node[:, 1])
            rel_l = rel.to(torch.int64)
            go_right = self._route_sparse(fi, ebin, emask, rid,
                                          split_f[rel_l], split_b[rel_l],
                                          split_d[rel_l], rows)
            node = 2 * node + 1 + go_right.to(torch.int32)

        n_leaves = 2 ** self.max_depth
        leaf_rel = node - (n_leaves - 1)
        gh_leaf = self._seg_sum(gh_row, leaf_rel, n_leaves)
        leaf_w = -gh_leaf[:, 0] / (gh_leaf[:, 1] + self.lambda_)
        if mono:
            leaf_w = torch.clamp(leaf_w, lo, hi)
        leaf = self.learning_rate * leaf_w
        return (torch.cat(features), torch.cat(thresholds),
                torch.cat(defaults), torch.cat(gains), torch.cat(covers),
                leaf, leaf_rel)

    @staticmethod
    def _route_sparse(fi, ebin, emask, rid, row_feat, row_thr, row_dir,
                      rows: int) -> torch.Tensor:
        """One level of sparse routing, shared by training and inference:
        each row's bin for its split feature is the max over its matching
        entries (a ``scatter_reduce`` "amax" over a zero base, which also
        gives 0 = missing to rows with no matching entry), then the
        threshold / default-direction rule.  ``rid`` is int64."""
        match = (fi == row_feat[rid]) & emask
        row_bin = torch.zeros(rows, dtype=torch.int32,
                              device=fi.device).scatter_reduce(
            0, rid, torch.where(match, ebin, 0), "amax")
        return torch.where(row_bin == 0, row_dir == 1, row_bin > row_thr)

    @torch.no_grad()
    def _tree_margins_sparse_one(self, feature, threshold, default_right,
                                 leaf, rid, fi, ebin, emask,
                                 rows: int) -> torch.Tensor:
        """One tree's leaf weight per row by sparse routing."""
        node = torch.zeros(rows, dtype=torch.int64, device=fi.device)
        for _ in range(self.max_depth):
            go_right = self._route_sparse(fi, ebin, emask, rid,
                                          feature[node], threshold[node],
                                          default_right[node], rows)
            node = 2 * node + 1 + go_right.to(torch.int64)
        return leaf[node - (2 ** self.max_depth - 1)]

    def _margins_sparse(self, feature, threshold, default_right, leaf,
                        base, rid, fi, ebin, emask) -> torch.Tensor:
        """[rows] margins over ``num_trees`` trees, added tree by tree in
        the JAX package's order (``base`` is [rows])."""
        m = base
        for i in range(self.num_trees):
            m = m + self._tree_margins_sparse_one(
                feature[i], threshold[i], default_right[i], leaf[i], rid, fi,
                ebin, emask, base.shape[0])
        return m

    # ---- public API ---------------------------------------------------------

    @torch.no_grad()
    def fit(self, bins, label, weight=None, eval_set: Optional[tuple] = None,
            early_stopping_rounds: int = 0, qid=None) -> dict:
        """Train the forest on binned features.

        bins: u8 [rows, features] (``QuantileBinner.transform`` output);
        ``eval_set``: optional ``(eval_bins, eval_label[, eval_weight])``
        held-out set; with ``early_stopping_rounds > 0`` boosting stops
        after that many rounds without eval-loss improvement and the forest
        is truncated at the best round (``trees_used``).  ``qid``: per-row
        query ids for ``objective='rank:pairwise'`` (contiguous groups);
        its eval_set form is the 4-tuple ``(eval_bins, eval_label,
        eval_weight_or_None, eval_qid)``.  Returns the forest dict."""
        bins = self._bins(bins)
        label = self._t(label, torch.float32)
        w = (torch.ones_like(label) if weight is None
             else self._t(weight, torch.float32))
        self._start_fit(int(label.shape[0]), [(0, int(label.shape[0]))])
        eval_margin = eval_label = eval_weight = None
        if eval_set is not None:
            eval_bins = self._bins(eval_set[0])
            eval_label = self._t(eval_set[1], torch.float32)
            eval_weight = (self._t(eval_set[2]) if len(eval_set) > 2
                           and eval_set[2] is not None else None)
            eval_margin = (lambda f, t, d, leaf:
                           self._tree_margins(f, t, d, leaf, eval_bins))

        def build(g, h, col_mask, col_key):
            return self._build_tree(bins, g, h, col_mask, col_key)

        if self.objective == "rank:pairwise":
            grad_hess, eval_loss_fn = self._rank_fns(
                qid, w,
                eval_qid=(eval_set[3] if eval_set is not None and
                          len(eval_set) > 3 else None),
                eval_w=eval_weight, have_eval=eval_set is not None)
            return self._boost(label, w, build, eval_margin=eval_margin,
                               eval_label=eval_label,
                               eval_weight=eval_weight,
                               early_stopping_rounds=early_stopping_rounds,
                               grad_hess=grad_hess,
                               eval_loss_fn=eval_loss_fn)
        driver = (self._boost_multi if self.objective == "softmax"
                  else self._boost)
        return driver(label, w, build, eval_margin=eval_margin,
                      eval_label=eval_label, eval_weight=eval_weight,
                      early_stopping_rounds=early_stopping_rounds)

    @staticmethod
    def _entry_arrays(batch):
        """(row_id, findex, emask) of a PaddedBatch.  Entries whose value is
        0 are masked as missing (padding lanes, and stored zeros, which the
        value-0 padding convention cannot tell from them, as
        ``csr_to_dense_missing`` documents); NaN entries too."""
        v = batch.value
        emask = (v != 0) & ~torch.isnan(v)
        return batch.row_ids(), batch.index, emask

    def _entry_bins(self, batch, binner: QuantileBinner):
        """(row_id, findex, ebin, emask) of a staged batch on the model's
        device.  A pre-binned ``BinnedBatch`` (the binned epoch cache)
        brings its ``ebin``/``emask``, after its ``cuts_digest`` is checked
        against the binner's (mixing bin vocabularies would train a wrong
        forest); a ``PaddedBatch``'s bins come from
        ``binner.transform_entries``."""
        if hasattr(batch, "ebin"):
            digest = getattr(batch, "cuts_digest", "")
            if digest and binner.cuts is not None \
                    and digest != binner.cuts_digest():
                raise ValueError(
                    f"pre-binned batch was built under cuts {digest} but "
                    f"the binner holds {binner.cuts_digest()}; rebuild the "
                    "cache or pass the matching binner")
            return (self._t(batch.row_ids(), torch.int32),
                    self._t(batch.index, torch.int32),
                    self._t(batch.ebin, torch.int32), self._t(batch.emask))
        rid, fi, emask = self._entry_arrays(batch)
        ebin = binner.transform_entries(fi, batch.value)
        return (self._t(rid, torch.int32), self._t(fi, torch.int32),
                self._t(ebin), self._t(emask))

    @torch.no_grad()
    def fit_batch(self, batch, binner: QuantileBinner, weight=None,
                  eval_set=None, early_stopping_rounds: int = 0) -> dict:
        """Train directly on a staged CSR ``PaddedBatch``, with no densify.

        The sparse XGBoost-hist path: per-entry bins
        (``binner.transform_entries``), O(nnz) histograms a level, and
        absent cells handled as missing through the learned default
        directions.  Needs ``missing_aware=True`` on this model and the
        binner.  ``weight`` defaults to ``batch.weight`` (padding rows carry
        0 there).  Entries with a stored 0 count as missing, as in
        ``csr_to_dense_missing``, so this and ``fit`` on the densified
        matrix grow the same forest.  ``eval_set``: a held-out
        ``PaddedBatch`` (its weight masks its padding rows); with
        ``early_stopping_rounds`` as in ``fit``.  rank:pairwise reads the
        batches' ``qid``.  Returns the forest dict."""
        if not (self.missing_aware and binner.missing_aware):
            raise ValueError("fit_batch requires missing_aware=True on "
                             "both the GBDT and the QuantileBinner")
        label = self._t(batch.label, torch.float32)
        w = self._t(batch.weight if weight is None else weight,
                    torch.float32)
        row_id, findex, ebin, emask = self._entry_bins(batch, binner)
        self._start_fit(int(label.shape[0]), [(0, int(batch.num_rows))])
        # the same for every tree: the cast entry arrays and (for the
        # kernel) the feature-sorted layout, built once
        entries = self._sparse_entries(row_id, findex, ebin, emask)
        layout = self._sparse_fit_layout(row_id, findex, ebin, emask)
        eval_margin = eval_label = eval_weight = None
        if eval_set is not None:
            ev = self._sparse_entries(*self._entry_bins(eval_set, binner))
            eval_label = self._t(eval_set.label, torch.float32)
            eval_weight = self._t(eval_set.weight, torch.float32)
            ev_rows = eval_label.shape[0]
            eval_margin = (lambda f, t, d, leaf:
                           self._tree_margins_sparse_one(
                               f, t, d, leaf, ev[0], ev[1], ev[2], ev[3],
                               ev_rows))

        def build(g, h, col_mask, col_key):
            return self._build_tree_sparse(entries, g, h, col_mask, col_key,
                                           layout=layout)

        if self.objective == "rank:pairwise":
            grad_hess, eval_loss_fn = self._rank_fns(
                batch.qid, w,
                eval_qid=(eval_set.qid if eval_set is not None else None),
                eval_w=eval_weight, have_eval=eval_set is not None)
            return self._boost(label, w, build, eval_margin=eval_margin,
                               eval_label=eval_label,
                               eval_weight=eval_weight,
                               early_stopping_rounds=early_stopping_rounds,
                               grad_hess=grad_hess,
                               eval_loss_fn=eval_loss_fn)
        driver = (self._boost_multi if self.objective == "softmax"
                  else self._boost)
        return driver(label, w, build, eval_margin=eval_margin,
                      eval_label=eval_label, eval_weight=eval_weight,
                      early_stopping_rounds=early_stopping_rounds)

    @torch.no_grad()
    def fit_streamed(self, batches, binner: QuantileBinner, eval_set=None,
                     early_stopping_rounds: int = 0,
                     staging_options: Optional[dict] = None) -> dict:
        """Out-of-core training: XGBoost's external-memory mode.

        ``batches`` is a replayable source of staged batches
        (``PaddedBatch`` or pre-binned ``BinnedBatch``): a dataset URI (a
        fresh ``DeviceStagingIter`` on the model's device for each replay,
        with ``staging_options``, e.g. ``dict(batch_size=8192,
        num_workers=4)`` or ``dict(bin_cache=path, binner=binner)``), a
        callable returning a fresh iterator, or a sequence.  Every replay
        must yield the same batches in the same order.

        Residency: the rows' state (label, weight, margins, node ids,
        grad/hess, a few words a row) stays on the device; the entries are
        streamed again for each level.  Where a level can take the sparse
        kernel, the once-a-fit feature-sorted layout (~13 bytes an entry)
        is resident too: pass 0 gathers the batches' entries on the device
        and sorts them once, and each kernel level routes the rows in a
        streamed pass of its own, then runs one kernel launch over the
        layout.  Levels on ``index_add`` ("xla") add each batch's histogram
        into the level's in the pass that also routes the previous level,
        as the JAX package's do.

        The trees are ``fit_batch``'s on the concatenated batches: split
        finding is shared, and on the card the kernel levels' histograms,
        node totals and leaf sums are exact fixed-point sums, so the
        forests are equal bit for bit.  All of ``fit_batch``'s objectives
        and controls apply (rank:pairwise needs batches staged with
        ``with_qid=True``); ``eval_set`` is a resident ``PaddedBatch``.
        Under a mesh plan a batch's real rows (its first ``num_rows``)
        take their row sampling at their numbers in the one-process epoch,
        whatever padding the ranks' batches carry, so a sampled sharded fit
        grows the forest of one process whose batches are full.
        Returns the forest dict."""
        if not (self.missing_aware and binner.missing_aware):
            raise ValueError("fit_streamed requires missing_aware=True on "
                             "both the GBDT and the QuantileBinner")
        if isinstance(batches, str):
            uri = batches
            opts = dict(staging_options or {})
            opts.setdefault("device", self.device)
            replay = lambda: iter(DeviceStagingIter(uri, **opts))  # noqa: E731
        elif staging_options is not None:
            raise ValueError("staging_options only applies when `batches` "
                             "is a dataset URI string")
        else:
            replay = batches if callable(batches) else (lambda: iter(batches))

        # pass 0: the rows' resident state and each batch's row offset,
        # plus, where a level can take the kernel, the entries on the
        # device for the once-a-fit sort (under a mesh, of this process's
        # rows: its kernel levels take the exact sharded route, as
        # fit_batch's do)
        want_layout = self._sparse_layout_enabled()
        labels, weights, qids, offsets, real = [], [], [], [0], []
        ent = ([], [], [], []) if want_layout else None
        for b in replay():
            if want_layout:
                rid_b, fi_b, eb_b, em_b = self._entry_bins(b, binner)
                ent[0].append(rid_b.to(torch.int64) + offsets[-1])
                ent[1].append(fi_b)
                ent[2].append(eb_b)
                ent[3].append(em_b)
            labels.append(self._t(b.label, torch.float32))
            weights.append(self._t(b.weight, torch.float32))
            if b.qid is not None:
                qids.append(self._t(b.qid))
            real.append((offsets[-1], int(b.num_rows)))
            offsets.append(offsets[-1] + int(b.label.shape[0]))
        if not labels:
            raise ValueError("fit_streamed: the batch source is empty")
        label, w = torch.cat(labels), torch.cat(weights)
        self._start_fit(int(label.shape[0]), real)
        qid = torch.cat(qids) if len(qids) == len(labels) else None
        rows = int(label.shape[0])
        F, B = self.num_features, self.num_bins
        layout = None
        if want_layout:
            layout = self._sparse_fit_layout(*(torch.cat(e) for e in ent))
            ent = None  # only the sorted layout stays resident

        def stream():
            """(row offset, the batch's cast entry arrays, its rows)."""
            for i, b in enumerate(replay()):
                yield (offsets[i], self._sparse_entries(
                    *self._entry_bins(b, binner)), int(b.label.shape[0]))

        def routed(node_b, prev, first_prev, e, nb):
            pf, pb, pd = prev
            rid, fi, ebin, emask = e
            rel_p = (node_b - first_prev).to(torch.int64)
            go_right = self._route_sparse(fi, ebin, emask, rid, pf[rel_p],
                                          pb[rel_p], pd[rel_p], nb)
            return 2 * node_b + 1 + go_right.to(torch.int32)

        def route_pass(node, prev, first_prev):
            # one streamed pass routing every row through prev's splits
            return torch.cat([routed(node[off:off + nb], prev, first_prev,
                                     e, nb) for off, e, nb in stream()])

        def build_tree(grad, hess, col_mask, col_key):
            gh_row = torch.stack([grad, hess], dim=-1).contiguous()
            # the kernel levels' entry (grad, hess) in layout order, once a
            # tree; only the rows' node ids change by level
            gh_e = (entry_gh(gh_row, layout=layout)
                    if layout is not None else None)
            node = torch.zeros(rows, dtype=torch.int32, device=self.device)
            lo = torch.full((1,), -torch.inf, device=self.device)
            hi = torch.full((1,), torch.inf, device=self.device)
            active = (torch.ones(1, self._interaction_groups.shape[0],
                                 dtype=torch.bool, device=self.device)
                      if self._interaction_groups is not None else None)
            features, thresholds, defaults, gains, covers = [], [], [], [], []
            prev = None  # the previous level's (split_f, split_b, split_d)
            for depth in range(self.max_depth):
                first = 2 ** depth - 1
                n_nodes = 2 ** depth
                impl = (self._hist_impl_sparse(n_nodes)
                        if layout is not None else "xla")
                if impl == "pallas":
                    if prev is not None:
                        node = route_pass(node, prev, 2 ** (depth - 1) - 1)
                        prev = None
                    rel = node - first
                    hist = self._level_histogram_sparse(layout, rel, gh_row,
                                                        gh_e, n_nodes)
                else:
                    hist = torch.zeros(n_nodes, F, B, 2, device=self.device)
                    parts = []
                    for off, e, nb in stream():
                        node_b = node[off:off + nb]
                        if prev is not None:
                            # route through the previous level's splits in
                            # the pass that accumulates this level
                            node_b = routed(node_b, prev,
                                            2 ** (depth - 1) - 1, e, nb)
                            parts.append(node_b)
                        hist = hist + histogram_gh_sparse(
                            *e, node_b - first, gh_row[off:off + nb],
                            n_nodes, F, B)
                    if prev is not None:
                        node = torch.cat(parts)
                        prev = None
                    rel = node - first
                    if self.mesh_plan is not None:
                        hist = self.mesh_plan.allreduce(hist)
                gh_node = self._seg_sum(gh_row, rel, n_nodes)
                (split_f, split_b, split_d, split_g,
                 lo, hi, active) = self._level_splits_from_hist(
                    hist, gh_node, lo, hi, active, col_mask, col_key, depth)
                features.append(split_f)
                thresholds.append(split_b)
                defaults.append(split_d)
                gains.append(split_g)
                covers.append(gh_node[:, 1])
                prev = (split_f, split_b, split_d)

            # the last pass: route through the deepest splits to the leaves
            node = route_pass(node, prev, 2 ** (self.max_depth - 1) - 1)
            n_leaves = 2 ** self.max_depth
            leaf_rel = node - (n_leaves - 1)
            gh_leaf = self._seg_sum(gh_row, leaf_rel, n_leaves)
            leaf_w = -gh_leaf[:, 0] / (gh_leaf[:, 1] + self.lambda_)
            if self.monotone_constraints is not None:
                leaf_w = torch.clamp(leaf_w, lo, hi)
            leaf = self.learning_rate * leaf_w
            return (torch.cat(features), torch.cat(thresholds),
                    torch.cat(defaults), torch.cat(gains), torch.cat(covers),
                    leaf, leaf_rel)

        eval_margin = eval_label = eval_weight = None
        if eval_set is not None:
            ev = self._sparse_entries(*self._entry_bins(eval_set, binner))
            eval_label = self._t(eval_set.label, torch.float32)
            eval_weight = self._t(eval_set.weight, torch.float32)
            ev_rows = eval_label.shape[0]
            eval_margin = (lambda f, t, d, leaf:
                           self._tree_margins_sparse_one(
                               f, t, d, leaf, ev[0], ev[1], ev[2], ev[3],
                               ev_rows))
        if self.objective == "rank:pairwise":
            if qid is None:
                raise ValueError("rank:pairwise fit_streamed needs batches "
                                 "staged with_qid=True")
            grad_hess, eval_loss_fn = self._rank_fns(
                qid, w,
                eval_qid=(eval_set.qid if eval_set is not None else None),
                eval_w=eval_weight, have_eval=eval_set is not None)
            return self._boost(label, w, build_tree,
                               eval_margin=eval_margin,
                               eval_label=eval_label,
                               eval_weight=eval_weight,
                               early_stopping_rounds=early_stopping_rounds,
                               grad_hess=grad_hess,
                               eval_loss_fn=eval_loss_fn)
        driver = (self._boost_multi if self.objective == "softmax"
                  else self._boost)
        return driver(label, w, build_tree, eval_margin=eval_margin,
                      eval_label=eval_label, eval_weight=eval_weight,
                      early_stopping_rounds=early_stopping_rounds)

    def _batch_routing(self, params: dict, batch, binner: QuantileBinner,
                       what: str):
        if not (self.missing_aware and binner.missing_aware):
            # a dense missing_aware=False forest has every code shifted -1
            # against transform_entries: routing it here would be wrong
            raise ValueError(f"{what} requires missing_aware=True on both "
                             "the GBDT and the QuantileBinner")
        entries = self._sparse_entries(*self._entry_bins(batch, binner))
        return self._forest(params), entries

    @torch.no_grad()
    def margins_batch(self, params: dict, batch,
                      binner: QuantileBinner) -> torch.Tensor:
        """[rows] margins over a staged CSR batch (sparse routing)."""
        (feature, threshold, default_right), ent = self._batch_routing(
            params, batch, binner, "margins_batch")
        base = params["base"].expand(batch.label.shape[0]).to(
            self.device).clone()
        return self._margins_sparse(feature, threshold, default_right,
                                    params["leaf"], base, *ent)

    @torch.no_grad()
    def margins_multi_batch(self, params: dict, batch,
                            binner: QuantileBinner) -> torch.Tensor:
        """[rows, K] softmax margins over a staged CSR batch."""
        (feature, threshold, default_right), ent = self._batch_routing(
            params, batch, binner, "margins_multi_batch")
        K, rows = self.num_class, batch.label.shape[0]
        m = params["base"].expand(rows, K).clone()
        for i in range(feature.shape[0]):
            m[:, i % K] += self._tree_margins_sparse_one(
                feature[i], threshold[i], default_right[i], params["leaf"][i],
                *ent, rows)
        return m

    def predict_batch(self, params: dict, batch,
                      binner: QuantileBinner) -> torch.Tensor:
        if self.objective == "softmax":
            return torch.softmax(
                self.margins_multi_batch(params, batch, binner), dim=1)
        m = self.margins_batch(params, batch, binner)
        return torch.sigmoid(m) if self.objective == "logistic" else m

    def margins_batch_bucketed(self, params: dict, batch,
                               binner: QuantileBinner, row_bucket=None,
                               nnz_bucket=None) -> torch.Tensor:
        """``margins_batch`` on the batch padded up to its pow-2 (rows, nnz)
        bucket, sliced back to its rows.  Real-row margins are unchanged:
        padding lanes are value 0 (masked) and padding rows are cut off."""
        padded = pad_batch_to_bucket(batch, row_bucket, nnz_bucket)
        return self.margins_batch(params, padded,
                                  binner)[:batch.batch_size]

    def predict_batch_bucketed(self, params: dict, batch,
                               binner: QuantileBinner, row_bucket=None,
                               nnz_bucket=None) -> torch.Tensor:
        """Bucketed ``predict_batch`` (see :meth:`margins_batch_bucketed`);
        the serving engine's route for a gbdt snapshot."""
        padded = pad_batch_to_bucket(batch, row_bucket, nnz_bucket)
        return self.predict_batch(params, padded, binner)[:batch.batch_size]

    def predict_staged(self, params: dict, uri: str,
                       binner: QuantileBinner, batch_size: int = 65536,
                       **staging_kwargs) -> np.ndarray:
        """Streaming inference over a whole dataset file: stage sparse
        batches onto the model's device (``DeviceStagingIter``), score each
        with ``predict_batch``, and return the real rows' predictions in
        file order as numpy.  Staging kwargs (part/num_parts, format,
        nnz_bucket, ...) pass through, except ``sharding`` and a
        multi-process run: padding would interleave across shards, and
        this surface slices each batch to its ``num_rows``."""
        if staging_kwargs.get("sharding") is not None:
            raise ValueError(
                "predict_staged is a single-host, unsharded surface "
                "(tail-only padding assumption); stage with "
                "DeviceStagingIter and score with predict_batch, keeping "
                "rows where batch.weight > 0")
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise ValueError(
                "predict_staged in a multi-process run would interleave "
                "padding across processes; use DeviceStagingIter + "
                "predict_batch per batch instead")
        staging_kwargs.setdefault("device", self.device)
        it = DeviceStagingIter(uri, batch_size=batch_size, **staging_kwargs)
        outs = []
        try:
            for batch in it:
                pred = self.predict_batch(params, batch, binner)
                # padding is tail-only: slice by the real-row count (a
                # weight > 0 filter would drop zero-weighted file rows)
                outs.append(pred[:batch.num_rows].cpu().numpy())
        finally:
            it.close()
        if not outs:
            shape = ((0, self.num_class) if self.objective == "softmax"
                     else (0,))
            return np.zeros(shape, np.float32)
        return np.concatenate(outs)

    def _bins(self, bins) -> torch.Tensor:
        """Codes on the model's device, uint8 or int32 as the kernel reads
        them (other integer types are widened once, not per level)."""
        b = self._t(bins)
        if b.dtype not in (torch.uint8, torch.int32):
            b = b.to(torch.int32)
        return b.contiguous()

    def _forest(self, params: dict):
        default_right = params.get("default_right")
        if default_right is None:
            # forests saved before default_right existed predict as
            # missing-left everywhere
            default_right = torch.zeros_like(params["feature"])
        return params["feature"], params["threshold"], default_right

    @torch.no_grad()
    def margins(self, params: dict, bins) -> torch.Tensor:
        """[rows] margins: the base plus each tree's leaf weight, added tree
        by tree in the JAX package's order."""
        bins = self._bins(bins)
        feature, threshold, default_right = self._forest(params)
        m = params["base"].expand(bins.shape[0]).clone()
        for i in range(self.num_trees):
            m = m + self._tree_margins(feature[i], threshold[i],
                                       default_right[i], params["leaf"][i],
                                       bins)
        return m

    @torch.no_grad()
    def margins_multi(self, params: dict, bins) -> torch.Tensor:
        """[rows, K] softmax margins (tree i contributes to class i % K)."""
        bins = self._bins(bins)
        feature, threshold, default_right = self._forest(params)
        K = self.num_class
        m = params["base"].expand(bins.shape[0], K).clone()
        for i in range(feature.shape[0]):
            m[:, i % K] += self._tree_margins(feature[i], threshold[i],
                                              default_right[i],
                                              params["leaf"][i], bins)
        return m

    def predict(self, params: dict, bins) -> torch.Tensor:
        if self.objective == "softmax":
            return torch.softmax(self.margins_multi(params, bins), dim=1)
        m = self.margins(params, bins)
        return torch.sigmoid(m) if self.objective == "logistic" else m

    def predict_bucketed(self, params: dict, bins,
                         row_bucket=None) -> torch.Tensor:
        """Dense ``predict`` padded up to a pow-2 row bucket (padding rows
        are bin 0 and are sliced away)."""
        bins = self._bins(bins)
        rows = bins.shape[0]
        rb = (bucket_pow2(rows) if row_bucket is None
              else max(int(row_bucket), rows))
        if rb != rows:
            bins = torch.cat([bins, bins.new_zeros(rb - rows,
                                                   bins.shape[1])])
        return self.predict(params, bins)[:rows]

    def feature_importance(self, params: dict,
                           kind: str = "gain") -> torch.Tensor:
        """Per-feature importance over real splits (the get_score surface):
        "weight" (split count), "gain"/"cover" (per-split average gain /
        hessian mass), "total_gain"/"total_cover" (sums).  Returns f32
        [num_features]; null splits are excluded."""
        feat = _host(params["feature"]).reshape(-1)
        thr = _host(params["threshold"]).reshape(-1)
        real = thr < self.num_bins
        counts = np.zeros(self.num_features, np.float64)
        np.add.at(counts, feat[real], 1.0)
        if kind == "weight":
            return self._t(counts.astype(np.float32))
        base = kind[len("total_"):] if kind.startswith("total_") else kind
        if base not in ("gain", "cover"):
            raise ValueError(f"unknown importance kind '{kind}'")
        key = f"split_{base}"
        if key not in params:
            raise KeyError(
                f"forest has no '{key}' (saved before importance "
                "bookkeeping existed); kind='weight' still works")
        vals = _host(params[key]).astype(np.float64).reshape(-1)
        out = np.zeros(self.num_features, np.float64)
        np.add.at(out, feat[real], vals[real])
        if not kind.startswith("total_"):
            out = np.divide(out, counts, out=np.zeros_like(out),
                            where=counts > 0)
        return self._t(out.astype(np.float32))

    def loss(self, params: dict, bins, label, weight=None) -> torch.Tensor:
        """Mean objective over rows; ``weight`` masks padding rows."""
        if self.objective == "rank:pairwise":
            raise ValueError("ranking loss needs qids: use "
                             "pairwise_loss(params, bins, label, qid)")
        m = (self.margins_multi(params, bins)
             if self.objective == "softmax"
             else self.margins(params, bins))
        label = self._t(label, torch.float32)
        w = None if weight is None else self._t(weight, torch.float32)
        return self._objective_loss(m, label, w)
