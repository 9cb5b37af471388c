"""Field-aware Factorization Machine: the consumer of the libffm parser's
field lane (``DeviceStagingIter(with_field=True)`` stages the field ids).

score(x) = b + w.x + 1/2 sum_{i != j} <v[f_i, fl_j], v[f_j, fl_i]> x_i x_j

where fl_i is entry i's field.  As in the JAX package, the pairwise sum
uses the field-grouped identity

    S[r, a, b, :] = sum_{k in row r, fl_k = a} x_k * v[f_k, b, :]
    sum_{i != j} ... = sum_{a,b} <S[r, a, b], S[r, b, a]>
                       - sum_k x_k^2 |v[f_k, fl_k]|^2

so the interaction term is one gather ([nnz, fields, K] factor rows), one
sum keyed by (row, source field) and one einsum; padding entries (value 0)
add nothing.  The linear term is ``csr_matvec`` (the segment-sum kernel on
the card with ``sdot_backend="pallas"``: one launch a batch); the
field-pair sums are ``index_add``, as the JAX package's are a plain
``jax.ops.segment_sum``.  Factors live as v[num_features, num_fields, K].
"""
from __future__ import annotations

import torch
from torch import nn

from .._device import resolve_device
from ..data.staging import PaddedBatch
from ..ops.segment_sum import check_force, clamp_index
from ..ops.sparse import csr_matvec
from .common import SGDModelMixin


class FieldAwareFactorizationMachine(SGDModelMixin, nn.Module):
    """Parameters ``w`` [F], ``v`` [F, num_fields, K] and ``b`` [] start at
    zero; call :meth:`init` for the random start, or load a state dict."""

    def __init__(self, num_features: int, num_fields: int,
                 num_factors: int = 4, objective: str = "logistic",
                 l2: float = 0.0, learning_rate: float = 0.05,
                 init_scale: float = 0.01,
                 sdot_backend: str | None = None, device="cuda"):
        super().__init__()
        if objective not in ("logistic", "squared"):
            raise ValueError(f"unknown objective '{objective}'")
        if num_fields < 1:
            raise ValueError("num_fields must be >= 1")
        check_force(sdot_backend, "sdot_backend")
        dev = resolve_device(device)
        self.num_features = num_features
        self.num_fields = num_fields
        self.num_factors = num_factors
        self.objective = objective
        self.l2 = l2
        self.learning_rate = learning_rate
        self.init_scale = init_scale
        self.sdot_backend = sdot_backend
        self.w = nn.Parameter(torch.zeros(num_features, device=dev))
        self.v = nn.Parameter(torch.zeros(num_features, num_fields,
                                          num_factors, device=dev))
        self.b = nn.Parameter(torch.zeros((), device=dev))

    @torch.no_grad()
    def init(self, seed: int = 0) -> "FieldAwareFactorizationMachine":
        """Random start: w = 0, b = 0, v = init_scale * N(0, 1) drawn from
        a ``torch.Generator`` seeded with ``seed`` (not the JAX package's
        numbers: tests hand both packages the same numpy params)."""
        gen = torch.Generator(device=self.v.device).manual_seed(seed)
        self.w.zero_()
        self.b.zero_()
        self.v.copy_(self.init_scale * torch.randn(
            self.v.shape, generator=gen, device=self.v.device))
        return self

    def margins(self, batch: PaddedBatch) -> torch.Tensor:
        if batch.field is None:
            raise ValueError(
                "FFM needs field ids: stage with "
                "DeviceStagingIter(..., with_field=True) (libfm format)")
        B, A, K = batch.batch_size, self.num_fields, self.num_factors
        rid = batch.row_ids()
        idx = clamp_index(batch.index, self.num_features)
        val = batch.value
        # out-of-range field ids clamp (padding lanes carry value 0, so
        # their clamped target adds nothing anyway)
        fld = torch.clamp(batch.field, 0, A - 1)
        rid_l = rid.to(torch.int64)

        linear = csr_matvec(self.w, batch.index, val, rid, B,
                            force=self.sdot_backend)
        # [nnz, A, K]: entry k's factor rows toward every target field
        ve = self.v[idx] * val[:, None, None]
        # summed by (row, source field) -> S[r, a, b, :]
        S = torch.zeros(B * A, A, K, dtype=ve.dtype,
                        device=ve.device).index_add(
            0, rid_l * A + fld.to(torch.int64), ve).reshape(B, A, A, K)
        cross = torch.einsum("rabk,rbak->r", S, S)
        # the self-pair diagonal (i == j): x_k^2 |v[f_k, fl_k]|^2
        v_self = self.v[idx, fld.to(torch.int64)]              # [nnz, K]
        diag = torch.zeros(B, dtype=ve.dtype, device=ve.device).index_add(
            0, rid_l, (val ** 2) * torch.sum(v_self ** 2, dim=-1))
        return linear + 0.5 * (cross - diag) + self.b

    def _l2_terms(self) -> tuple:
        return (self.w, self.v)
