"""Factorization Machine.

score(x) = b + w.x + 1/2 sum_k [(sum_i v_ik x_i)^2 - sum_i v_ik^2 x_i^2]

One batch takes three segment-sums: the linear term (1 lane) and the two
second-order sparse x dense products (K lanes each).  Under a dp x tp plan
(``mesh_plan=`` a ``parallel.MeshPlan`` with a model axis) the module holds
its block of ``w`` and ``v`` and each sum adds every model process's
partial sums (``ops.sparse.local_entries``).
"""
from __future__ import annotations

import torch
from torch import nn

from .._device import resolve_device
from ..data.staging import PaddedBatch
from ..ops.segment_sum import check_force
from ..ops.sparse import csr_matmul, csr_matvec, csr_row_sumsq_matmul
from .common import SGDModelMixin


class FactorizationMachine(SGDModelMixin, nn.Module):
    """Parameters ``w`` [F], ``v`` [F, K] and ``b`` [] start at zero; call
    :meth:`init` for the random start, or load a state dict.  Under a plan
    with a model axis ``w`` and ``v`` are this process's block of F/M
    features (``table_block``)."""

    def __init__(self, num_features: int, num_factors: int = 16,
                 objective: str = "logistic", l2: float = 0.0,
                 learning_rate: float = 0.05, init_scale: float = 0.01,
                 sdot_backend: str | None = None, mesh_plan=None,
                 device="cuda"):
        super().__init__()
        if objective not in ("logistic", "squared"):
            raise ValueError(f"unknown objective '{objective}'")
        check_force(sdot_backend, "sdot_backend")
        dev = resolve_device(device)
        self.num_features = num_features
        self.num_factors = num_factors
        self.objective = objective
        self.l2 = l2
        self.learning_rate = learning_rate
        self.init_scale = init_scale
        self.sdot_backend = sdot_backend
        rows = self._set_mesh_plan(mesh_plan, num_features)
        self.w = nn.Parameter(torch.zeros(rows, device=dev))
        self.v = nn.Parameter(torch.zeros(rows, num_factors, device=dev))
        self.b = nn.Parameter(torch.zeros((), device=dev))

    @torch.no_grad()
    def init(self, seed: int = 0) -> "FactorizationMachine":
        """Random start: w = 0, b = 0, v = init_scale * N(0, 1) drawn from
        a ``torch.Generator`` seeded with ``seed`` (not the JAX package's
        numbers: tests hand both packages the same numpy params); a block
        of a sharded table is its rows of the whole table's draw."""
        gen = torch.Generator(device=self.v.device).manual_seed(seed)
        self.w.zero_()
        self.b.zero_()
        v = self.init_scale * torch.randn(
            (self.num_features, self.num_factors), generator=gen,
            device=self.v.device)
        self.v.copy_(v[slice(*(self.table_block or (None,)))])
        return self

    def margins(self, batch: PaddedBatch) -> torch.Tensor:
        B = batch.batch_size
        rid = batch.row_ids()  # once, shared by the three reductions
        fb = self.sdot_backend
        e = self._entries(batch, rid)  # this block's entries, or None
        linear = csr_matvec(self.w, batch.index, batch.value, rid, B,
                            force=fb, entries=e)
        vx = csr_matmul(self.v, batch.index, batch.value, rid, B,
                        force=fb, entries=e)  # [B, K]
        v2x2 = csr_row_sumsq_matmul(self.v, batch.index, batch.value, rid, B,
                                    force=fb, entries=e)  # [B, K]
        second = 0.5 * torch.sum(vx ** 2 - v2x2, dim=-1)
        return linear + second + self.b

    def _l2_terms(self) -> tuple:
        return (self.w, self.v)
