"""Factorization Machine.

score(x) = b + w.x + 1/2 sum_k [(sum_i v_ik x_i)^2 - sum_i v_ik^2 x_i^2]

One batch takes three segment-sums: the linear term (1 lane) and the two
second-order sparse x dense products (K lanes each).
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
    :meth:`init` for the random start, or load a state dict."""

    def __init__(self, num_features: int, num_factors: int = 16,
                 objective: str = "logistic", l2: float = 0.0,
                 learning_rate: float = 0.05, init_scale: float = 0.01,
                 sdot_backend: str | None = None, device="cuda"):
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
        self.w = nn.Parameter(torch.zeros(num_features, device=dev))
        self.v = nn.Parameter(torch.zeros(num_features, num_factors,
                                          device=dev))
        self.b = nn.Parameter(torch.zeros((), device=dev))

    @torch.no_grad()
    def init(self, seed: int = 0) -> "FactorizationMachine":
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
        B = batch.batch_size
        rid = batch.row_ids()  # once, shared by the three reductions
        fb = self.sdot_backend
        linear = csr_matvec(self.w, batch.index, batch.value, rid, B,
                            force=fb)
        vx = csr_matmul(self.v, batch.index, batch.value, rid, B,
                        force=fb)  # [B, K]
        v2x2 = csr_row_sumsq_matmul(self.v, batch.index, batch.value, rid, B,
                                    force=fb)  # [B, K]
        second = 0.5 * torch.sum(vx ** 2 - v2x2, dim=-1)
        return linear + second + self.b

    def _l2_terms(self) -> tuple:
        return (self.w, self.v)
