"""Sparse linear model (logistic / squared loss) over padded batches."""
from __future__ import annotations

import torch
from torch import nn

from .._device import resolve_device
from ..data.staging import PaddedBatch
from ..ops.segment_sum import check_force
from ..ops.sparse import csr_matvec
from .common import SGDModelMixin


class SparseLinearModel(SGDModelMixin, nn.Module):
    """Logistic regression / linear regression over sparse batches.

    Parameters ``w`` [num_features] and ``b`` [] start at zero (the
    canonical linear init).  objective: "logistic" (labels in {0,1} or
    {-1,1}) or "squared".  ``sdot_backend`` picks the Row::SDot reduction
    (:mod:`..ops.segment_sum`).  ``mesh_plan`` (a ``parallel.MeshPlan``, a
    mesh or the ``(mesh, axis)`` tuple) serves ``place_params``,
    ``batch_sharding`` and ``grad_allreduce``; ``train_step`` takes its
    plan from a sharded batch."""

    def __init__(self, num_features: int, objective: str = "logistic",
                 l2: float = 0.0, learning_rate: float = 0.1,
                 sdot_backend: str | None = None, mesh_plan=None,
                 device="cuda"):
        super().__init__()
        if objective not in ("logistic", "squared"):
            raise ValueError(f"unknown objective '{objective}'")
        check_force(sdot_backend, "sdot_backend")
        dev = resolve_device(device)
        self.num_features = num_features
        self.objective = objective
        self.l2 = l2
        self.learning_rate = learning_rate
        self.sdot_backend = sdot_backend
        self.w = nn.Parameter(torch.zeros(num_features, device=dev))
        self.b = nn.Parameter(torch.zeros((), device=dev))
        self._set_mesh_plan(mesh_plan)

    @torch.no_grad()
    def init(self, seed: int = 0) -> "SparseLinearModel":
        """The canonical linear start, in place: ``w`` [F] and 0-d ``b``
        zero, f32 (``seed`` is unused, as the JAX package's)."""
        del seed
        self.w.zero_()
        self.b.zero_()
        return self

    def margins(self, batch: PaddedBatch) -> torch.Tensor:
        """Per-row scores w.x + b."""
        return csr_matvec(self.w, batch.index, batch.value, batch.row_ids(),
                          batch.batch_size, force=self.sdot_backend) + self.b

    @torch.no_grad()
    def evaluate(self, batches) -> dict:
        """Weighted loss (and accuracy, for the logistic objective) over an
        iterable of batches, reduced on the host as the JAX package's."""
        total_w = total_loss = correct = 0.0
        for batch in batches:
            m = self.margins(batch)
            w = batch.weight
            sum_w = float(torch.sum(w))
            total_w += sum_w
            total_loss += float(self.loss(batch)) * sum_w
            if self.objective == "logistic":
                y = (batch.label > 0.5).to(torch.float32)
                pred = (m > 0).to(torch.float32)
                correct += float(torch.sum((pred == y) * w))
        out = {"loss": total_loss / max(total_w, 1.0)}
        if self.objective == "logistic":
            out["accuracy"] = correct / max(total_w, 1.0)
        return out
